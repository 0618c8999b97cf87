"""Layer stack ("Chain") as ``nn.Module``s.

Counterpart of ``deepqlearning_tpu.models.chain``: Dense, Flatten,
Activation, the recurrent cells LSTM and GRU, and Chain. Parameters keep the
JAX layout — ``w [din, dout]``, ``b [dout]``; a cell's ``wi [in, gH]``,
``wh [H, gH]``, ``b [gH]`` with the gates in the order i,f,g,o (LSTM) or
r,z,n (GRU) — so weights move 1:1 between the packages without a transpose.

The modules own their parameters (created on ``device``), and the learner
works functionally on a dict of tensors ``{name: tensor}`` keyed like
``named_parameters()``: ``init(generator)`` refills the module's parameters
from a seeded generator and returns that dict (sharing storage with the
module), and ``apply(params, x)`` runs the forward with any such dict
(``torch.func.functional_call``), e.g. the target network's.

Recurrent state is explicit, as in the JAX package: ``init_state(batch)``
gives a tuple with one entry per layer (``()`` for stateless layers, ``(h,
c)`` for LSTM, ``(h,)`` for GRU), ``apply(params, x, state) -> (y, state')``
steps once and ``apply_sequence(params, xs [T, B, ...], state)`` unrolls
over time with the cells' input projections hoisted out of the time loop.
A feed-forward network's ``apply`` returns ``(y, ())``.
"""
from __future__ import annotations

import math
from typing import Callable, Dict, Optional

import torch
from torch import nn
from torch.func import functional_call


class _Functional(nn.Module):
    """``init``/``apply`` over a parameter dict, shared by all networks."""

    recurrent = False

    def init(self, generator: Optional[torch.Generator] = None
             ) -> Dict[str, torch.Tensor]:
        """Re-initialise every parameter in place from ``generator`` and
        return the parameter dict (views of the module's parameters)."""
        for m in self.modules():
            if isinstance(m, (Dense, LSTM, GRU)):
                m.reset_parameters(generator)
        return params_of(self)

    def init_state(self, batch_size: int, device=None) -> tuple:
        return ()

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor,
              state=None):
        """Forward with the given parameters; returns ``(q, state')``. A
        recurrent network needs ``state`` (see ``init_state``); a
        feed-forward one returns an empty state, as the JAX ``apply``
        does."""
        if not self.recurrent:
            return functional_call(self, params, (x,)), ()
        if state is None:
            raise ValueError(
                "recurrent Chain requires explicit state; call init_state()")
        return functional_call(self, params, (x, state))

    def apply_sequence(self, params: Dict[str, torch.Tensor],
                       xs: torch.Tensor, state):
        """Unroll over a time-major ``[T, B, ...]`` sequence from ``state``;
        returns ``(ys [T, B, out], state')``."""
        return functional_call(self, params, (xs, state), {"sequence": True})


def params_of(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters as a plain dict of detached tensors."""
    return {k: v.detach() for k, v in module.named_parameters()}


def _glorot_(w: torch.Tensor, generator) -> None:
    limit = math.sqrt(6.0 / (w.shape[0] + w.shape[1]))
    u = torch.rand(w.shape, generator=generator, device=w.device)
    w.copy_(u * (2 * limit) - limit)


class Dense(_Functional):
    """Affine layer with an optional activation (``torch.tanh``,
    ``torch.relu`` or any elementwise callable)."""

    def __init__(self, in_dim: int, out_dim: int,
                 activation: Optional[Callable] = None, use_bias: bool = True,
                 device=None):
        super().__init__()
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.activation = activation
        self.use_bias = use_bias
        self.w = nn.Parameter(torch.empty(self.in_dim, self.out_dim,
                                          device=device))
        self.b = (nn.Parameter(torch.zeros(self.out_dim, device=device))
                  if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform ``w`` and zero ``b``, as the JAX ``Dense.init``."""
        with torch.no_grad():
            _glorot_(self.w, generator)
            if self.b is not None:
                self.b.zero_()

    def forward(self, x):
        y = x @ self.w  # also over leading [T, B] axes
        if self.b is not None:
            y = y + self.b
        if self.activation is not None:
            y = self.activation(y)
        return y


class Flatten(_Functional):
    """Flatten all but the leading batch axis."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(_Functional):
    """Standalone elementwise activation layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def lstm_cell(xi, h, c, wh, b):
    """One LSTM step (gates i,f,g,o) from the input projection ``xi = x @
    wi``; returns ``(h', c')``."""
    i, f, g, o = (xi + h @ wh + b).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    return torch.sigmoid(o) * torch.tanh(c), c


def gru_cell(xi, h, wh, b):
    """One GRU step (gates r,z,n) from the input projection ``xi = x @
    wi``; returns ``h'``."""
    H = h.shape[-1]
    hh = h @ wh
    r = torch.sigmoid(xi[..., :H] + hh[..., :H] + b[:H])
    z = torch.sigmoid(xi[..., H:2 * H] + hh[..., H:2 * H] + b[H:2 * H])
    n = torch.tanh(xi[..., 2 * H:] + r * hh[..., 2 * H:] + b[2 * H:])
    return (1.0 - z) * n + z * h


class _Cell(_Functional):
    """A recurrent cell with ``n_gates`` gates: ``wi [in, gH]``, ``wh [H,
    gH]``, ``b [gH]``. ``forward(x, state)`` steps once; with ``sequence``
    it unrolls ``xs [T, B, in]`` with the input projection ``xs @ wi`` taken
    for all steps at once."""

    recurrent = True
    n_gates = 0

    def __init__(self, in_dim: int, hidden: int, device=None):
        super().__init__()
        self.in_dim, self.hidden = int(in_dim), int(hidden)
        g = self.n_gates * self.hidden
        self.wi = nn.Parameter(torch.empty(self.in_dim, g, device=device))
        self.wh = nn.Parameter(torch.empty(self.hidden, g, device=device))
        self.b = nn.Parameter(torch.zeros(g, device=device))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform ``wi`` and ``wh``, zero ``b`` (LSTM: forget-gate
        bias 1.0), as the JAX ``init``."""
        with torch.no_grad():
            _glorot_(self.wi, generator)
            _glorot_(self.wh, generator)
            self.b.zero_()

    def forward(self, x, state, sequence: bool = False):
        if not sequence:
            return self._cell(x @ self.wi, state)
        T, B = x.shape[0], x.shape[1]
        xi_all = (x.reshape(T * B, -1) @ self.wi).reshape(T, B, -1)
        ys = []
        for t in range(T):
            y, state = self._cell(xi_all[t], state)
            ys.append(y)
        return torch.stack(ys), state


class LSTM(_Cell):
    """LSTM cell, gates i,f,g,o; state ``(h, c)``."""

    n_gates = 4

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        super().reset_parameters(generator)
        with torch.no_grad():
            self.b[self.hidden:2 * self.hidden] = 1.0

    def init_state(self, batch_size: int, device=None):
        z = lambda: torch.zeros(batch_size, self.hidden,
                                device=device or self.wi.device)
        return (z(), z())

    def _cell(self, xi, state):
        h, c = lstm_cell(xi, *state, self.wh, self.b)
        return h, (h, c)


class GRU(_Cell):
    """GRU cell, gates r,z,n; state ``(h,)``."""

    n_gates = 3

    def init_state(self, batch_size: int, device=None):
        return (torch.zeros(batch_size, self.hidden,
                            device=device or self.wi.device),)

    def _cell(self, xi, state):
        h = gru_cell(xi, *state, self.wh, self.b)
        return h, (h,)


class Chain(_Functional):
    """Sequential container; an empty chain is the identity. With a
    ``state`` (one entry per layer) it threads recurrent state and returns
    ``(y, state')``."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (tuple, list)):
            layers = tuple(layers[0])
        self.layers = nn.ModuleList(layers)

    def forward(self, x, state=None, sequence: bool = False):
        if state is None:
            for layer in self.layers:
                x = layer(x)
            return x
        new_state = []
        for layer, s in zip(self.layers, state):
            if layer.recurrent:
                x, s = layer(x, s, sequence)
            elif sequence and isinstance(layer, Flatten):
                x = x.reshape(x.shape[0], x.shape[1], -1)
            else:
                x = layer(x)
            new_state.append(s)
        return x, tuple(new_state)

    def init_state(self, batch_size: int, device=None) -> tuple:
        return tuple(l.init_state(batch_size, device) for l in self.layers)

    @property
    def recurrent(self) -> bool:
        return any(l.recurrent for l in self.layers)

    @property
    def out_dim(self) -> Optional[int]:
        for layer in reversed(self.layers):
            if isinstance(layer, Dense):
                return layer.out_dim
            if isinstance(layer, _Cell):
                return layer.hidden
        return None


def isrecurrent(network) -> bool:
    return bool(getattr(network, "recurrent", False))
