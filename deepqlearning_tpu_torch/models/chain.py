"""Layer stack ("Chain") as ``nn.Module``s.

Counterpart of ``deepqlearning_tpu.models.chain``: Dense, Flatten,
Activation, Conv2D, the recurrent cells LSTM and GRU, and Chain. Parameters
keep the JAX layout — ``w [din, dout]``, ``b [dout]``; a Conv2D's ``w [kh,
kw, in, out]`` (HWIO) over NHWC inputs; a cell's ``wi [in, gH]``, ``wh [H,
gH]``, ``b [gH]`` with the gates in the order i,f,g,o (LSTM) or r,z,n (GRU)
— so weights move 1:1 between the packages without a transpose.

Dtypes follow the JAX layers: ``init(generator, dtype)`` gives every
parameter ``dtype`` (e.g. ``torch.bfloat16``). A layer takes its products
in f32 (``jnp.dot(..., preferred_element_type=float32)``: the operands
promoted to f32, where a bf16 product is exact; on the card a bf16 GEMM
with an f32 result), adds the bias and applies
the activation in f32, and casts the result to the input's dtype; an f32
input against bf16 weights computes in f32. A bf16 Conv2D keeps its output
in bf16 before the bias, as the JAX layer does
(``preferred_element_type=None``). For f32 operands every cast is the
identity, and an f32 convolution runs without TF32 on the card, and
every convolution with cuDNN's deterministic algorithms
(:class:`_ConvNoTF32`), whatever the global flags say.

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

import contextlib
import math
from typing import Callable, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.func import functional_call


class _Functional(nn.Module):
    """``init``/``apply`` over a parameter dict, shared by all networks."""

    recurrent = False

    def init(self, generator: Optional[torch.Generator] = None,
             dtype: torch.dtype = torch.float32) -> Dict[str, torch.Tensor]:
        """Re-initialise every parameter in place from ``generator``, in
        ``dtype`` (the draws are those of f32, rounded), and return the
        parameter dict (views of the module's parameters)."""
        self.to(dtype)
        for m in self.modules():
            if isinstance(m, (Dense, Conv2D, LSTM, GRU)):
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


def _glorot_(w: torch.Tensor, generator, fan_in: Optional[int] = None,
             fan_out: Optional[int] = None) -> None:
    fan_in = w.shape[0] if fan_in is None else fan_in
    fan_out = w.shape[1] if fan_out is None else fan_out
    limit = math.sqrt(6.0 / (fan_in + fan_out))
    u = torch.rand(w.shape, generator=generator, device=w.device)
    w.copy_(u * (2 * limit) - limit)


class _DotBF16(torch.autograd.Function):
    """``x @ w`` of bf16 operands with an f32 result on the card: one
    tensor-core GEMM (cuBLAS, ``torch.mm(..., out_dtype=float32)``) with
    f32 accumulation, the products exact. The backward takes the f32
    cotangent as it comes, promoting the other operand, and gives each
    gradient in its operand's dtype, as ``x.float() @ w.float()`` would."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        x2 = x.reshape(-1, x.shape[-1])
        return torch.mm(x2, w, out_dtype=torch.float32).reshape(
            x.shape[:-1] + (w.shape[1],))

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        g2 = g.reshape(-1, g.shape[-1])
        gx = gw = None
        if ctx.needs_input_grad[0]:
            gx = (g2 @ w.float().t()).to(x.dtype).reshape(x.shape)
        if ctx.needs_input_grad[1]:
            gw = (x.reshape(-1, x.shape[-1]).float().t() @ g2).to(w.dtype)
        return gx, gw


def dot_f32(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in f32 over any leading axes, as ``jnp.dot(x, w,
    preferred_element_type=float32)``. Two bf16 operands on the card take
    :class:`_DotBF16`; otherwise the operands are promoted to f32 (a bf16
    product is exact there, so the sums are the same) and f32 operands are
    used as they are (TF32 off by PyTorch's default)."""
    if x.is_cuda and x.dtype == w.dtype == torch.bfloat16:
        return _DotBF16.apply(x, w)
    return x.float() @ w.float()


class Dense(_Functional):
    """Affine layer with an optional activation (``torch.tanh``,
    ``torch.relu`` or any elementwise callable)."""

    def __init__(self, in_dim: int, out_dim: int,
                 activation: Optional[Callable] = None, use_bias: bool = True,
                 device=None, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dim, self.out_dim = int(in_dim), int(out_dim)
        self.activation = activation
        self.use_bias = use_bias
        kw = dict(device=device, dtype=dtype)
        self.w = nn.Parameter(torch.empty(self.in_dim, self.out_dim, **kw))
        self.b = (nn.Parameter(torch.zeros(self.out_dim, **kw))
                  if use_bias else None)
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform ``w`` and zero ``b``, as the JAX ``Dense.init``."""
        with torch.no_grad():
            _glorot_(self.w, generator)
            if self.b is not None:
                self.b.zero_()

    def forward(self, x):
        y = dot_f32(x, self.w)  # also over leading [T, B] axes
        if self.b is not None:
            y = y + self.b.float()
        if self.activation is not None:
            y = self.activation(y)
        return y.to(x.dtype)


class Flatten(_Functional):
    """Flatten all but the leading batch axis (NHWC order after a Conv2D,
    as the JAX layer flattens, so a Dense layer after the convolutions
    takes JAX's weights unchanged)."""

    def forward(self, x):
        return x.reshape(x.shape[0], -1)


class Activation(_Functional):
    """Standalone elementwise activation layer."""

    def __init__(self, fn: Callable):
        super().__init__()
        self.fn = fn

    def forward(self, x):
        return self.fn(x)


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """lax's ``"SAME"`` padding of one spatial axis, (low, high): the
    output has ``ceil(n / s)`` positions and the odd pad goes high, e.g.
    (0, 1) at n = 20, k = 3, s = 2."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


@contextlib.contextmanager
def _cudnn_exact():
    """cuDNN without TF32 and with deterministic algorithms only."""
    cudnn = torch.backends.cudnn
    prev = cudnn.allow_tf32, cudnn.deterministic
    cudnn.allow_tf32, cudnn.deterministic = False, True
    try:
        yield
    finally:
        cudnn.allow_tf32, cudnn.deterministic = prev


class _ConvNoTF32(torch.autograd.Function):
    """``conv2d`` of NCHW ``x`` and OIHW ``w`` (cuDNN on the card), in the
    operands' dtype, whose forward and backward both run with cuDNN's TF32
    off and its deterministic algorithms only (the backward runs outside
    the forward's context): an f32 convolution stays f32 whatever the
    global flag says, and every run gives the same bits, as XLA's
    convolutions do (an f32 weight gradient at batch 1024 otherwise takes
    an algorithm whose sums vary from run to run, which the CUDA graph's
    replay check of ``learner/segment.py`` refuses)."""

    @staticmethod
    def forward(ctx, x, w, stride, padding):
        ctx.save_for_backward(x, w)
        ctx.conf = (stride, padding)
        with _cudnn_exact():
            return F.conv2d(x, w, None, stride, padding)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        stride, padding = ctx.conf
        with _cudnn_exact():
            gx, gw, _ = torch.ops.aten.convolution_backward(
                g, x, w, None, list(stride), list(padding), [1, 1], False,
                [0, 0], 1, [ctx.needs_input_grad[0], ctx.needs_input_grad[1],
                            False])
        return gx, gw, None, None


class Conv2D(_Functional):
    """2-D convolution over NHWC inputs, lax.conv semantics: ``w [kh, kw,
    in, out]`` (HWIO, permuted to OIHW at the call), ``stride``,
    ``padding`` ``"SAME"`` (lax's, asymmetric when the total is odd: the
    input is padded with ``F.pad``) or ``"VALID"``. The weight takes the
    input's dtype; a bf16 input keeps a bf16 output, then the bias and the
    activation in f32 and the result in the input's dtype."""

    def __init__(self, in_channels: int, out_channels: int,
                 kernel=(3, 3), stride=(1, 1), padding: str = "SAME",
                 activation: Optional[Callable] = None, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        if padding not in ("SAME", "VALID"):
            raise ValueError(f"padding must be 'SAME' or 'VALID', got "
                             f"{padding!r}")
        self.in_channels, self.out_channels = int(in_channels), \
            int(out_channels)
        self.kernel = tuple(int(k) for k in kernel)
        self.stride = tuple(int(s) for s in stride)
        self.padding = padding
        self.activation = activation
        kw = dict(device=device, dtype=dtype)
        self.w = nn.Parameter(torch.empty(*self.kernel, self.in_channels,
                                          self.out_channels, **kw))
        self.b = nn.Parameter(torch.zeros(self.out_channels, **kw))
        self.reset_parameters()

    def reset_parameters(self, generator: Optional[torch.Generator] = None):
        """Glorot-uniform ``w`` over ``kh·kw·in`` / ``kh·kw·out`` and zero
        ``b``, as the JAX ``Conv2D.init``."""
        kh, kw = self.kernel
        with torch.no_grad():
            _glorot_(self.w, generator, kh * kw * self.in_channels,
                     kh * kw * self.out_channels)
            self.b.zero_()

    def forward(self, x):
        xc = x.permute(0, 3, 1, 2)                  # NCHW view of NHWC
        pad = (0, 0)
        if self.padding == "SAME":
            (h0, h1), (w0, w1) = (same_pads(n, k, s) for n, k, s in zip(
                x.shape[1:3], self.kernel, self.stride))
            if (h0, w0) == (h1, w1):
                pad = (h0, w0)
            else:
                xc = F.pad(xc, (w0, w1, h0, h1))
        y = _ConvNoTF32.apply(xc, self.w.to(x.dtype).permute(3, 2, 0, 1),
                              self.stride, pad).permute(0, 2, 3, 1)
        y = y.float() + self.b.float()
        if self.activation is not None:
            y = self.activation(y)
        return y.to(x.dtype)


def lstm_cell(xi, h, c, wh, b):
    """One LSTM step (gates i,f,g,o) from the input projection ``xi = x @
    wi``; returns ``(h', c')``. The gates are f32 and ``h'``, ``c'`` take
    ``h``'s dtype, as the JAX cell."""
    i, f, g, o = (xi.float() + dot_f32(h, wh) + b.float()).chunk(4, dim=-1)
    c = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h2 = torch.sigmoid(o) * torch.tanh(c)
    return h2.to(h.dtype), c.to(h.dtype)


def gru_cell(xi, h, wh, b):
    """One GRU step (gates r,z,n) from the input projection ``xi = x @
    wi``; returns ``h'`` in ``h``'s dtype, the gates in f32, as the JAX
    cell."""
    H = h.shape[-1]
    xi, hh, b = xi.float(), dot_f32(h, wh), b.float()
    r = torch.sigmoid(xi[..., :H] + hh[..., :H] + b[:H])
    z = torch.sigmoid(xi[..., H:2 * H] + hh[..., H:2 * H] + b[H:2 * H])
    n = torch.tanh(xi[..., 2 * H:] + r * hh[..., 2 * H:] + b[2 * H:])
    return ((1.0 - z) * n + z * h.float()).to(h.dtype)


class _Cell(_Functional):
    """A recurrent cell with ``n_gates`` gates: ``wi [in, gH]``, ``wh [H,
    gH]``, ``b [gH]``. ``forward(x, state)`` steps once; with ``sequence``
    it unrolls ``xs [T, B, in]`` with the input projection ``xs @ wi`` taken
    for all steps at once."""

    recurrent = True
    n_gates = 0

    def __init__(self, in_dim: int, hidden: int, device=None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.in_dim, self.hidden = int(in_dim), int(hidden)
        g = self.n_gates * self.hidden
        kw = dict(device=device, dtype=dtype)
        self.wi = nn.Parameter(torch.empty(self.in_dim, g, **kw))
        self.wh = nn.Parameter(torch.empty(self.hidden, g, **kw))
        self.b = nn.Parameter(torch.zeros(g, **kw))
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
            return self._cell(dot_f32(x, self.wi), state)
        T, B = x.shape[0], x.shape[1]
        xi_all = dot_f32(x.reshape(T * B, -1), self.wi).reshape(T, B, -1)
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
            elif sequence and isinstance(layer, Conv2D):
                T, B = x.shape[0], x.shape[1]
                x = layer(x.reshape((T * B,) + x.shape[2:]))
                x = x.reshape((T, B) + x.shape[1:])
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
