"""Feed-forward layer stack ("Chain") as ``nn.Module``s.

Counterpart of ``deepqlearning_tpu.models.chain`` for the feed-forward
layers (Dense, Flatten, Activation, Chain). Parameters keep the JAX
layout — ``w [din, dout]``, ``b [dout]`` — so weights move 1:1 between the
packages without a transpose.

The modules own their parameters (created on ``device``), and the learner
works functionally on a dict of tensors ``{name: tensor}`` keyed like
``named_parameters()``: ``init(generator)`` refills the module's parameters
from a seeded generator and returns that dict (sharing storage with the
module), and ``apply(params, x)`` runs the forward with any such dict
(``torch.func.functional_call``), e.g. the target network's.
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
            if isinstance(m, Dense):
                m.reset_parameters(generator)
        return params_of(self)

    def apply(self, params: Dict[str, torch.Tensor], x: torch.Tensor):
        """Forward with the given parameters; returns ``(q, state)`` with an
        empty state, as the JAX ``apply`` does for feed-forward nets."""
        return functional_call(self, params, (x,)), ()


def params_of(module: nn.Module) -> Dict[str, torch.Tensor]:
    """The module's parameters as a plain dict of detached tensors."""
    return {k: v.detach() for k, v in module.named_parameters()}


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
        limit = math.sqrt(6.0 / (self.in_dim + self.out_dim))
        with torch.no_grad():
            u = torch.rand(self.w.shape, generator=generator,
                           device=self.w.device)
            self.w.copy_(u * (2 * limit) - limit)
            if self.b is not None:
                self.b.zero_()

    def forward(self, x):
        y = x @ self.w
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


class Chain(_Functional):
    """Sequential container; an empty chain is the identity."""

    def __init__(self, *layers):
        super().__init__()
        if len(layers) == 1 and isinstance(layers[0], (tuple, list)):
            layers = tuple(layers[0])
        self.layers = nn.ModuleList(layers)

    def forward(self, x):
        for layer in self.layers:
            x = layer(x)
        return x

    @property
    def out_dim(self) -> Optional[int]:
        for layer in reversed(self.layers):
            if isinstance(layer, Dense):
                return layer.out_dim
        return None


def isrecurrent(network) -> bool:
    return bool(getattr(network, "recurrent", False))
