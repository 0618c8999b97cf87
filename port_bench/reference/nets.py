"""Plain dueling Q-networks, written from a configuration's network spec.

A spec (``configs/<name>.json``, key ``net``) lists the network's layers,
each ``[kind, *args]``; a kind's plain forward, output shape,
multiply-adds and parameter count come from ``layers/<kind>.py``. The
dueling split is the measured program's: the trailing run of Dense layers
is the advantage head, a copy with its last layer ``Dense(n, 1)`` the value
head, the layers before it the shared base; ``Q = V + A - mean_a A``.
Parameters are a dict keyed as the program keys its own
(``base.layers.<i>.w``, ``val.layers.<j>.b``, ...), so a snapshot of the
program's state can be read. A recurrent layer kind (``RECURRENT``, such as
``layers/LSTM.py``) steps a state of its own, which the base carries: a
list with one entry per base layer, None for a stateless one.

Precision follows the configuration: parameters and activations in its
dtype (f32 or bf16); every product is taken in f32 on f32 copies of the
operands with TF32 off (the layer files say where each rounds).
``Precision`` chooses a lower precision for the control: ``"tf32"`` lets
cuBLAS and cuDNN take TF32, ``"fp8"`` rounds both operands of every
product to e4m3 with a per-tensor scale.
"""
from __future__ import annotations

import contextlib

import torch


class Precision:
    """How the operands of each product are taken: ``"exact"`` (f32, TF32
    off), ``"tf32"`` or ``"fp8"`` (module docstring)."""

    def __init__(self, kind: str = "exact"):
        if kind not in ("exact", "tf32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    @contextlib.contextmanager
    def flags(self):
        m, c = torch.backends.cuda.matmul, torch.backends.cudnn
        prev = m.allow_tf32, c.allow_tf32, c.deterministic
        m.allow_tf32 = c.allow_tf32 = self.kind == "tf32"
        c.deterministic = True
        try:
            yield
        finally:
            m.allow_tf32, c.allow_tf32, c.deterministic = prev

    def operand(self, x: torch.Tensor) -> torch.Tensor:
        """``x`` as an f32 operand (straight through for the gradient)."""
        x = x.float()
        if self.kind != "fp8":
            return x
        scale = 448.0 / x.detach().abs().amax().clamp(min=1e-30)
        r = (x.detach() * scale).to(torch.float8_e4m3fn).float() / scale
        return x + (r - x.detach())


class Net:
    """The dueling network of ``spec`` over observations of ``obs_shape``;
    ``parts.layer(kind)`` gives a layer kind's file. ``streams`` maps
    ``base``, ``val`` and ``adv`` to their layers, each ``(module, args,
    prefix, input shape)``."""

    def __init__(self, spec, parts, obs_shape):
        layers = [(parts.layer(l[0]), list(l[1:])) for l in spec["layers"]]
        split = len(layers)
        while split > 0 and layers[split - 1][0].DENSE:
            split -= 1
        if split == len(layers):
            raise ValueError("the network has no trailing Dense run to split")
        adv = layers[split:]
        val = adv[:-1] + [(adv[-1][0], adv[-1][0].value_head(adv[-1][1]))]
        self.streams, shape = {}, tuple(obs_shape)
        for name, ls in (("base", layers[:split]), ("val", val),
                         ("adv", adv)):
            s, out = shape, []
            for i, (mod, args) in enumerate(ls):
                out.append((mod, args, f"{name}.layers.{i}", s))
                s = mod.out_shape(s, args)
            self.streams[name] = out
            if name == "base":
                shape = s
        self.num_actions = adv[-1][1][1]
        self.recurrent = any(getattr(m, "RECURRENT", False)
                             for m, _a, _p, _s in self.streams["base"])

    def macs(self):
        """Multiply-adds per sample of each layer with parameters:
        ``(base, val, adv)``."""
        return tuple([m.macs(s, a) for m, a, _p, s in self.streams[k]
                      if m.PARAMS] for k in ("base", "val", "adv"))

    def first_macs(self) -> int:
        """Multiply-adds per sample of the layers that read the observation:
        the base's first layer with parameters, or both heads' first where
        the base has none (of a layer whose file gives ``obs_macs``, such as
        a cell, only its product with that input)."""
        base, val, adv = ([(m, a, s) for m, a, _p, s in self.streams[k]
                           if m.PARAMS] for k in ("base", "val", "adv"))
        macs = lambda m, a, s: getattr(m, "obs_macs", m.macs)(s, a)
        return macs(*base[0]) if base else macs(*val[0]) + macs(*adv[0])

    def n_params(self) -> int:
        return sum(m.n_params(a) for ls in self.streams.values()
                   for m, a, _p, _s in ls)

    def fused_collect(self) -> bool:
        """Whether the port's fused collect (K4, or K6 for a base that is
        one recurrent cell) runs every layer."""
        ok = all(m.fused_collect(a) for ls in self.streams.values()
                 for m, a, _p, _s in ls)
        cells = [getattr(m, "RECURRENT", False)
                 for m, _a, _p, _s in self.streams["base"] if m.PARAMS]
        return ok and (not self.recurrent or cells == [True])

    def init_state(self, n: int, dtype, device) -> list:
        """The base's state of ``n`` rows at an episode's start."""
        return [m.init_state(n, a, dtype, device)
                if getattr(m, "RECURRENT", False) else None
                for m, a, _p, _s in self.streams["base"]]

    def q(self, params, obs, prec: Precision = Precision(), state=None):
        """``(Q [N, A], scale [N])`` in the configuration's dtype of
        observations ``obs [N, *obs_shape]``; ``scale`` is the largest
        magnitude among a row's V, A and Q in f32, the size its roundings
        are taken at. A recurrent network steps from ``state``
        (``init_state``'s form) and returns its next state last."""
        new = []
        with prec.flags():
            x = obs
            for k, (mod, args, prefix, _s) in enumerate(
                    self.streams["base"]):
                if getattr(mod, "RECURRENT", False):
                    x, s = mod.step(x, state[k], params, prefix, args, prec)
                    new.append(s)
                else:
                    x = mod.forward(x, params, prefix, args, prec)
                    new.append(None)
            outs = []
            for k in ("val", "adv"):
                h = x
                for mod, args, prefix, _s in self.streams[k]:
                    h = mod.forward(h, params, prefix, args, prec)
                outs.append(h)
        v, a = outs
        q = v + a - a.mean(dim=-1, keepdim=True)
        scale = torch.cat([v.float().abs(), a.float().abs(),
                           q.float().abs()], dim=1).amax(dim=1)
        return (q, scale) if state is None else (q, scale, new)

    def unroll(self, params, xs, prec: Precision = Precision()):
        """``(Q [N, T, A], scale [N, T])`` of windows ``xs [N, T,
        *obs_shape]``, stepped from a zero state."""
        state = self.init_state(xs.shape[0], xs.dtype, xs.device)
        qs, scales = [], []
        for t in range(xs.shape[1]):
            q, scale, state = self.q(params, xs[:, t], prec, state)
            qs.append(q)
            scales.append(scale)
        return torch.stack(qs, dim=1), torch.stack(scales, dim=1)
