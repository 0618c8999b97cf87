"""Exploration strategies (``deepqlearning_tpu.solver.exploration``).

Schedules map an aggregate step count ``t`` (a Python int) to ε, computed
in float32 as the JAX package does, so both packages compare their uniforms
against the same ε.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class LinearDecaySchedule:
    """ε(t): linear from ``start`` to ``stop`` over ``steps`` steps, then
    flat."""

    start: float = 1.0
    stop: float = 0.01
    steps: int = 5000

    def __call__(self, t) -> float:
        f32 = np.float32
        frac = np.clip(f32(t) / f32(max(self.steps, 1)), f32(0.0), f32(1.0))
        return float(f32(self.start) - f32(self.start - self.stop) * frac)


@dataclasses.dataclass(frozen=True)
class ConstantEpsilon:
    eps: float = 0.01

    def __call__(self, t) -> float:
        return float(np.float32(self.eps))


def epsilon_greedy_select(eps_fn):
    """``select(q [E, A], t, generator) -> (actions [E] int64, eps)``: a
    uniform random action with probability ε(t), else the first-max greedy
    action."""

    def select(q, t, generator):
        E, A = q.shape
        eps = eps_fn(t)
        greedy = torch.argmax(q, dim=-1)
        rand = torch.randint(0, A, (E,), generator=generator,
                             device=q.device)
        explore = torch.rand(E, generator=generator, device=q.device) < eps
        return torch.where(explore, rand, greedy), eps

    return select
