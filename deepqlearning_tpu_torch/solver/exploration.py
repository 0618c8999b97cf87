"""Exploration strategies (``deepqlearning_tpu.solver.exploration``).

Schedules map an aggregate step count ``t`` (a Python int) to ε, computed
in float32 as the JAX package does, so both packages compare their uniforms
against the same ε. A vectorized strategy's ``select(q [E, A], t,
generator) -> (actions [E], eps)`` takes a ``torch.Generator`` where the JAX
protocol takes a key.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

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


@dataclasses.dataclass(frozen=True)
class EpsGreedyPolicy:
    """ε-greedy exploration with a schedule; the solver's default strategy.

    The solver hands this policy to ``build_loop`` as its schedule alone
    (``eps``, no ``select_fn``), so the collect kernels K4/K6 take it
    wherever ``collect_plan_for`` accepts the env and the network; ``select``
    is the same strategy for the plain keyed collect step."""

    schedule: LinearDecaySchedule = LinearDecaySchedule()

    def eps(self, t) -> float:
        return self.schedule(t)

    def select(self, q, t, generator):
        """``(q [E, A], t, generator) -> (actions [E], eps)``."""
        return epsilon_greedy_select(self.schedule)(q, t, generator)

    def loginfo(self, t):
        return {"eps": float(self.schedule(t))}


@dataclasses.dataclass(frozen=True)
class VectorizedStrategy:
    """User-defined exploration strategy for the vectorized path:
    ``fn(q [E, A], t, generator) -> (actions [E], eps)``, the counterpart
    of the host path's ``f(policy, env, obs, t, rng) -> (action, eps)``.
    ``schedule`` optionally gives ε(t) for the log; without one ε logs as
    0."""

    fn: Callable
    schedule: Optional[Callable] = None

    def select(self, q, t, generator):
        return self.fn(q, t, generator)

    def eps(self, t) -> float:
        if self.schedule is not None:
            return self.schedule(t)
        return 0.0

    def loginfo(self, t):
        return {"eps": float(self.eps(t))}


def eps_schedule(strategy):
    """ε(t) of a schedule-based strategy: its ``eps`` method, or the
    strategy itself when it is a schedule; None for anything else (a
    function-valued strategy). ``ConstantEpsilon.eps`` is a float field,
    so the schedule test comes after the method test."""
    if callable(getattr(strategy, "eps", None)):
        return strategy.eps
    if isinstance(strategy, (LinearDecaySchedule, ConstantEpsilon)):
        return strategy
    return None


def exploration(f, policy, env, obs, global_step, rng):
    """Dispatch through a function-valued strategy ``f(policy, env, obs,
    global_step, rng) -> (action, eps)``; the ``HostEnv`` path calls bare
    callables this way, the vectorized path refuses them."""
    return f(policy, env, obs, global_step, rng)


def linear_epsilon_greedy(max_steps: int, eps_fraction: float,
                          eps_end: float) -> EpsGreedyPolicy:
    """Linear decay from 1 to ``eps_end`` over ``eps_fraction *
    max_steps`` steps."""
    return EpsGreedyPolicy(
        LinearDecaySchedule(start=1.0, stop=eps_end,
                            steps=max(1, int(eps_fraction * max_steps))))
