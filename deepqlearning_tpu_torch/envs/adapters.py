"""MDP/POMDP problem adapters (``deepqlearning_tpu.envs.adapters``).

A problem is a small object of functions, and ``MDPEnv`` / ``POMDPEnv``
adapt it onto the ``Env`` protocol, so ``solve`` accepts it as it accepts
any env. Randomness comes from a ``torch.Generator`` (make tensors on
``generator.device``). The functions come in either of two forms, told apart
by the arity of ``initial_state``:

* one instance at a time, the JAX package's protocol with a generator where
  it takes a key (``initial_state(generator)``, one required parameter):
  the env's per-instance ``reset`` / ``step`` / ``observe`` call them, and
  the batched methods vmap those (``envs/base.py``);
* batched (``initial_state(num, generator)``, two): every state, action and
  observation carries a leading batch axis ``[E, ...]``; the per-instance
  methods are the batched ones at one row.

On the card ``solve`` captures the problem's functions of either form
(batched, or per-instance under ``torch.func.vmap``) into a CUDA graph and
replays it, so they must be pure device code that draws only from the
generator passed in, as ``envs/base.py`` states for envs: a Python counter
or a host random number in ``gen`` or ``observation`` would repeat its
value at capture on every replay, and makes the segment raise.

A FunctionalMDP provides
  * ``initial_state(generator) -> state`` (a tensor, or a pytree of them)
  * ``gen(state, action, generator) -> next_state``
  * ``reward(state, action, next_state) -> float``
  * ``isterminal(state) -> bool``
  * ``convert_s(state) -> float tensor`` (the network's input)
  * ``num_actions``, ``discount``; optionally ``action_map``.

A FunctionalPOMDP also provides
  * ``observation(state, action, next_state, generator) -> obs``
  * ``convert_o(obs) -> float tensor``; optionally ``initial_obs(state)``
and the env observes ``convert_o(obs)`` instead of the state.

The adapters cast the reward and the done flag to f32.
"""
from __future__ import annotations

import inspect

import torch

from .base import Env

_ARITY = ("initial_state takes one required positional parameter (the "
          "generator: a per-instance problem) or two (num, generator: a "
          "batched problem)")


def check_requirements(problem, pomdp: bool = False):
    """Raise ``TypeError`` listing what the problem lacks of the interface
    ``solve`` needs, or when ``initial_state`` has neither form's arity."""
    required = ["initial_state", "gen", "reward", "isterminal"]
    required.append("convert_o" if pomdp else "convert_s")
    if pomdp:
        required.append("observation")
    attrs = ["num_actions", "discount"]
    missing = [m for m in required if not callable(getattr(problem, m, None))]
    missing += [a for a in attrs if not hasattr(problem, a)]
    if missing:
        raise TypeError(
            f"{type(problem).__name__} does not satisfy the "
            f"{'POMDP' if pomdp else 'MDP'} interface; missing: "
            + ", ".join(missing))
    _batched(problem)


def _batched(problem) -> bool:
    """Whether ``problem`` is written batched (``initial_state(num,
    generator)``) rather than one instance at a time
    (``initial_state(generator)``); ``TypeError`` for any other arity."""
    params = inspect.signature(problem.initial_state).parameters.values()
    n = sum(p.kind in (p.POSITIONAL_ONLY, p.POSITIONAL_OR_KEYWORD)
            and p.default is p.empty for p in params)
    if n not in (1, 2):
        raise TypeError(f"{type(problem).__name__}: {_ARITY}; it takes {n}")
    return n == 2


def _probe():
    return torch.Generator().manual_seed(0)


def _f32(x) -> torch.Tensor:
    return torch.as_tensor(x).float()


class _ProblemEnv(Env):
    """``batched``: whether the problem is written batched (module
    docstring)."""

    def __init__(self, problem):
        self.problem = problem
        self.batched = _batched(problem)
        self.num_actions = int(problem.num_actions)
        self.discount = float(problem.discount)
        _, obs = self.reset(_probe())
        self.obs_shape = tuple(obs.shape)

    @property
    def action_map(self):
        if hasattr(self.problem, "action_map"):
            return list(self.problem.action_map)
        return list(range(self.num_actions))

    def _outcome(self, s, action, sp):
        return (_f32(self.problem.reward(s, action, sp)),
                _f32(self.problem.isterminal(sp)))

    # each method takes the problem's own form (``_reset``, ``_step``,
    # ``_observe`` of the subclass), or the base class's bridge to it: one
    # row of the batched form, or vmap over the per-instance one
    def observe(self, state):
        if self.batched:
            return super().observe(state)
        return self._observe(state)

    def reset_batch(self, num: int, generator: torch.Generator):
        if self.batched:
            return self._reset(generator, num)
        return super().reset_batch(num, generator)

    def step_batch(self, state, action, generator: torch.Generator):
        if self.batched:
            return self._step(state, action, generator)
        return super().step_batch(state, action, generator)

    def observe_batch(self, state):
        if self.batched:
            return self._observe(state)
        return super().observe_batch(state)


class MDPEnv(_ProblemEnv):
    """Adapter: FunctionalMDP problem → Env."""

    def _observe(self, state):
        return _f32(self.problem.convert_s(state))

    def _reset(self, generator, *num):
        state = self.problem.initial_state(*num, generator)
        return state, self._observe(state)

    def _step(self, state, action, generator):
        sp = self.problem.gen(state, action, generator)
        r, done = self._outcome(state, action, sp)
        return sp, self._observe(sp), r, done

    def reset(self, generator: torch.Generator):
        if self.batched:
            return super().reset(generator)
        return self._reset(generator)

    def step(self, state, action, generator: torch.Generator):
        if self.batched:
            return super().step(state, action, generator)
        return self._step(state, action, generator)


class POMDPEnv(_ProblemEnv):
    """Adapter: FunctionalPOMDP problem → Env. The env state is
    ``(hidden_state, obs)``; the agent sees only ``convert_o`` of the
    sampled observation."""

    def _observe(self, state):
        return state[1]

    def _reset(self, generator, *num):
        s = self.problem.initial_state(*num, generator)
        if hasattr(self.problem, "initial_obs"):
            o = self.problem.initial_obs(s)
        else:
            a0 = torch.zeros(*num, dtype=torch.long, device=generator.device)
            o = self.problem.observation(s, a0, s, generator)
        obs = _f32(self.problem.convert_o(o))
        return (s, obs), obs

    def _step(self, state, action, generator):
        s, _ = state
        sp = self.problem.gen(s, action, generator)
        o = self.problem.observation(s, action, sp, generator)
        obs = _f32(self.problem.convert_o(o))
        r, done = self._outcome(s, action, sp)
        return (sp, obs), obs, r, done

    def reset(self, generator: torch.Generator):
        if self.batched:
            return super().reset(generator)
        return self._reset(generator)

    def step(self, state, action, generator: torch.Generator):
        if self.batched:
            return super().step(state, action, generator)
        return self._step(state, action, generator)
