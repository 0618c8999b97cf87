"""MDP/POMDP problem adapters (``deepqlearning_tpu.envs.adapters``).

A problem is a small object of functions, and ``MDPEnv`` / ``POMDPEnv``
adapt it onto the batched ``Env`` protocol, so ``solve`` accepts it as it
accepts any env. In the port the functions are batched: every state,
action and observation carries a leading batch axis ``[E, ...]``, and
randomness comes from a ``torch.Generator`` (make tensors on
``generator.device``).

A FunctionalMDP provides
  * ``initial_state(num, generator) -> state`` (a tensor, or a tuple of them)
  * ``gen(state, action, generator) -> next_state``
  * ``reward(state, action, next_state) -> [E]``
  * ``isterminal(state) -> [E]`` (bool)
  * ``convert_s(state) -> [E, *obs_shape]`` float
  * ``num_actions``, ``discount``; optionally ``action_map``.

A FunctionalPOMDP also provides
  * ``observation(state, action, next_state, generator) -> obs``
  * ``convert_o(obs) -> [E, *obs_shape]`` float; optionally
    ``initial_obs(state)``
and the env observes ``convert_o(obs)`` instead of the state.
"""
from __future__ import annotations

import torch

from .base import Env


def check_requirements(problem, pomdp: bool = False):
    """Raise ``TypeError`` listing what the problem lacks of the interface
    ``solve`` needs."""
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


def _probe():
    return torch.Generator().manual_seed(0)


class _ProblemEnv(Env):
    def __init__(self, problem):
        self.problem = problem
        self.num_actions = int(problem.num_actions)
        self.discount = float(problem.discount)

    @property
    def action_map(self):
        if hasattr(self.problem, "action_map"):
            return list(self.problem.action_map)
        return list(range(self.num_actions))

    def _outcome(self, s, action, sp):
        r = torch.as_tensor(self.problem.reward(s, action, sp)).float()
        done = torch.as_tensor(self.problem.isterminal(sp)).float()
        return r, done


class MDPEnv(_ProblemEnv):
    """Adapter: FunctionalMDP problem → batched Env."""

    def __init__(self, problem):
        super().__init__(problem)
        s0 = problem.initial_state(1, _probe())
        self.obs_shape = tuple(self.observe(s0).shape[1:])

    def observe(self, state):
        return torch.as_tensor(self.problem.convert_s(state)).float()

    def reset_batch(self, num: int, generator: torch.Generator):
        state = self.problem.initial_state(num, generator)
        return state, self.observe(state)

    def step_batch(self, state, action, generator: torch.Generator):
        sp = self.problem.gen(state, action, generator)
        r, done = self._outcome(state, action, sp)
        return sp, self.observe(sp), r, done


class POMDPEnv(_ProblemEnv):
    """Adapter: FunctionalPOMDP problem → batched Env. The env state is
    ``(hidden_state, obs)``; the agent sees only ``convert_o`` of the
    sampled observation."""

    def __init__(self, problem):
        super().__init__(problem)
        _, obs = self.reset_batch(1, _probe())
        self.obs_shape = tuple(obs.shape[1:])

    def _convert(self, o):
        return torch.as_tensor(self.problem.convert_o(o)).float()

    def observe(self, state):
        return state[1]

    def reset_batch(self, num: int, generator: torch.Generator):
        s = self.problem.initial_state(num, generator)
        if hasattr(self.problem, "initial_obs"):
            o = self.problem.initial_obs(s)
        else:
            a0 = torch.zeros(num, dtype=torch.long, device=generator.device)
            o = self.problem.observation(s, a0, s, generator)
        obs = self._convert(o)
        return (s, obs), obs

    def step_batch(self, state, action, generator: torch.Generator):
        s, _ = state
        sp = self.problem.gen(s, action, generator)
        obs = self._convert(self.problem.observation(s, action, sp,
                                                     generator))
        r, done = self._outcome(s, action, sp)
        return (sp, obs), obs, r, done
