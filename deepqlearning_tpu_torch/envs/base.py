"""Batched environment protocol.

Counterpart of ``deepqlearning_tpu.envs.base``. The JAX envs are pure
functions vmapped over keys; here an env steps a whole batch at once, and its
randomness comes from a ``torch.Generator`` (or from uniforms the caller
passes in):

    env.reset_batch(num, generator)              -> (state, obs)
    env.step_batch(state, action, generator)     -> (state, obs, reward, done)

``state`` is a tensor with a leading batch axis ``[E, ...]`` (or a tuple
of such tensors, as the problem adapters' states are), ``obs`` is
``[E, *obs_shape]`` f32, ``action`` ``[E]`` int, ``reward``/``done`` ``[E]``
f32.
"""
from __future__ import annotations

from typing import Any, Sequence, Tuple

import torch


class Env:
    """Base class for batched environments.

    Subclasses define ``num_actions``, ``obs_shape``, ``discount``,
    ``reset_batch`` and ``step_batch``."""

    num_actions: int
    obs_shape: Tuple[int, ...]
    discount: float = 1.0

    @property
    def action_map(self) -> Sequence[Any]:
        return list(range(self.num_actions))

    def reset_batch(self, num: int, generator: torch.Generator):
        raise NotImplementedError

    def step_batch(self, state, action, generator: torch.Generator):
        raise NotImplementedError


def auto_reset(env: Env, state, obs, done, truncate, generator):
    """Where an episode ended (done or truncated), replace (state, obs) with
    a fresh reset. Returns ``(state, obs, ended)``."""
    ended = torch.logical_or(done.bool(), truncate.bool())
    fresh_state, fresh_obs = env.reset_batch(done.shape[0], generator)

    def pick(a, b):
        if isinstance(a, tuple):
            return tuple(pick(x, y) for x, y in zip(a, b))
        return torch.where(ended.reshape((-1,) + (1,) * (a.dim() - 1)), a, b)

    return pick(fresh_state, state), pick(fresh_obs, obs), ended
