"""TestMDP, the deterministic fixture with a known optimum, batched.

Counterpart of ``deepqlearning_tpu.envs.test_mdp`` (the reference's
``test/test_env.jl``): a history of the last 4 visited rooms (0/1/2), a
time index, 4 actions, horizon ``max_time``. Action ``a < 3`` moves to room
``a``; action 3 repeats the previous room. The reward is ``[-0.1, 0.0,
0.1][new_room]``, times -10 if the previous room was room 1. The
observation stacks the images of the last ``o_stack`` rooms, most recent
first, on the last axis, scaled by 1/255. Optimal value 2.1, optimal policy
``[1, 0, 1, 0, 2]``.

The batched state is an ``[E, 5]`` int32 block: the history, oldest first,
then the time index. The dynamics draw no randomness.
A per-instance state (``reset``, ``step``, ``observe``) is one row of the
batched state.
"""
from __future__ import annotations

import numpy as np
import torch

from .base import Env, batch_of_one, first_row

_HIST = 4  # the reference always keeps a history of 4


class TestMDP(Env):
    __test__ = False  # not a pytest class despite the reference-parity name

    def __init__(self, shape=(6,), o_stack=4, max_time=6, discount=0.99,
                 img_seed=0):
        self.shape = tuple(int(s) for s in shape)
        self.o_stack = int(o_stack)
        self.max_time = int(max_time)
        self.discount = float(discount)
        self.num_actions = 4
        self.obs_shape = self.shape + (self.o_stack,)
        rng = np.random.RandomState(img_seed)
        bad = rng.randint(1, 51, size=self.shape)
        normal = rng.randint(100, 151, size=self.shape)
        good = rng.randint(150, 201, size=self.shape)
        self._images = torch.from_numpy(
            np.stack([bad, normal, good]).astype(np.float32) / 255.0)
        self._rewards = torch.tensor([-0.1, 0.0, 0.1])

    def observe_batch(self, state: torch.Tensor) -> torch.Tensor:
        """``state [E, 5]`` -> ``obs [E, *shape, o_stack]``."""
        recent = state[:, _HIST - self.o_stack:_HIST].flip(1).long()
        frames = self._images.to(state.device)[recent]  # [E, o, *shape]
        return torch.movedim(frames, 1, -1)

    def reset_batch(self, num: int, generator: torch.Generator):
        state = torch.zeros(num, _HIST + 1, dtype=torch.int32,
                            device=generator.device)
        state[:, _HIST] = 1
        return state, self.observe_batch(state)

    def step_batch(self, state, action, generator: torch.Generator):
        hist, t = state[:, :_HIST], state[:, _HIST]
        prev = hist[:, -1]
        action = action.to(torch.int32)
        new = torch.where(action < 3, action, prev)
        t_new = t + 1
        r = self._rewards.to(state.device)[new.long()]
        r = torch.where(prev == 1, r * -10.0, r)
        new_state = torch.cat([hist[:, 1:], new[:, None], t_new[:, None]],
                              dim=1)
        done = (t_new >= self.max_time).float()
        return new_state, self.observe_batch(new_state), r, done

    # --- one instance (the JAX package's protocol): the batched code at
    # one row
    def reset(self, generator: torch.Generator):
        return first_row(self.reset_batch(1, generator))

    def step(self, state, action, generator: torch.Generator):
        state, action = batch_of_one(state, action)
        return first_row(self.step_batch(state, action, generator))

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        return first_row(self.observe_batch(batch_of_one(state)))
