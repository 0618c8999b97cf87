"""Tiger POMDP, batched (``deepqlearning_tpu.envs.tiger``).

The tiger is behind the left or the right door; the actions are open-left,
open-right and listen. Listening costs ``r_listen`` and hears the tiger's
side correctly with probability ``p_correct``; opening the tiger's door
gives ``r_findtiger``, the other ``r_escapetiger``, and ends the episode.
The agent observes only the last listen outcome, a length-1 float vector (1
= heard left).

The batched state is an ``[E, 3]`` f32 block ``(tiger_left, last_obs,
opened)``. Uniforms come in rows as in SimpleGridWorld's cols protocol:
``reset_cols`` reads one (the tiger's side, left when ``u < 0.5``) and
``step_cols`` one (the listen is correct when ``u < p_correct``), so a test
can inject the outcomes of the JAX package's Bernoulli draws.
A per-instance state (``reset``, ``step``, ``observe``) is one row of the
batched state.
"""
from __future__ import annotations

import torch

from .base import Env, batch_of_one, first_row


class TigerPOMDP(Env):
    n_uniform_step = 1
    n_uniform_reset = 1

    def __init__(self, r_listen: float = -1.0, r_findtiger: float = -100.0,
                 r_escapetiger: float = 10.0, p_correct: float = 0.85,
                 discount: float = 0.95):
        self.r_listen = float(r_listen)
        self.r_findtiger = float(r_findtiger)
        self.r_escapetiger = float(r_escapetiger)
        self.p_correct = float(p_correct)
        self.discount = float(discount)
        self.num_actions = 3
        self.obs_shape = (1,)

    @property
    def action_map(self):
        return ["open-left", "open-right", "listen"]

    def observe_batch(self, state: torch.Tensor) -> torch.Tensor:
        return state[:, 1:2].clone()

    def reset_cols(self, u: torch.Tensor):
        """``u [>=1, E]`` -> ``(state [E, 3], obs [E, 1])``."""
        left = (u[0] < 0.5).float()
        state = torch.stack([left, torch.zeros_like(left),
                             torch.zeros_like(left)], dim=1)
        return state, self.observe_batch(state)

    def step_cols(self, state: torch.Tensor, action: torch.Tensor,
                  u: torch.Tensor):
        """``state [E, 3]``, ``action [E]``, ``u [>=1, E]`` -> ``(state',
        obs [E, 1], reward [E], done [E])``."""
        left = state[:, 0] > 0.5
        is_listen = action == 2
        correct = u[0] < self.p_correct
        heard_left = torch.where(correct, left, ~left)
        new_obs = torch.where(is_listen, heard_left.float(), state[:, 1])
        tiger_behind = torch.where(action == 0, left, ~left)
        r = torch.where(
            is_listen, self.r_listen,
            torch.where(tiger_behind, self.r_findtiger,
                        self.r_escapetiger)).float()
        done = (~is_listen).float()
        new_state = torch.stack([state[:, 0], new_obs, done], dim=1)
        return new_state, self.observe_batch(new_state), r, done

    def reset_batch(self, num: int, generator: torch.Generator):
        u = torch.rand(self.n_uniform_reset, num, generator=generator,
                       device=generator.device)
        return self.reset_cols(u)

    def step_batch(self, state, action, generator: torch.Generator):
        u = torch.rand(self.n_uniform_step, state.shape[0],
                       generator=generator, device=state.device)
        return self.step_cols(state, action, u)

    # --- one instance (the JAX package's protocol): the batched code at
    # one row
    def reset(self, generator: torch.Generator):
        return first_row(self.reset_batch(1, generator))

    def step(self, state, action, generator: torch.Generator):
        state, action = batch_of_one(state, action)
        return first_row(self.step_batch(state, action, generator))

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        return first_row(self.observe_batch(batch_of_one(state)))
