"""MountainCar (Moore 1990, Gym's MountainCar-v0 constants), batched.

Counterpart of ``deepqlearning_tpu.envs.mountain_car``: an under-powered
car rocks out of a valley; actions push left, not at all, or right; reward
-1 per step; the episode ends at the goal position. The dynamics are those
of the JAX ``step_cols`` / ``reset_cols``, op for op.

The batched state is an ``[E, 2]`` f32 block in the JAX cols order
``(position, velocity)``; the observation is the state. The step draws no
uniforms; the reset draws one (the position, uniform in [-0.6, -0.4]). The
collect kernel (``ops/cuda/fused_collect.py``) runs the same dynamics on
the card and reads the physics constants from this object.
A per-instance state (``reset``, ``step``, ``observe``) is one row of the
batched state.
"""
from __future__ import annotations

import torch

from .base import Env, batch_of_one, first_row


class MountainCar(Env):
    lane_state_width = 2  # [position, velocity]
    n_uniform_step = 0
    n_uniform_reset = 1

    def __init__(self, discount: float = 0.99):
        self.discount = float(discount)
        self.num_actions = 3  # push left / no push / push right
        self.obs_shape = (2,)
        self.min_position = -1.2
        self.max_position = 0.6
        self.max_speed = 0.07
        self.goal_position = 0.5
        self.force = 0.001
        self.gravity = 0.0025

    @property
    def action_map(self):
        return ["left", "none", "right"]

    def step_cols(self, state: torch.Tensor, action: torch.Tensor,
                  u: torch.Tensor = None):
        """``state [E, 2]``, ``action [E]`` (float or int); ``u`` unused ->
        ``(state' [E, 2], obs [E, 2], reward [E], done [E])``."""
        pos, vel = state.float().unbind(1)
        vel = (vel + (action.float() - 1.0) * self.force
               - torch.cos(3.0 * pos) * self.gravity)
        vel = torch.clamp(vel, -self.max_speed, self.max_speed)
        npos = torch.clamp(pos + vel, self.min_position, self.max_position)
        vel = torch.where((npos <= self.min_position) & (vel < 0.0), 0.0, vel)
        done = (npos >= self.goal_position).float()
        new = torch.stack([npos, vel], dim=1)
        return new, self.observe_batch(new), torch.full_like(done, -1.0), done

    def reset_cols(self, u: torch.Tensor):
        """``u [>=1, E]`` -> ``(state [E, 2], obs [E, 2])``."""
        pos = -0.6 + u[0] * 0.2
        state = torch.stack([pos, torch.zeros_like(pos)], dim=1)
        return state, self.observe_batch(state)

    def observe_batch(self, state: torch.Tensor) -> torch.Tensor:
        """``state [E, 2]`` -> ``obs [E, 2]``: the state itself."""
        return state.clone()

    def reset_batch(self, num: int, generator: torch.Generator):
        u = torch.rand(self.n_uniform_reset, num, generator=generator,
                       device=generator.device)
        return self.reset_cols(u)

    def step_batch(self, state, action, generator: torch.Generator):
        return self.step_cols(state, action)

    # --- one instance (the JAX package's protocol): the batched code at
    # one row
    def reset(self, generator: torch.Generator):
        return first_row(self.reset_batch(1, generator))

    def step(self, state, action, generator: torch.Generator):
        state, action = batch_of_one(state, action)
        return first_row(self.step_batch(state, action, generator))

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        return first_row(self.observe_batch(batch_of_one(state)))
