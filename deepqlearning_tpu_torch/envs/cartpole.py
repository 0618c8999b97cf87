"""CartPole (Barto-Sutton-Anderson, Gym's CartPole-v1 constants), batched.

Counterpart of ``deepqlearning_tpu.envs.cartpole``: push the cart left or
right; the episode ends when the pole leans past ±12° or the cart leaves
±2.4; reward 1 per step. The dynamics are those of the JAX ``step_cols`` /
``reset_cols``, op for op.

The batched state is an ``[E, 4]`` f32 block in the JAX cols order
``(x, x_dot, theta, theta_dot)``; the observation is the state. The step
draws no uniforms; the reset draws four (``u * 0.1 - 0.05`` each). The
collect kernel (``ops/cuda/fused_collect.py``) runs the same dynamics on
the card and reads the physics constants from this object.
A per-instance state (``reset``, ``step``, ``observe``) is one row of the
batched state.
"""
from __future__ import annotations

import math

import torch

from .base import Env, batch_of_one, first_row


def div_exact(a: torch.Tensor, c: float) -> torch.Tensor:
    """``a / c`` rounded once, as the JAX package divides: a CUDA tensor
    divided by a Python scalar is multiplied by the scalar's reciprocal
    instead, which can round differently."""
    return a / torch.full_like(a, c)


class CartPole(Env):
    lane_state_width = 4  # [x, x_dot, theta, theta_dot]
    n_uniform_step = 0
    n_uniform_reset = 4

    def __init__(self, discount: float = 0.99):
        self.discount = float(discount)
        self.num_actions = 2
        self.obs_shape = (4,)
        self.gravity = 9.8
        self.masscart = 1.0
        self.masspole = 0.1
        self.length = 0.5  # half pole length
        self.force_mag = 10.0
        self.tau = 0.02
        self.theta_threshold = 12 * 2 * math.pi / 360
        self.x_threshold = 2.4

    @property
    def action_map(self):
        return ["left", "right"]

    def step_cols(self, state: torch.Tensor, action: torch.Tensor,
                  u: torch.Tensor = None):
        """``state [E, 4]``, ``action [E]`` (float or int); ``u`` unused ->
        ``(state' [E, 4], obs [E, 4], reward [E], done [E])``."""
        x, x_dot, theta, theta_dot = state.float().unbind(1)
        force = torch.where(action.float() == 1.0, self.force_mag,
                            -self.force_mag)
        costh = torch.cos(theta)
        sinth = torch.sin(theta)
        total_mass = self.masscart + self.masspole
        polemass_length = self.masspole * self.length
        temp = div_exact(force + polemass_length * theta_dot ** 2 * sinth,
                         total_mass)
        theta_acc = (self.gravity * sinth - costh * temp) / (
            self.length * (4.0 / 3.0 - div_exact(
                self.masspole * costh ** 2, total_mass)))
        x_acc = temp - div_exact(polemass_length * theta_acc * costh,
                                 total_mass)
        nx = x + self.tau * x_dot
        nx_dot = x_dot + self.tau * x_acc
        nth = theta + self.tau * theta_dot
        nth_dot = theta_dot + self.tau * theta_acc
        done = ((torch.abs(nx) > self.x_threshold)
                | (torch.abs(nth) > self.theta_threshold)).float()
        new = torch.stack([nx, nx_dot, nth, nth_dot], dim=1)
        return new, self.observe_batch(new), torch.ones_like(done), done

    def reset_cols(self, u: torch.Tensor):
        """``u [>=4, E]`` -> ``(state [E, 4], obs [E, 4])``."""
        state = (u[0:4] * 0.1 - 0.05).t().contiguous()
        return state, self.observe_batch(state)

    def observe_batch(self, state: torch.Tensor) -> torch.Tensor:
        """``state [E, 4]`` -> ``obs [E, 4]``: the state itself."""
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
