"""Acrobot (Sutton 1996, Gym's Acrobot-v1 constants and RK4 step), batched.

Counterpart of ``deepqlearning_tpu.envs.acrobot``: a two-link pendulum
with torque -1, 0 or +1 at the elbow; reward -1 per step until the tip
swings above one link length. The dynamics are the JAX ``_dsdt`` and
``step``, op for op; ``_wrap_pi`` is a floor modulo (``torch.remainder``).

The batched state is an ``[E, 4]`` f32 block ``(theta1, theta2, dtheta1,
dtheta2)``; the observation is ``(cos θ1, sin θ1, cos θ2, sin θ2, dθ1,
dθ2)``. The JAX env has no cols protocol, so the collect kernel does not
serve it: loops on Acrobot take the plain collect step.
A per-instance state (``reset``, ``step``, ``observe``) is one row of the
batched state.
"""
from __future__ import annotations

import math

import torch

from .base import Env, batch_of_one, first_row


def _wrap_pi(x: torch.Tensor) -> torch.Tensor:
    return torch.remainder(x + math.pi, 2.0 * math.pi) - math.pi


class Acrobot(Env):
    LINK_LENGTH_1 = 1.0
    LINK_MASS_1 = 1.0
    LINK_MASS_2 = 1.0
    LINK_COM_POS_1 = 0.5
    LINK_COM_POS_2 = 0.5
    LINK_MOI = 1.0
    MAX_VEL_1 = 4.0 * math.pi
    MAX_VEL_2 = 9.0 * math.pi
    G = 9.8
    DT = 0.2

    def __init__(self, discount: float = 0.99):
        self.discount = float(discount)
        self.num_actions = 3  # torque -1 / 0 / +1 at the elbow
        self.obs_shape = (6,)

    @property
    def action_map(self):
        return [-1.0, 0.0, 1.0]

    def observe_batch(self, state: torch.Tensor) -> torch.Tensor:
        t1, t2, d1, d2 = state.unbind(1)
        return torch.stack([torch.cos(t1), torch.sin(t1), torch.cos(t2),
                            torch.sin(t2), d1, d2], dim=1)

    def _dsdt(self, s, torque):
        m1, m2 = self.LINK_MASS_1, self.LINK_MASS_2
        l1 = self.LINK_LENGTH_1
        lc1, lc2 = self.LINK_COM_POS_1, self.LINK_COM_POS_2
        i1 = i2 = self.LINK_MOI
        g = self.G
        theta1, theta2, dtheta1, dtheta2 = s
        d1 = (m1 * lc1 ** 2
              + m2 * (l1 ** 2 + lc2 ** 2 + 2 * l1 * lc2 * torch.cos(theta2))
              + i1 + i2)
        d2 = m2 * (lc2 ** 2 + l1 * lc2 * torch.cos(theta2)) + i2
        phi2 = m2 * lc2 * g * torch.cos(theta1 + theta2 - math.pi / 2.0)
        phi1 = (-m2 * l1 * lc2 * dtheta2 ** 2 * torch.sin(theta2)
                - 2 * m2 * l1 * lc2 * dtheta2 * dtheta1 * torch.sin(theta2)
                + (m1 * lc1 + m2 * l1) * g * torch.cos(theta1 - math.pi / 2.0)
                + phi2)
        ddtheta2 = (torque + d2 / d1 * phi1
                    - m2 * l1 * lc2 * dtheta1 ** 2 * torch.sin(theta2)
                    - phi2) / (m2 * lc2 ** 2 + i2 - d2 ** 2 / d1)
        ddtheta1 = -(d2 * ddtheta2 + phi1) / d1
        return (dtheta1, dtheta2, ddtheta1, ddtheta2)

    def step_batch(self, state, action, generator: torch.Generator = None):
        """``state [E, 4]``, ``action [E]`` -> ``(state' [E, 4], obs [E, 6],
        reward [E], done [E])``: one RK4 step of length ``DT``."""
        torque = action.float() - 1.0
        s = state.float().unbind(1)
        add = lambda a, h, k: tuple(x + h * y for x, y in zip(a, k))
        k1 = self._dsdt(s, torque)
        k2 = self._dsdt(add(s, self.DT / 2.0, k1), torque)
        k3 = self._dsdt(add(s, self.DT / 2.0, k2), torque)
        k4 = self._dsdt(add(s, self.DT, k3), torque)
        ns = tuple(x + self.DT / 6.0 * (a + 2 * b + 2 * c + d)
                   for x, a, b, c, d in zip(s, k1, k2, k3, k4))
        new = torch.stack([
            _wrap_pi(ns[0]), _wrap_pi(ns[1]),
            torch.clamp(ns[2], -self.MAX_VEL_1, self.MAX_VEL_1),
            torch.clamp(ns[3], -self.MAX_VEL_2, self.MAX_VEL_2)], dim=1)
        t1, t2 = new[:, 0], new[:, 1]
        done = (-torch.cos(t1) - torch.cos(t2 + t1) > 1.0).float()
        return new, self.observe_batch(new), torch.full_like(done, -1.0), done

    def reset_batch(self, num: int, generator: torch.Generator):
        """Each angle and velocity uniform in [-0.1, 0.1)."""
        u = torch.rand(num, 4, generator=generator, device=generator.device)
        state = u * 0.2 - 0.1
        return state, self.observe_batch(state)

    # --- one instance (the JAX package's protocol): the batched code at
    # one row
    def reset(self, generator: torch.Generator):
        return first_row(self.reset_batch(1, generator))

    def step(self, state, action, generator: torch.Generator):
        state, action = batch_of_one(state, action)
        return first_row(self.step_batch(state, action, generator))

    def observe(self, state: torch.Tensor) -> torch.Tensor:
        return first_row(self.observe_batch(batch_of_one(state)))
