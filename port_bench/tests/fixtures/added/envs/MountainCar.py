"""MountainCar (Moore 1990; Gym's MountainCar-v0 constants), on both sides
of the check: an env kind that the benchmark's own folder does not hold,
added by a test as a file of its own.

State ``[E, 2]`` f32 ``(position, velocity)``, the observation the state;
actions push left, not at all, or right; reward -1 a step; the episode
ends at the goal. A step draws nothing, a reset one uniform (the position,
in [-0.6, -0.4]).
"""
import torch

STATE_WIDTH = 2
STEP_UNIFORMS = 0
RESET_UNIFORMS = 1
FUSED_COLLECT = True


def program(spec):
    from deepqlearning_tpu_torch.envs.mountain_car import MountainCar

    return MountainCar(discount=spec["discount"])


class Reference:
    def __init__(self, spec, device):
        self.discount = float(spec["discount"])
        self.num_actions = 3
        self.obs_shape = (2,)

    def step(self, state, action, u=None):
        pos, vel = state[:, 0], state[:, 1]
        vel = vel + (action.float() - 1.0) * 0.001 - torch.cos(
            3.0 * pos) * 0.0025
        vel = torch.clamp(vel, -0.07, 0.07)
        npos = torch.clamp(pos + vel, -1.2, 0.6)
        vel = torch.where((npos <= -1.2) & (vel < 0.0), 0.0, vel)
        new = torch.stack([npos, vel], dim=1)
        return new, new.clone(), torch.full_like(npos, -1.0), (
            npos >= 0.5).float()

    def reset(self, u, n):
        pos = -0.6 + u[0] * 0.2
        state = torch.stack([pos, torch.zeros_like(pos)], dim=1)
        return state, state.clone()
