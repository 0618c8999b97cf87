"""TestMDP (DeepQLearning.jl's ``test/test_env.jl``), on both sides of the
check.

The last 4 rooms visited and a time index; action ``a < 3`` moves to room
``a``, action 3 stays; reward ``[-0.1, 0, 0.1][room]``, times -10 after
room 1; the episode ends at ``max_time``; the observation stacks the
rooms' images (``shape``, seeded by ``img_seed``), most recent first, on
the last axis. State ``[E, 5]`` int32. No draws.
"""
import numpy as np
import torch

STATE_WIDTH = 5
STEP_UNIFORMS = 0
RESET_UNIFORMS = 0
FUSED_COLLECT = False


def program(spec):
    """The port's env."""
    from deepqlearning_tpu_torch import TestMDP

    return TestMDP(tuple(spec["shape"]), spec["o_stack"], spec["max_time"],
                   discount=spec["discount"], img_seed=spec["img_seed"])


class Reference:
    """The plain batched env: ``step(state, action, u)``, ``reset(u, n)``
    (``u`` unused: the env draws nothing)."""

    def __init__(self, spec, device):
        self.shape = tuple(spec["shape"])
        self.o_stack = int(spec["o_stack"])
        self.max_time = int(spec["max_time"])
        self.discount = float(spec["discount"])
        self.num_actions = 4
        self.obs_shape = self.shape + (self.o_stack,)
        self.device = device
        rng = np.random.RandomState(int(spec["img_seed"]))
        bad = rng.randint(1, 51, size=self.shape)
        normal = rng.randint(100, 151, size=self.shape)
        good = rng.randint(150, 201, size=self.shape)
        self.images = torch.from_numpy(
            np.stack([bad, normal, good]).astype(np.float32) / 255.0
        ).to(device)
        self.rewards = torch.tensor([-0.1, 0.0, 0.1], device=device)

    def observe(self, state):
        recent = state[:, 4 - self.o_stack:4].flip(1).long()
        return torch.movedim(self.images[recent], 1, -1)

    def step(self, state, action, u=None):
        hist, t = state[:, :4], state[:, 4]
        prev = hist[:, -1]
        new = torch.where(action.to(torch.int32) < 3,
                          action.to(torch.int32), prev)
        r = self.rewards[new.long()]
        r = torch.where(prev == 1, r * -10.0, r)
        ns = torch.cat([hist[:, 1:], new[:, None], (t + 1)[:, None]], dim=1)
        done = (t + 1 >= self.max_time).float()
        return ns, self.observe(ns), r, done

    def reset(self, u, n):
        state = torch.zeros(n, 5, dtype=torch.int32, device=self.device)
        state[:, 4] = 1
        return state, self.observe(state)
