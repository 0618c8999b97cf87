"""SimpleGridWorld (POMDPModels semantics), batched.

Counterpart of ``deepqlearning_tpu.envs.gridworld``: 10x10 grid, actions
up/down/left/right, the intended move with probability ``tprob`` else one of
the other three, off-grid moves stay put; reward cells are absorbing. The
dynamics are those of the JAX ``step_cols``/``reset_cols``.

The batched state is an ``[E, 3]`` f32 block ``(px, py, terminal)``.
Uniforms come in rows as in the JAX cols protocol: ``step_cols`` reads two
(direction branch, other-direction pick) and ``reset_cols`` two (x, y
spawn). The collect kernel (``ops/cuda/fused_collect.py``) runs the same
dynamics on the card and reads the reward cells, ``tprob`` and the grid size
from this object.
A per-instance state (``reset``, ``step``, ``observe``) is one row of the
batched state.
"""
from __future__ import annotations

import torch

from .base import Env, batch_of_one, first_row

# (dx, dy) for up, down, left, right
DIRS = ((0, 1), (0, -1), (-1, 0), (1, 0))


class SimpleGridWorld(Env):
    lane_state_width = 3
    n_uniform_step = 2
    n_uniform_reset = 2

    def __init__(self, size=(10, 10),
                 rewards={(4, 3): -10.0, (4, 6): -5.0, (9, 3): 10.0,
                          (8, 8): 3.0},
                 tprob: float = 0.7, discount: float = 0.95):
        self.size = tuple(int(s) for s in size)
        self.tprob = float(tprob)
        self.discount = float(discount)
        self.num_actions = 4
        self.obs_shape = (2,)
        self.reward_cells = [(int(x), int(y), float(r))
                             for (x, y), r in rewards.items() if r != 0.0]

    @property
    def action_map(self):
        return ["up", "down", "left", "right"]

    def step_cols(self, state: torch.Tensor, action: torch.Tensor,
                  u: torch.Tensor):
        """``state [E, 3]``, ``action [E]`` (float or int), ``u [>=2, E]`` in
        [0, 1) -> ``(state' [E, 3], obs [E, 2], reward [E], done [E])``."""
        px, py, term = state[:, 0], state[:, 1], state[:, 2]
        action = action.float()
        cell_r = torch.zeros_like(px)
        for cx, cy, rv in self.reward_cells:
            cell_r = cell_r + torch.where((px == cx) & (py == cy),
                                          torch.full_like(px, rv), 0.0)
        r = torch.where(term > 0.5, 0.0, cell_r)
        in_cell = (cell_r != 0.0).float()
        other = torch.floor(u[1] * 3.0)
        other = torch.where(other >= action, other + 1.0, other)
        d = torch.where(u[0] < self.tprob, action, other)
        dx = torch.zeros_like(px)
        dy = torch.zeros_like(py)
        for k, (ddx, ddy) in enumerate(DIRS):
            sel = d == float(k)
            dx = torch.where(sel, float(ddx), dx)
            dy = torch.where(sel, float(ddy), dy)
        npx = torch.clamp(px + dx, 1.0, float(self.size[0]))
        npy = torch.clamp(py + dy, 1.0, float(self.size[1]))
        bt = torch.maximum(term, in_cell)
        npx = torch.where(bt > 0.5, px, npx)
        npy = torch.where(bt > 0.5, py, npy)
        new = torch.stack([npx, npy, bt], dim=1)
        return new, self.observe_batch(new), r, bt

    def observe_batch(self, state: torch.Tensor) -> torch.Tensor:
        """``state [E, 3]`` -> ``obs [E, 2]``: the position, ``(-1, -1)``
        once terminal."""
        term = state[:, 2:3] > 0.5
        return torch.where(term, -1.0, state[:, :2])

    def reset_cols(self, u: torch.Tensor):
        """``u [>=2, E]`` -> ``(state [E, 3], obs [E, 2])``: uniform spawn."""
        px = 1.0 + torch.floor(u[0] * float(self.size[0]))
        py = 1.0 + torch.floor(u[1] * float(self.size[1]))
        state = torch.stack([px, py, torch.zeros_like(px)], dim=1)
        return state, self.observe_batch(state)

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
