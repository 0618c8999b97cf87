"""SimpleGridWorld (POMDPModels' semantics), on both sides of the check.

A grid of ``size``; actions up, down, left, right; the intended move with
probability ``tprob``, else one of the other three; off-grid moves stay
put; a reward cell pays its reward on the step taken from it and ends the
episode. State ``[E, 3]`` f32 ``(x, y, terminal)``; the observation is
``(x, y)``, or -1 at a terminal. A step reads two uniforms per env (the
branch and the other direction), a reset two (the spawn cell).
"""
import torch

STATE_WIDTH = 3       # f32 lanes of one env's state
STEP_UNIFORMS = 2
RESET_UNIFORMS = 2
# the port's fused collect (K4) has device code for this env: with an f32
# Dense network the collect draws its uniforms as one block
FUSED_COLLECT = True
DIRS = ((0, 1), (0, -1), (-1, 0), (1, 0))


def program(spec):
    """The port's env."""
    from deepqlearning_tpu_torch import SimpleGridWorld

    return SimpleGridWorld(
        size=tuple(spec["size"]),
        rewards={(x, y): r for x, y, r in spec["reward_cells"]},
        tprob=spec["tprob"], discount=spec["discount"])


class Reference:
    """The plain batched env: ``step(state, action, u)``, ``reset(u, n)``
    with ``u`` the env's uniforms ``[k, E]``."""

    def __init__(self, spec, device):
        self.size = tuple(spec["size"])
        self.cells = [tuple(c) for c in spec["reward_cells"]]
        self.tprob = float(spec["tprob"])
        self.discount = float(spec["discount"])
        self.num_actions = 4
        self.obs_shape = (2,)

    def observe(self, state):
        return torch.where(state[:, 2:3] > 0.5, -1.0, state[:, :2])

    def step(self, state, action, u):
        px, py, term = state[:, 0], state[:, 1], state[:, 2]
        action = action.float()
        cell_r = torch.zeros_like(px)
        for cx, cy, rv in self.cells:
            cell_r = cell_r + torch.where((px == cx) & (py == cy),
                                          torch.full_like(px, rv), 0.0)
        r = torch.where(term > 0.5, 0.0, cell_r)
        other = torch.floor(u[1] * 3.0)
        other = torch.where(other >= action, other + 1.0, other)
        d = torch.where(u[0] < self.tprob, action, other)
        dx, dy = torch.zeros_like(px), torch.zeros_like(py)
        for k, (ddx, ddy) in enumerate(DIRS):
            dx = torch.where(d == float(k), float(ddx), dx)
            dy = torch.where(d == float(k), float(ddy), dy)
        nx = torch.clamp(px + dx, 1.0, float(self.size[0]))
        ny = torch.clamp(py + dy, 1.0, float(self.size[1]))
        t = torch.maximum(term, (cell_r != 0.0).float())
        nx, ny = torch.where(t > 0.5, px, nx), torch.where(t > 0.5, py, ny)
        new = torch.stack([nx, ny, t], dim=1)
        return new, self.observe(new), r, t

    def reset(self, u, n):
        px = 1.0 + torch.floor(u[0] * float(self.size[0]))
        py = 1.0 + torch.floor(u[1] * float(self.size[1]))
        state = torch.stack([px, py, torch.zeros_like(px)], dim=1)
        return state, self.observe(state)
