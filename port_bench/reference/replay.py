"""Plain proportional prioritized replay (Schaul et al. 2016).

The sum tree is a tuple of f32 levels, leaves first, 64 children per node
where the level divides (2^20 leaves: 2^20, 2^14, 2^8, 4, 1); a parent is
the sum of its children. A stratified draw of ``D`` rows takes one target
mass per stratum, ``(i + u_i) / D · total``, and descends: at each node
the children are summed left to right in runs of 4, the 16 run sums are
prefix-summed by a Hillis-Steele scan, and the child is the number of
prefix sums at or below the mass (clamped to the last child). That is the
order the measured program's descent adds in, so both pick the same leaf
from the same tree. The draws come out sub-batch-major: sub-batch ``u`` of
``n`` takes strata ``u, n + u, 2n + u, ...``.

Priorities are ``(|r| + eps)^alpha`` at insert and ``(|td| + eps)^alpha``
after an update (a leaf drawn twice keeps its last value); importance
weights ``(N p / total)^-beta`` with ``N`` the fill, unnormalised.
"""
from __future__ import annotations

import torch

LANES = 16


def rebuild(tree):
    for child, parent in zip(tree[:-1], tree[1:]):
        torch.sum(child.view(parent.shape[0], -1), dim=1, out=parent)


def set_leaves(tree, idx, prio):
    """Set the leaves at ``idx`` (the last of repeated indices wins)."""
    pos = torch.arange(idx.shape[0], device=idx.device)
    last = torch.full((tree[0].shape[0],), -1, dtype=pos.dtype,
                      device=idx.device)
    last.scatter_reduce_(0, idx, pos, reduce="amax")
    tree[0][idx] = prio.float()[last[idx]]
    rebuild(tree)


def descend(tree, mass):
    D = mass.shape[0]
    idx = torch.zeros(D, dtype=torch.int64, device=mass.device)
    lane = torch.arange(LANES, device=mass.device)
    for child, parent in reversed(list(zip(tree[:-1], tree[1:]))):
        bf = child.shape[0] // parent.shape[0]
        v = mass.new_zeros(D, 4 * LANES)
        v[:, :bf] = child.view(-1, bf)[idx]
        v = v.view(D, LANES, 4)
        s = [v[..., 0]]
        for m in range(1, 4):
            s.append(s[-1] + v[..., m])
        s = torch.stack(s, dim=-1)
        incl = s[..., 3]
        off = 1
        while off < LANES:
            y = torch.cat([incl.new_zeros(D, off), incl[:, :-off]], dim=1)
            incl = torch.where(lane >= off, incl + y, incl)
            off *= 2
        excl = torch.cat([incl.new_zeros(D, 1), incl[:, :-1]], dim=1)
        csum = (excl[..., None] + s).view(D, 4 * LANES)[:, :bf]
        j = (mass[:, None] >= csum).sum(dim=1).clamp(max=bf - 1)
        prev = csum.gather(1, (j - 1).clamp(min=0)[:, None])[:, 0]
        mass = torch.where(j > 0, mass - prev, mass)
        idx = idx * bf + j
    return idx


class Replay:
    """Rows ``obs``, ``next_obs`` (storage dtype) and ``scalars [C, 4]``
    f32 (action, reward, done, 0) over a sum tree, with the fill and the
    next insert position as host ints."""

    def __init__(self, obs, next_obs, scalars, tree, pos, size, per,
                 obs_shape):
        self.obs_shape = tuple(obs_shape)
        self.obs, self.next_obs, self.scalars = obs, next_obs, scalars
        self.tree = tree
        self.pos, self.size = int(pos), int(size)
        self.C = obs.shape[0]
        self.alpha, self.beta, self.eps = (per["alpha"], per["beta"],
                                           per["eps"])

    def insert(self, obs, action, reward, next_obs, done):
        E = action.shape[0]
        idx = (self.pos + torch.arange(E, device=action.device)) % self.C
        self.obs[idx] = obs.reshape(E, -1).to(self.obs.dtype)
        self.next_obs[idx] = next_obs.reshape(E, -1).to(self.obs.dtype)
        self.scalars[idx] = torch.stack(
            [action.float(), reward.float(), done.float(),
             torch.zeros_like(reward, dtype=torch.float32)], dim=1)
        set_leaves(self.tree, idx, (reward.float().abs() + self.eps)
                   ** self.alpha)
        self.pos = (self.pos + E) % self.C
        self.size = min(self.size + E, self.C)
        return idx

    def sample(self, n_batches, batch, u):
        """``(idx, obs, action, reward, next_obs, done, weights)`` of
        ``n_batches * batch`` draws from uniforms ``u``, sub-batch-major."""
        D = n_batches * batch
        total = self.tree[-1][0]
        mass = (torch.arange(D, dtype=torch.float32, device=u.device)
                + u) / D * total
        idx = descend(self.tree, mass)
        if n_batches > 1:
            idx = idx.reshape(-1, n_batches).t().reshape(-1)
        prio = self.tree[0][idx]
        p = prio / torch.clamp(total, min=1e-30)
        n = torch.tensor(float(max(self.size, 1)), device=u.device)
        weights = torch.where(p > 0, (n * p) ** (-self.beta),
                              torch.ones_like(p))
        sc = self.scalars[idx]
        shape = (D,) + self.obs_shape
        return (idx, self.obs[idx].reshape(shape), sc[:, 0].long(), sc[:, 1],
                self.next_obs[idx].reshape(shape), sc[:, 2], weights)

    def update(self, idx, td):
        set_leaves(self.tree, idx, (td.abs() + self.eps) ** self.alpha)
