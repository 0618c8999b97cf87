"""Array sum-tree for proportional prioritized sampling, on the device.

Counterpart of ``deepqlearning_tpu.ops.sumtree``: a tuple of per-level
tensors, leaves first, with a branching factor of 64 (a non-uniform last
level: 2^20 leaves give levels of 2^20/2^14/2^8/4/1).

Unlike the JAX version, the updates here work IN PLACE: ``set_priorities``
and ``set_priorities_slice`` write the leaves and re-sum the upper levels
into the existing level tensors, and return the same tuple. Children are
fetched with plain indexing (``level.view(P, bf)[idx]``); the one-hot
fetch of the JAX package worked around serialized TPU gathers.
"""
from __future__ import annotations

from typing import List, Optional, Tuple

import torch

Tree = Tuple[torch.Tensor, ...]

BRANCH = 64


def tree_capacity(n: int) -> int:
    """Round up to the next power of two (leaf count)."""
    cap = 1
    while cap < n:
        cap *= 2
    return cap


def _branch(size: int) -> int:
    return BRANCH if size % BRANCH == 0 and size >= BRANCH else size


def _level_sizes(cap: int) -> List[int]:
    sizes = [cap]
    while sizes[-1] > 1:
        sizes.append(sizes[-1] // _branch(sizes[-1]))
    return sizes


def init_tree(capacity: int, device=None) -> Tree:
    cap = tree_capacity(capacity)
    return tuple(torch.zeros(s, dtype=torch.float32, device=device)
                 for s in _level_sizes(cap))


def rebuild(tree: Tree) -> Tree:
    """Re-sum every level above the leaves, in place."""
    for child, parent in zip(tree[:-1], tree[1:]):
        torch.sum(child.view(parent.shape[0], -1), dim=1, out=parent)
    return tree


def last_source(indices: torch.Tensor, size: int) -> torch.Tensor:
    """For each entry of ``indices`` (values in ``[0, size)``), the position
    of the LAST entry with the same value. Scattering ``values[last_source]``
    makes every write to a repeated index carry the same value, so a scatter
    is deterministic (last write wins) on every device, without the host
    sync a boolean mask would cost."""
    pos = torch.arange(indices.shape[0], device=indices.device)
    last = torch.full((size,), -1, dtype=pos.dtype, device=indices.device)
    last.scatter_reduce_(0, indices, pos, reduce="amax")
    return last[indices]


def set_priorities(tree: Tree, indices: torch.Tensor,
                   priorities: torch.Tensor) -> Tree:
    """Set leaf priorities at arbitrary ``indices`` (last write wins) and
    rebuild, in place."""
    indices = indices.long()
    src = last_source(indices, tree[0].shape[0])
    tree[0][indices] = priorities.float()[src]
    return rebuild(tree)


def set_priorities_slice(tree: Tree, start,
                         priorities: torch.Tensor) -> Tree:
    """Set a contiguous run of leaves starting at ``start`` (an int or a
    0-d int tensor on the tree's device, read on the device) and rebuild,
    in place. Used by the aligned ring insert."""
    n = priorities.shape[0]
    idx = torch.as_tensor(start, device=tree[0].device) + torch.arange(
        n, device=tree[0].device)
    return set_priorities_run(tree, idx, priorities)


def set_priorities_run(tree: Tree, indices: torch.Tensor,
                       priorities: torch.Tensor) -> Tree:
    """Set the leaves at ``indices``, all distinct (a contiguous run of
    :func:`set_priorities_slice`), and rebuild, in place."""
    tree[0].index_copy_(0, indices, priorities.float())
    return rebuild(tree)


def total(tree: Tree) -> torch.Tensor:
    return tree[-1][0]


def get_leaf(tree: Tree, indices: torch.Tensor) -> torch.Tensor:
    """The leaf priorities at ``indices``."""
    return tree[0][indices]


def descend(tree: Tree, mass: torch.Tensor):
    """Descend given target masses; returns ``(leaf idx [D] int64,
    residual mass [D])``. Per level: prefix-sum the node's children, take
    ``j = Σ(mass >= csum)`` clamped to ``bf - 1``, subtract the mass before
    child ``j`` (``sumtree.descend`` of the JAX package)."""
    D = mass.shape[0]
    idx = torch.zeros(D, dtype=torch.int64, device=mass.device)
    for child, parent in reversed(list(zip(tree[:-1], tree[1:]))):
        P = parent.shape[0]
        bf = child.shape[0] // P
        children = child.view(P, bf)[idx]                        # [D, bf]
        csum = torch.cumsum(children, dim=1)
        j = (mass[:, None] >= csum).sum(dim=1).clamp(max=bf - 1)
        prev = torch.where(
            j > 0,
            torch.gather(csum, 1, (j - 1).clamp(min=0)[:, None])[:, 0],
            torch.zeros_like(mass),
        )
        mass = mass - prev
        idx = idx * bf + j
    return idx, mass


def stratified_mass(tree: Tree, u: torch.Tensor,
                    stratified: bool = True) -> torch.Tensor:
    """Target masses from uniforms ``u [D]``: one draw per equal-mass
    stratum when ``stratified``."""
    D = u.shape[0]
    if stratified:
        u = (torch.arange(D, dtype=torch.float32, device=u.device) + u) / D
    return u * total(tree)


def sample(tree: Tree, batch_size: int, stratified: bool = True,
           u: Optional[torch.Tensor] = None,
           generator: Optional[torch.Generator] = None):
    """Draw ``batch_size`` leaves proportional to priority, with uniforms
    ``u`` if given, else drawn from ``generator``. Returns
    ``(indices [D] int64, priorities [D] f32)``."""
    if u is None:
        u = torch.rand(batch_size, generator=generator,
                       device=tree[0].device)
    idx, _ = descend(tree, stratified_mass(tree, u, stratified))
    return idx, tree[0][idx]


def gumbel(shape, generator: Optional[torch.Generator] = None,
           device=None) -> torch.Tensor:
    """Standard Gumbel noise ``-log(-log(u))``, ``u`` uniform in
    ``[tiny, 1)`` (``jax.random.gumbel``'s construction)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = torch.clamp(u, min=torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def sample_without_replacement(tree: Tree, batch_size: int,
                               noise: Optional[torch.Tensor] = None,
                               generator: Optional[torch.Generator] = None):
    """Weighted sampling without replacement (the reference's draw,
    ``src/prioritized_experience_replay.jl:85``) by Gumbel-top-k:
    ``argtop_k(log p_i + G_i)`` draws like successive proportional draws
    without replacement. ``noise`` is the Gumbel noise ``G [..., leaves]``,
    one independent pass per leading index (``[leaves]``, drawn from
    ``generator``, if not given). Empty slots (priority 0) score ``-inf``
    and come last. A ``[..., N]``-wide pass and a top-k over its last axis,
    no tree descent. Returns ``(indices [..., B] int64, priorities [..., B]
    f32)``."""
    leaves = tree[0]
    if noise is None:
        noise = gumbel(leaves.shape, generator, leaves.device)
    scores = torch.where(leaves > 0, torch.log(leaves) + noise,
                         torch.full_like(noise, -torch.inf))
    idx = torch.topk(scores, batch_size, dim=-1).indices
    return idx, leaves[idx]
