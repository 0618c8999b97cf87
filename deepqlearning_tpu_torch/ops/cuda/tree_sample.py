"""K2: sum-tree descent for stratified draws (``csrc/tree_sample.cu``).

Replaces the whole-descent (``_sample_impl``) and windowed
(``_windowed_impl``) kernels of ``deepqlearning_tpu/ops/pallas/
tree_sample.py`` with one direct-gather descent: a group of 16 lanes per
draw reads each node's children as one coalesced row and finds the child
by a scan across the lanes. Its input is the target-mass vector (the
uniforms and the stratification stay in plain torch, in
``replay/prioritized.py``); it writes int64 leaf indices and their
priorities in the u-major order that ``sample_n`` hands to its
sub-updates, so no cast or reorder follows it. On the card it is bound by
the latency of its dependent per-level reads (see the source).

:func:`tree_sample_plain` is the twin (``sumtree.descend``, then the same
order); :func:`tree_sample_scan` adds each node's children in exactly the
kernel's order, in f32, and must equal the kernel bit for bit.
"""
from __future__ import annotations

import functools

import torch

from .. import sumtree
from . import build

LANES = 16   # TS_LANES of csrc/tree_sample.cu: the lanes of one draw
MAX_LEVELS = 8  # TS_MAXL


def u_major(x, n_batches: int):
    """Reorder stratum-major draws ``[B·n]`` (draw ``b·n + u``) to
    ``n_batches`` contiguous sub-batches of B (row ``u·B + b``)."""
    if n_batches == 1:
        return x
    return x.reshape(-1, n_batches).t().reshape(-1)


def tree_sample_plain(tree, mass, n_batches: int = 1):
    """Plain PyTorch version: ``(leaf idx [D] int64, leaf priority [D])``,
    u-major over ``n_batches`` sub-batches."""
    idx, _ = sumtree.descend(tree, mass)
    idx = u_major(idx, n_batches)
    return idx, tree[0][idx]


def tree_sample_scan(tree, mass, n_batches: int = 1):
    """The kernel's arithmetic in torch, f32 and step for step: at each
    node, lane ``l`` of 16 holds children ``4l..4l+3`` (0 past the
    branching factor) and their in-order running sums ``s``; a Hillis-Steele
    inclusive scan of the lane sums gives the prefix ``p`` before each
    lane; ``csum = p + s``; ``j = #{k < bf : mass >= csum_k}`` clamped to
    ``bf - 1``; ``mass -= csum_{j-1}`` when ``j > 0``. Same outputs as
    :func:`tree_sample_plain`."""
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
        s = torch.stack(s, dim=-1)                    # [D, 16, 4]
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
    idx = u_major(idx, n_batches)
    return idx, tree[0][idx]


@functools.lru_cache(maxsize=16)
def _levels(key) -> build.TreeLevels:
    """The kernel's level descriptor for ``key`` = ((level pointer, level
    size), ...), leaves first: built once per tree (the level tensors live
    as long as their buffer), not on every draw."""
    t = build.TreeLevels()
    t.n = len(key)
    for i, (ptr, size) in enumerate(key):
        t.lv[i], t.size[i] = ptr, size
        if i + 1 < len(key):
            t.bf[i] = size // key[i + 1][1]
    return t


def tree_sample_cuda(tree, mass, n_batches: int = 1):
    """Launch K2: ``(leaf idx [D] int64, leaf priority [D] f32)``, u-major
    over ``n_batches`` sub-batches."""
    mass = mass.float().contiguous()
    build.require_cuda(mass, *tree)
    D = mass.shape[0]
    if not 2 <= len(tree) <= MAX_LEVELS or mass.dim() != 1:
        raise ValueError(f"tree_sample needs a tree of 2 to {MAX_LEVELS} "
                         "levels and a 1-D mass vector")
    if n_batches < 1 or D % n_batches:
        raise ValueError(f"{D} draws do not split into {n_batches} "
                         "sub-batches")
    key = tuple((t.data_ptr(), t.shape[0]) for t in tree)
    if any(p % 16 for p, _ in key):
        raise ValueError("tree_sample needs 16-byte aligned levels")
    idx = torch.empty(D, dtype=torch.int64, device=mass.device)
    prio = torch.empty(D, dtype=torch.float32, device=mass.device)
    err = build.library().dq_tree_sample(
        _levels(key), mass.data_ptr(), D, n_batches, idx.data_ptr(),
        prio.data_ptr(), build.stream_ptr(mass.device))
    build.check(err, "tree_sample")
    return idx, prio


def tree_sample(tree, mass, n_batches: int = 1):
    """Leaf index and priority for each target mass, u-major over
    ``n_batches`` sub-batches: the CUDA kernel for CUDA tensors, the plain
    version for CPU tensors."""
    if mass.is_cuda:
        return tree_sample_cuda(tree, mass, n_batches)
    return tree_sample_plain(tree, mass, n_batches)
