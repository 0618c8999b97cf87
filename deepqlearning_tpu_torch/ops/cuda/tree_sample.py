"""K2: sum-tree descent for stratified draws (``csrc/tree_sample.cu``).

Replaces the whole-descent (``_sample_impl``) and windowed
(``_windowed_impl``) kernels of ``deepqlearning_tpu/ops/pallas/
tree_sample.py`` with one direct-gather descent: a thread per draw walks the
levels root to leaf with a sequential running sum over each node's
children. Its input is the target-mass vector; the uniforms, the
stratification and the u-major reorder stay in plain torch around it
(``replay/prioritized.py``). On the card it is bound by the latency of its
dependent per-level loads (see the source).
"""
from __future__ import annotations

import ctypes

import torch

from .. import sumtree
from . import build


def tree_sample_plain(tree, mass):
    """Plain PyTorch version: ``(leaf idx [D] int64, leaf priority [D])``."""
    idx, _ = sumtree.descend(tree, mass)
    return idx, tree[0][idx]


def tree_sample_cuda(tree, mass):
    """Launch K2: ``(leaf idx [D] int32, leaf priority [D] f32)``."""
    mass = mass.float().contiguous()
    build.require_cuda(mass, *tree)
    if len(tree) < 2 or mass.dim() != 1:
        raise ValueError("tree_sample needs a tree of at least two levels "
                         "and a 1-D mass vector")
    D = mass.shape[0]
    idx = torch.empty(D, dtype=torch.int32, device=mass.device)
    prio = torch.empty(D, dtype=torch.float32, device=mass.device)
    sizes = (ctypes.c_int * len(tree))(*[t.shape[0] for t in tree])
    err = build.library().dq_tree_sample(
        len(tree), build.int64_array([t.data_ptr() for t in tree]), sizes,
        mass.data_ptr(), D, idx.data_ptr(), prio.data_ptr(),
        build.stream_ptr(mass.device))
    build.check(err, "tree_sample")
    tree_sample_cuda.launches += 1
    return idx, prio


tree_sample_cuda.launches = 0


def tree_sample(tree, mass):
    """Leaf index and priority for each target mass: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors."""
    if mass.is_cuda:
        return tree_sample_cuda(tree, mass)
    return tree_sample_plain(tree, mass)
