"""K9: the plain train steps' Adam update and gradient max-abs in one launch
(``csrc/adam.cu``).

No TPU kernel is replaced: on the TPU, XLA fuses optax's Adam into the
jitted update. :func:`adam_update` is what ``learner/train_step.py::Adam.
update`` runs; the plain steps (ungrouped and grouped plain, the DRQN plain
steps, the plain data-parallel steps) log its max-abs as their gradient
norm. For CUDA tensors it launches K9, which gives the bits of
:func:`adam_update_plain`'s ATen chain (the source says how); for CPU
tensors it runs that twin. The routes of K3, K5, K7 and K8 keep their
in-kernel Adam and never come here.

K9 also adds 1 to the int32 count on the device and takes the bias
corrections ``1 - β^t`` from it as the twin's ATen kernels do. A CUDA
tensor that K9 cannot take (a dtype other than f32 or bf16, a moment or
gradient of another dtype or shape than its parameter, a parameter or
moment that is not contiguous, tensors on more than one device, a count
that is not an int32 scalar beside them) raises ``ValueError`` naming it;
a strided gradient is made contiguous first. The max-abs of a call meets
in a workspace of ``1 + AD_MAXB`` ints per device that the optimizer keeps
(``Adam.workspace``: a ticket that the kernel re-arms and the blocks'
partials), so one optimizer's calls on a device must not overlap on two
streams.

Counts: the recorder's ``kernels.launches`` under ``dq_adam_update`` (K9
launches, ``build.py``: one per call up to ``AD_MAXT`` tensors),
``train.adam_kernel`` (calls that launched K9) and ``train.adam_plain``
(calls of the twin); inside a CUDA graph they count the warm-up and the
capture, not the replays.
"""
from __future__ import annotations

import ctypes

import torch

from ...utils import profiling
from ..helpers import globalnorm
from . import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}  # dtype -> flags bit 0
UNIT_BYTES = 16  # a unit: the elements of one 16-byte load
THREADS = 256  # AD_THREADS of csrc/adam.cu
RESIDENT_BLOCKS = 1024  # about the H100's resident 256-thread blocks

@torch.no_grad()
def adam_update_plain(opt, grads, state, params) -> torch.Tensor:
    """The plain twin: ``globalnorm(grads)``, then Adam per tensor as ATen
    kernels, in place on params, m, v and count (``opt``'s constants,
    ``Adam._rounded``). Returns the max-abs, an f32 scalar."""
    profiling.count("train.adam_plain")
    grad_norm = globalnorm(grads)
    state.count.add_(1)
    t = state.count.float()
    bc1 = 1.0 - opt.b1 ** t
    bc2 = 1.0 - opt.b2 ** t
    for k, g in grads.items():
        m, v, p = state.m[k], state.v[k], params[k]
        c1, b1, c2, b2, eps, neg_lr = opt._rounded(p.dtype)
        m.mul_(b1).add_(c1 * g)
        v.mul_(b2).add_(c2 * (g * g))
        p.add_(neg_lr * ((m / bc1.to(m.dtype))
                         / (torch.sqrt(v / bc2.to(v.dtype)) + eps)))
    return grad_norm


def adam_rows(grads, state, params) -> list:
    """``[(p, m, v, g)]`` of the tensors K9 updates, in ``grads``' order,
    each gradient contiguous; raises ``ValueError`` on a tensor K9 cannot
    take (module docstring)."""
    rows, dev = [], None
    for k, g in grads.items():
        p, m, v = params[k], state.m[k], state.v[k]
        if p.dtype not in DTYPES:
            raise ValueError(f"adam_update: parameter {k!r} is {p.dtype}; "
                             "kernel K9 takes float32 and bfloat16")
        for what, t in (("moment m", m), ("moment v", v), ("gradient", g)):
            if t.dtype != p.dtype or t.shape != p.shape:
                raise ValueError(
                    f"adam_update: the {what} of {k!r} is {t.dtype} "
                    f"{tuple(t.shape)}, its parameter {p.dtype} "
                    f"{tuple(p.shape)}")
        for what, t in (("parameter", p), ("moment m", m), ("moment v", v)):
            if not t.is_contiguous():
                raise ValueError(f"adam_update: the {what} {k!r} is not "
                                 "contiguous; kernel K9 updates it in place "
                                 "as a flat array")
        dev = p.device if dev is None else dev
        if any(t.device != dev for t in (p, m, v, g)) or dev.type != "cuda":
            raise ValueError(f"adam_update: {k!r} is not on {dev} with the "
                             "other tensors (kernel K9 takes one CUDA device)")
        if p.numel() >= 2 ** 31:
            raise ValueError(f"adam_update: {k!r} has {p.numel()} elements; "
                             "kernel K9 indexes with 32 bits")
        rows.append((p, m, v, g.contiguous()))
    if not rows:
        raise ValueError("adam_update: no gradients")
    return rows


def adam_tables(rows, consts) -> list:
    """The kernel's tables (``build.AdamTab``) for ``rows`` (:func:`adam_
    rows`), ``AD_MAXT`` tensors each: pointers, element counts, each
    tensor's first 16-byte unit, flags (bit 0 bf16, bit 1 all four
    pointers 16-byte aligned), and ``consts`` ``{dtype: (1-β1, β1, 1-β2,
    β2, ε, -lr)}`` (``Adam._rounded``)."""
    tabs = []
    for c0 in range(0, len(rows), build.AD_MAXT):
        tab, unit = build.AdamTab(), 0
        chunk = rows[c0:c0 + build.AD_MAXT]
        for i, (p, m, v, g) in enumerate(chunk):
            ptrs = [t.data_ptr() for t in (p, m, v, g)]
            tab.p[i], tab.m[i], tab.v[i], tab.g[i] = ptrs
            tab.n[i] = p.numel()
            tab.start[i] = unit
            tab.flags[i] = DTYPES[p.dtype] | (
                2 * all(x % UNIT_BYTES == 0 for x in ptrs))
            per_unit = UNIT_BYTES // p.element_size()
            unit += -(-p.numel() // per_unit)
        tab.start[len(chunk)] = unit
        tab.nt = len(chunk)
        for dtype, j in DTYPES.items():
            if dtype in consts:
                tab.k[j][:] = consts[dtype]
        tabs.append(tab)
    return tabs


def launch_grids(units) -> list:
    """Blocks per launch for tables of ``units`` 16-byte units: a unit per
    thread, or as many as keep the launches' blocks within
    ``RESIDENT_BLOCKS`` (so one wave, each thread the same count), at
    least one block each."""
    cap = max(1, RESIDENT_BLOCKS // len(units))
    out = []
    for u in units:
        per = max(1, -(-u // (THREADS * cap)))
        out.append(max(1, -(-u // (THREADS * per))))
    return out


def _workspace(opt, device) -> torch.Tensor:
    """The optimizer's ticket and partials on ``device``, made zero at its
    first call there; each call leaves the ticket at zero again."""
    if device not in opt.workspace:
        opt.workspace[device] = torch.zeros(1 + build.AD_MAXB,
                                            dtype=torch.int32, device=device)
    return opt.workspace[device]


@torch.no_grad()
def adam_update(opt, grads, state, params) -> torch.Tensor:
    """Adam (``opt``: ``learner/train_step.py::Adam``) on ``params`` in
    place from ``grads``, with ``state``'s moments and count; returns the
    gradients' max-abs (``ops/helpers.py::globalnorm``) as an f32 scalar.
    K9 for CUDA tensors, :func:`adam_update_plain` for CPU ones."""
    if not next(iter(params.values())).is_cuda:
        return adam_update_plain(opt, grads, state, params)
    rows = adam_rows(grads, state, params)
    count = state.count
    dev = count.device
    if (count.dtype != torch.int32 or count.dim() != 0
            or dev != rows[0][0].device):
        raise ValueError(f"adam_update: the count is {count.dtype} "
                         f"{tuple(count.shape)} on {dev}; kernel K9 takes "
                         "an int32 scalar on the parameters' device")
    gnorm = torch.empty((), dtype=torch.float32, device=dev)
    consts = {t.dtype: opt._rounded(t.dtype) for t, *_ in rows}
    tabs = adam_tables(rows, consts)
    grids = launch_grids([t.start[t.nt] for t in tabs])
    work, lib = _workspace(opt, dev), build.library()
    stream, base = build.stream_ptr(dev), 0
    for tab, grid in zip(tabs, grids):
        err = lib.dq_adam_update(
            ctypes.byref(tab), count.data_ptr(), opt.b1, opt.b2,
            work.data_ptr(), base, grid, sum(grids), gnorm.data_ptr(),
            stream)
        build.check(err, "adam_update")
        base += grid
    profiling.count("train.adam_kernel")
    return gnorm
