"""K10: a Conv2D or Dense layer's epilogue, the bias add, the activation and
the casts around its product, in one launch forward and one backward
(``csrc/bias_act.cu``).

No TPU kernel is replaced: on the TPU, XLA fuses the epilogue into the
product's output. :func:`bias_act` is what ``models/chain.py``'s Conv2D and
Dense layers run on the card when their activation is ``torch.relu``,
``torch.tanh`` or None and the product and the output are f32 or bf16
(:func:`takes`, which ``models/chain.py::epilogue`` asks); any other
activation or dtype, and every CPU tensor, keeps the ATen chain
:func:`bias_act_plain`, the kernel's twin. The
forward gives the chain's bits; so does the backward's cotangent of the
product, but for one case that the source names (a relu result in (0,
2^-134] that rounds to a bf16 zero); the bias gradient is an f32 sum in
another, fixed order, the same bits on every call and graph replay.

What K10 cannot take (a CPU tensor, a dtype other than f32 or bf16, an
activation other than those three, a bias that is not ``[C]`` on the
product's device, no elements or 2^31 and more) raises ``ValueError``
naming it; a strided product or cotangent is made contiguous first. The
backward's bias sum meets in a ticket of one int that the forward's launch
zeroes for it, one per forward call that may need a bias gradient, so no
two launches share one.

Counts: the recorder's ``kernels.launches`` under ``dq_bias_act`` and
``dq_bias_act_grad`` (K10's forward and backward launches, ``build.py``),
``model.bias_act_kernel`` (forward calls that launched K10) and
``model.bias_act_plain`` (forward calls of the ATen chain); inside a CUDA
graph they count the warm-up and the capture, not the replays.
"""
from __future__ import annotations

import torch

from ...utils import profiling
from . import build

KINDS = {torch.float32: 0, torch.bfloat16: 1}  # dtype -> the kernel's kind
ACTS = ((None, 0), (torch.relu, 1), (torch.tanh, 2))  # by identity
THREADS = 256  # BA_THREADS of csrc/bias_act.cu
MAX_BLOCKS = 1024  # BA_MAXB: the forward's most blocks
# the backward's most blocks, 2 per SM: its bias partials meet in one
# block at the end, so fewer and fuller blocks finish sooner
GRAD_BLOCKS = 264


def bias_act_plain(y, b, act, dtype):
    """The ATen chain: ``y`` widened to f32, plus ``b`` in f32, ``act``,
    rounded to ``dtype``."""
    profiling.count("model.bias_act_plain")
    y = y.float()
    if b is not None:
        y = y + b.float()
    if act is not None:
        y = act(y)
    return y.to(dtype)


def _act_code(act) -> int:
    for fn, code in ACTS:
        if act is fn:
            return code
    return -1


def _refusal(y, b, act, dtype):
    """Why K10 cannot take a call, or None: a CUDA product of 1 to 2^31 - 1
    elements, ``act`` relu, tanh or None, f32 or bf16 product, bias and
    output, and a bias ``[C]`` on the product's device."""
    if not y.is_cuda:
        return f"the product is on {y.device}; kernel K10 takes a CUDA tensor"
    for what, dt in (("product", y.dtype), ("output", dtype)) + (
            (("bias", b.dtype),) if b is not None else ()):
        if dt not in KINDS:
            return (f"the {what} is {dt}; kernel K10 takes float32 and "
                    "bfloat16")
    if _act_code(act) < 0:
        return (f"activation {act!r}; kernel K10 takes torch.relu, "
                "torch.tanh or None")
    if y.dim() < 1 or not 0 < y.numel() < 2 ** 31:
        return (f"a product of shape {tuple(y.shape)}; kernel K10 takes 1 "
                "to 2^31 - 1 elements")
    C = y.shape[-1]
    if b is not None and (tuple(b.shape) != (C,) or b.device != y.device):
        return (f"a bias of shape {tuple(b.shape)} on {b.device} for a "
                f"product [..., {C}] on {y.device}")
    return None


def takes(y, b, act, dtype) -> bool:
    """Whether a layer hands its epilogue to K10: K10 takes the call and
    there is something to do (a layer with no bias, no activation and no
    cast has no epilogue)."""
    return (_refusal(y, b, act, dtype) is None
            and not (b is None and act is None and y.dtype == dtype))


def launch_plan(M: int, C: int, vec: int, most: int = MAX_BLOCKS) -> tuple:
    """``(tx, ty, blocks)`` for ``M`` rows of ``C`` elements in units of
    ``vec``: a thread per unit of a row (at most ``THREADS``, one row per
    block then), the block's other threads on further rows, and the grid
    over the rows, at most ``most`` blocks."""
    units = C // vec
    tx = min(units, THREADS)
    ty = THREADS // tx
    return tx, ty, max(1, min(-(-M // ty), most))


def _vec(C: int, dtypes, tensors) -> int:
    """The elements of a 16-byte unit of the wider of the kernel's two
    element types ``dtypes``, where ``C`` is a multiple of it and every one
    of ``tensors`` (None for an array the launch does not touch) starts
    16-byte aligned; else 1."""
    width = 16 // max(torch.empty((), dtype=d).element_size()
                      for d in dtypes)
    if C % width or any(t.data_ptr() % 16 for t in tensors
                        if t is not None):
        return 1
    return width


def _check(y, b, act, dtype):
    """Raise ``ValueError`` on what K10 cannot take; ``(M, C, act code)``."""
    why = _refusal(y, b, act, dtype)
    if why is not None:
        raise ValueError(f"bias_act: {why}")
    return y.numel() // y.shape[-1], y.shape[-1], _act_code(act)


def _bias_kind(b) -> int:
    return 0 if b is None else 1 + KINDS[b.dtype]


def _ptr(t):
    return None if t is None else t.data_ptr()


class _BiasAct(torch.autograd.Function):
    """K10 forward; its backward is K10's second kernel. Saved: the
    output for relu and for tanh with an f32 output, the product and the
    bias for tanh with a bf16 one, nothing for no activation."""

    @staticmethod
    def forward(ctx, y, b, act, dtype):
        M, C, code = _check(y, b, act, dtype)
        y = y.contiguous()
        out = torch.empty(y.shape, dtype=dtype, device=y.device)
        # the bias gradient's ticket, zeroed by this launch
        ctx.ticket = (torch.empty(1, dtype=torch.int32, device=y.device)
                      if b is not None and ctx.needs_input_grad[1] else None)
        # the bias is read element by element
        vec = _vec(C, (y.dtype, dtype), (y, out))
        tx, ty, grid = launch_plan(M, C, vec)
        err = build.library().dq_bias_act(
            y.data_ptr(), KINDS[y.dtype], _ptr(b), _bias_kind(b),
            out.data_ptr(), KINDS[dtype], _ptr(ctx.ticket), code, M, C,
            int(vec > 1), tx, ty, grid, build.stream_ptr(y.device))
        build.check(err, "bias_act")
        ctx.shape, ctx.code, ctx.y_dtype = (M, C), code, y.dtype
        if code == 2 and dtype != torch.float32:
            ctx.code = 3  # tanh recomputed from the product and the bias
            ctx.save_for_backward(y, b)
        elif code:
            ctx.save_for_backward(out, b)
        else:
            ctx.save_for_backward(None, b)
        return out

    @staticmethod
    def backward(ctx, g):
        src, b = ctx.saved_tensors
        need_y, need_b = ctx.needs_input_grad[:2]  # need_b: a bias
        if not (need_y or need_b):
            return None, None, None, None
        (M, C), code, dev = ctx.shape, ctx.code, g.device
        g = g.contiguous()
        dy = (torch.empty(g.shape, dtype=ctx.y_dtype, device=dev)
              if need_y else None)
        db = torch.empty(C, dtype=b.dtype, device=dev) if need_b else None
        vec = _vec(C, (g.dtype, ctx.y_dtype), (g, src, dy))
        tx, ty, grid = launch_plan(M, C, vec, GRAD_BLOCKS)
        part = (torch.empty(grid * C, dtype=torch.float32, device=dev)
                if db is not None else None)
        err = build.library().dq_bias_act_grad(
            g.data_ptr(), KINDS[g.dtype], _ptr(src), _ptr(b), _bias_kind(b),
            _ptr(dy), KINDS[ctx.y_dtype], _ptr(part),
            _ptr(ctx.ticket if need_b else None), _ptr(db), _bias_kind(db),
            code, M, C, int(vec > 1), tx, ty, grid, build.stream_ptr(dev))
        build.check(err, "bias_act backward")
        return dy, db, None, None


def bias_act(y, b, act, dtype):
    """``act(y + b)`` in f32, rounded to ``dtype``, over a CUDA product
    ``y [..., C]`` and a bias ``b [C]`` (or None), by K10."""
    out = _BiasAct.apply(y, b, act, dtype)
    profiling.count("model.bias_act_kernel")
    return out
