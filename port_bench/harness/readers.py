"""Arithmetic shared by the per-layer metrics' readers (``metrics/``)."""
from __future__ import annotations

import statistics


def median(xs):
    return statistics.median(xs) if xs else None


def roofline(ctx, symbol: str):
    """The kernel's share of its roofline in %: the least time its work
    takes (``kernels/<symbol>.py``, at the f32 peak) over its device time
    per launch in the trace; None without a trace, a launch or a work
    count."""
    if ctx.trace is None:
        return None
    launches, seconds = ctx.trace["by_kernel"].get(symbol, (0, 0.0))
    part = ctx.registry.kernel(symbol)
    if not launches or part is None:
        return None
    flops, nbytes = part.work(ctx)
    return 100.0 * ctx.work.bound_s(flops, nbytes) / (seconds / launches)
