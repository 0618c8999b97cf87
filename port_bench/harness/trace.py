"""A device trace of a steady stretch of segments, and its reduction.

The profiler (CUPTI) can lose the first records of a CUDA graph's first
launch in a session, so the session first runs one segment that primes
it, then a marked pause, and only the device's events after the pause
count (the method of the port's ``ops/cuda/loop_profile.py::traced``,
copied here). The harness's own calls are marked by ``record_function``
spans (``port_bench:<name>``), so an idle gap on the device can be named
by what the host was doing then.
"""
from __future__ import annotations

import time
from typing import List, Tuple

PAUSE = "port_bench:pause"
SPAN = "port_bench:"


def kernel_symbol(name: str) -> str:
    """A device event's kernel name without return type, template arguments
    and parameters."""
    cut = [i for i in (name.find("("), name.find("<")) if i >= 0]
    return name[:min(cut, default=len(name))].split(" ")[-1]


def traced(torch, prime, fn):
    """``(fn(), device events, host spans, wall seconds of fn)``, events and
    spans as ``(name, start_us, end_us)``, only those after the pause."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime()
        torch.cuda.synchronize()
        with record_function(PAUSE):
            time.sleep(0.02)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    pause = next(e for e in events if e.name == PAUSE)
    cut = 0.5 * (pause.time_range.start + pause.time_range.end)
    dev, spans = [], []
    for e in events:
        if e.time_range.start < cut:
            continue
        rec = (e.name, e.time_range.start, e.time_range.end)
        if e.name.startswith(SPAN):
            # the span's own record on the device timeline is no operation
            if e.device_type != DeviceType.CUDA and e.name != PAUSE:
                spans.append((e.name[len(SPAN):],) + rec[1:])
        elif e.device_type == DeviceType.CUDA:
            dev.append(rec)
    return out, dev, spans, wall


def union(events) -> List[Tuple[float, float]]:
    """The device's busy intervals: the union of its events' intervals."""
    out = []
    for _n, s, e in sorted(events, key=lambda x: x[1]):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [tuple(x) for x in out]


def reduce(dev, spans) -> dict:
    """Busy seconds, device seconds and launches by kernel symbol, and the
    idle gaps between busy intervals by the host span they fall in."""
    busy = union(dev)
    by_kernel = {}
    for name, s, e in dev:
        k = by_kernel.setdefault(kernel_symbol(name), [0, 0.0])
        k[0] += 1
        k[1] += (e - s) * 1e-6
    gaps = {}
    for (_s0, e0), (s1, _e1) in zip(busy[:-1], busy[1:]):
        mid = 0.5 * (e0 + s1)
        label = next((n for n, s, e in spans if s <= mid <= e), "host")
        gaps[label] = gaps.get(label, 0.0) + (s1 - e0) * 1e-6
    return dict(busy_s=sum(e - s for s, e in busy) * 1e-6,
                by_kernel=by_kernel, gaps=gaps)
