"""One run of one cell: set-up, the checked iterations, the timed window,
the traced stretch (``trace``), then the plain reference and the result.

Set-up is the program's: build the loop, populate it up to the replay
start, capture the iteration's graph, and run the first three iterations
through the window's own call, ``run_segment(carry, 1)``, which the
reference follows afterwards (their snapshots to the host are the check's
and are left out of ``setup_s``). The window then runs segments back to
back, each ``run_segment(carry, n)`` and a device-to-host read of the
loss (``solve``'s log-point read), until ``seconds`` have passed; every
segment's wall time from launch to loss counts. Once it closes the peak
memory is read, the program's state freed, and the reference run.
"""
from __future__ import annotations

import contextlib
import gc
import math
import statistics
import subprocess
import time
from types import SimpleNamespace

import torch

from ..reference.loop import follow
from ..reference.nets import Net
from . import check, program, work
from .registry import Registry
from .trace import reduce, traced

N_CHECKED = 3
TRACE_S = 0.3


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)


def _span(on: bool, name: str):
    if not on:
        return contextlib.nullcontext()
    from torch.profiler import record_function

    return record_function("port_bench:" + name)


def segments(p, n: int, until_s: float = None, count: int = None,
             spans: bool = False):
    """Segments of ``n`` iterations back to back, until ``until_s`` seconds
    have passed or ``count`` segments have run: ``(wall ms per segment,
    host ms per replay per segment, non-finite losses, seconds)``."""
    seg, host, bad = [], [], 0
    start = time.perf_counter()
    while True:
        t0 = time.perf_counter()
        with _span(spans, "segment.replay"):
            p.carry = p.run_segment(p.carry, n)
        t1 = time.perf_counter()
        with _span(spans, "segment.read"):
            loss = float(p.carry.loss)
        t2 = time.perf_counter()
        seg.append(1e3 * (t2 - t0))
        host.append(1e3 * (t1 - t0) / n)
        bad += not math.isfinite(loss)
        if (until_s is not None and t2 - start >= until_s) or (
                count is not None and len(seg) >= count):
            return seg, host, bad, t2 - start


def p95(xs):
    return statistics.quantiles(xs, n=20)[18] if len(xs) > 1 else xs[0]


def card_line() -> str:
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def run_cell(name: str, seed: int, seconds: float, trace: bool, device,
             t0: float, reg: Registry = None, wrap=None, log=print):
    """The result dict of one run (``run.py``), or of a test's run on the
    CPU (``device``, a cell of ``reg``, ``wrap`` breaking the loop)."""
    reg = reg or Registry()
    cell = reg.cell(name)
    config = reg.config(cell["config"])
    tr = work.traffic(config, cell)
    torch.backends.cuda.matmul.allow_tf32 = False
    cuda = torch.device(device).type == "cuda"

    p = program.build(config, tr, seed, device, reg, wrap)
    start, prog, rows, held = program.checked(p, N_CHECKED)
    _sync(device)
    setup_s = time.perf_counter() - t0 - held

    n = tr["segment_iters"]
    seg, host, bad, window_s = segments(p, n, until_s=seconds)
    iters = len(seg) * n
    win = dict(segment_ms=seg, host_ms=host, iterations=iters,
               seconds=window_s,
               env_steps=iters * tr["env_steps_per_iter"])
    trc = None
    if trace:
        count = max(2, math.ceil(TRACE_S / (statistics.median(seg) * 1e-3)))
        _, dev, spans, wall = traced(
            torch, lambda: segments(p, n, count=1),
            lambda: segments(p, n, count=count, spans=True))
        trc = dict(reduce(dev, spans), window_s=wall,
                   iterations=count * n)
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    del p
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()

    ref = follow(config, tr, start, device, rows, reg)
    nums = check.numbers(start, prog, ref)
    limits = cell["limits"]
    correct = check.verdict(nums, limits) and bad == 0

    net = Net(config["net"], reg, config["env"]["obs_shape"])
    ctx = SimpleNamespace(config=config, traffic=tr, window=win, trace=trc,
                          work=work, registry=reg, net=net)
    metrics = {}
    if trace:
        for m in reg.metrics_of(name, "per_layer"):
            v = reg.metric(m["name"]).read(ctx)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        e2e = dict(env_steps_per_s=win["env_steps"] / window_s,
                   segment_ms_p95=p95(seg), setup_s=setup_s)
        for m in reg.metrics_of(name, "end_to_end"):
            metrics[m["name"]] = {"value": e2e[m["name"]], "unit": m["unit"]}
    devinfo = dict(platform="gpu" if cuda else "cpu",
                   kind=(torch.cuda.get_device_name(device) if cuda
                         else "cpu"),
                   count=1, memory_peak_bytes=int(peak))
    out = dict(correct=bool(correct), attempted=len(seg), failed=bad,
               metrics=metrics, device=devinfo)
    if trace:
        devinfo.update(busy_s=trc["busy_s"], window_s=trc["window_s"])
        ops = sorted(trc["by_kernel"].items(), key=lambda kv: -kv[1][1])
        gaps = sorted(trc["gaps"].items(), key=lambda kv: -kv[1])
        out["breakdown"] = dict(device_ops=[[k, v[1]] for k, v in ops[:10]],
                                idle_gaps=[[k, v] for k, v in gaps[:10]])
    out["card"] = card_line() if cuda else "cpu"
    out["reference"] = dict(ref["ties"], setup_held_s=held)
    out["counters"] = program.adam_counters()
    out["checks"] = {k: {"value": nums.get(k), "limit": v}
                     for k, v in limits.items()}
    for k, v in limits.items():
        log(f"check {k} {nums.get(k)!r} limit {v!r}")
    return out
