"""The port's recorder of spans and counters, and its profiling and debug
hooks (``deepqlearning_tpu.utils.profiling``).

The recorder is always on. It keeps what it records in memory: a bounded
ring of spans per name, running totals per name and route (count, seconds,
self seconds), counters, and a bounded ring of sampled replay times.
Nothing grows with the length of a run. ``snapshot()`` returns all of it
as plain Python values and ``reset()`` empties it.

* :func:`span` ``(name, route=None, n=None)``: a span from
  ``time.perf_counter_ns``, with its parent (the innermost open span of
  the thread) and the attributes ``route`` and ``n``. Its self time is its
  duration less the time its child spans cover. While a ``torch.profiler``
  session is active (:func:`trace` around a ``solve``), the span is also a
  range of that session under its own name, so the program's spans stand
  on the device trace's clock beside the kernels they launched.
* :func:`count` ``(name, n=1, key="")`` adds to a counter;
  :func:`put` ``(name, value, key="")`` sets one; :func:`counter`
  ``(name, key="")`` reads one.
* :class:`ReplaySampler`: the device time of a CUDA graph's replays,
  sampled without a profiler (``learner/segment.py::CompiledSegment``).

No span may sit inside code that a CUDA graph captures: host code there
runs once, at capture, and never on a replay.

The port's kernel launches are counted here too, once, where the kernel
library is bound (``ops/cuda/build.py``): ``kernels.launches`` keyed by
the C entry point (``dq_td_loss``, ``dq_fused_update``, ...).

``enabled`` (module flag) turns all recording off, for tests and for
measuring what recording costs, and with it the launch count; it is not a
setting of the solver.

``trace(logdir)`` records a ``torch.profiler`` trace (host, and the card's
kernels when CUDA is available) into ``logdir`` for TensorBoard or
Perfetto; ``enable_nan_checks`` turns on autograd's anomaly detection,
which raises where a backward pass produces NaN.
"""
from __future__ import annotations

import collections
import contextlib
import itertools
import threading
import time

import torch

enabled = True

SPANS_PER_NAME = 256
SAMPLES = 1024
# sampling starts again no sooner than this after the last sample began
SAMPLE_PERIOD_NS = 250_000_000


def _profiler_active() -> bool:
    return torch._C._autograd._profiler_enabled()


class Recorder:
    """Spans, totals, counters and replay samples, all bounded."""

    def __init__(self):
        self._local = threading.local()
        self._ids = itertools.count(1)
        self.spans = collections.defaultdict(
            lambda: collections.deque(maxlen=SPANS_PER_NAME))
        # (name, route) -> [count, total ns, self ns]
        self.totals = collections.defaultdict(lambda: [0, 0, 0])
        self.counters = collections.defaultdict(dict)
        self.samples = collections.deque(maxlen=SAMPLES)
        self.unresolved = []
        self.pool = collections.defaultdict(list)
        self.next_sample_ns = 0

    def stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def close(self, sp, end: int) -> None:
        dur = end - sp.start
        self.spans[sp.name].append(
            (sp.id, sp.name, sp.start, end, sp.parent, sp.route, sp.n))
        t = self.totals[(sp.name, sp.route)]
        t[0] += 1
        t[1] += dur
        t[2] += dur - sp.child_ns

    # -- replay samples ------------------------------------------------
    def events(self, device, k: int) -> list:
        free = self.pool[device]
        return [free.pop() if free else torch.cuda.Event(enable_timing=True)
                for _ in range(k)]

    def resolve(self, wait: bool = False) -> None:
        """Turn the samples whose events have all completed into times
        (``wait``: wait for them); the events go back to the pool."""
        keep = []
        for s in self.unresolved:
            ev = s["events"]
            if wait:
                ev[-1].synchronize()
            elif not ev[-1].query():
                keep.append(s)
                continue
            s["device_ms"] = ev[0].elapsed_time(ev[1])
            s["gap_ms"] = ev[1].elapsed_time(ev[2]) if len(ev) > 2 else None
            self.pool[s.pop("device")].extend(s.pop("events"))
            self.samples.append(s)
        self.unresolved = keep

    def snapshot(self) -> dict:
        self.resolve(wait=True)
        spans = sorted(itertools.chain.from_iterable(self.spans.values()),
                       key=lambda r: r[2])
        totals = {}
        for (name, route), (c, total, own) in self.totals.items():
            totals.setdefault(name, {})[route or ""] = dict(
                count=c, total_s=total * 1e-9, self_s=own * 1e-9)
        return dict(
            spans=[dict(id=i, name=nm, start_ns=s, end_ns=e, parent=p,
                        route=r, n=n) for i, nm, s, e, p, r, n in spans],
            totals=totals,
            counters={k: dict(v) for k, v in self.counters.items()},
            samples=[dict(s) for s in self.samples])


RECORDER = Recorder()


class _Span:
    __slots__ = ("name", "route", "n", "id", "parent", "start", "child_ns",
                 "range", "stack")

    def __init__(self, name, route, n):
        self.name, self.route, self.n = name, route, n

    def __enter__(self):
        self.stack = stack = RECORDER.stack()
        self.id = next(RECORDER._ids)
        self.parent = stack[-1].id if stack else None
        self.child_ns = 0
        self.range = None
        if _profiler_active():
            self.range = torch._C._profiler._RecordFunctionFast(self.name)
            self.range.__enter__()
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        stack = self.stack
        stack.pop()
        if stack:
            stack[-1].child_ns += end - self.start
        if self.range is not None:
            self.range.__exit__(*exc)
        RECORDER.close(self, end)
        return False


def span(name: str, route: str = None, n: int = None):
    """A context manager that records a span (module docstring)."""
    if not enabled:
        return contextlib.nullcontext()
    return _Span(name, route, n)


def count(name: str, n: int = 1, key: str = "") -> None:
    """Add ``n`` to the counter ``name`` under ``key`` (a route, or "")."""
    if enabled:
        c = RECORDER.counters[name]
        c[key] = c.get(key, 0) + n


def put(name: str, value, key: str = "") -> None:
    """Set the counter ``name`` under ``key`` to ``value``."""
    if enabled:
        RECORDER.counters[name][key] = value


def counter(name: str, key: str = ""):
    """The counter ``name`` under ``key``, 0 where nothing was counted."""
    return RECORDER.counters.get(name, {}).get(key, 0)


def snapshot() -> dict:
    """What the recorder holds: ``spans`` (the rings' records, by start:
    ``id``, ``name``, ``start_ns``, ``end_ns``, ``parent``, ``route``,
    ``n``), ``totals`` (``{name: {route: {count, total_s, self_s}}}``,
    route "" for none), ``counters`` (``{name: {key: value}}``) and
    ``samples`` (each with ``route``, ``call``, ``t_ns``, ``n``,
    ``device_ms`` and ``gap_ms``: :class:`ReplaySampler`). Waits for the
    sampled events recorded so far; a sample still waiting for its
    segment's next call is left out until that call."""
    return RECORDER.snapshot()


def reset() -> None:
    """Empty the recorder."""
    global RECORDER
    RECORDER = Recorder()


class ReplaySampler:
    """Sampled device time of one CUDA graph's replays (``route``), with no
    profiler: at most once per ``SAMPLE_PERIOD_NS`` of wall time over all
    samplers, and never while a ``torch.profiler`` session is active, a
    call of the graph records a CUDA event just before its first replay
    and one just after its last, and the graph's next call one more
    before its own first replay. Events between the replays would slow
    them (on the card 1.6 % of a call of 16 short replays, against 0.5 %
    for these three). A sample (``snapshot()["samples"]``) holds the
    call's device time from its first replay's first node to its last
    replay's last node (``device_ms``: the gaps between nodes and between
    its replays included) and the gap from there to the next call's first
    replay (``gap_ms``: the device waiting for the host, across the
    caller's reads between the calls; None where the next call came
    under a profiler), with the route, the graph's call index (``call``,
    from 0), the host time it began (``t_ns``) and its replay count
    ``n``. The events are read once they have completed, at a later call
    or at ``snapshot()``: the hot path never waits for the device."""

    def __init__(self, route: str, device):
        self.route, self.device = route, device
        self.calls = 0
        self.pending = None

    def start(self, n: int):
        """Call right before a call's first replay: the two events to
        record before its first replay and after its last, or None where
        this call is not sampled."""
        self.calls += 1
        if not enabled:
            return None
        rec = RECORDER
        traced = _profiler_active()
        s, self.pending = self.pending, None
        if s is not None:
            if not traced:
                s["events"] += rec.events(self.device, 1)
                s["events"][-1].record()
            rec.unresolved.append(s)
        if rec.unresolved:
            rec.resolve()
        now = time.perf_counter_ns()
        if n <= 0 or traced or now < rec.next_sample_ns:
            return None
        rec.next_sample_ns = now + SAMPLE_PERIOD_NS
        self.pending = dict(route=self.route, call=self.calls - 1, t_ns=now,
                            n=n, device=self.device,
                            events=rec.events(self.device, 2))
        return self.pending["events"]


@contextlib.contextmanager
def trace(logdir: str):
    """Capture a ``torch.profiler`` trace into ``logdir``."""
    from torch.profiler import (
        ProfilerActivity, profile, tensorboard_trace_handler)

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(logdir)) as prof:
        yield prof


def enable_nan_checks(enabled: bool = True):
    """Anomaly mode: a backward pass that produces NaN raises."""
    torch.autograd.set_detect_anomaly(enabled)
