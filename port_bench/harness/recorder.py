"""The program's own recorder (``deepqlearning_tpu_torch/utils/
profiling.py``), read in-process once the cell has run: the spans,
counters and sampled replay times of the harness's two graphs, named as
``program.py`` names them. Each reader gives None where the program has no
recorder or the recorder holds nothing of them."""
from __future__ import annotations

import statistics

SEGMENT = "port_bench segment"
POPULATE = "port_bench populate"


def snapshot():
    """The recorder's ``snapshot()``, or None from a program without it."""
    from deepqlearning_tpu_torch.utils import profiling

    read = getattr(profiling, "snapshot", None)
    return read() if read is not None else None


def window_samples(snap) -> list:
    """The sampled calls of the segment's graph in the timed window: from
    its call ``N_CHECKED`` on, since the checked iterations' calls and the
    host copies between them are the check's (the traced stretch samples
    nothing: the recorder does not sample under a profiler)."""
    from .bench import N_CHECKED

    return [s for s in (snap or {}).get("samples", [])
            if s["route"] == SEGMENT and s["call"] >= N_CHECKED]


def device_ms_per_replay(snap):
    """Median over the sampled calls of the device time per replay: the
    call's first node to its last, over its replays."""
    ms = [s["device_ms"] / s["n"] for s in window_samples(snap)]
    return statistics.median(ms) if ms else None


def launch_gap_share(snap):
    """The device waiting for the host to launch the next segment (the
    loss read included), in % of the sampled calls' time: each call's gap
    to the next call's first replay over the call's device time and that
    gap."""
    calls = [s for s in window_samples(snap) if s["gap_ms"] is not None]
    if not calls:
        return None
    gaps = sum(s["gap_ms"] for s in calls)
    return 100.0 * gaps / (sum(s["device_ms"] for s in calls) + gaps)


def span_seconds(snap, name: str, routes) -> float:
    """Seconds of the spans ``name`` of ``routes``, or None without one."""
    by_route = (snap or {}).get("totals", {}).get(name, {})
    found = [by_route[r]["total_s"] for r in routes if r in by_route]
    return sum(found) if found else None
