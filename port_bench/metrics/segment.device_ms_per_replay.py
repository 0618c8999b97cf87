"""The device's milliseconds per replay of the segment's graph: from a
sampled call's first node to its last (the gaps between nodes and
between the call's replays included) over its replays, median over the
calls the recorder sampled with CUDA events in the untraced window
(``harness/recorder.py``)."""
from port_bench.harness.recorder import device_ms_per_replay, snapshot


def read(ctx):
    return device_ms_per_replay(snapshot())
