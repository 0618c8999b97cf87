"""Set-up's seconds making the two CUDA graphs (populate's and the
segment's): their ``segment.capture`` spans, each a warm-up, the capture
with its node count, and the guard replay."""
from port_bench.harness.recorder import (
    POPULATE, SEGMENT, snapshot, span_seconds)


def read(ctx):
    return span_seconds(snapshot(), "segment.capture", (POPULATE, SEGMENT))
