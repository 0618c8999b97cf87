"""Forward calls of the Soft MoE layer in one iteration of the segment's
graph (``port_bench segment``): the recorder's counter
``segment.layer_calls.soft_moe``, put at capture from the calls that the
captured iteration made. None from a program that puts none."""
from port_bench.harness.recorder import SEGMENT, snapshot


def read(ctx):
    counters = (snapshot() or {}).get("counters", {})
    return counters.get("segment.layer_calls.soft_moe", {}).get(SEGMENT)
