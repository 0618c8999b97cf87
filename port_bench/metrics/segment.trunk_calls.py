"""Forward calls of the conv trunk's layers in one iteration of the
segment's graph (``port_bench segment``): the sum of the recorder's
counters ``segment.layer_calls.conv2d``, ``.maxpool2d`` and ``.residual``,
put at capture from the calls that the captured iteration made. None
from a program that puts none of them."""
from port_bench.harness.recorder import SEGMENT, snapshot

LAYERS = ("conv2d", "maxpool2d", "residual")


def read(ctx):
    counters = (snapshot() or {}).get("counters", {})
    calls = [counters.get(f"segment.layer_calls.{k}", {}).get(SEGMENT)
             for k in LAYERS]
    found = [c for c in calls if c is not None]
    return sum(found) if found else None
