"""Set-up's seconds filling the replay to its start: the ``populate``
span of ``make_collect_graph``'s run (the populate graph's capture is
``setup.capture_s``'s)."""
from port_bench.harness.recorder import POPULATE, snapshot, span_seconds


def read(ctx):
    return span_seconds(snapshot(), "populate", (POPULATE,))
