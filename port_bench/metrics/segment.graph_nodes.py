"""Nodes of the segment's captured iteration (``port_bench segment``), of
every type: the recorder's counter ``segment.graph_nodes``, set at
capture. A replay launches them all."""
from port_bench.harness.recorder import SEGMENT, snapshot


def read(ctx):
    snap = snapshot()
    nodes = (snap or {}).get("counters", {}).get("segment.graph_nodes", {})
    return nodes.get(SEGMENT)
