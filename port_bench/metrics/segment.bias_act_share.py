"""The share of the Conv2D and Dense forwards in one iteration of the
segment's graph (``port_bench segment``) whose epilogue (bias, activation,
casts) took the hand-written kernel K10 rather than the ATen chain, in %:
the recorder's counter ``segment.layer_calls.bias_act_kernel`` over its sum
with ``.bias_act_plain``, both put at capture. None from a program that
puts neither, or where the iteration ran no such layer."""
from port_bench.harness.recorder import SEGMENT, snapshot


def read(ctx):
    counters = (snapshot() or {}).get("counters", {})
    kernel, plain = (
        counters.get(f"segment.layer_calls.bias_act_{k}", {}).get(SEGMENT)
        for k in ("kernel", "plain"))
    if kernel is None and plain is None:
        return None
    total = (kernel or 0) + (plain or 0)
    return 100.0 * (kernel or 0) / total if total else None
