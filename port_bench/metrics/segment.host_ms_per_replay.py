"""The host's milliseconds to launch one iteration's graph: the host clock
around ``run_segment`` alone (the enqueue, no synchronise), per
iteration, median over the window's segments."""
from port_bench.harness.readers import median


def read(ctx):
    return median(ctx.window["host_ms"])
