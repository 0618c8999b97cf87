"""The device idle between the nodes inside one replay, in %: 1 - (the
traced stretch's busy seconds per iteration) / (the untraced sampled
device time of one replay). Kernel durations are not stretched by the
trace, the gaps between them are, so the busy time is taken from the
trace and the replay's span from the samples."""
from port_bench.harness.recorder import device_ms_per_replay, snapshot


def read(ctx):
    ms = device_ms_per_replay(snapshot())
    if ctx.trace is None or not ctx.trace["iterations"] or not ms:
        return None
    busy = ctx.trace["busy_s"] / ctx.trace["iterations"]
    return 100.0 * (1.0 - busy / (ms * 1e-3))
