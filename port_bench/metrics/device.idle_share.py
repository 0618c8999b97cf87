"""The share of the traced stretch in which no operation ran on the card,
in %: 1 - (the union of the device's event intervals) / (the stretch's
wall time)."""


def read(ctx):
    if ctx.trace is None or ctx.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - ctx.trace["busy_s"] / ctx.trace["window_s"])
