"""The whole iteration's share of the card's peak, in %: model FLOPs of
the window's iterations (``harness/work.py::step_flops``: the collect's
forward, and per update the forward, backward and both s' forwards) over
the window's seconds and the configuration's peak (f32 67 TFLOP/s with
TF32 off, bf16 989 TFLOP/s)."""


def read(ctx):
    w = ctx.window
    if not w["iterations"]:
        return None
    flops = ctx.work.step_flops(ctx.net, ctx.config, ctx.traffic) * w[
        "iterations"]
    peak = ctx.work.PEAK_FLOPS[ctx.config["dtype"]]
    return 100.0 * flops / w["seconds"] / peak
