"""K11, the target net's Q(s') (``csrc/fused_drqn.cu``,
``dr_target_kernel``): per launch the frozen target net's zero-state unroll
over every window of an iteration, the U·B windows of T steps, forward
only. FLOPs as ``kernels/dr_group_kernel.py`` counts K5's forward:
``2·U·B·T·macs``, ``macs`` the cell's ``(cin + H)·G`` and the Dense
layers' multiply-adds of one step. Bytes: the windows' next obs (f32) read
once, Q(s') (f32, A per step) written once and the parameters read once."""


def work(ctx):
    w, c, t = ctx.work, ctx.config, ctx.traffic
    steps = t["updates_per_iter"] * t["batch_size"] * t["trace_length"]
    macs = sum(sum(m) for m in ctx.net.macs())
    A, P = ctx.net.num_actions, ctx.net.n_params()
    return 2 * steps * macs, 4 * steps * (w.obs_numel(c) + A) + 4 * P
