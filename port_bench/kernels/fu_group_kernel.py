"""K3, the grouped update (``csrc/fused_update.cu``): per launch the U
sub-updates of B rows, each the forward on s and on s' (double-Q), the
TD loss, the backward (every weight gradient and every input gradient
but the observation's) and Adam. Bytes: each input read once (both
observations, action as int64, reward, done, weight, the target's Q(s'),
parameters and both moments) and each output written once (parameters,
moments, TD errors, priorities, loss, gradient norm)."""


def work(ctx):
    w, c, t = ctx.work, ctx.config, ctx.traffic
    rows = t["updates_per_iter"] * t["batch_size"]
    f = w.forward_flops(ctx.net)
    per_row = f * (2 if c["double_q"] else 1) + f + f - w.first_layer_flops(
        ctx.net)
    A = ctx.net.num_actions
    P = ctx.net.n_params()
    nbytes = (rows * (4 * 2 * w.obs_numel(c) + 8 + 4 * 3 + 4 * A)
              + 4 * 3 * P + 4 * 3 * P + rows * 8 + 8)
    return rows * per_row, nbytes
