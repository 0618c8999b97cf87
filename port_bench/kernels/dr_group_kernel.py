"""K5, the recurrent grouped update (``csrc/fused_drqn.cu``,
``dr_group_kernel``): per launch the U sub-updates of B windows of T
steps, each the unroll over s' for the double-Q argmax, the unroll over s,
the masked Huber loss, BPTT and Adam. FLOPs as
``chip_smoke.py::_drqn_update_flops`` counts them: ``2·U·B·T·macs·((2 if
double-Q else 1) + 2)``, ``macs`` the cell's ``(cin + H)·G`` and the
Dense layers' multiply-adds of one step: the forward on s (and on s'),
and the backward at twice the forward (the weight gradient and the input
and state gradient). Bytes: each input read once: the windows' obs and
next obs (f32), actions (int32), reward, done and mask (f32) and the
target net's Q(s') (f32, A per step), the U·B·T window steps of each; the
parameters and both Adam moments read and written once; the count read
and written, the loss and the gradient's max-abs written."""


def work(ctx):
    w, c, t = ctx.work, ctx.config, ctx.traffic
    steps = t["updates_per_iter"] * t["batch_size"] * t["trace_length"]
    macs = sum(sum(m) for m in ctx.net.macs())
    flops = 2 * steps * macs * ((2 if c["double_q"] else 1) + 2)
    A, P = ctx.net.num_actions, ctx.net.n_params()
    nbytes = (steps * (4 * 2 * w.obs_numel(c) + 4 + 4 * 3 + 4 * A)
              + 4 * 6 * P + 8 + 8)
    return flops, nbytes
