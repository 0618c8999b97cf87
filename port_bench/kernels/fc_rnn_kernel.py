"""K6, the recurrent collect (``csrc/fused_collect.cu``,
``fc_rnn_kernel``): per launch one ε-greedy step of every env, the cell's
step on the observation and the env's state row, zeroed where the episode
ended, then K4's work on the cell's output. FLOPs and bytes: K4's
(``kernels/fc_kernel.py``: the forward over every env, the cell's
multiply-adds and parameters in it), and the cell's state rows read and
written once, ``S`` f32 per env (``h`` and ``c``: ``2H`` for an LSTM)."""
import torch


def work(ctx):
    flops, nbytes = ctx.registry.kernel("fc_kernel").work(ctx)
    state = ctx.net.init_state(1, torch.float32, "cpu")
    S = sum(x.shape[1] for s in state if s is not None for x in s)
    return flops, nbytes + 2 * 4 * ctx.traffic["num_envs"] * S
