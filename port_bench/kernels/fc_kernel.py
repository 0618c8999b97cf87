"""K4, the fused collect (``csrc/fused_collect.cu``): per launch one
ε-greedy step of every env: the Q forward, the env step and reset, the
transition's fields. Bytes: observation, env state (its width from the
env's file), episode step (int32) and return, the uniforms (2 and the
env's step and reset uniforms) and the parameters read once; the fields
(obs, next obs, action, reward, done, ended), the next observation and
state, episode step and return, and three totals written once."""


def work(ctx):
    w, c, t = ctx.work, ctx.config, ctx.traffic
    E, no = t["num_envs"], w.obs_numel(c)
    env = ctx.registry.env(c["env"]["kind"])  # envs/<kind>.py
    W = env.STATE_WIDTH
    nu = 2 + env.STEP_UNIFORMS + env.RESET_UNIFORMS
    reads = E * (4 * no + 4 * W + 4 + 4 + 4 * nu) + 4 * ctx.net.n_params() + 4
    writes = E * (4 * (2 * no + 4) + 4 * no + 4 * W + 4 + 4) + 12
    return E * w.forward_flops(ctx.net), reads + writes
