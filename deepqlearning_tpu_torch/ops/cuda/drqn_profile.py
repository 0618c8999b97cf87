"""Device profile of the DRQN loop on one CUDA GPU, by kernel name.

    python3 -m deepqlearning_tpu_torch.ops.cuda.drqn_profile [--iters N]

Builds ``scripts/drqn_bench.py``'s configuration (SimpleGridWorld, 16384
envs, ``Chain(LSTM(2,32), Dense(32,4))``, episode replay of 4096 episodes,
batch 512, trace 8, U = 4, double-Q) through ``build_loop``, populates it,
runs 3 warm-up iterations and then N (default 10) under ``torch.profiler``
(CUDA events and kernels). Prints the card, then one JSON line: device ms,
launches and the busy share per iteration, and every device event name
(kernels, ATen's among them, copies and fills) with its launches and
device ms per iteration, most launches first.

It uses only the package's loop API and seeds its generators itself, so the
file can be copied into another checkout of the port (the same path under
``deepqlearning_tpu_torch/ops/cuda/``) to profile that checkout's loop the
same way, in the same call.
"""
import argparse
import json
import subprocess
import time


def drqn_loop(torch, dev, num_envs=16384):
    """The DRQN configuration's ``(iterate, carry)`` after ``populate``."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, Dense, DQNConfig, EpisodeReplayBuffer,
        LinearDecaySchedule, SimpleGridWorld)
    from deepqlearning_tpu_torch.learner.loop import (
        build_loop, init_carry, populate)

    env = SimpleGridWorld()
    net = Chain(LSTM(2, 32, device=dev), Dense(32, env.num_actions,
                                               device=dev))
    cfg = DQNConfig(num_envs=num_envs, batch_size=512, buffer_size=4096,
                    train_freq=4096, trace_length=8, max_episode_length=100,
                    recurrence=True, double_q=True)
    buf = EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size, cfg.batch_size,
                              cfg.trace_length, cfg.max_episode_length,
                              num_envs=num_envs, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.01, 100_000),
                              gamma=env.discount)
    c = init_carry(env, net, buf, cfg, opt, dev)
    # every env commits an episode before the first sample
    return it, populate(pop, buf, c, cfg.max_episode_length + 1)


def device_profile(torch, it, c, n):
    """``n`` iterations of any loop's ``it`` under ``torch.profiler``:
    ``(carry, summary)`` with device ms, launches and busy share per
    iteration and ``{name: [launches, device ms] per iteration}``, most
    launches first. Only the device's own events count (kernels, copies,
    fills): an ATen op's or a runtime call's device time is that of the
    kernels it launched, which are counted already."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            c = it(c)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    names = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            k = names.setdefault(e.name, [0, 0.0])
            k[0] += 1
            k[1] += e.time_range.elapsed_us()
    dev_us = sum(v[1] for v in names.values())
    return c, dict(
        device_ms=round(dev_us * 1e-3 / n, 4),
        launches=round(sum(v[0] for v in names.values()) / n, 1),
        busy=round(dev_us * 1e-6 / wall, 4),
        by_name={k: [v[0] / n, round(v[1] * 1e-3 / n, 4)] for k, v in
                 sorted(names.items(), key=lambda kv: -kv[1][0])})


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("drqn_profile: no CUDA device")
    torch.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    it, c = drqn_loop(torch, dev)
    for _ in range(3):  # warm-up
        c = it(c)
    c, summary = device_profile(torch, it, c, args.iters)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps(dict(iters=args.iters, loss=float(c.loss), **summary)))


if __name__ == "__main__":
    main()
