"""Device profile of a loop on one CUDA GPU, by kernel name.

    python3 -m deepqlearning_tpu_torch.ops.cuda.loop_profile \
        [--loop drqn|u1] [--iters N]

``--loop drqn`` (the default) builds ``scripts/drqn_bench.py``'s
configuration (SimpleGridWorld, 16384 envs, ``Chain(LSTM(2,32),
Dense(32,4))``, episode replay of 4096 episodes, batch 512, trace 8, U = 4,
double-Q); ``--loop u1`` the iteration of ``DeepQLearningSolver.solve`` at
U = 1 that ``chip_smoke.py`` phases 11 (a) and 14 drive (SimpleGridWorld,
4096 envs = train_freq, the headline's dueling 2-64-64-4 tanh net, PER of 2^18
slots, batch 512, double-Q, a target sync every 8 iterations). Either goes
through ``build_loop``, is populated, runs 3 warm-up iterations, N
(default 10) each timed on the host from an idle queue (the enqueue), and
N under ``torch.profiler`` (CUDA events and kernels) after one more that
primes the session (:func:`traced`). Prints the card,
then one JSON line: host enqueue, device ms, launches and the busy share
per iteration, the port's kernels and the rest (ATen's kernels, copies,
fills) with their launches and device ms per iteration, and every device
event name, most launches first.

It uses only the package's loop API and seeds its generators itself, so the
file (with ``kernel_events.py`` beside it) can be copied into another
checkout of the port (the same path under
``deepqlearning_tpu_torch/ops/cuda/``) to profile that checkout's loop the
same way, in the same call.
"""
import argparse
import json
import re
import subprocess
import time

from .kernel_events import kernel_symbol


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


def u1_loop(torch, dev, num_envs=4096):
    """``solve``'s U = 1 iteration (``chip_smoke.py`` phase 11 (a)'s
    configuration, which phase 14 builds through its own ``_loop``) as
    ``(iterate, carry)`` after 4 populate steps: one K4 collect step, one K2
    draw, one update with the K1 loss head. Kept here so that this file
    alone profiles the iteration in another checkout of the port."""
    from deepqlearning_tpu_torch import (
        Chain, Dense, DQNConfig, Flatten, LinearDecaySchedule,
        PrioritizedReplayBuffer, SimpleGridWorld, create_dueling_network)
    from deepqlearning_tpu_torch.learner.loop import (
        build_loop, init_carry, populate)

    env = SimpleGridWorld()
    net = create_dueling_network(Chain(
        Flatten(), Dense(2, 64, torch.tanh, device=dev),
        Dense(64, 64, torch.tanh, device=dev),
        Dense(64, env.num_actions, device=dev)))
    cfg = DQNConfig(num_envs=num_envs, batch_size=512, buffer_size=1 << 18,
                    train_freq=num_envs, target_update_freq=8 * num_envs,
                    max_episode_length=100, double_q=True, dueling=True,
                    prioritized_replay=True)
    buf = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size,
        alpha=cfg.prioritized_replay_alpha, beta=cfg.prioritized_replay_beta,
        eps=cfg.prioritized_replay_epsilon, prioritized=True, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.01, 100_000),
                              gamma=env.discount)
    return it, populate(pop, buf, init_carry(env, net, buf, cfg, opt, dev),
                        4)


def port_kernels():
    """The symbols of the port's kernels, read from its CUDA sources."""
    from deepqlearning_tpu_torch.ops.cuda import build

    pat = re.compile(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)"
                     r"\s*)?(\w+)\s*\(")
    return {m.group(1) for src in build.sources()
            for m in pat.finditer(src.read_text())}


def enqueue_ms(torch, it, c, n):
    """``(carry, host ms per iteration)``: ``n`` iterations, each from an
    idle queue and timed until ``it`` returns."""
    total = 0.0
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        c = it(c)
        total += time.perf_counter() - t0
    return c, 1e3 * total / n


PAUSE = "loop_profile pause"


def traced(torch, prime, fn):
    """``(fn(), [device events], wall s of fn)``: ``prime()``, a marked
    pause of 20 ms and ``fn()`` in one ``torch.profiler`` session, and the
    device's events (kernels, copies, fills) that start after the pause.
    The profiler can lose the first records of a CUDA graph's first launch
    in a session: the head of that replay, which grows the longer the
    process has replayed graphs (on an H100 it has reached past the first
    three port kernels of a 1370-node replay). It lost none of a graph's
    later launches in a session, so ``prime()`` launches each graph that
    ``fn()`` replays once and only what follows counts."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prime()
        torch.cuda.synchronize()
        with record_function(PAUSE):
            time.sleep(0.02)
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = prof.events()
    pause = next(e for e in events if e.name == PAUSE)
    cut = 0.5 * (pause.time_range.start + pause.time_range.end)
    return out, [e for e in events if e.device_type == DeviceType.CUDA
                 and e.time_range.start >= cut], wall


def device_profile(torch, it, c, n):
    """``n`` iterations of any loop's ``it`` under ``torch.profiler``,
    after one that primes the session (:func:`traced`): ``(carry,
    summary)`` with device ms, launches and busy share per iteration,
    ``by_kernel``: ``{port kernel symbol or "other": [launches, device ms]
    per iteration}`` (other: ATen's kernels, copies, fills), and
    ``by_name``: the same for every event name, most launches first. Only
    the device's own events count (kernels, copies, fills): an ATen op's or
    a runtime call's device time is that of the kernels it launched, which
    are counted already. The carry comes back ``n + 1`` iterations on."""
    box = [c]

    def prime():
        box[0] = it(box[0])

    def run():
        x = box[0]
        for _ in range(n):
            x = it(x)
        return x

    c, events, wall = traced(torch, prime, run)
    names = {}
    for e in events:
        k = names.setdefault(e.name, [0, 0.0])
        k[0] += 1
        k[1] += e.time_range.elapsed_us()
    dev_us = sum(v[1] for v in names.values())
    ours, kernels, other = port_kernels(), {}, [0, 0.0]
    for k, (count, us) in names.items():
        sym = kernel_symbol(k)
        acc = kernels.setdefault(sym, [0, 0.0]) if sym in ours else other
        acc[0] += count
        acc[1] += us
    kernels["other"] = other
    per_iter = lambda v: [v[0] / n, round(v[1] * 1e-3 / n, 6)]
    return c, dict(
        device_ms=round(dev_us * 1e-3 / n, 4),
        launches=round(sum(v[0] for v in names.values()) / n, 1),
        busy=round(dev_us * 1e-6 / wall, 4),
        by_kernel={k: per_iter(v) for k, v in kernels.items()},
        by_name={k: per_iter(v) for k, v in
                 sorted(names.items(), key=lambda kv: -kv[1][0])})


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--loop", choices=("drqn", "u1"), default="drqn")
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("loop_profile: no CUDA device")
    torch.manual_seed(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    it, c = (drqn_loop if args.loop == "drqn" else u1_loop)(torch, dev)
    for _ in range(3):  # warm-up
        c = it(c)
    c, enq = enqueue_ms(torch, it, c, args.iters)
    c, summary = device_profile(torch, it, c, args.iters)
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0])
    print(json.dumps(dict(loop=args.loop, iters=args.iters,
                          loss=float(c.loss), enqueue_ms=enq, **summary)))


if __name__ == "__main__":
    main()
