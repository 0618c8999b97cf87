#!/usr/bin/env python3
"""Smoke run of deepqlearning_tpu_torch on one CUDA GPU (NVIDIA Hopper).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the hand-written kernels from ``deepqlearning_tpu_torch/csrc``
(into ``csrc/_build/``), and in phases, each printing a line:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off;
2. build: compiles the kernel library, prints the seconds;
3. kernels: each kernel against its plain PyTorch twin on the card, at the
   main path's shapes, with stated tolerances, and both times;
4. slice: the small loop on the card against the same loop on the CPU
   (plain twins) with injected uniforms;
5. headline loop: the headline configuration (131072 envs, 2^20 replay,
   batch 512, train_freq 4096) through ``build_loop``, env-steps/s;
6. ungrouped loop: 128 envs, one update per iteration (the K1 path).

The launch counters are zeroed just before phase 5 and read after phase 6:
every kernel of the path must have launched there. Prints the card's line,
a JSON line of per-kernel results, and last the line
``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero; without a CUDA device it exits non-zero before printing a result.
"""
import json
import subprocess
import sys
import time

import numpy as np


def _say(msg):
    print(msg, flush=True)


def _time_ms(fn, iters=20, warmup=2):
    """Mean device time of ``fn`` in ms, by CUDA events around ``iters``
    calls after ``warmup`` calls."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def _check(ok, what):
    if not ok:
        raise AssertionError(what)


def _close(a, b, rtol, atol, what):
    import torch

    a, b = a.detach().float().cpu(), b.detach().float().cpu()
    if not torch.allclose(a, b, rtol=rtol, atol=atol):
        err = (a - b).abs().max().item()
        raise AssertionError(f"{what}: max abs err {err} beyond "
                             f"rtol {rtol} / atol {atol}")
    return (a - b).abs().max().item() if a.numel() else 0.0


def phase_kernels(torch, dev, results):
    from deepqlearning_tpu_torch import (
        Chain, Dense, Flatten, create_dueling_network)
    from deepqlearning_tpu_torch.ops import sumtree
    from deepqlearning_tpu_torch.ops.cuda import (
        fused_collect as fc, fused_update as fu, td_kernel as tk,
        tree_sample as ts)
    from deepqlearning_tpu_torch.envs.gridworld import SimpleGridWorld

    g = torch.Generator(device=dev).manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    uni = lambda *s: torch.rand(*s, generator=g, device=dev)

    # --- K1: B=512, A=4, double-Q and max. loss rtol 1e-5; td/prio/grad
    # atol 1e-6 (the same f32 elementwise math; only the loss sum's order
    # differs)
    B, A = 512, 4
    args = (rnd(B, A), rnd(B, A), rnd(B, A),
            torch.randint(0, A, (B,), generator=g, device=dev),
            rnd(B), (uni(B) < 0.1).float(), uni(B) + 0.5)
    err = 0.0
    for dq in (True, False):
        ko = tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, dq)
        po = tk.td_loss_plain(*args, 0.95, 0.6, 1e-3, dq)
        err = max(err, _close(ko[0], po[0], 1e-5, 1e-6, "K1 loss"))
        for k, p, n in zip(ko[1:], po[1:], ("td", "prio", "grad")):
            err = max(err, _close(k, p, 1e-5, 1e-6, f"K1 {n}"))
    ms = _time_ms(lambda: tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, True), 200)
    pms = _time_ms(lambda: tk.td_loss_plain(*args, 0.95, 0.6, 1e-3, True), 200)
    results["td_loss"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    _say(f"K1 td_loss B=512 A=4: ok, max_abs_err {err:.3g}, "
         f"kernel {ms:.4f} ms, plain {pms:.4f} ms")

    # --- K2: 2^20 leaves / 16384 draws and 4096 / 600. Indices >= 99%
    # exact and the rest adjacent (the twin's cumsum sums in another
    # order); priorities equal to the returned leaf's value.
    err = 0.0
    timing = None
    for cap, D in ((1 << 20, 16384), (4096, 600)):
        tree = sumtree.init_tree(cap, dev)
        sumtree.set_priorities_slice(tree, 0, uni(cap) + 0.01)
        mass = sumtree.stratified_mass(tree, uni(D))
        ik, pk = ts.tree_sample_cuda(tree, mass)
        ip, pp = ts.tree_sample_plain(tree, mass)
        ik = ik.long()
        exact = (ik == ip).float().mean().item()
        _check(exact >= 0.99, f"K2 {cap}/{D}: only {exact:.4f} exact")
        _check((ik - ip).abs().max().item() <= 1, f"K2 {cap}/{D}: not adjacent")
        _check(torch.equal(pk, tree[0][ik]), f"K2 {cap}/{D}: prio != leaf")
        err = max(err, (ik - ip).abs().max().item())
        if timing is None:
            timing = (_time_ms(lambda: ts.tree_sample_cuda(tree, mass), 100),
                      _time_ms(lambda: ts.tree_sample_plain(tree, mass), 100))
        _say(f"K2 tree_sample {cap} leaves / {D} draws: ok, exact {exact:.5f}")
    results["tree_sample"] = dict(max_abs_err=float(err), ms=timing[0],
                                  plain_ms=timing[1])
    _say(f"K2 tree_sample 2^20/16384: kernel {timing[0]:.4f} ms, "
         f"plain {timing[1]:.4f} ms")

    # --- K3: U=32, B=512, dueling 2->64->64->4 double-Q lr 1e-4, and a
    # plain chain with max. params rtol 2e-4 / atol 2e-5 and loss rtol
    # 1e-4, gnorm rtol 1e-3 (the JAX package's fused-vs-XLA tolerances);
    # td/prio rtol 1e-4 / atol 1e-5.
    U, B = 32, 512
    err = 0.0
    timing = None
    for dueling, double_q in ((True, True), (False, False)):
        chain = Chain(Flatten(), Dense(2, 64, torch.tanh, device=dev),
                      Dense(64, 64, torch.tanh, device=dev),
                      Dense(64, 4, device=dev))
        net = create_dueling_network(chain) if dueling else chain
        plan = fu.plan_for(net)
        _check(plan is not None, "K3 plan")
        params = net.init(g)
        n = U * B
        data = dict(obs=uni(n, 2) * 10, nobs=uni(n, 2) * 10,
                    action=torch.randint(0, 4, (n,), generator=g, device=dev),
                    reward=rnd(n), done=(uni(n) < 0.05).float(),
                    weights=uni(n) + 0.5, q_sp_tgt=rnd(n, 4))
        kw = dict(gamma=0.95, double_q=double_q, lr=1e-4, alpha=0.6,
                  eps=1e-3, batch_size=B, n_updates=U)

        def state():
            p = {k: v.clone() for k, v in params.items()}
            z = {k: torch.zeros_like(v) for k, v in params.items()}
            return (p, z, {k: v.clone() for k, v in z.items()},
                    torch.zeros((), dtype=torch.int32, device=dev))

        ks, ps = state(), state()
        ko = fu.fused_group_update_cuda(plan, *ks, **data, **kw)
        po = fu.fused_group_update_plain(plan, *ps, **data, **kw)
        for k in plan.names:
            err = max(err, _close(ks[0][k], ps[0][k], 2e-4, 2e-5, f"K3 {k}"))
        err = max(err, _close(ko[0], po[0], 1e-4, 1e-5, "K3 td"))
        err = max(err, _close(ko[1], po[1], 1e-4, 1e-5, "K3 prio"))
        err = max(err, _close(ko[2], po[2], 1e-4, 0.0, "K3 loss"))
        err = max(err, _close(ko[3], po[3], 1e-3, 1e-7, "K3 gnorm"))
        _check(int(ks[3]) == int(ps[3]) == U, "K3 count")
        if timing is None:
            timing = (
                _time_ms(lambda: fu.fused_group_update_cuda(
                    plan, *state(), **data, **kw), 10),
                _time_ms(lambda: fu.fused_group_update_plain(
                    plan, *state(), **data, **kw), 3, 1))
        _say(f"K3 fused_group_update dueling={dueling} double_q={double_q} "
             f"U=32 B=512: ok")
    results["fused_group_update"] = dict(max_abs_err=err, ms=timing[0],
                                         plain_ms=timing[1])
    _say(f"K3 fused_group_update U=32 B=512: kernel {timing[0]:.4f} ms, "
         f"plain {timing[1]:.4f} ms")

    # --- K4: E=131072 GridWorld, shared uniforms. Actions equal for
    # >= 99.99% of envs, a differing env's top-two Q within 1e-5; the other
    # outputs compared on agreeing envs (rtol/atol 1e-6: the same f32 env
    # math); totals rtol 1e-5 when every action agrees.
    env = SimpleGridWorld()
    E = 131072
    net = create_dueling_network(Chain(
        Flatten(), Dense(2, 64, torch.tanh, device=dev),
        Dense(64, 64, torch.tanh, device=dev), Dense(64, 4, device=dev)))
    plan = fc.collect_plan_for(env, net, None)
    _check(plan is not None, "K4 plan")
    params = net.init(g)
    gen_env = torch.Generator(device=dev).manual_seed(1)
    st, obs = env.reset_batch(E, gen_env)
    st[:, 2] = (uni(E) < 0.05).float()
    ins = dict(obs=obs, state=st,
               ep_step=torch.randint(0, 100, (E,), generator=g, device=dev,
                                     dtype=torch.int32),
               ep_ret=rnd(E), u=uni(6, E), eps=0.3, max_episode_length=100)
    ko = fc.fused_collect_cuda(env, plan, params, **ins)
    po = fc.fused_collect_plain(env, plan, params, **ins)
    agree = ko[0][:, 4] == po[0][:, 4]
    frac = agree.float().mean().item()
    _check(frac >= 0.9999, f"K4 actions agree on only {frac:.6f}")
    if not bool(agree.all()):
        q = fu.q_values(plan.net, params, obs[~agree])[0]
        top2 = q.topk(2, dim=1).values
        _check(bool(((top2[:, 0] - top2[:, 1]) <= 1e-5).all()),
               "K4 differing action without a near tie")
    err = 0.0
    for k, p, n in zip(ko[:5], po[:5], ("fields", "obs", "state", "ep_step",
                                        "ep_ret")):
        err = max(err, _close(k[agree], p[agree], 1e-6, 1e-6, f"K4 {n}"))
    if bool(agree.all()):
        err = max(err, _close(ko[5], po[5], 1e-5, 1e-3, "K4 totals"))
    ms = _time_ms(lambda: fc.fused_collect_cuda(env, plan, params, **ins), 50)
    pms = _time_ms(lambda: fc.fused_collect_plain(env, plan, params, **ins), 20)
    results["fused_collect"] = dict(max_abs_err=err, ms=ms, plain_ms=pms)
    _say(f"K4 fused_collect E=131072: ok, actions agree {frac:.6f}, "
         f"kernel {ms:.4f} ms, plain {pms:.4f} ms")


def _small_loop(torch, dev, sample_u, collect_u):
    from deepqlearning_tpu_torch import (
        Chain, Dense, DQNConfig, Flatten, LinearDecaySchedule,
        PrioritizedReplayBuffer, SimpleGridWorld, create_dueling_network)
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry
    from deepqlearning_tpu_torch.models.chain import params_of

    env = SimpleGridWorld()
    net = create_dueling_network(Chain(
        Flatten(), Dense(2, 16, torch.tanh), Dense(16, 16, torch.tanh),
        Dense(16, 4)))
    net.init(torch.Generator().manual_seed(0))  # same weights on both devices
    net.to(dev)
    cfg = DQNConfig(num_envs=128, batch_size=32, buffer_size=1024,
                    train_freq=32, max_episode_length=5,
                    target_update_freq=256, learning_rate=1e-3)
    buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.05, 500), 0.95)
    c = init_carry(env, net, buf, cfg, opt, dev, params=params_of(net))
    st, obs = env.reset_cols(collect_u[0][:2].to(dev))
    cc = (c.actor._replace(env_state=st, obs=obs), c.replay, c.params)
    for i in range(2):
        cc = pop(cc, None, collect_u[i].to(dev))
    c = c._replace(actor=cc[0], replay=cc[1])
    for i in range(2):
        c = it(c, collect_u=[collect_u[2 + i].to(dev)],
               sample_u=[sample_u[i].to(dev)])
    return c


def phase_slice(torch, dev):
    """The small loop (128 envs, U=4, B=32) on the card vs on the CPU from
    the same seed and uniforms. Params rtol 1e-3 / atol 1e-4 and replay rows
    exact on envs whose actions agree: the card sums in other orders."""
    rng = np.random.default_rng(0)
    collect_u = [torch.from_numpy(rng.random((6, 128), np.float32))
                 for _ in range(4)]
    sample_u = [torch.from_numpy(rng.random(128, np.float32))
                for _ in range(2)]
    cg = _small_loop(torch, dev, sample_u, collect_u)
    torch.cuda.synchronize()
    cc = _small_loop(torch, torch.device("cpu"), sample_u, collect_u)
    err = 0.0
    for k in cc.params:
        err = max(err, _close(cg.params[k], cc.params[k], 1e-3, 1e-4,
                              f"slice {k}"))
    _close(cg.loss, cc.loss, 1e-3, 1e-5, "slice loss")
    rows_g, rows_c = cg.replay.rows.cpu(), cc.replay.rows
    agree = (rows_g[:, 4] == rows_c[:, 4]).float().mean().item()
    _check(agree >= 0.99, f"slice replay actions agree on only {agree}")
    _say(f"slice GPU vs CPU (128 envs, U=4, B=32, 2 iterations): ok, "
         f"params max_abs_err {err:.3g}, replay actions agree {agree:.4f}")


def _loop(torch, dev, num_envs, buffer_size, batch_size, train_freq,
          n_iters, n_pop):
    from deepqlearning_tpu_torch import (
        Chain, Dense, DQNConfig, Flatten, LinearDecaySchedule,
        PrioritizedReplayBuffer, SimpleGridWorld, create_dueling_network)
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry

    env = SimpleGridWorld()
    net = create_dueling_network(Chain(
        Flatten(), Dense(2, 64, torch.tanh, device=dev),
        Dense(64, 64, torch.tanh, device=dev),
        Dense(64, env.num_actions, device=dev)))
    cfg = DQNConfig(num_envs=num_envs, batch_size=batch_size,
                    buffer_size=buffer_size, train_freq=train_freq,
                    max_episode_length=100, double_q=True, dueling=True,
                    prioritized_replay=True)
    buf = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size,
        alpha=cfg.prioritized_replay_alpha, beta=cfg.prioritized_replay_beta,
        eps=cfg.prioritized_replay_epsilon, prioritized=True, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.01, 100_000),
                              gamma=env.discount)
    c = init_carry(env, net, buf, cfg, opt, dev)
    cc = (c.actor, c.replay, c.params)
    for _ in range(n_pop):
        cc = pop(cc, c.generator)
    c = c._replace(actor=cc[0], replay=cc[1])
    c = it(c)  # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n_iters):
        c = it(c)
    loss = float(c.loss)  # device -> host read ends the timed region
    dt = time.perf_counter() - t0
    _check(np.isfinite(loss) and np.isfinite(float(c.gnorm)), "loss finite")
    _check(all(bool(torch.isfinite(p).all()) for p in c.params.values()),
           "params finite")
    _check(c.replay.size > 0 and int(c.actor.ep_count) > 0, "loop progress")
    sps = n_iters * cfg.env_steps_per_iter / dt
    return cfg, sps, loss


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from deepqlearning_tpu_torch.ops.cuda import (
        build, fused_collect as fc, fused_update as fu, td_kernel as tk,
        tree_sample as ts)

    # 1. device
    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _say(f"device: {torch.cuda.get_device_name(0)} | torch {torch.__version__}"
         f" cuda {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    _say(f"build: {time.perf_counter() - t0:.2f} s -> "
         f"{build._library_path().name}")

    # 3. kernels vs plain
    results = {}
    phase_kernels(torch, dev, results)

    # 4. the small slice on the card vs the CPU
    phase_slice(torch, dev)

    # 5. + 6. the main path, counters from zero
    wrappers = {"td_loss": tk.td_loss_cuda, "tree_sample": ts.tree_sample_cuda,
                "fused_group_update": fu.fused_group_update_cuda,
                "fused_collect": fc.fused_collect_cuda}
    for w in wrappers.values():
        w.launches = 0
    cfg, sps, loss = _loop(torch, dev, 131072, 1 << 20, 512, 4096, 20, 2)
    head = {k: w.launches for k, w in wrappers.items()}
    for k in ("tree_sample", "fused_group_update", "fused_collect"):
        _check(head[k] > 0, f"headline loop did not launch {k}")
    _say(f"headline loop: 131072 envs, 2^20 replay, batch 512, U="
         f"{cfg.updates_per_iter}: {sps:.1f} env-steps/s, loss {loss:.5g} "
         f"| {card} | launches {head}")
    cfg, sps2, loss2 = _loop(torch, dev, 128, 4096, 32, 128, 20, 4)
    launches = {k: w.launches for k, w in wrappers.items()}
    for k in ("td_loss", "tree_sample", "fused_collect"):
        _check(launches[k] > head[k], f"ungrouped loop did not launch {k}")
    _say(f"ungrouped loop: 128 envs, batch 32, U={cfg.updates_per_iter}: "
         f"{sps2:.1f} env-steps/s, loss {loss2:.5g} | {card}")

    src = {
        "td_loss": ("deepqlearning_tpu_torch/csrc/td_kernel.cu",
                    "deepqlearning_tpu/ops/pallas/td_kernel.py:72"),
        "tree_sample": ("deepqlearning_tpu_torch/csrc/tree_sample.cu",
                        "deepqlearning_tpu/ops/pallas/tree_sample.py:195"),
        "fused_group_update": (
            "deepqlearning_tpu_torch/csrc/fused_update.cu",
            "deepqlearning_tpu/ops/pallas/fused_update.py:421"),
        "fused_collect": ("deepqlearning_tpu_torch/csrc/fused_collect.cu",
                          "deepqlearning_tpu/ops/pallas/fused_collect.py:434"),
    }
    kernels = [dict(name=k, route="cuda", source=src[k][0],
                    replaces=src[k][1], launches=launches[k], **results[k])
               for k in wrappers]
    _say(card)
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
