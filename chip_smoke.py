#!/usr/bin/env python3
"""Smoke run of deepqlearning_tpu_torch on one CUDA GPU (NVIDIA Hopper).

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It builds the hand-written kernels from ``deepqlearning_tpu_torch/csrc``
(into ``csrc/_build/``), and in phases, each printing a line:

1. device: requires CUDA, prints the card's name and power limit, turns
   TF32 off;
2. build: compiles the kernel library, prints the seconds; then the
   replay buffers and ``init_carry`` built with no ``device`` argument must
   hold their tensors on the card;
3. kernels: each kernel (K1-K11) against its plain PyTorch twin on the
   card, at the main paths' shapes, with stated tolerances, both times and
   the kernel's bound (the least time for the same bytes or FLOPs on the
   card) and its share of it (K3/K5 also against the tile-order reference
   and two runs bit for bit, K8 against its tile-order reference; K7/K8
   also run the data-parallel update, K7/K8 and an Adam launch per
   sub-update, against K3's/K5's update, bit for bit, and its twin; K2
   equal to its scan-order reference bit for bit, K2 and K6 two runs bit
   for bit; the double-Q checks allow for near ties of the s' argmax
   and print how many they found; K1 at B = 1 to 10000, A = 4 and 5,
   int64 and int32 actions, out-of-range actions, contiguous and strided
   inputs, two runs bit for bit; K4 and K6 also on CartPole and
   MountainCar at ε = 0.3 and 1, two runs bit for bit, done flags allowed
   to flip only within a few ulps of a threshold, counted; K2 and K3 also
   at the CartPole solve's shapes, 2^16 leaves / 4096 draws in 16 and U =
   16, B = 256 with its dueling 4-64-64-2 net; K1 and K2 also at the
   image-observation DQN's shapes: B = 512, A = 4 on the Q values of its
   bf16 conv net cast to f32, and 2^15 leaves / 2048 draws in 4; K9, the
   plain steps' Adam, at the benchmark's two configurations' parameters,
   3 steps bit for bit, beside the twin eager and as one graph replay;
   K10, the layers' epilogue, forward and backward at the Nature and
   IMPALA cells' shapes, output and product cotangent bit for bit, bias
   gradient within f32 reassociation, beside the twin eager and both as
   one graph replay; K11, the DRQN target net's Q(s'), at the
   ``grid_drqn.learner`` cell's 2048 windows of 8 steps and on three other
   nets (GRU, Dense before the cell, two-layer heads, an odd window
   count, a 64-step trace), within f32 reassociation, two calls and ten
   graph replays bit for bit, beside the twin eager and as one graph
   replay);
   then K1 (B = 32, 512, 4096, and the conv route's), K2 (also the conv
   route's), K4 and K6 (each env), K7, K8, K9 and K10 (forward and
   backward) timed by their device events alone, beside their wrappers'
   CUDA-event times, and an empty kernel launched as K1 is, K1's launch
   floor;
4. slices: the small feed-forward loop (on SimpleGridWorld and on
   CartPole) and the small DRQN loop on the card against the same loops on
   the CPU (plain twins) with injected uniforms and draws; then the full
   conv net of ``examples/image_conv_dqn.py`` (f32 and bf16, B = 512) on
   the card against its CPU forward, cuDNN's TF32 flag on (the layer turns
   it off for f32 itself), and the f32 gradients;
5. headline loop: the headline configuration (131072 envs, 2^20 replay,
   batch 512, train_freq 4096) through ``build_loop``;
6. ungrouped loop: 128 envs, one update per iteration (the K1 path);
   then the grouped plain loop: 2048 envs, U = 4, batch 512, 2^15 PER and
   the 512-wide dueling net of ``examples/image_conv_dqn.py``, which the
   K3 and K4 plans refuse (K1 and K9 exactly U times per iteration, K2,
   the plain collect step; K3, K4 and K7 never);
7. DRQN loop: ``scripts/drqn_bench.py``'s configuration (16384 envs,
   LSTM(2, 32), episode replay, batch 512, trace 8, U = 4), populate and
   the iterations as graph replays (the library called by the graphs'
   warm-ups and captures and one eager warm-up only: K6 5, K5 and K11
   3); then
   MountainCar at the headline's shape (131072 envs, 2^20 PER, batch 512,
   U = 32, dueling 2-64-64-3; episodes cut at 4 steps): K4 on a second env
   inside a loop;
8. DP headline loop: the headline configuration through
   ``DataParallelRunner`` in a one-rank NCCL world (K7, ``pmean_flat``
   and one Adam launch per sub-update), populate and the iterations as
   replays of the runner's CUDA graphs: ``pmean_flat``, K7 and the Adam
   launched U times by each of the segment graph's warm-up and capture,
   K7 U times per replay in a primed trace;
9. DP DRQN loop: the DRQN configuration the same way (K8);
10. two ranks: a small data-parallel slice in two gloo ranks on the one
    card (NCCL refuses two ranks on one device) against the same two-rank
    program on CPU tensors, eager iterations (the gate's route for gloo);
11. solve: ``DeepQLearningSolver.solve`` with ``device=None`` (the card):
    (a) SimpleGridWorld with the headline's dueling net at U = 1 (4096
    envs, batch 512, 2^18 PER, 100 iterations, eval, log and save in a
    temporary logdir; K1, K2 and K4 at least once per iteration, K3
    never), then ``restore_best_model`` and ``resume=True`` for 5 more
    iterations, which continue the saved counters; (b) the DRQN solve
    (LSTM(2, 32), dueling, 1024 envs, U = 1, as graph replays: K5
    launched 2 times, K6 4); (c)
    ``tests/test_learning.py::test_prioritized_ddqn``'s configuration on
    TestMDP, greedy return >= 1.5; (d) the CartPole solve
    at ``examples/cartpole_dqn.py``'s configuration (256 envs, U = 16,
    batch 256, 2^16 PER, 400,000 steps): K4 (CartPole), K2 and K3 exactly
    once per iteration, K1 never, and a greedy return >= 150 of 200 over
    64 episodes; (e) the image-observation DQN's solve at
    ``examples/image_conv_dqn.py``'s configuration (TestMDP with (20, 20, 4)
    obs, 2048 envs, bf16 conv 4-32-64-128 + dueling 3200-512, 2^15 bf16
    PER, batch 512, U = 4, 400,000 steps, 8 evaluations of 128 episodes)
    through the example's ``main``: K1 exactly U and K2 exactly once per
    iteration, K3, K4 and K7 never, a save and a restore, and a best greedy
    return >= 1.0 (optimum 2.1); (f) ``tests/test_learning.py``'s
    ``test_testmdp_drqn`` and ``test_gridworld_ddrqn`` configurations
    (6000 steps each) through ``solve(device=None)``, each greedy return
    >= 0.0 as those tests ask;
18. per-instance envs (after 11): ``torch.func.vmap`` with a CUDA
    generator (each vmapped draw must equal ``torch.rand(E)`` from the
    same state); (a) :func:`user_envs`' GridWorld, written one instance at
    a time with a NamedTuple state and no cols, through ``build_loop`` at
    the headline's shape: K3 and K2 launched by the graph's warm-up and
    capture, K4 and K1 never, its first 2 iterations equal bit for bit to
    the built-in SimpleGridWorld's plain collect loop (or to the built-in
    dynamics on row-wise draws, where one ``[2, E]`` draw does not line up
    with them); (b) the per-instance StaticArrayMDP through
    ``solve(device=None)`` (K1 and K2 once per replay in its trace; greedy
    return > 1.0); (c) the per-instance MiniPOMDP through a DRQN ``solve``
    (K5 once per replay in its trace, K6 never); each as graph replays;
19. compiled segment (after 18): the CUDA graph of one iteration
    (``learner/segment.py``) on the headline, U = 1, grouped plain, conv
    (bf16 and f32), CartPole, DRQN (K5, K6), DRQN plain (autograd BPTT,
    the plain recurrent collect), per-instance GridWorld and the built-in
    SimpleGridWorld with the plain collect (K2, K3), and per-instance
    MiniPOMDP DRQN (K5) routes at full width, and the DP headline (K7), DP
    DRQN (K8) and DP local SGD (k = 2 on the ``(1, 1)`` mesh: two graphs)
    routes in the one-rank NCCL world: 3 replays against 3 eager
    iterations from cloned carries, every tensor and the generator's state
    bit for bit; the replays draw fresh numbers (they differ from eager
    iterations that reuse one generator state); the launches per
    iteration of :func:`_segment_routes`' table at the warm-ups and
    captures and in a trace of the replays; ``torch.cuda.memory_allocated``
    flat over 100 replays; then ``basic_evaluation``'s graphs on 11 (a),
    (b) and (e)'s evaluations against the eager rollout bit for bit, the
    caller's generator included, and an env with a Python counter must
    make it raise. Last of all, a ``select_fn`` that reads the device from
    the host (``.item()``) must make ``solve`` raise.
    ``python3 chip_smoke.py --segment-only`` runs phases 1, 2 and 19.

Phases 12-17 are unused: the benchmark times and profiles the loops
(``python3 port_bench/run.py --workload <cell> --trace 1``). The loops of
phases 5-9 and the solves of 11 and 18 run as replays of their CUDA
graphs, as ``solve`` runs them, and so do their greedy evaluations; 11
(d) and (e) on seeds 0, 1 and 2, each gated. ``torch.profiler`` can lose
the first records of a graph's first launch in a session, so each trace
that counts a graph's launches either primes the session with one launch
(``port_bench/harness/trace.py::traced``: phases 8, 9 and 19) or leaves
each graph's first launch out (11 (a)'s resume, 18 (b) and (c)).

Launches are the recorder's ``kernels.launches`` by the library's entry
point (``ops/cuda/build.py``), :data:`KERNELS` gives each entry point's
kernel symbol in a trace. Each of the paths 5 to 9 and each part of 11
and 18 runs with the recorder emptied just before it and read just after:
every kernel of the path must have launched there, K3 / K5 not on the
data-parallel paths, and ``pmean_flat`` (``train.pmean_flat``) once per
sub-update of each traced iteration (the graph's warm-up and capture).
Prints the card's line, a JSON line of per-kernel results, and last the
line ``{"ok": true, "device": {...}}``. Any failed phase raises and exits
non-zero; without a CUDA device it exits non-zero before printing a
result.
"""
import itertools
import json
import os
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


def _nbytes(*xs):
    """Bytes of tensors, or of the tensors in dicts, lists and tuples."""
    n = 0
    for x in xs:
        if isinstance(x, dict):
            n += _nbytes(*x.values())
        elif isinstance(x, (list, tuple)):
            n += _nbytes(*x)
        elif hasattr(x, "element_size"):
            n += x.numel() * x.element_size()
    return n


def _bound(nbytes, flops):
    """``(bound_ms, bound_by)``: the benchmark's bound (``port_bench/
    harness/work.py``: the larger of the bytes over the memory rate and the
    operations over the FP32 rate) and which of the two it is."""
    from port_bench.harness import work

    by = ("bytes" if nbytes / work.PEAK_BYTES
          >= flops / work.PEAK_FLOPS["float32"] else "operations")
    return 1e3 * work.bound_s(flops, nbytes), by


def _macs(layers):
    """Multiply-adds of one row through Dense layers."""
    return sum(lp.din * lp.dout for lp in layers)


def _dense_update_flops(plan, B, U, double_q):
    """FLOPs of U feed-forward sub-updates of B rows: the forward on s (and
    s' for double-Q), dW of every layer and dh of every layer but each
    head's first; 2 per multiply-add."""
    macs = _macs(plan.layers)
    first = sum(h[0].din * h[0].dout for h in (plan.val, plan.adv) if h)
    return 2 * U * B * (macs * (2 if double_q else 1) + macs + macs - first)


def _drqn_update_flops(plan, B, T, U, double_q):
    """FLOPs of U recurrent sub-updates of B windows of T steps: per step
    the Dense layers and the cell's (cin + H) x G gate product, forward on
    s (and s' for double-Q), backward twice the forward (dW and dh)."""
    cp = plan.cell
    macs = _macs(plan.dense) + (cp.in_dim + cp.hidden) * cp.n_gates * cp.hidden
    return 2 * U * B * T * macs * ((2 if double_q else 1) + 2)


def _adam_state(torch, params):
    """A copy of ``params`` with zero Adam moments and an int32 count."""
    z = {k: torch.zeros_like(v) for k, v in params.items()}
    return ({k: v.clone() for k, v in params.items()}, z,
            {k: v.clone() for k, v in z.items()},
            torch.zeros((), dtype=torch.int32,
                        device=next(iter(params.values())).device))


def _kernel_line(name, ms, plain_ms, bound_ms, bound_by):
    return (f"{name}: kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms ({bound_by}), share {bound_ms / ms:.4f}")


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


# The double-Q argmax over the online Q(s') decides each row's target. Where
# a row's top two lie within TIE_GAP (relative to max(1, |Q|)) the kernel
# and its twin may pick different actions: their Q values differ by the f32
# rounding of other sum orders and by the small drift that builds up over
# U sub-updates. Such a row is a near tie.
TIE_GAP = 1e-4


def _near_ties(q, keep):
    """``(index, best, second)`` of each entry of ``q [..., A]`` (an index
    tuple over the leading axes) whose top two values lie within TIE_GAP
    and where ``keep`` is true."""
    top = q.topk(2, dim=-1)
    v, i = top.values, top.indices
    near = (v[..., 0] - v[..., 1]
            <= TIE_GAP * v[..., 0].abs().clamp(min=1.0)) & keep
    return [(tuple(ix), int(i[tuple(ix)][0]), int(i[tuple(ix)][1]))
            for ix in near.nonzero().tolist()]


def _swap_ties(q_sp_tgt, ties):
    """``q_sp_tgt`` with, for each near tie, the target values of its two
    actions swapped: a twin that picks ``best`` then reads the target at
    ``second``, the kernel's other choice."""
    if not ties:
        return q_sp_tgt
    q = q_sp_tgt.clone()
    for ix, b1, b2 in ties:
        q[ix + (b1,)], q[ix + (b2,)] = q_sp_tgt[ix + (b2,)], q_sp_tgt[
            ix + (b1,)]
    return q


def _ff_ties(torch, fu, plan, params, data, kw):
    """The near ties of K3's double-Q argmax along the twin's trajectory:
    the twin run one sub-update at a time, each sub-update's s' rows
    checked before it (rows with done = 1 take no target from s')."""
    U, B = kw["n_updates"], kw["batch_size"]
    st = _adam_state(torch, params)
    ties = []
    for u in range(U):
        part = {k: v[u * B:(u + 1) * B] for k, v in data.items()}
        q = fu.q_values(plan, st[0], part["nobs"])[0]
        ties += [((u * B + r,), b1, b2) for (r,), b1, b2 in
                 _near_ties(q, part["done"] == 0)]
        fu.fused_group_update_plain(plan, *st, **part,
                                    **dict(kw, n_updates=1))
    return ties


def _drqn_ties(torch, fd, plan, params, data, kw):
    """The same for K5: each sub-update's window steps of s' (unrolled from
    the zero state, time-major), those that are masked or done excepted."""
    U, B = kw["n_updates"], kw["batch_size"]
    st = _adam_state(torch, params)
    ties = []
    for u in range(U):
        part = {k: v[u * B:(u + 1) * B] for k, v in data.items()}
        q = fd._unroll(plan, st[0], part["nobs"].transpose(0, 1))
        keep = ((part["done"] == 0) & (part["mask"] > 0)).t()
        ties += [((u * B + b, t), b1, b2) for (t, b), b1, b2 in
                 _near_ties(q, keep)]
        fd.fused_drqn_group_update_plain(plan, *st, **part,
                                         **dict(kw, n_updates=1))
    return ties


def _tie_aware(pairs_fn, ties):
    """Hold a kernel's outputs to its references, allowing for near ties.

    ``pairs_fn(swaps)`` recomputes the references with the near ties in
    ``swaps`` taken the other way (:func:`_swap_ties`) and returns ``(kernel
    out, reference, rtol, atol, name, counts)`` tuples. Every pair must hold
    with no tie swapped; where some do not and there are near ties, the
    kernel's other choices are found one at a time: the tie whose swap
    (beside those found) brings the references closest to the kernel, if
    it at least halves their distance in units of the tolerances, until
    every pair holds or no tie does. A mismatch with no near tie, or one
    that no swap explains, fails as before. Returns ``(max abs error of
    the pairs that count, near ties, ties taken the other way)``."""
    import torch

    def ok(p):
        a, b = p[0].detach().float(), p[1].detach().float()
        return bool(torch.allclose(a, b, rtol=p[2], atol=p[3]))

    def dist(pairs):
        d = 0.0
        for a, b, rtol, atol, _, _ in pairs:
            a, b = a.detach().double(), b.detach().double()
            d += float((((a - b).abs() / (atol + rtol * b.abs())
                         .clamp(min=1e-30)) ** 2).sum())
        return d

    pairs, taken = pairs_fn(()), []
    while not all(ok(p) for p in pairs) and len(taken) < len(ties):
        d0 = dist(pairs)
        best = min(((dist(pairs_fn(tuple(taken) + (t,))), t) for t in ties
                    if t not in taken), key=lambda x: x[0])
        if best[0] > 0.5 * d0:
            break
        taken.append(best[1])
        pairs = pairs_fn(tuple(taken))
    err = 0.0
    for a, b, rtol, atol, what, counts in pairs:
        e = _close(a, b, rtol, atol, what)
        if counts:
            err = max(err, e)
    return err, len(ties), len(taken)


# A done flag of CartPole or MountainCar compares a next-state value with a
# threshold (|x| > 2.4, |theta| > 12 deg, position >= 0.5): where the
# kernel's transcendentals and its twin's differ by an ulp, a value within
# an ulp or two of the threshold may end the episode in one and not the
# other. Such a flip is allowed within FLIP_ULPS ulps of a threshold,
# counted and printed; a flip anywhere else fails.
FLIP_ULPS = 4


def _env_states(torch, env, E, gen):
    """Batched states spread so that many steps end their episode:
    CartPole x in [-2.5, 2.5], theta in [-0.22, 0.22], velocities N(0, 1);
    MountainCar position in [-1.2, 0.55], velocity in [-0.07, 0.07]."""
    dev = gen.device
    r = lambda lo, hi: lo + (hi - lo) * torch.rand(E, generator=gen,
                                                  device=dev)
    n = lambda: torch.randn(E, generator=gen, device=dev)
    from deepqlearning_tpu_torch import CartPole

    if isinstance(env, CartPole):
        return torch.stack([r(-2.5, 2.5), n(), r(-0.22, 0.22), n()], dim=1)
    return torch.stack([r(-1.2, 0.55), r(-0.07, 0.07)], dim=1)


def _done_flips(env, ko, po, keep):
    """Envs among ``keep`` whose done flag the kernel (``ko``) and its twin
    (``po``) set differently; fails unless each lies within FLIP_ULPS ulps
    of a threshold, read from the twin's next state."""
    no = env.obs_shape[0]
    flip = (ko[0][:, 2 * no + 2] != po[0][:, 2 * no + 2]) & keep
    if bool(flip.any()):
        ns = po[0][flip][:, no:2 * no].cpu().numpy()
        from deepqlearning_tpu_torch import CartPole

        tests = ([(np.abs(ns[:, 0]), env.x_threshold),
                  (np.abs(ns[:, 2]), env.theta_threshold)]
                 if isinstance(env, CartPole)
                 else [(ns[:, 0], env.goal_position)])
        near = np.zeros(len(ns), bool)
        for v, thr in tests:
            t = np.float32(thr)
            near |= np.abs(v - t) <= FLIP_ULPS * np.spacing(t)
        _check(bool(near.all()), f"{type(env).__name__}: done flags differ "
               f"away from the thresholds at {ns[~near][:4]}")
    return flip


def _collect_env_check(torch, dev, fc, fu, fd, name, env, net, E, gen):
    """K4 (or K6, for a recurrent net) on ``env`` against its twin on the
    card at ε = 0.3 and ε = 1, each run twice and equal bit for bit.
    Actions equal for >= 99.99% of envs, a differing env's top-two Q
    within 1e-5; done flags equal but for the flips ``_done_flips``
    allows; on the envs where both agree the fields, obs, env state,
    counters and returns at rtol/atol 1e-6 (the same f32 env math; the
    transcendentals may differ by an ulp), the new h/c at 1e-5 (gate sums
    in other orders), the totals at rtol 1e-5 when every env agrees.
    Returns the kernel's JSON fields for this env."""
    plan = fc.collect_plan_for(env, net, None)
    rec = plan is not None and plan.cell is not None
    _check(plan is not None and rec == getattr(net, "recurrent", False),
           f"{name}: plan")
    params = net.init(gen)
    st = _env_states(torch, env, E, gen)
    ins = dict(obs=st.clone(), state=st,
               ep_step=torch.randint(0, 100, (E,), generator=gen, device=dev,
                                     dtype=torch.int32),
               ep_ret=torch.randn(E, generator=gen, device=dev),
               u=torch.rand(plan.n_uniforms, E, generator=gen, device=dev),
               max_episode_length=100)
    if rec:
        ins["nstate"] = torch.randn(E, plan.state_width, generator=gen,
                                    device=dev) * 0.5
    cuda = fc.fused_collect_rnn_cuda if rec else fc.fused_collect_cuda
    err, n_flips, fracs = 0.0, 0, []
    for eps in (0.3, 1.0):
        # ε as the device scalar the kernels read through a pointer, the
        # twin on the same tensor
        e = torch.full((), eps, dtype=torch.float32, device=dev)
        ko = cuda(env, plan, params, eps=e, **ins)
        ko2 = cuda(env, plan, params, eps=e, **ins)
        _check(all(torch.equal(a, b) for a, b in zip(ko, ko2)),
               f"{name} eps={eps}: two runs differ")
        po = fc.fused_collect_plain(env, plan, params, eps=e, **ins)
        no = plan.no
        agree = ko[0][:, 2 * no] == po[0][:, 2 * no]
        frac = agree.float().mean().item()
        fracs.append(frac)
        _check(frac >= 0.9999, f"{name} eps={eps}: actions agree on only "
               f"{frac:.6f}")
        if not bool(agree.all()):
            x = ins["obs"][~agree]
            if rec:
                H = plan.cell.hidden
                ns = ins["nstate"][~agree]
                x, _ = fd.cell_step(plan.cell, params, x, ns[:, :H],
                                    ns[:, H:] if plan.cell.kind == "lstm"
                                    else None)
            top2 = fu.q_values(plan.net, params, x)[0].topk(2, dim=1).values
            _check(bool(((top2[:, 0] - top2[:, 1]) <= 1e-5).all()),
                   f"{name}: differing action without a near tie")
        flips = _done_flips(env, ko, po, agree)
        n_flips += int(flips.sum())
        keep = agree & ~flips
        names = ("fields", "obs", "state", "ep_step", "ep_ret")
        for k, p, n in zip(ko[:5], po[:5], names):
            err = max(err, _close(k[keep], p[keep], 1e-6, 1e-6,
                                  f"{name} eps={eps} {n}"))
        if rec:
            err = max(err, _close(ko[6][keep], po[6][keep], 1e-5, 1e-5,
                                  f"{name} eps={eps} h/c"))
        if bool(keep.all()):
            err = max(err, _close(ko[5], po[5], 1e-5, 1e-3,
                                  f"{name} eps={eps} totals"))
        ended = po[0][:, 2 * no + 3]
        _check(bool((ended > 0).any()), f"{name}: no episode ended")
    run = lambda: cuda(env, plan, params, eps=0.3, **ins)
    ms = _time_ms(run, 50)
    pms = _time_ms(lambda: fc.fused_collect_plain(env, plan, params, eps=0.3,
                                                  **ins), 20)
    ko = run()
    flops = 2 * E * _macs(plan.net.layers)
    out_bytes = _nbytes(ko[:5])
    if rec:
        cp = plan.cell
        flops += 2 * E * (cp.in_dim + cp.hidden) * cp.n_gates * cp.hidden
        out_bytes += _nbytes(ko[6])
    bms, by = _bound(_nbytes(ins, params) + out_bytes
                     + 12 * -(-E // plan.tile), flops)
    _say(f"{'K6' if rec else 'K4'} {name} E={E}: ok at eps 0.3 and 1, "
         f"actions agree {min(fracs):.6f}, done flips within {FLIP_ULPS} "
         f"ulps of a threshold: {n_flips}, max_abs_err {err:.3g}, two runs "
         f"bit-identical, {plan.tile} envs per block, {plan.n_uniforms} "
         f"uniform rows | " + _kernel_line("kernel", ms, pms, bms, by))
    return dict(max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms,
                bound_by=by, done_flips=n_flips)



def user_envs():
    """``(GridWorld, StaticArrayMDP, MiniPOMDP)``: three problems written
    one instance at a time, as a user of the JAX package writes them (its
    ``Env.reset(key)`` / ``step(state, action, key)`` / ``observe(state)``
    and its problems' ``initial_state(key)`` / ``gen(s, a, key)``), with
    torch in place of jnp, a generator in place of a key and no cols.
    ``GridWorld`` is SimpleGridWorld's dynamics over a NamedTuple state; it
    draws its uniforms one at a time in the order of the built-in env's
    rows, so that on the CPU its vmapped draws are the built-in env's.
    ``StaticArrayMDP`` is ``tests/test_compat.py``'s, ``MiniPOMDP`` a hidden
    bit observed correctly with probability 0.9. Every tensor is made on
    the generator's (or the state's) device."""
    from typing import NamedTuple

    import torch

    from deepqlearning_tpu_torch.envs.base import Env

    def uniform(generator):
        return torch.rand((), generator=generator, device=generator.device)

    class GridState(NamedTuple):
        pos: torch.Tensor       # [2] f32, 1-indexed
        terminal: torch.Tensor  # () f32, 0 or 1

    class GridWorld(Env):
        DIRS = ((0, 1), (0, -1), (-1, 0), (1, 0))  # up, down, left, right

        def __init__(self, size=(10, 10), tprob=0.7, discount=0.95,
                     rewards=((4, 3, -10.0), (4, 6, -5.0), (9, 3, 10.0),
                              (8, 8, 3.0))):
            self.size = size
            self.tprob = tprob
            self.discount = discount
            self.rewards = rewards
            self.num_actions = 4
            self.obs_shape = (2,)

        def observe(self, state):
            return torch.where(state.terminal > 0.5, -1.0, state.pos)

        def reset(self, generator):
            ux, uy = uniform(generator), uniform(generator)
            pos = torch.stack([1.0 + torch.floor(ux * float(self.size[0])),
                               1.0 + torch.floor(uy * float(self.size[1]))])
            state = GridState(pos, torch.zeros((), device=generator.device))
            return state, self.observe(state)

        def step(self, state, action, generator):
            u_dir, u_other = uniform(generator), uniform(generator)
            px, py = state.pos[0], state.pos[1]
            cell_r = torch.zeros_like(px)
            for cx, cy, rv in self.rewards:
                cell_r = cell_r + torch.where((px == cx) & (py == cy), rv,
                                              0.0)
            r = torch.where(state.terminal > 0.5, 0.0, cell_r)
            a = action.float()
            other = torch.floor(u_other * 3.0)
            other = torch.where(other >= a, other + 1.0, other)
            d = torch.where(u_dir < self.tprob, a, other)
            dx, dy = torch.zeros_like(px), torch.zeros_like(py)
            for k, (ddx, ddy) in enumerate(self.DIRS):
                dx = torch.where(d == float(k), float(ddx), dx)
                dy = torch.where(d == float(k), float(ddy), dy)
            pos = torch.stack([torch.clamp(px + dx, 1.0, float(self.size[0])),
                               torch.clamp(py + dy, 1.0, float(self.size[1]))])
            terminal = torch.maximum(state.terminal, (cell_r != 0.0).float())
            new = GridState(torch.where(terminal > 0.5, state.pos, pos),
                            terminal)
            return new, self.observe(new), r, terminal > 0.5

    class StaticArrayMDP:
        num_actions = 2
        discount = 0.95
        action_map = [0, 1]

        def initial_state(self, generator):
            return torch.ones(1, dtype=torch.int32, device=generator.device)

        def gen(self, s, a, generator):
            return s + a.to(torch.int32)

        def reward(self, s, a, sp):
            return (s[0] ** 2).float()

        def isterminal(self, s):
            return s[0] >= 3

        def convert_s(self, s):
            return s.float()

    class MiniPOMDP:
        num_actions = 2
        discount = 0.9
        action_map = ["stay", "guess"]

        def initial_state(self, generator):
            return (uniform(generator) < 0.5).to(torch.int32)

        def gen(self, s, a, generator):
            return s

        def reward(self, s, a, sp):
            return torch.where(a == 1, torch.where(s == 1, 1.0, -1.0), 0.0)

        def isterminal(self, s):
            return torch.zeros((), dtype=torch.bool, device=s.device)

        def observation(self, s, a, sp, generator):
            return torch.where(uniform(generator) < 0.9, sp, 1 - sp)

        def initial_obs(self, s):
            return s

        def convert_o(self, o):
            return o[None].float()

    return GridWorld, StaticArrayMDP, MiniPOMDP


def phase_default_device(torch):
    """The entry points with no ``device`` argument put their tensors on
    the card."""
    from deepqlearning_tpu_torch import (
        Chain, Dense, DQNConfig, EpisodeReplayBuffer, Flatten,
        LinearDecaySchedule, PrioritizedReplayBuffer, ReplayBuffer,
        SimpleGridWorld)
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry

    def tensors(x):
        if hasattr(x, "device"):
            return [x]
        if isinstance(x, dict):
            return [t for v in x.values() for t in tensors(v)]
        if isinstance(x, (tuple, list)):
            return [t for v in x for t in tensors(v)]
        return []

    env = SimpleGridWorld()
    bufs = (PrioritizedReplayBuffer(env.obs_shape, 64, 8),
            ReplayBuffer(env.obs_shape, 64, 8),
            EpisodeReplayBuffer(env.obs_shape, 8, 4, 2, 4, num_envs=2))
    net = Chain(Flatten(), Dense(2, 8, torch.tanh, device="cuda"),
                Dense(8, 4, device="cuda"))
    cfg = DQNConfig(num_envs=16, batch_size=8, buffer_size=64, train_freq=16)
    _, _, opt = build_loop(env, net, bufs[0], cfg, LinearDecaySchedule(),
                           0.95)
    carry = init_carry(env, net, bufs[0], cfg, opt)
    got = [t for b in bufs for t in tensors(b.init())] + tensors(
        [carry.actor, carry.replay, carry.params, carry.target_params,
         carry.opt_state, carry.loss])
    _check(len(got) > 20 and all(t.device.type == "cuda" for t in got),
           "an entry point without device= left the card")
    _say(f"default device: three buffers and init_carry built with no "
         f"device argument hold {len(got)} tensors, all on cuda")


def _k1_layouts(torch, data):
    """K1's inputs as given (contiguous), and laid out as the replay hands
    them over: reward, done and weights as columns of one matrix (strided,
    as the replay's reward and done are) and the Q matrices one float past
    a 16-byte boundary (the kernel's scalar path even at A % 4 == 0); the
    caller strides the actions once it has cast them."""
    q3, (a, r, d, w) = data[:3], data[3:]

    def shifted(q):
        flat = torch.empty(q.numel() + 1, dtype=q.dtype, device=q.device)
        out = flat[1:].view(q.shape)
        out.copy_(q)
        return out

    cols = torch.stack([r, d, w], dim=1)
    return {"contiguous": data,
            "strided": (*(shifted(q) for q in q3), a, cols[:, 0],
                        cols[:, 1], cols[:, 2])}


def _k1_check(torch, dev, tk, g, results):
    """K1 against its twin at B in {1, 32, 33, 512, 4096, 10000} (one row,
    the ungrouped loop's batch, a ragged warp, the main paths' batch, a
    cluster of 8 blocks, and a cluster whose threads loop over chunks of
    rows with a ragged tail), A in {4, 5} (float4 rows, and the scalar path
    that also takes A = 4 when misaligned), double-Q and max, int64 and
    int32 actions, actions -1 and A in some rows (they select nothing), and
    contiguous or strided inputs (``_k1_layouts``): every instantiation of
    the kernel.
    loss rtol 1e-5; td/prio/grad atol 1e-6 (the same f32 elementwise math;
    only the loss sum's order differs). Two runs equal bit for bit on all
    four outputs. Times and bound at B = 512, A = 4."""
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    uni = lambda *s: torch.rand(*s, generator=g, device=dev)
    err, n = 0.0, 0
    for B in (1, 32, 33, 512, 4096, 10000):
        for A in (4, 5):
            action = torch.randint(0, A, (B,), generator=g, device=dev)
            action[1::5], action[3::5] = -1, A
            data = (rnd(B, A), rnd(B, A), rnd(B, A), action, rnd(B),
                    (uni(B) < 0.1).float(), uni(B) + 0.5)
            for act, (layout, lin) in itertools.product(
                    (torch.int64, torch.int32),
                    _k1_layouts(torch, data).items()):
                args = lin[:3] + (lin[3].to(act),) + lin[4:]
                if layout == "strided":
                    args = args[:3] + (torch.stack([args[3]] * 2, 1)[:, 1],
                                       *args[4:])
                for dq in (True, False):
                    ko = tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, dq)
                    again = tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, dq)
                    po = tk.td_loss_plain(*args, 0.95, 0.6, 1e-3, dq)
                    what = f"K1 B={B} A={A} {act} {layout} double_q={dq}"
                    _check(all(torch.equal(a, b) for a, b in zip(ko, again)),
                           f"{what}: two runs differ")
                    err = max(err, _close(ko[0], po[0], 1e-5, 1e-6,
                                          f"{what} loss"))
                    for k, p, name in zip(ko[1:], po[1:],
                                          ("td", "prio", "grad")):
                        err = max(err, _close(k, p, 1e-5, 1e-6,
                                              f"{what} {name}"))
                    n += 1
    B, A = 512, 4
    args = (rnd(B, A), rnd(B, A), rnd(B, A),
            torch.randint(0, A, (B,), generator=g, device=dev),
            rnd(B), (uni(B) < 0.1).float(), uni(B) + 0.5)
    ko = tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, True)
    ms = _time_ms(lambda: tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, True), 200)
    pms = _time_ms(lambda: tk.td_loss_plain(*args, 0.95, 0.6, 1e-3, True), 200)
    bms, by = _bound(_nbytes(args, ko), 12 * B * A)
    results["td_loss"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                              bound_ms=bms, bound_by=by)
    _say(f"K1 td_loss: ok in {n} cases (B 1/32/33/512/4096/10000, A 4/5, "
         f"int64 and int32 actions with -1 and A in some rows, contiguous "
         f"and strided inputs, double-Q and max), two runs equal bit for "
         f"bit, max_abs_err {err:.3g} | B=512 A=4: "
         + _kernel_line("K1", ms, pms, bms, by))


def _conv_route_kernels(torch, dev, tk, ts, results):
    """K1 and K2 at the image-observation DQN's shapes
    (``examples/image_conv_dqn.py``; phase 11 (e)), from a generator of
    their own (``kernel_events.py::conv_k1_inputs``): K1 at B = 512, A = 4 on
    the Q values of the bf16 conv net cast to f32 (the train step's casts),
    double-Q and max, against its twin at ``_k1_check``'s tolerances (loss
    rtol 1e-5, td/prio/grad atol 1e-6), two runs bit for bit; K2 on 2^15
    leaves with 2048 draws in 4 sub-batches, bit for bit against the
    scan-order reference and >= 99% exact against the twin, as the other
    K2 cases. Wrapper and plain times by CUDA events and the bound; the
    device-event times come from ``phase_device_events``."""
    from deepqlearning_tpu_torch.ops import sumtree
    from deepqlearning_tpu_torch.ops.cuda.kernel_events import conv_k1_inputs

    g = torch.Generator(device=dev).manual_seed(3)
    args = conv_k1_inputs(torch, dev, g)
    err = 0.0
    for dq in (True, False):
        ko = tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, dq)
        again = tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, dq)
        po = tk.td_loss_plain(*args, 0.95, 0.6, 1e-3, dq)
        what = f"K1 conv route B=512 double_q={dq}"
        _check(all(torch.equal(a, b) for a, b in zip(ko, again)),
               f"{what}: two runs differ")
        err = max(err, _close(ko[0], po[0], 1e-5, 1e-6, f"{what} loss"))
        for k, p, name in zip(ko[1:], po[1:], ("td", "prio", "grad")):
            err = max(err, _close(k, p, 1e-5, 1e-6, f"{what} {name}"))
    ms = _time_ms(lambda: tk.td_loss_cuda(*args, 0.95, 0.6, 1e-3, True), 200)
    pms = _time_ms(lambda: tk.td_loss_plain(*args, 0.95, 0.6, 1e-3, True),
                   200)
    bms, by = _bound(_nbytes(args, ko), 12 * 512 * 4)
    results["td_loss"]["conv_route"] = dict(
        max_abs_err=err, ms=ms, plain_ms=pms, bound_ms=bms, bound_by=by)
    _say(f"K1 td_loss on the conv route (B=512, A=4, Q of the bf16 conv net "
         f"cast to f32): ok, double-Q and max, two runs equal bit for bit, "
         f"max_abs_err {err:.3g} | " + _kernel_line("K1", ms, pms, bms, by))
    cap, D, n = 1 << 15, 2048, 4
    tree = sumtree.init_tree(cap, dev)
    sumtree.set_priorities_slice(
        tree, 0, torch.rand(cap, generator=g, device=dev) + 0.01)
    mass = sumtree.stratified_mass(tree, torch.rand(D, generator=g,
                                                    device=dev))
    ik, pk = ts.tree_sample_cuda(tree, mass, n)
    ik2, pk2 = ts.tree_sample_cuda(tree, mass, n)
    ip, pp = ts.tree_sample_plain(tree, mass, n)
    isc, psc = ts.tree_sample_scan(tree, mass, n)
    _check(torch.equal(ik, ik2) and torch.equal(pk, pk2),
           "K2 conv route: two runs differ")
    _check(torch.equal(ik, isc) and torch.equal(pk, psc),
           "K2 conv route: differs from the scan-order reference")
    exact = (ik == ip).float().mean().item()
    _check(exact >= 0.99, f"K2 conv route: only {exact:.4f} exact")
    _check((ik - ip).abs().max().item() <= 1, "K2 conv route: not adjacent")
    _check(torch.equal(pk, tree[0][ik]), "K2 conv route: prio != leaf")
    t = (_time_ms(lambda: ts.tree_sample_cuda(tree, mass, n), 100),
         _time_ms(lambda: ts.tree_sample_plain(tree, mass, n), 100))
    reads = min(_nbytes(tree), D * len(tree) * 64 * 4)
    b = _bound(reads + _nbytes(mass, pk, ik), D * len(tree) * 64 * 2)
    results["tree_sample"]["conv_route"] = dict(
        max_abs_err=float((ik - ip).abs().max().item()), ms=t[0],
        plain_ms=t[1], bound_ms=b[0], bound_by=b[1])
    _say(f"K2 tree_sample on the conv route (2^15 leaves / 2048 draws in 4 "
         f"sub-batches): ok, equal to the scan-order reference bit for bit, "
         f"two runs bit-identical, exact vs the twin {exact:.5f} | "
         + _kernel_line("K2", *t, *b))


def phase_adam_kernel(torch, dev, results):
    """K9 (``ops/cuda/adam.py``) at the benchmark's two configurations'
    parameters (``kernel_events.adam_nets``): 3 steps against the plain
    twin, bit for bit (params, moments, count, max-abs); then the wrapper's
    time by CUDA events, the twin's eager and as the replay of one captured
    CUDA graph (the ATen chain as the plain steps' graphs ran it before
    K9), and the bound: g, m, v and p read and m, v and p written once at
    3.35 TB/s. The kernel's device time follows in phase 3's device
    events."""
    from deepqlearning_tpu_torch.learner.train_step import AdamState
    from deepqlearning_tpu_torch.ops.cuda import adam
    from deepqlearning_tpu_torch.ops.cuda.kernel_events import (
        adam_inputs, adam_nets)

    g = torch.Generator(device=dev).manual_seed(9)
    by = {}
    for name in adam_nets(torch, dev):
        opt, grads, state, params = adam_inputs(torch, dev, g, name)
        rp = {k: t.clone() for k, t in params.items()}
        rs = AdamState({k: t.clone() for k, t in state.m.items()},
                       {k: t.clone() for k, t in state.v.items()},
                       state.count.clone())
        for step in range(3):
            gk = adam.adam_update(opt, grads, state, params)
            gp = adam.adam_update_plain(opt, grads, rs, rp)
            _check(torch.equal(gk, gp) and torch.equal(state.count, rs.count)
                   and all(torch.equal(params[k], rp[k])
                           and torch.equal(state.m[k], rs.m[k])
                           and torch.equal(state.v[k], rs.v[k])
                           for k in params),
                   f"K9 {name}: step {step + 1} differs from the plain twin")
        ms = _time_ms(lambda: adam.adam_update(opt, grads, state, params),
                      200)
        pms = _time_ms(lambda: adam.adam_update_plain(opt, grads, rs, rp),
                       50)
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            adam.adam_update_plain(opt, grads, rs, rp)
        torch.cuda.current_stream(dev).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            adam.adam_update_plain(opt, grads, rs, rp)
        gms = _time_ms(graph.replay, 200)
        n = sum(p.numel() for p in params.values())
        nbytes = _nbytes(grads) + 2 * _nbytes(params, state.m, state.v)
        bms, bound_by = _bound(nbytes, 12 * n)
        by[name] = dict(params=n, tensors=len(params), bytes=nbytes, ms=ms,
                        plain_ms=pms, plain_graph_ms=gms, bound_ms=bms,
                        bound_by=bound_by)
        del graph
        _say(f"K9 adam_update {name} ({len(params)} tensors, {n} params): "
             f"3 steps equal to the plain twin bit for bit | "
             + _kernel_line("K9", ms, pms, bms, bound_by)
             + f"; the twin as one graph replay {gms:.4f} ms")
    results["adam_update"] = dict(
        max_abs_err=0.0, **by["nature_dueling_dqn bf16"], by_config=by)


def _bias_act_run(torch, fn, y, b, act, dtype, cot):
    """``(out, dy, db)`` of the epilogue ``fn`` under the cotangent."""
    y = y.detach().requires_grad_()
    b = b.detach().requires_grad_()
    out = fn(y, b, act, dtype)
    dy, db = torch.autograd.grad(out, (y, b), cot)
    return out.detach(), dy, db


def _graph_ms(torch, dev, fn, iters=50):
    """``fn``'s time as the replay of one captured CUDA graph (two eager
    warm-up calls on a side stream first), by CUDA events."""
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
        for _ in range(2):
            fn()
    torch.cuda.current_stream(dev).wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    ms = _time_ms(graph.replay, iters)
    del graph
    return ms


def phase_bias_act_kernel(torch, dev, results):
    """K10 (``ops/cuda/bias_act.py``) at the cells' epilogues
    (``kernel_events.bias_act_shapes``): forward and backward against the
    plain twin (the ATen chain), the output and the product's cotangent
    bit for bit, the bias gradient within an f32 sum in another order
    (n 2^-24 sum|dz| with n = 2 log2(rows) + 2, and a bf16 ulp where the
    bias is bf16); then, by CUDA events, the wrapper's forward and
    backward, the twin's eager, and each as the replay of one captured
    CUDA graph (the twin's: the ATen chain as the graphs ran it before
    K10); the bound: the product read and the output written (forward),
    the cotangent and the saved output (or product) read and the product's
    cotangent written (backward) once at 3.35 TB/s. The kernels' device
    times follow in phase 3's device events."""
    from deepqlearning_tpu_torch.ops.cuda import bias_act as ba
    from deepqlearning_tpu_torch.ops.cuda.kernel_events import (
        bias_act_inputs, bias_act_shapes)

    g = torch.Generator(device=dev).manual_seed(10)
    by, worst = {}, 0.0
    for name in bias_act_shapes():
        y, b, cot, act, od = bias_act_inputs(torch, dev, g, name)
        out, dy, db = _bias_act_run(torch, ba.bias_act, y, b, act, od, cot)
        w_out, w_dy, w_db = _bias_act_run(torch, ba.bias_act_plain, y, b,
                                          act, od, cot)
        same = all(torch.equal(u.view(torch.int16 if u.element_size() == 2
                                      else torch.int32),
                               v.view(torch.int16 if v.element_size() == 2
                                      else torch.int32))
                   for u, v in ((out, w_out), (dy, w_dy)))
        _check(same, f"K10 {name}: the output or the product's cotangent "
                     "differs from the ATen chain")
        rows = w_dy.reshape(-1, w_dy.shape[-1]).float()
        n = 2 * rows.shape[0].bit_length() + 2
        tol = n * 2.0 ** -24 * rows.abs().sum(0)
        if db.dtype == torch.bfloat16:
            tol = tol + w_db.float().abs() * 2.0 ** -7
        err = (db.float() - w_db.float()).abs()
        of_tol = float((err / tol.clamp_min(1e-30)).max())
        _check(bool((err <= tol).all()),
               f"K10 {name}: bias gradient off by {float(err.max()):.3g}")
        worst = max(worst, float((err / rows.abs().sum(0).clamp_min(
            1e-30)).max()))
        again = _bias_act_run(torch, ba.bias_act, y, b, act, od, cot)
        _check(torch.equal(again[2], db), f"K10 {name}: two runs differ")
        step = lambda fn: (lambda: _bias_act_run(torch, fn, y, b, act, od,
                                                 cot))
        ms = _time_ms(step(ba.bias_act), 100)
        pms = _time_ms(step(ba.bias_act_plain), 100)
        gms = _graph_ms(torch, dev, step(ba.bias_act))
        pgms = _graph_ms(torch, dev, step(ba.bias_act_plain))
        src = 0 if act is None else (
            y if act is torch.tanh and od != torch.float32 else out)
        fwd = _nbytes(y, out, b)
        bwd = _nbytes(cot, dy, db) + (_nbytes(src) if act is not None
                                      else 0)
        bms, bound_by = _bound(fwd + bwd, 0)
        by[name] = dict(bytes=fwd + bwd, fwd_bytes=fwd, bwd_bytes=bwd,
                        ms=ms, plain_ms=pms, graph_ms=gms,
                        plain_graph_ms=pgms, bound_ms=bms,
                        fwd_bound_ms=_bound(fwd, 0)[0],
                        bwd_bound_ms=_bound(bwd, 0)[0], bound_by=bound_by)
        _say(f"K10 bias_act {name} ({tuple(y.shape)}, {y.dtype} -> {od}): "
             f"output and product cotangent equal to the ATen chain bit for "
             f"bit, bias gradient at {of_tol:.3f} of its tolerance, two "
             f"runs equal | forward and backward: "
             + _kernel_line("K10", ms, pms, bms, bound_by)
             + f"; as one graph replay: K10 {gms:.4f} ms, the ATen chain "
               f"{pgms:.4f} ms")
    results["bias_act"] = dict(max_abs_err=worst,
                               **by["IMPALA 32x84x84x16 relu"], by_shape=by)


def phase_drqn_target_kernel(torch, dev, results):
    """K11 (``ops/cuda/fused_drqn.py::drqn_target_q``) against its plain
    twin (the network's ATen unroll) on ``kernel_events.drqn_target_nets``:
    equal within f32 sums in another order (rtol 1e-5, atol 1e-5 of
    max(1, |Q|)), two calls and ten replays of one captured CUDA graph bit
    for bit; then, by CUDA events, the wrapper, K11 as 20 launches in one
    graph (per launch), the twin eager and as the replay of one graph (the
    ATen chain as the DRQN graphs ran it before K11); the bound:
    2·N·T·macs at the FP32 rate, or the next obs and parameters read and Q
    written once at 3.35 TB/s. K11's device time follows in phase 3's
    device events."""
    from deepqlearning_tpu_torch.ops.cuda import fused_drqn as fd
    from deepqlearning_tpu_torch.ops.cuda.kernel_events import (
        drqn_target_inputs, drqn_target_nets)

    g = torch.Generator(device=dev).manual_seed(11)
    by, worst = {}, 0.0
    for name in drqn_target_nets(torch, dev):
        plan, net, params, nobs = drqn_target_inputs(torch, dev, g, name)
        N, T = nobs.shape[0], nobs.shape[1]
        q = fd.drqn_target_q_cuda(plan, params, nobs)
        p = fd.drqn_target_q_plain(net, params, nobs)
        scale = max(1.0, float(p.abs().max()))
        err = _close(q, p, 1e-5, 1e-5 * scale, f"K11 {name}")
        worst = max(worst, err / scale)
        _check(torch.equal(q, fd.drqn_target_q_cuda(plan, params, nobs)),
               f"K11 {name}: two calls differ")
        graph = torch.cuda.CUDAGraph()
        side = torch.cuda.Stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(side):
            fd.drqn_target_q_cuda(plan, params, nobs)
        torch.cuda.current_stream(dev).wait_stream(side)
        with torch.cuda.graph(graph):
            out = fd.drqn_target_q_cuda(plan, params, nobs)
        for _ in range(10):
            out.zero_()
            graph.replay()
            _check(torch.equal(out, q), f"K11 {name}: a replay differs")
        del graph
        ms = _time_ms(lambda: fd.drqn_target_q_cuda(plan, params, nobs),
                      100)
        gms = _graph_ms(torch, dev, lambda: [fd.drqn_target_q_cuda(
            plan, params, nobs) for _ in range(20)]) / 20
        pms = _time_ms(lambda: fd.drqn_target_q_plain(net, params, nobs),
                       20)
        pgms = _graph_ms(torch, dev,
                         lambda: fd.drqn_target_q_plain(net, params, nobs))
        cp = plan.cell
        macs = _macs(plan.dense) + (cp.in_dim + cp.hidden) * cp.n_gates \
            * cp.hidden
        nbytes = _nbytes(nobs, q, params)
        bms, bound_by = _bound(nbytes, 2 * N * T * macs)
        by[name] = dict(windows=N, T=T, bytes=nbytes, ms=ms, graph_ms=gms,
                        plain_ms=pms, plain_graph_ms=pgms, bound_ms=bms,
                        bound_by=bound_by)
        _say(f"K11 drqn_target_q {name} ({N} windows of {T} steps): within "
             f"{err:.3g} of the twin (max |Q| {scale:.3g}), two calls and "
             f"10 graph replays bit for bit | "
             + _kernel_line("K11", gms, pms, bms, bound_by)
             + f"; the wrapper eager {ms:.4f} ms, the twin as one graph "
               f"replay {pgms:.4f} ms")
    results["drqn_target"] = dict(
        max_abs_err=worst, **by["LSTM32 dueling (grid_drqn.learner)"],
        by_net=by)


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

    _k1_check(torch, dev, tk, g, results)

    # --- K2: 2^20 leaves / 16384 draws in 32 sub-batches of 512 (the
    # headline's sample_n), 4096 / 600 in one, and 2^16 / 4096 in 16 (the
    # CartPole solve's, from a generator of its own: the later phases'
    # inputs stay those of g). Equal bit for bit to the scan-order
    # reference (the kernel's sum order, int64 u-major); against the twin
    # (sumtree.descend, cumsum in another order) indices >= 99% exact and
    # the rest adjacent; priorities equal to the returned leaf's value.
    err = 0.0
    timing, solve_shape = None, None
    g_cp = torch.Generator(device=dev).manual_seed(10)
    for cap, D, n, gk in ((1 << 20, 16384, 32, g), (4096, 600, 1, g),
                          (1 << 16, 4096, 16, g_cp)):
        u = lambda *s: torch.rand(*s, generator=gk, device=dev)
        tree = sumtree.init_tree(cap, dev)
        sumtree.set_priorities_slice(tree, 0, u(cap) + 0.01)
        mass = sumtree.stratified_mass(tree, u(D))
        ik, pk = ts.tree_sample_cuda(tree, mass, n)
        ik2, pk2 = ts.tree_sample_cuda(tree, mass, n)
        ip, pp = ts.tree_sample_plain(tree, mass, n)
        isc, psc = ts.tree_sample_scan(tree, mass, n)
        _check(ik.dtype == torch.int64 and torch.equal(ik, ik2)
               and torch.equal(pk, pk2), f"K2 {cap}/{D}: two runs differ")
        _check(torch.equal(ik, isc) and torch.equal(pk, psc),
               f"K2 {cap}/{D}: differs from the scan-order reference")
        exact = (ik == ip).float().mean().item()
        _check(exact >= 0.99, f"K2 {cap}/{D}: only {exact:.4f} exact")
        _check((ik - ip).abs().max().item() <= 1, f"K2 {cap}/{D}: not adjacent")
        _check(torch.equal(pk, tree[0][ik]), f"K2 {cap}/{D}: prio != leaf")
        err = max(err, (ik - ip).abs().max().item())
        if timing is None or gk is g_cp:
            t = (_time_ms(lambda: ts.tree_sample_cuda(tree, mass, n), 100),
                 _time_ms(lambda: ts.tree_sample_plain(tree, mass, n), 100))
            # each draw reads one 64-wide node per level, the tree at most
            # once; a compare-add per child read
            reads = min(_nbytes(tree), D * len(tree) * 64 * 4)
            b = _bound(reads + _nbytes(mass, pk, ik), D * len(tree) * 64 * 2)
            if timing is None:
                timing, bound = t, b
            else:
                solve_shape = dict(ms=t[0], plain_ms=t[1], bound_ms=b[0],
                                   bound_by=b[1])
                _say(_kernel_line(f"K2 tree_sample 2^16/4096 in 16 (the "
                                  f"CartPole solve's)", *t, *b))
        _say(f"K2 tree_sample {cap} leaves / {D} draws in {n} sub-batches: "
             f"ok, equal to the scan-order reference bit for bit, two runs "
             f"bit-identical, exact vs the twin {exact:.5f}, "
             f"{-(-D // 16)} blocks of 256")
    results["tree_sample"] = dict(max_abs_err=float(err), ms=timing[0],
                                  plain_ms=timing[1], bound_ms=bound[0],
                                  bound_by=bound[1],
                                  cartpole_solve_shape=solve_shape)
    _say(_kernel_line("K2 tree_sample 2^20/16384", *timing, *bound))
    _conv_route_kernels(torch, dev, tk, ts, results)

    # --- K3: U=32, B=512, dueling 2->64->64->4 double-Q lr 1e-4, and a
    # plain chain with max; then the CartPole solve's shape (U=16, B=256,
    # dueling 4->64->64->2 double-Q, lr 1e-3, gamma 0.99, from a generator
    # of its own). params rtol 2e-4 / atol 2e-5 and loss rtol
    # 1e-4, gnorm rtol 1e-3 (the JAX package's fused-vs-XLA tolerances);
    # td/prio rtol 1e-4 / atol 1e-5. Against the tile-order reference
    # (the kernel's sum order) rtol 1e-5: params atol 1e-6 (1% of lr; the
    # forward's dot products still round in another order), td/prio atol
    # 1e-5 (the twin's: (|td| + 1e-3)^0.6 multiplies a td error by up to
    # ~10 near td = 0), loss and gnorm atol 0. Two runs bit-identical.
    from deepqlearning_tpu_torch import CartPole

    err = 0.0
    timing = None
    for dueling, double_q, cartpole in ((True, True, False),
                                        (False, False, False),
                                        (True, True, True)):
        gk = g_cp if cartpole else g
        u = lambda *s: torch.rand(*s, generator=gk, device=dev)
        if cartpole:
            U, B, no, A, lr, gamma = 16, 256, 4, 2, 1e-3, 0.99
            net = _cartpole_net(torch, dev)
        else:
            U, B, no, A, lr, gamma = 32, 512, 2, 4, 1e-4, 0.95
            chain = Chain(Flatten(), Dense(2, 64, torch.tanh, device=dev),
                          Dense(64, 64, torch.tanh, device=dev),
                          Dense(64, 4, device=dev))
            net = create_dueling_network(chain) if dueling else chain
        plan = fu.plan_for(net)
        _check(plan is not None, "K3 plan")
        params = net.init(gk)
        n = U * B
        if cartpole:
            # CartPole's states and its unit reward
            data = dict(obs=_env_states(torch, CartPole(), n, gk),
                        nobs=_env_states(torch, CartPole(), n, gk),
                        action=torch.randint(0, A, (n,), generator=gk,
                                             device=dev),
                        reward=torch.ones(n, device=dev),
                        done=(u(n) < 0.05).float(), weights=u(n) + 0.5,
                        q_sp_tgt=torch.randn(n, A, generator=gk, device=dev))
        else:
            data = dict(obs=u(n, 2) * 10, nobs=u(n, 2) * 10,
                        action=torch.randint(0, 4, (n,), generator=g,
                                             device=dev),
                        reward=rnd(n), done=(u(n) < 0.05).float(),
                        weights=u(n) + 0.5, q_sp_tgt=rnd(n, 4))
        kw = dict(gamma=gamma, double_q=double_q, lr=lr, alpha=0.6,
                  eps=1e-3, batch_size=B, n_updates=U)
        shape = (f"dueling={dueling} double_q={double_q} U={U} B={B} "
                 f"{no}->64->64->{A} lr {lr:g}")

        state = lambda: _adam_state(torch, params)

        ks, ks2 = state(), state()
        ko = fu.fused_group_update_cuda(plan, *ks, **data, **kw)
        ko2 = fu.fused_group_update_cuda(plan, *ks2, **data, **kw)
        _check(all(torch.equal(a, b) for a, b in zip(ko, ko2)) and all(
            torch.equal(ks[i][k], ks2[i][k]) for i in range(3)
            for k in plan.names), f"K3 {shape}: two runs differ")

        def pairs(swaps):
            d = dict(data, q_sp_tgt=_swap_ties(data["q_sp_tgt"], swaps))
            ps, rs = state(), state()
            po = fu.fused_group_update_plain(plan, *ps, **d, **kw)
            ro = fu.fused_group_update_tiled(plan, *rs, **d, **kw)
            _check(int(ks[3]) == int(ps[3]) == U, "K3 count")
            out = []
            for k in plan.names:
                out += [(ks[0][k], ps[0][k], 2e-4, 2e-5, f"K3 {k}", True),
                        (ks[0][k], rs[0][k], 1e-5, 1e-6,
                         f"K3 vs tile-order {k}", False)]
            for i, n in ((0, "td"), (1, "prio")):
                out.append((ko[i], ro[i], 1e-5, 1e-5,
                            f"K3 vs tile-order {n}", False))
            for i, n in ((2, "loss"), (3, "gnorm")):
                out.append((ko[i], ro[i], 1e-5, 0.0,
                            f"K3 vs tile-order {n}", False))
            return out + [(ko[0], po[0], 1e-4, 1e-5, "K3 td", True),
                          (ko[1], po[1], 1e-4, 1e-5, "K3 prio", True),
                          (ko[2], po[2], 1e-4, 0.0, "K3 loss", True),
                          (ko[3], po[3], 1e-3, 1e-7, "K3 gnorm", True)]

        ties = _ff_ties(torch, fu, plan, params, data, kw) if double_q else []
        e, n_ties, n_other = _tie_aware(pairs, ties)
        err = max(err, e)
        if timing is None or cartpole:
            # one state for all timed calls: the state's copies stay out
            # of the kernel's time
            st = state()
            t = (_time_ms(lambda: fu.fused_group_update_cuda(
                    plan, *st, **data, **kw), 20),
                 _time_ms(lambda: fu.fused_group_update_plain(
                    plan, *st, **data, **kw), 3, 1))
            # inputs read once, params/m/v read and written, td/prio out
            b = _bound(_nbytes(data) + 6 * _nbytes(params) + _nbytes(ko[:2]),
                       _dense_update_flops(plan, B, U, double_q))
            if timing is None:
                timing, bound = t, b
                copy_ms = _time_ms(state, 20)
            else:
                solve_shape = dict(max_abs_err=e, ms=t[0], plain_ms=t[1],
                                   bound_ms=b[0], bound_by=b[1])
                _say(_kernel_line(f"K3 fused_group_update {shape} (the "
                                  f"CartPole solve's)", *t, *b))
        _say(f"K3 fused_group_update {shape}: ok, matches the tile-order "
             f"reference at rtol 1e-5, two runs bit-identical, grid "
             f"{fu.launch_grid(plan, B, dev)} blocks of {fu.THREADS}; "
             f"{n_ties} near ties of the s' argmax, {n_other} taken the "
             f"other way by the kernel")
    results["fused_group_update"] = dict(
        max_abs_err=err, ms=timing[0], plain_ms=timing[1], bound_ms=bound[0],
        bound_by=bound[1], cartpole_solve_shape=solve_shape)
    _say(_kernel_line("K3 fused_group_update U=32 B=512 (dueling, double-Q; "
                      "one cooperative launch)", *timing, *bound)
         + f"; a fresh params/m/v/count copy takes {copy_ms:.4f} ms")

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
    bms, by = _bound(_nbytes(ins, params, ko[:5]) + 12 * E // plan.tile,
                     2 * E * _macs(plan.net.layers))
    results["fused_collect"] = dict(max_abs_err=err, ms=ms, plain_ms=pms,
                                    bound_ms=bms, bound_by=by)
    _say(f"K4 fused_collect E=131072: ok, actions agree {frac:.6f}, "
         f"{plan.tile} envs per block | "
         + _kernel_line("K4", ms, pms, bms, by))
    # --- K4 on CartPole (the CartPole solve's dueling 4-64-64-2 tanh net)
    # and MountainCar (dueling 2-64-64-3 tanh) at E=131072, from a
    # generator of their own (the later phases' inputs stay those of g)
    from deepqlearning_tpu_torch import CartPole, MountainCar
    from deepqlearning_tpu_torch.ops.cuda import fused_drqn as fd

    gen = torch.Generator(device=dev).manual_seed(9)
    by_env = {}
    for name, env, net in (
            ("CartPole", CartPole(), _cartpole_net(torch, dev)),
            ("MountainCar", MountainCar(),
             _dueling_net(torch, dev, 64, torch.tanh, 2, 3))):
        by_env[name] = _collect_env_check(torch, dev, fc, fu, fd, name, env,
                                          net, E, gen)
    results["fused_collect"]["by_env"] = by_env
    results["fused_collect"]["max_abs_err"] = max(
        err, *(r["max_abs_err"] for r in by_env.values()))
    phase_recurrent_kernels(torch, dev, g, results)


def phase_recurrent_kernels(torch, dev, g, results):
    from deepqlearning_tpu_torch import (
        GRU, LSTM, Chain, Dense, DuelingNetwork, create_dueling_network)
    from deepqlearning_tpu_torch.envs.gridworld import SimpleGridWorld
    from deepqlearning_tpu_torch.ops.cuda import (
        build, fused_collect as fc, fused_drqn as fd, fused_update as fu)

    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    uni = lambda *s: torch.rand(*s, generator=g, device=dev)

    # --- K5: B=512, T=8; LSTM(2,32)+Dense(32,4) with double-Q at U=4 and
    # U=32, and a dueling GRU net with a Dense layer before the cell and
    # max targets; then a trace too long for the tiles' T-step regions in
    # shared memory (U=2, B=32, T=256: they lie in global scratch,
    # dr_group_gm_kernel). Each against its twin and the tile-order
    # reference, two runs bit-identical (_k5_check).
    B, T = 512, 8
    lstm = Chain(LSTM(2, 32, device=dev), Dense(32, 4, device=dev))
    gru = create_dueling_network(Chain(
        Dense(2, 16, torch.tanh, device=dev), GRU(16, 32, device=dev),
        Dense(32, 32, torch.tanh, device=dev), Dense(32, 4, device=dev)))
    err = 0.0
    for name, net, double_q, U in (("LSTM32 double-Q", lstm, True, 4),
                                   ("LSTM32 double-Q", lstm, True, 32),
                                   ("dueling GRU max", gru, False, 4)):
        plan = fd.drqn_plan_for(net, T, B, double_q)
        _check(plan is not None, f"K5 plan {name}")
        params = net.init(g)
        n = U * B
        lens = torch.randint(1, T + 1, (n,), generator=g, device=dev)
        data = dict(
            obs=uni(n, T, 2) * 10, nobs=uni(n, T, 2) * 10,
            action=torch.randint(0, 4, (n, T), generator=g, device=dev),
            reward=rnd(n, T), done=(uni(n, T) < 0.1).float(),
            mask=(torch.arange(T, device=dev)[None] < lens[:, None]).float(),
            q_sp_tgt=rnd(n, T, 4))
        e, kw = _k5_check(torch, dev, fd, name, plan, params, data, double_q,
                          U, B, T)
        err = max(err, e)
        if U == 4 and double_q:
            state = lambda: _adam_state(torch, params)
            # the parent commit's way (a fresh params/m/v/count copy per
            # call, the copy inside the time), and the kernel alone on one
            # reused state
            st = state()
            timing = (
                _time_ms(lambda: fd.fused_drqn_group_update_cuda(
                    plan, *state(), **data, **kw), 20),
                _time_ms(lambda: fd.fused_drqn_group_update_plain(
                    plan, *state(), **data, **kw), 3, 1))
            alone_ms = _time_ms(lambda: fd.fused_drqn_group_update_cuda(
                plan, *st, **data, **kw), 20)
            copy_ms = _time_ms(state, 20)
            bound = _bound(_nbytes(data) + 6 * _nbytes(params),
                           _drqn_update_flops(plan, B, T, U, double_q))
    Tl, Bl, Ul = 256, 32, 2
    plan = fd.drqn_plan_for(lstm, Tl, Bl, True)
    _check(plan is not None and plan.desc(Tl).act_global == 1,
           "K5 long-trace plan")
    params = lstm.init(g)
    n = Ul * Bl
    data = dict(
        obs=uni(n, Tl, 2) * 10, nobs=uni(n, Tl, 2) * 10,
        action=torch.randint(0, 4, (n, Tl), generator=g, device=dev),
        reward=rnd(n, Tl), done=(uni(n, Tl) < 0.1).float(),
        mask=(torch.arange(Tl, device=dev)[None] < torch.randint(
            1, Tl + 1, (n, 1), generator=g, device=dev)).float(),
        q_sp_tgt=rnd(n, Tl, 4))
    err = max(err, _k5_check(torch, dev, fd, "LSTM32 double-Q, long trace",
                             plan, params, data, True, Ul, Bl, Tl)[0])
    # the paths the main ones do not take, from a generator of their own
    # (the later phases' inputs stay those of the stream above): a ragged
    # last tile of 3 windows (an odd row count), actions -1 and A (the
    # kernel's guard selects nothing), and two wide nets whose tiles shrink
    # to 2 and 1 windows (a dueling LSTM with a 128-wide Dense layer before
    # it; 128 actions at T = 32). The wide nets' parameters are held to
    # the tile-order reference through K8's gradient, before Adam: after
    # it, the f32 reference's own rounding at these widths exceeds atol
    # 1e-6 (``ops/cuda/k5_phases.py --precision``).
    g2 = torch.Generator(device=dev).manual_seed(5)
    wide = create_dueling_network(Chain(
        Dense(2, 128, torch.relu, device=dev), LSTM(128, 16, device=dev),
        Dense(16, 128, torch.tanh, device=dev), Dense(128, 4, device=dev)))
    many = Chain(LSTM(4, 48, device=dev), Dense(48, 128, device=dev))
    for name, net, double_q, U, Bc, Tc, acts, narrow in (
            ("dueling GRU max, ragged", gru, False, 2, 511, T, (0, 4), True),
            ("LSTM32 double-Q, actions in [-1, A]", lstm, True, 2, B, T,
             (-1, 5), True),
            ("dueling Dense(2,128)+LSTM(128,16) double-Q", wide, True, 2, 64,
             T, (0, 4), False),
            ("LSTM(4,48)+Dense(48,128) max", many, False, 2, 24, 32,
             (0, 128), False)):
        plan = fd.drqn_plan_for(net, Tc, Bc, double_q)
        _check(plan is not None, f"K5 plan {name}")
        params = net.init(g2)
        n, A = U * Bc, plan.head.num_actions
        lens = torch.randint(1, Tc + 1, (n,), generator=g2, device=dev)
        r = lambda *s: torch.rand(*s, generator=g2, device=dev)
        data = dict(
            obs=r(n, Tc, plan.in_dim) * 10, nobs=r(n, Tc, plan.in_dim) * 10,
            action=torch.randint(*acts, (n, Tc), generator=g2, device=dev),
            reward=torch.randn(n, Tc, generator=g2, device=dev),
            done=(r(n, Tc) < 0.1).float(),
            mask=(torch.arange(Tc, device=dev)[None] < lens[:, None]).float(),
            q_sp_tgt=torch.randn(n, Tc, A, generator=g2, device=dev))
        err = max(err, _k5_check(torch, dev, fd, name, plan, params, data,
                                 double_q, U, Bc, Tc, narrow)[0])
    results["fused_drqn_group_update"] = dict(
        max_abs_err=err, ms=timing[0], plain_ms=timing[1], bound_ms=bound[0],
        bound_by=bound[1])
    _say(_kernel_line("K5 fused_drqn_group_update LSTM32 U=4 B=512 T=8 "
                      "(one cooperative launch; a fresh params/m/v/count "
                      "copy per call, as timed before)", *timing, *bound)
         + f"; the kernel alone on one reused state {alone_ms:.4f} ms; the "
         f"copy alone {copy_ms:.4f} ms")

    # --- K6: E=16384 GridWorld with LSTM32, with GRU16 + Dense(16,32,
    # tanh) + Dense(32,4), and with a dueling net on an LSTM16 base, shared
    # uniforms. Actions equal for >= 99.99% of
    # envs, a differing env's top-two Q within 1e-5; on agreeing envs the
    # fields, obs and env state at 1e-6 (the same f32 env math) and the new
    # h/c at rtol/atol 1e-5 (gate sums in other orders). Two runs
    # bit-identical; at least one block per SM; ptxas: no stack.
    ptx = build.ptxas_report(("fc_kernel", "fc_rnn_kernel",
                              "tree_sample_kernel"))
    for k, line in sorted(ptx.items()):
        _say(f"ptxas {k}: {line}")
    # one instantiation per env the kernels step (FcEnv<ENV>): the
    # SimpleGridWorld one, K6 as the DRQN loop runs it, has no stack; the
    # CartPole and MountainCar ones keep the 32-byte frame of sinf/cosf's
    # argument reduction for |x| > 105615 (a local array, not touched
    # otherwise)
    _check(" 0 bytes stack frame" in " " + ptx["fc_rnn_kernel<0>"],
           "K6 uses a local-memory stack")
    _check(all(f"{k}<{n}>" in ptx for k in ("fc_kernel", "fc_rnn_kernel")
               for n in range(3)), f"instantiations {sorted(ptx)}")
    env = SimpleGridWorld()
    E = 16384
    err = 0.0
    timing = None
    nets = (("LSTM32", lstm),
            ("GRU16", Chain(GRU(2, 16, device=dev),
                            Dense(16, 32, torch.tanh, device=dev),
                            Dense(32, 4, device=dev))),
            ("dueling LSTM16", DuelingNetwork(
                Chain(LSTM(2, 16, device=dev)),
                Chain(Dense(16, 32, torch.tanh, device=dev),
                      Dense(32, 1, device=dev)),
                Chain(Dense(16, 32, torch.tanh, device=dev),
                      Dense(32, 4, device=dev)))))
    for name, net in nets:
        plan = fc.collect_plan_for(env, net, None)
        _check(plan is not None and plan.cell is not None, f"K6 plan {name}")
        params = net.init(g)
        st, obs = env.reset_batch(E, torch.Generator(device=dev).manual_seed(2))
        st[:, 2] = (uni(E) < 0.05).float()
        ins = dict(obs=obs, state=st,
                   ep_step=torch.randint(0, 100, (E,), generator=g,
                                         device=dev, dtype=torch.int32),
                   ep_ret=rnd(E), u=uni(6, E), eps=0.3, max_episode_length=100,
                   nstate=rnd(E, plan.state_width) * 0.5)
        ko = fc.fused_collect_rnn_cuda(env, plan, params, **ins)
        ko2 = fc.fused_collect_rnn_cuda(env, plan, params, **ins)
        _check(all(torch.equal(a, b) for a, b in zip(ko, ko2)),
               f"K6 {name}: two runs differ")
        blocks = -(-E // plan.tile)
        _check(blocks >= 132, f"K6 {name}: {blocks} blocks")
        po = fc.fused_collect_plain(env, plan, params, **ins)
        agree = ko[0][:, 4] == po[0][:, 4]
        frac = agree.float().mean().item()
        _check(frac >= 0.9999, f"K6 {name} actions agree on only {frac:.6f}")
        if not bool(agree.all()):
            H = plan.cell.hidden
            ns = ins["nstate"][~agree]
            h, _ = fd.cell_step(plan.cell, params, obs[~agree], ns[:, :H],
                                ns[:, H:] if plan.cell.kind == "lstm" else None)
            top2 = fu.q_values(plan.net, params, h)[0].topk(2, dim=1).values
            _check(bool(((top2[:, 0] - top2[:, 1]) <= 1e-5).all()),
                   f"K6 {name} differing action without a near tie")
        for k, p, n, tol in zip(ko, po, ("fields", "obs", "state", "ep_step",
                                         "ep_ret", "totals", "h/c"),
                                (1e-6,) * 5 + (None, 1e-5)):
            if tol is not None:
                err = max(err, _close(k[agree], p[agree], tol, tol,
                                      f"K6 {name} {n}"))
        if timing is None:
            timing = (_time_ms(lambda: fc.fused_collect_rnn_cuda(
                          env, plan, params, **ins), 50),
                      _time_ms(lambda: fc.fused_collect_plain(
                          env, plan, params, **ins), 20))
            cp = plan.cell
            bound = _bound(_nbytes(ins, params, ko[:5], ko[6])
                           + 12 * blocks,
                           2 * E * (_macs(plan.net.layers) + (
                               cp.in_dim + cp.hidden) * cp.n_gates
                               * cp.hidden))
        _say(f"K6 fused_collect (recurrent) {name} E=16384: ok, actions "
             f"agree {frac:.6f}, max_abs_err {err:.3g}, two runs "
             f"bit-identical, {blocks} blocks of {plan.tile} envs")
    # --- K6 on CartPole (LSTM(4,32) + Dense(32,2)) and MountainCar (a
    # dueling GRU16 head) at E=16384, from a generator of their own
    from deepqlearning_tpu_torch import CartPole, MountainCar

    gen = torch.Generator(device=dev).manual_seed(10)
    by_env = {}
    for name, env, net in (
            ("CartPole", CartPole(),
             Chain(LSTM(4, 32, device=dev), Dense(32, 2, device=dev))),
            ("MountainCar", MountainCar(), DuelingNetwork(
                Chain(GRU(2, 16, device=dev)),
                Chain(Dense(16, 32, torch.tanh, device=dev),
                      Dense(32, 1, device=dev)),
                Chain(Dense(16, 32, torch.tanh, device=dev),
                      Dense(32, 3, device=dev))))):
        by_env[name] = _collect_env_check(torch, dev, fc, fu, fd, name, env,
                                          net, E, gen)
    results["fused_collect_rnn"] = dict(
        max_abs_err=max(err, *(r["max_abs_err"] for r in by_env.values())),
        ms=timing[0], plain_ms=timing[1], bound_ms=bound[0],
        bound_by=bound[1], by_env=by_env)
    _say(_kernel_line("K6 fused_collect (recurrent) LSTM32 E=16384", *timing,
                      *bound))
    phase_grads_kernels(torch, dev, g, results, lstm, gru)


def phase_device_events(results):
    """K1 (B = 512, the ungrouped loop's B = 32, and 4096), K2, K4 and K6
    (on each env they step), K7, K8, K9, K10 and K11 timed by their device
    events alone (``ops/cuda/kernel_events.py``:
    the kernel's launches under ``torch.profiler``, matched by name) beside
    their wrappers' CUDA-event times: for a kernel this short the wrapper's
    time is the host's enqueue of the next call, not the kernel. The share
    is the bound over the device time. Beside K1 an empty kernel launched
    as K1 is (its block, or its cluster past 512 rows) gives the launch
    floor (``floor_ms``, ``floor_ms_b32``, ``floor_ms_b4096`` in K1's JSON
    entry). It runs in a process of its
    own: after a profiler session in this process, later traces in it
    missed the first device events of their windows."""
    root = os.path.dirname(os.path.abspath(__file__))
    out = subprocess.run(
        [sys.executable, "-m", "deepqlearning_tpu_torch.ops.cuda.kernel_events"],
        cwd=root, capture_output=True, text=True, check=True)
    measured = json.loads(out.stdout.strip().splitlines()[-1])
    # K1 as _k1_check bounds it at 512: q_s, q_sp_online, q_sp_target,
    # int64 actions, reward, done, weights in; loss, td, prio, grad out; 12
    # operations per Q value
    k1_bound = lambda B, A=4: _bound(
        4 * (3 * B * A + 3 * B + 1 + 2 * B + B * A) + 8 * B, 12 * B * A)[0]
    rows = {}
    for B in (512, 32, 4096):
        sfx = "" if B == 512 else f"_b{B}"
        rows[f"K1 td_loss B={B}"] = ("td_loss", f"device_ms{sfx}",
                                     k1_bound(B))
        rows[f"K1 floor: empty kernel, K1's block B={B}"] = (
            "td_loss", f"floor_ms{sfx}", None)
    rows.update({
        "K2 tree_sample 2^20/16384": (
            "tree_sample", "device_ms", results["tree_sample"]["bound_ms"]),
        "K6 fused_collect (recurrent) LSTM32 E=16384": (
            "fused_collect_rnn", "device_ms",
            results["fused_collect_rnn"]["bound_ms"]),
        "K4 fused_collect SimpleGridWorld E=131072": (
            "fused_collect", "device_ms",
            results["fused_collect"]["bound_ms"]),
        "K7 fused_grads U=1 DP headline B=512": (
            "fused_grads", "device_ms", results["fused_grads"]["bound_ms"]),
        "K8 fused_drqn_grads U=1 DP DRQN LSTM32 B=512 T=8": (
            "fused_drqn_grads", "device_ms",
            results["fused_drqn_grads"]["bound_ms"])})
    # K1 and K2 on the conv route (_conv_route_kernels)
    rows["K1 td_loss conv route B=512"] = (
        ("td_loss", "conv_route"), "device_ms",
        results["td_loss"]["conv_route"]["bound_ms"])
    rows["K2 tree_sample conv route 2^15/2048 in 4"] = (
        ("tree_sample", "conv_route"), "device_ms",
        results["tree_sample"]["conv_route"]["bound_ms"])
    # K4 and K6 on the other envs they step: in the kernels' by_env entries
    for env, cell in (("CartPole", "LSTM32"), ("MountainCar", "dueling GRU16")):
        rows[f"K4 fused_collect {env} E=131072"] = (
            ("fused_collect", env), "device_ms",
            results["fused_collect"]["by_env"][env]["bound_ms"])
        rows[f"K6 fused_collect (recurrent) {env} {cell} E=16384"] = (
            ("fused_collect_rnn", env), "device_ms",
            results["fused_collect_rnn"]["by_env"][env]["bound_ms"])
    for name, r in results["adam_update"]["by_config"].items():
        rows[f"K9 adam_update {name}"] = (("adam_update", name), "device_ms",
                                          r["bound_ms"])
    for name, r in results["bias_act"]["by_shape"].items():
        rows[f"K10 bias_act {name}"] = (("bias_act", name), "device_ms",
                                        r["fwd_bound_ms"])
        rows[f"K10 bias_act_grad {name}"] = (("bias_act", name),
                                             "grad_device_ms",
                                             r["bwd_bound_ms"])
    for name, r in results["drqn_target"]["by_net"].items():
        rows[f"K11 drqn_target_q {name}"] = (("drqn_target", name),
                                             "device_ms", r["bound_ms"])
    _check(set(measured) == set(rows),
           f"kernel_events measured {sorted(measured)}")
    for name, r in measured.items():
        key, field, bound = rows[name]
        entry = (results[key] if isinstance(key, str) else
                 results[key[0]][key[1]] if key[1] == "conv_route" else
                 results[key[0]]["by_config"][key[1]]
                 if key[0] == "adam_update" else
                 results[key[0]]["by_shape"][key[1]]
                 if key[0] == "bias_act" else
                 results[key[0]]["by_net"][key[1]]
                 if key[0] == "drqn_target" else
                 results[key[0]]["by_env"][key[1]])
        entry[field] = r["device_ms"]
        tail = ("the launch floor" if bound is None else
                f"bound {bound:.6f} ms, share of the device time "
                f"{bound / r['device_ms']:.4f}")
        _say(f"{name}: device events {r['device_ms']:.6f} ms per launch "
             f"({r['launches_per_call']:g} launch per call), wrapper by CUDA "
             f"events {r['wrapper_ms']:.4f} ms, {tail}")
    for B in (512, 32, 4096):
        sfx = "" if B == 512 else f"_b{B}"
        k1, floor = (results["td_loss"][f"device_ms{sfx}"],
                     results["td_loss"][f"floor_ms{sfx}"])
        _say(f"K1 B={B}: {k1:.6f} ms against the empty kernel's "
             f"{floor:.6f} ms, {k1 / floor:.3f}x the launch floor")
    k9 = results["adam_update"]
    k9["device_ms"] = k9["by_config"]["nature_dueling_dqn bf16"]["device_ms"]
    k10 = results["bias_act"]
    for name, r in k10["by_shape"].items():
        dms = r["device_ms"] + r["grad_device_ms"]
        _say(f"K10 {name}: forward {r['device_ms']:.6f} + backward "
             f"{r['grad_device_ms']:.6f} ms on the device, bound "
             f"{r['bound_ms']:.6f} ms (bytes), share {r['bound_ms'] / dms:.4f}"
             f"; the ATen chain as one graph replay {r['plain_graph_ms']:.4f}"
             f" ms")
    main = k10["by_shape"]["IMPALA 32x84x84x16 relu"]
    k10["device_ms"] = main["device_ms"]
    k10["grad_device_ms"] = main["grad_device_ms"]
    k11 = results["drqn_target"]
    k11["device_ms"] = k11["by_net"][
        "LSTM32 dueling (grid_drqn.learner)"]["device_ms"]


def _k5_check(torch, dev, fd, name, plan, params, data, double_q, U, B, T,
              params_vs_tiled=True):
    """K5 on windows ``data`` (``U·B`` of ``T`` steps) against its twin at
    the JAX package's fused-vs-XLA tolerances (params/m/v rtol 2e-4 / atol
    2e-5, loss rtol 1e-4, gnorm rtol 1e-3) and against the tile-order
    reference (the kernel's sum order) at rtol 1e-5: loss and gnorm atol
    0, params (``params_vs_tiled``) atol 1e-6 (0.1% of lr; the unrolls' dot
    products still round in another order), and K8's gradient of the
    first sub-update (the same kernel at U = 1) atol 1e-5 of its largest
    entry. Two runs must be bit-identical. With double-Q the references
    allow for near ties of the s' argmax (:func:`_tie_aware`). Prints a
    line; returns ``(max_abs_err against the twin, the update's
    keywords)``."""
    kw = dict(gamma=0.95, double_q=double_q, lr=1e-3, batch_size=B,
              n_updates=U)
    ks, ks2 = (_adam_state(torch, params) for _ in range(2))
    kl, kg = fd.fused_drqn_group_update_cuda(plan, *ks, **data, **kw)
    kl2, kg2 = fd.fused_drqn_group_update_cuda(plan, *ks2, **data, **kw)
    what = f"K5 {name} U={U} B={B} T={T}"
    _check(torch.equal(kl, kl2) and torch.equal(kg, kg2) and all(
        torch.equal(ks[i][k], ks2[i][k]) for i in range(3)
        for k in plan.names), f"{what}: two runs differ")
    first = {k: v[:B] for k, v in data.items()}
    gk = fd.fused_drqn_grads_cuda(plan, params, **first, gamma=0.95,
                                  double_q=double_q)

    def pairs(swaps):
        d = dict(data, q_sp_tgt=_swap_ties(data["q_sp_tgt"], swaps))
        ps, rs = (_adam_state(torch, params) for _ in range(2))
        pl, pg = fd.fused_drqn_group_update_plain(plan, *ps, **d, **kw)
        rl, rg = fd.fused_drqn_group_update_tiled(plan, *rs, **d, **kw)
        gr = fd.fused_drqn_grads_tiled(
            plan, params, **{k: v[:B] for k, v in d.items()}, gamma=0.95,
            double_q=double_q)
        _check(int(ks[3]) == int(ps[3]) == U, f"{what} count")
        out = []
        for k in plan.names:
            for i, part in ((0, "param"), (1, "m"), (2, "v")):
                out.append((ks[i][k], ps[i][k], 2e-4, 2e-5,
                            f"{what} {part} {k}", True))
            if params_vs_tiled:
                out.append((ks[0][k], rs[0][k], 1e-5, 1e-6,
                            f"{what} vs tile-order {k}", False))
        return out + [
            (kl, rl, 1e-5, 0.0, f"{what} vs tile-order loss", False),
            (kg, rg, 1e-5, 0.0, f"{what} vs tile-order gnorm", False),
            (gk[0], gr[0], 1e-5, 1e-5 * float(gr[0].abs().max()),
             f"{what} K8 gradient vs tile-order", False),
            (kl, pl, 1e-4, 0.0, f"{what} loss", True),
            (kg, pg, 1e-3, 1e-7, f"{what} gnorm", True)]

    ties = _drqn_ties(torch, fd, plan, params, data, kw) if double_q else []
    err, n_ties, n_other = _tie_aware(pairs, ties)
    d = plan.desc(T)
    _say(f"K5 fused_drqn_group_update {name} U={U} B={B} T={T}: ok, "
         f"matches the tile-order reference at rtol 1e-5 ("
         f"{'params, ' if params_vs_tiled else ''}loss, gnorm, K8's "
         f"gradient), two runs bit-identical, grid "
         f"{fd.launch_grid(plan, T, B, dev)} blocks of {fd.THREADS}, "
         f"{d.tile} windows per tile, T-step regions in "
         f"{'global' if d.act_global else 'shared'} memory, "
         f"{plan.smem_bytes(T)} bytes of shared memory; {n_ties} near ties "
         f"of the s' argmax, {n_other} taken the other way by the kernel")
    return err, kw


def phase_grads_kernels(torch, dev, g, results, lstm, gru):
    """K7 and K8, the grads-emitting sub-updates of the data-parallel
    route, against their twins, and the Adam launch that follows them on a
    flat gradient."""
    from deepqlearning_tpu_torch import Chain, Dense, Flatten, create_dueling_network
    from deepqlearning_tpu_torch.ops.cuda import (
        fused_drqn as fd, fused_update as fu)

    rnd = lambda *s: torch.randn(*s, generator=g, device=dev)
    uni = lambda *s: torch.rand(*s, generator=g, device=dev)

    # --- K7: B=512, dueling 2->64->64->{1,4} with double-Q (the headline)
    # and the plain chain with max targets. grads rtol 1e-4 / atol 1e-6
    # (f32 sums over 512 rows in another order: 32 tile partials reduced
    # in block order vs matmuls), td/prio rtol 1e-4 / atol 1e-5, loss and
    # gnorm rtol 1e-4. Then the flat Adam (K3's Adam kernel, one partial)
    # against its twin: params/m/v rtol 1e-5 / atol 1e-6.
    B = 512
    err = 0.0
    timing = None
    for dueling, double_q in ((True, True), (False, False)):
        chain = Chain(Flatten(), Dense(2, 64, torch.tanh, device=dev),
                      Dense(64, 64, torch.tanh, device=dev),
                      Dense(64, 4, device=dev))
        net = create_dueling_network(chain) if dueling else chain
        plan = fu.plan_for(net)
        params = net.init(g)
        data = dict(obs_s=uni(B, 2) * 10, obs_sp=uni(B, 2) * 10,
                    action=torch.randint(0, 4, (B,), generator=g, device=dev),
                    reward=rnd(B), done=(uni(B) < 0.05).float(),
                    weights=uni(B) + 0.5, q_sp_tgt=rnd(B, 4))
        kw = dict(gamma=0.95, double_q=double_q, alpha=0.6, eps=1e-3)
        ko = fu.fused_grads_cuda(plan, params, **data, **kw)
        po = fu.fused_grads_plain(plan, params, **data, **kw)
        err = max(err, _close(ko[0], po[0], 1e-4, 1e-6, "K7 flat grads"))
        err = max(err, _close(ko[1], po[1], 1e-4, 1e-5, "K7 td"))
        err = max(err, _close(ko[2], po[2], 1e-4, 1e-5, "K7 prio"))
        err = max(err, _close(ko[3], po[3], 1e-4, 0.0, "K7 loss"))
        err = max(err, _close(ko[4], po[4], 1e-4, 0.0, "K7 gnorm"))
        # the data-parallel update (K7, a reduce, K3's Adam kernel per
        # sub-update) at U=32 with a reduce that leaves the gradient as it
        # is: K3's update (the same partials summed in the same order, the
        # same Adam arithmetic) to rtol 1e-6, and its twin within K3's
        # tolerances (params/m/v rtol 2e-4 / atol 2e-5, loss rtol 1e-4)
        dp_err, same = _dp_group_check(
            torch, fu.fused_dp_group_update_cuda,
            fu.fused_dp_group_update_plain, fu.fused_group_update_cuda, plan,
            params, dict(gamma=0.95, double_q=double_q, lr=1e-4, alpha=0.6,
                         eps=1e-3), 32, B, lambda n: dict(
                obs=uni(n, 2) * 10, nobs=uni(n, 2) * 10,
                action=torch.randint(0, 4, (n,), generator=g, device=dev),
                reward=rnd(n), done=(uni(n) < 0.05).float(),
                weights=uni(n) + 0.5, q_sp_tgt=rnd(n, 4)), "K7",
            lambda d, k: _ff_ties(torch, fu, plan, params, d, k))
        err = max(err, dp_err)
        if timing is None:
            timing = (
                _time_ms(lambda: fu.fused_grads_cuda(plan, params, **data,
                                                     **kw), 200),
                _time_ms(lambda: fu.fused_grads_plain(plan, params, **data,
                                                      **kw), 20))
            # inputs and params read once; td, prio and the flat grad out
            bound = _bound(_nbytes(data, params, ko[:3]),
                           _dense_update_flops(plan, B, 1, double_q))
        _say(f"K7 fused_grads dueling={dueling} double_q={double_q} B=512: "
             f"ok; DP update U=32 equals K3's bit for bit: {same}")
    results["fused_grads"] = dict(max_abs_err=err, ms=timing[0],
                                  plain_ms=timing[1], bound_ms=bound[0],
                                  bound_by=bound[1])
    _say(_kernel_line("K7 fused_grads B=512 (one cooperative launch)",
                      *timing, *bound))

    # --- K8: B=512, T=8, LSTM(2,32)+Dense(32,4) with double-Q
    # (drqn_bench) and the dueling GRU net with a Dense layer before the
    # cell and max targets. grads rtol 1e-4 / atol 1e-6 (f32 sums over
    # 4096 window steps in another order: tile partials vs autograd), loss
    # and gnorm rtol 1e-4; against the tile-order reference rtol 1e-5 (grads
    # atol 1e-7, loss and gnorm atol 0). The data-parallel update with an
    # identity reduce equals K5's bit for bit.
    T = 8
    err = 0.0
    timing = None
    for name, net, double_q in (("LSTM32 double-Q", lstm, True),
                                ("dueling GRU max", gru, False)):
        plan = fd.drqn_plan_for(net, T, B, double_q)
        params = net.init(g)
        lens = torch.randint(1, T + 1, (B,), generator=g, device=dev)
        data = dict(
            obs=uni(B, T, 2) * 10, nobs=uni(B, T, 2) * 10,
            action=torch.randint(0, 4, (B, T), generator=g, device=dev),
            reward=rnd(B, T), done=(uni(B, T) < 0.1).float(),
            mask=(torch.arange(T, device=dev)[None] < lens[:, None]).float(),
            q_sp_tgt=rnd(B, T, 4))
        kw = dict(gamma=0.95, double_q=double_q)
        ko = fd.fused_drqn_grads_cuda(plan, params, **data, **kw)
        po = fd.fused_drqn_grads_plain(plan, params, **data, **kw)
        ro = fd.fused_drqn_grads_tiled(plan, params, **data, **kw)
        err = max(err, _close(ko[0], po[0], 1e-4, 1e-6, f"K8 {name} grads"))
        err = max(err, _close(ko[1], po[1], 1e-4, 0.0, f"K8 {name} loss"))
        err = max(err, _close(ko[2], po[2], 1e-4, 0.0, f"K8 {name} gnorm"))
        for k, r, n in zip(ko, ro, ("grads", "loss", "gnorm")):
            _close(k, r, 1e-5, 1e-7 if n == "grads" else 0.0,
                   f"K8 {name} vs tile-order {n}")
        # the data-parallel update at U=4 with an identity reduce against
        # K5's update (bit for bit) and its twin (K5's tolerances)
        dp_err, same = _dp_group_check(
            torch, fd.fused_drqn_dp_group_update_cuda,
            fd.fused_drqn_dp_group_update_plain,
            fd.fused_drqn_group_update_cuda, plan, params,
            dict(gamma=0.95, double_q=double_q, lr=1e-3), 4, B, lambda n: dict(
                obs=uni(n, T, 2) * 10, nobs=uni(n, T, 2) * 10,
                action=torch.randint(0, 4, (n, T), generator=g, device=dev),
                reward=rnd(n, T), done=(uni(n, T) < 0.1).float(),
                mask=(torch.arange(T, device=dev)[None]
                      < torch.randint(1, T + 1, (n, 1), generator=g,
                                      device=dev)).float(),
                q_sp_tgt=rnd(n, T, 4)), "K8",
            lambda d, k: _drqn_ties(torch, fd, plan, params, d, k))
        _check(same, f"K8 {name}: the DP update differs from K5's")
        err = max(err, dp_err)
        if timing is None:
            timing = (
                _time_ms(lambda: fd.fused_drqn_grads_cuda(
                    plan, params, **data, **kw), 100),
                _time_ms(lambda: fd.fused_drqn_grads_plain(
                    plan, params, **data, **kw), 3, 1))
            bound = _bound(_nbytes(data, params, ko[0]),
                           _drqn_update_flops(plan, B, T, 1, double_q))
        _say(f"K8 fused_drqn_grads {name} B=512 T=8: ok, matches the "
             f"tile-order reference at rtol 1e-5; DP update U=4 equals K5's "
             f"bit for bit")
    results["fused_drqn_grads"] = dict(max_abs_err=err, ms=timing[0],
                                       plain_ms=timing[1], bound_ms=bound[0],
                                       bound_by=bound[1])
    _say(_kernel_line("K8 fused_drqn_grads LSTM32 B=512 T=8 (one cooperative "
                      "launch)", *timing, *bound))


def _dp_group_check(torch, dp_cuda, dp_plain, whole_cuda, plan, params, kw,
                    U, B, make_data, what, ties_fn):
    """The data-parallel grouped update (kernel, reduce, Adam launch per
    sub-update) with a reduce that leaves the gradient as it is, against
    the whole-phase kernel's update (rtol 1e-6) and against its own twin
    (params/m/v rtol 2e-4 / atol 2e-5, loss rtol 1e-4, gnorm rtol 1e-3, the
    JAX package's fused-vs-XLA tolerances; with double-Q allowing for near
    ties of the s' argmax, :func:`_tie_aware`, found by ``ties_fn(data,
    kw)``); prints both kernel routes' times. Returns the max abs error
    against the twin and whether the kernels agree bit for bit."""
    data = make_data(U * B)
    kw = dict(kw, batch_size=B, n_updates=U)
    keep = lambda flat: None
    state = lambda: _adam_state(torch, params)
    ds, ws = state(), state()
    do = dp_cuda(plan, *ds, **data, reduce=keep, **kw)
    wo = whole_cuda(plan, *ws, **data, **kw)
    same = all(torch.equal(a, b) for a, b in zip(do, wo)) and all(
        torch.equal(ds[i][k], ws[i][k]) for i in range(3) for k in plan.names)
    for i in range(3):
        for k in plan.names:
            _close(ds[i][k], ws[i][k], 1e-6, 0.0, f"{what} DP vs whole {k}")

    def pairs(swaps):
        d = dict(data, q_sp_tgt=_swap_ties(data["q_sp_tgt"], swaps))
        ps = state()
        po = dp_plain(plan, *ps, **d, reduce=keep, **kw)
        _check(int(ds[3]) == int(ps[3]) == U, f"{what} DP count")
        return [(ds[i][k], ps[i][k], 2e-4, 2e-5, f"{what} DP {name} {k}",
                 True) for i, name in ((0, "param"), (1, "m"), (2, "v"))
                for k in plan.names] + [
            (do[-2], po[-2], 1e-4, 0.0, f"{what} DP loss", True),
            (do[-1], po[-1], 1e-3, 1e-7, f"{what} DP gnorm", True)]

    ties = ties_fn(data, kw) if kw["double_q"] else []
    err, n_ties, n_other = _tie_aware(pairs, ties)
    ms = _time_ms(lambda: dp_cuda(plan, *state(), **data, reduce=keep, **kw),
                  10)
    wms = _time_ms(lambda: whole_cuda(plan, *state(), **data, **kw), 10)
    _say(f"{what} DP update U={U} B={B}: {ms:.4f} ms (K7/K8 + Adam launch "
         f"per sub-update) vs {wms:.4f} ms (whole-phase kernel); {n_ties} "
         f"near ties of the s' argmax, {n_other} taken the other way by the "
         f"kernel")
    return err, same


def _small_loop(torch, dev, sample_u, collect_u, cartpole=False):
    """128 envs, U = 4, B = 32 on SimpleGridWorld (or CartPole) with a
    dueling 16-16 tanh net: populate 2 steps, then 2 iterations, every
    draw injected."""
    from deepqlearning_tpu_torch import (
        CartPole, Chain, Dense, DQNConfig, Flatten, LinearDecaySchedule,
        PrioritizedReplayBuffer, SimpleGridWorld, create_dueling_network)
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry
    from deepqlearning_tpu_torch.models.chain import params_of

    env = CartPole() if cartpole else SimpleGridWorld()
    no, A = env.obs_shape[0], env.num_actions
    net = create_dueling_network(Chain(
        Flatten(), Dense(no, 16, torch.tanh), Dense(16, 16, torch.tanh),
        Dense(16, A)))
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
    reset_rows = slice(2, 6) if cartpole else slice(0, 2)
    st, obs = env.reset_cols(collect_u[0][reset_rows].to(dev))
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
    the same seed and uniforms, on SimpleGridWorld and on CartPole. Params
    rtol 1e-3 / atol 1e-4 and replay actions >= 99% equal: the card sums in
    other orders."""
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
    # the same small loop on CartPole (its six uniform rows: explore,
    # random action, four reset values), and the same tolerances
    rng = np.random.default_rng(2)
    collect_u = [torch.from_numpy(rng.random((6, 128), np.float32))
                 for _ in range(4)]
    sample_u = [torch.from_numpy(rng.random(128, np.float32))
                for _ in range(2)]
    cg = _small_loop(torch, dev, sample_u, collect_u, cartpole=True)
    torch.cuda.synchronize()
    cc = _small_loop(torch, torch.device("cpu"), sample_u, collect_u,
                     cartpole=True)
    err = 0.0
    for k in cc.params:
        err = max(err, _close(cg.params[k], cc.params[k], 1e-3, 1e-4,
                              f"CartPole slice {k}"))
    _close(cg.loss, cc.loss, 1e-3, 1e-5, "CartPole slice loss")
    rows_g, rows_c = cg.replay.rows.cpu(), cc.replay.rows
    agree = (rows_g[:, 8] == rows_c[:, 8]).float().mean().item()
    _check(agree >= 0.99, f"CartPole slice actions agree on only {agree}")
    _check(int(cg.replay.size) == int(cc.replay.size) == 512,
           "CartPole slice size")
    _say(f"CartPole slice GPU vs CPU (128 envs, U=4, B=32, 2 iterations): "
         f"ok, params max_abs_err {err:.3g}, replay actions agree "
         f"{agree:.4f}")


def _small_drqn_loop(torch, dev, collect_u, draws):
    from deepqlearning_tpu_torch import (
        LSTM, Chain, Dense, DQNConfig, EpisodeReplayBuffer,
        LinearDecaySchedule, SimpleGridWorld)
    from deepqlearning_tpu_torch.learner.loop import (
        build_loop, init_carry, populate)
    from deepqlearning_tpu_torch.models.chain import params_of

    env = SimpleGridWorld()
    net = Chain(LSTM(2, 8), Dense(8, 4))
    net.init(torch.Generator().manual_seed(0))  # same weights on both devices
    net.to(dev)
    cfg = DQNConfig(num_envs=128, batch_size=16, buffer_size=256,
                    train_freq=64, trace_length=4, max_episode_length=5,
                    target_update_freq=256, learning_rate=1e-3,
                    recurrence=True)
    buf = EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size, cfg.batch_size,
                              cfg.trace_length, cfg.max_episode_length,
                              num_envs=cfg.num_envs, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.05, 500), 0.95)
    c = init_carry(env, net, buf, cfg, opt, dev, params=params_of(net))
    st, obs = env.reset_cols(collect_u[0][:2].to(dev))
    c = c._replace(actor=c.actor._replace(env_state=st, obs=obs))
    n_pop = cfg.max_episode_length + 1
    c = populate(pop, buf, c, n_pop, [u.to(dev) for u in collect_u[:n_pop]])
    to = lambda d: type(d)(*(x if x is None else x.to(dev) for x in d))
    for i in range(2):
        c = it(c, collect_u=[collect_u[n_pop + i].to(dev)],
               sample_u=[to(draws[i])])
    return c


def phase_drqn_slice(torch, dev):
    """The small DRQN loop (128 envs, LSTM(2,8), B=16, T=4, U=2) on the card
    vs on the CPU from the same seed, uniforms and draws: populate and two
    iterations. Params rtol 1e-3 / atol 1e-4 (the card sums in other
    orders); the stored episodes exactly on envs whose actions agree."""
    from deepqlearning_tpu_torch import EpisodeDraws

    rng = np.random.default_rng(1)
    collect_u = [torch.from_numpy(rng.random((6, 128), np.float32))
                 for _ in range(8)]
    draws = [EpisodeDraws(
        env_u=torch.from_numpy(rng.random(32, np.float32)),
        rec=torch.from_numpy(rng.integers(0, 1 << 30, 32)),
        start=torch.from_numpy(rng.integers(0, 1 << 30, 32)))
        for _ in range(2)]
    cg = _small_drqn_loop(torch, dev, collect_u, draws)
    torch.cuda.synchronize()
    cc = _small_drqn_loop(torch, torch.device("cpu"), collect_u, draws)
    err = 0.0
    for k in cc.params:
        err = max(err, _close(cg.params[k], cc.params[k], 1e-3, 1e-4,
                              f"drqn slice {k}"))
    _close(cg.loss, cc.loss, 1e-3, 1e-5, "drqn slice loss")
    rg, rc = cg.replay, cc.replay
    _check(rg.t == rc.t == 8, "drqn slice steps")
    data_g = rg.data.cpu()
    agree = (data_g[..., 4] == rc.data[..., 4]).all(dim=0)   # per env
    frac = agree.float().mean().item()
    _check(frac >= 0.99, f"drqn slice actions agree on only {frac}")
    _check(torch.equal(data_g[:, agree], rc.data[:, agree]),
           "drqn slice episode rows differ on agreeing envs")
    for name in ("ep_start", "ep_len", "rec_count"):
        _check(torch.equal(getattr(rg, name).cpu()[agree],
                           getattr(rc, name)[agree]),
               f"drqn slice {name} differs on agreeing envs")
    _say(f"DRQN slice GPU vs CPU (128 envs, LSTM(2,8), B=16, T=4, U=2, "
         f"2 iterations): ok, params max_abs_err {err:.3g}, envs agree "
         f"{frac:.4f}")


def _drqn_setup(torch, dev, num_envs=16384, **cfg_kw):
    """``(iteration, carry, cfg, (env, buffer))``: ``scripts/
    drqn_bench.py``'s configuration (SimpleGridWorld, ``Chain(LSTM(2, 32),
    Dense(32, 4))``, episode replay, batch 512, trace 8, U = 4 at 16384
    envs) through ``build_loop``, populated as ``solve`` populates it:
    ``max_episode_length + 1`` steps (every env commits an episode before
    the first sample) through ``make_collect_graph``, replays of one CUDA
    graph that end by dropping the open episodes. ``cfg_kw`` go to
    ``DQNConfig`` (``fused_updates=False, fused_collect=False``: the plain
    recurrent route)."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, Dense, DQNConfig, EpisodeReplayBuffer,
        LinearDecaySchedule, SimpleGridWorld)
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry
    from deepqlearning_tpu_torch.learner.segment import make_collect_graph

    env = SimpleGridWorld()
    net = Chain(LSTM(2, 32, device=dev), Dense(32, env.num_actions,
                                               device=dev))
    cfg = DQNConfig(num_envs=num_envs, batch_size=512, buffer_size=4096,
                    train_freq=4096, trace_length=8, max_episode_length=100,
                    recurrence=True, double_q=True, **cfg_kw)
    buf = EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size, cfg.batch_size,
                              cfg.trace_length, cfg.max_episode_length,
                              num_envs=num_envs, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.01, 100_000),
                              gamma=env.discount)
    c = init_carry(env, net, buf, cfg, opt, dev)
    n_pop = cfg.max_episode_length + 1
    c = make_collect_graph(pop, c, cfg, env, buf,
                           "chip_smoke DRQN populate")(c, n_pop)
    _check(not bool(c.replay.cur_len.any()) and int(c.replay.t) == n_pop,
           "DRQN populate graph: open episodes left or t wrong")
    return it, c, cfg, (env, buf)


def _drqn_loop(torch, dev, num_envs, n_iters):
    """:func:`_drqn_setup`'s loop, one eager warm-up iteration and
    ``n_iters`` as replays of its CUDA graph (``make_segment``, as
    ``solve`` runs them): ``(cfg, loss)``. The library is called by
    populate's warm-up and capture (K6), the eager warm-up (K5, K6) and
    the segment's warm-up and capture (K5, K6, and K11 beside K5): K6 5,
    K5 and K11 3."""
    from deepqlearning_tpu_torch.learner.segment import (
        CompiledSegment, make_segment)

    it, c, cfg, (env, buf) = _drqn_setup(torch, dev, num_envs)
    c = it(c)  # warm-up
    run = make_segment(it, c, cfg, env, buf, "chip_smoke DRQN loop")
    _check(isinstance(run, CompiledSegment), "the DRQN loop is not captured")
    c = run(c, n_iters)
    loss = float(c.loss)
    _check(np.isfinite(loss) and np.isfinite(float(c.gnorm)), "loss finite")
    _check(all(bool(torch.isfinite(p).all()) for p in c.params.values()),
           "params finite")
    _check(int(c.replay.rec_count.min()) > 0 and int(c.actor.ep_count) > 0,
           "loop progress")
    _check(int(c.replay.t) == cfg.max_episode_length + 2 + n_iters,
           f"DRQN loop: the ring's step counter {int(c.replay.t)}")
    _check(all(bool(torch.isfinite(s).all()) for s in c.actor.net_state[0]),
           "LSTM state finite")
    return cfg, loss


def _dueling_net(torch, dev, width, act, no=2, A=4):
    """The dueling ``Chain(Flatten(), Dense(no, w, act), Dense(w, w, act),
    Dense(w, A))``: by default over SimpleGridWorld's 2-d observation."""
    from deepqlearning_tpu_torch import (
        Chain, Dense, Flatten, create_dueling_network)

    return create_dueling_network(Chain(
        Flatten(), Dense(no, width, act, device=dev),
        Dense(width, width, act, device=dev), Dense(width, A, device=dev)))


def _cartpole_model(torch, dev=None):
    """``examples/cartpole_dqn.py``'s model: ``Chain(Dense(4, 64, tanh),
    Dense(64, 64, tanh), Dense(64, 2))`` (the solver makes it dueling)."""
    from deepqlearning_tpu_torch import Chain, Dense

    return Chain(Dense(4, 64, torch.tanh, device=dev),
                 Dense(64, 64, torch.tanh, device=dev),
                 Dense(64, 2, device=dev))


def _cartpole_net(torch, dev):
    """The CartPole solve's network: the example's model, dueling."""
    from deepqlearning_tpu_torch import create_dueling_network

    return create_dueling_network(_cartpole_model(torch, dev))


def _loop_setup(torch, dev, num_envs, buffer_size, batch_size, train_freq,
                n_pop, net=None, env=None, **cfg_kw):
    """``(iteration, carry, cfg, (env, buffer))``: a feed-forward PER loop
    through ``build_loop`` on SimpleGridWorld (or ``env``), with the
    headline's dueling 2-64-64-4 tanh net unless ``net`` is given, after
    ``n_pop`` populate steps; ``cfg_kw`` go to ``DQNConfig``."""
    from deepqlearning_tpu_torch import (
        DQNConfig, LinearDecaySchedule, PrioritizedReplayBuffer,
        SimpleGridWorld)
    from deepqlearning_tpu_torch.learner.loop import (
        build_loop, init_carry, populate)

    env = SimpleGridWorld() if env is None else env
    if net is None:
        net = _dueling_net(torch, dev, 64, torch.tanh)
    cfg_kw.setdefault("max_episode_length", 100)
    cfg = DQNConfig(num_envs=num_envs, batch_size=batch_size,
                    buffer_size=buffer_size, train_freq=train_freq,
                    double_q=True, dueling=True, prioritized_replay=True,
                    **cfg_kw)
    buf = PrioritizedReplayBuffer(
        env.obs_shape, cfg.buffer_size, cfg.batch_size,
        alpha=cfg.prioritized_replay_alpha, beta=cfg.prioritized_replay_beta,
        eps=cfg.prioritized_replay_epsilon, prioritized=True,
        obs_dtype=cfg.dtype, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.01, 100_000),
                              gamma=env.discount)
    c = populate(pop, buf, init_carry(env, net, buf, cfg, opt, dev), n_pop)
    return it, c, cfg, (env, buf)


def _loop(torch, dev, num_envs, buffer_size, batch_size, train_freq,
          n_iters, n_pop, net=None, env=None, **cfg_kw):
    """:func:`_loop_setup`'s loop, a warm-up iteration and ``n_iters``
    more: ``(cfg, loss)``. After the eager warm-up the iterations run
    through ``make_segment``, as ``solve`` runs them: replays of one CUDA
    graph on the routes that ``learner/segment.py`` captures (its warm-up
    and capture launch each kernel once more), eagerly on the others."""
    from deepqlearning_tpu_torch.learner.segment import make_segment

    it, c, cfg, (env, buf) = _loop_setup(
        torch, dev, num_envs, buffer_size, batch_size, train_freq, n_pop,
        net, env, **cfg_kw)
    c = it(c)  # warm-up
    c = make_segment(it, c, cfg, env, buf, "chip_smoke loop")(c, n_iters)
    loss = float(c.loss)
    _check(np.isfinite(loss) and np.isfinite(float(c.gnorm)), "loss finite")
    _check(all(bool(torch.isfinite(p).all()) for p in c.params.values()),
           "params finite")
    _check(int(c.replay.size) > 0 and int(c.actor.ep_count) > 0,
           "loop progress")
    return cfg, loss


def _wide_loop(torch, dev, n_iters):
    """The grouped plain route at full width: SimpleGridWorld, 2048 envs,
    train_freq 512 (U = 4), batch 512, 2^15-slot PER (α 0.6, β 0.4, ε
    1e-3), double-Q, lr 1e-4, γ 0.95, a target sync every 32768 env steps
    (``examples/image_conv_dqn.py``'s loop shape) with that example's
    512-wide dueling Dense head over the grid's 2-d observation. The K3
    plan (layers at most 256 wide) and the K4 plan (128) refuse the net:
    per iteration the plain collect step, one K2 draw of U·B rows and U
    sub-updates with the K1 loss head."""
    return _loop(torch, dev, 2048, 1 << 15, 512, 512, n_iters, 2,
                 net=_dueling_net(torch, dev, 512, torch.relu),
                 target_update_freq=512 * 64)


def _train_state_counters(torch, logdir):
    """``(iters, actor t)`` of the train state a solve saved in ``logdir``
    (``solver/checkpoint.py``'s archive: NamedTuples by field name)."""
    from deepqlearning_tpu_torch.solver import checkpoint

    raw = torch.load(os.path.join(logdir, checkpoint.TRAIN_STATE_NAME),
                     weights_only=True)["__fields__"]
    return int(raw["iters"]), int(raw["actor"]["__fields__"]["t"])


def _solve_ff(torch, dev, logdir, n_iters, resume=False):
    """``DeepQLearningSolver.solve`` on SimpleGridWorld with the headline's
    dueling 2-64-64-4 net at U = 1 (num_envs = train_freq = 4096), PER,
    double-Q, batch 512, a 2^18 replay, eval, log and save inside the run,
    on the card (``device=None``). Returns ``(solver, policy, env-steps/s
    over the whole solve)``."""
    from deepqlearning_tpu_torch import (
        Chain, DeepQLearningSolver, Dense, Flatten, SimpleGridWorld)

    E = 4096
    solver = DeepQLearningSolver(
        qnetwork=Chain(Flatten(), Dense(2, 64, torch.tanh),
                       Dense(64, 64, torch.tanh), Dense(64, 4)),
        num_envs=E, train_freq=E, batch_size=512, buffer_size=1 << 18,
        max_steps=n_iters * E, train_start=4 * E, learning_rate=1e-4,
        double_q=True, dueling=True, prioritized_replay=True,
        max_episode_length=100, target_update_freq=8 * E,
        eval_freq=25 * E, log_freq=25 * E, save_freq=50 * E,
        num_ep_eval=100, logdir=logdir, verbose=True)
    _check(solver.device is None, "the solve phase runs with device=None")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy = solver.solve(SimpleGridWorld(), resume=resume)
    dt = time.perf_counter() - t0
    _check(all(p.is_cuda and bool(torch.isfinite(p).all())
               for p in policy.params.values()), "solve: params on the card")
    _check(solver.metrics["t"] == [25 * E * k for k in
                                   range(1, n_iters // 25 + 1)],
           f"solve: log steps {solver.metrics['t']}")
    _check(all(np.isfinite(v) for v in solver.metrics["loss"]),
           "solve: loss finite")
    return solver, policy, n_iters * E / dt


def _solve_parts(torch, fn):
    """``(fn(), {part: seconds})``: ``fn()``, a ``solve``, with the seconds
    the port's recorder (``utils/profiling.py``) gives each part that is
    not a segment's replays: "capture" (the ``segment.capture`` spans of
    the solve's populate graph and segment: the warm-ups, captures and
    guard replays), "populate" (the populate graph's replays), "evaluation"
    and "save" (the spans ``solve.evaluation`` and ``solve.save``: the
    best model and the train state), each ending when the card has done
    its work."""
    from deepqlearning_tpu_torch.utils import profiling

    profiling.reset()
    out = fn()
    totals = profiling.snapshot()["totals"]

    def seconds(name, solve_only=False):
        return sum(t["total_s"] for route, t in totals.get(name, {}).items()
                   if route.startswith("solve on") or not solve_only)

    return out, dict(capture=seconds("segment.capture", True),
                     populate=seconds("populate"),
                     evaluation=seconds("solve.evaluation"),
                     save=seconds("solve.save"))


def _solve_drqn(torch, logdir, n_iters):
    """``solve`` with ``Chain(LSTM(2, 32), Dense(32, 4))``, dueling, episode
    replay (batch 512, trace 8), num_envs = train_freq = 1024 (U = 1)."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, DeepQLearningSolver, Dense, SimpleGridWorld)

    E = 1024
    solver = DeepQLearningSolver(
        qnetwork=Chain(LSTM(2, 32), Dense(32, 4)), num_envs=E, train_freq=E,
        batch_size=512, buffer_size=4096, trace_length=8,
        max_episode_length=100, recurrence=True, dueling=True, double_q=True,
        prioritized_replay=False, learning_rate=1e-3, max_steps=n_iters * E,
        target_update_freq=8 * E, eval_freq=10 * E, log_freq=10 * E,
        save_freq=10 * E, num_ep_eval=100, logdir=logdir, verbose=True)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy = solver.solve(SimpleGridWorld())
    dt = time.perf_counter() - t0
    _check(all(p.is_cuda and bool(torch.isfinite(p).all())
               for p in policy.params.values()), "DRQN solve: params")
    _check(len(solver.metrics["eval"]) == n_iters // 10,
           "DRQN solve: evaluations")
    av = policy.actionvalues(np.zeros(2, np.float32))
    _check(av.shape == (4,) and np.isfinite(av).all(), "DRQN policy")
    return solver, n_iters * E / dt


def _solve_learning(torch):
    """``tests/test_learning.py::test_prioritized_ddqn``'s configuration on
    the card: TestMDP((5, 5), 4, 6), 10000 steps, greedy return of 100
    episodes from a generator seeded 7, threshold 1.5 (optimum 2.1)."""
    from deepqlearning_tpu_torch import (
        Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, Flatten,
        LinearDecaySchedule, TestMDP, basic_evaluation)

    mdp = TestMDP((5, 5), 4, 6)
    solver = DeepQLearningSolver(
        qnetwork=Chain(Flatten(), Dense(100, 8, torch.tanh),
                       Dense(8, mdp.num_actions)),
        max_steps=10000, learning_rate=0.005, eval_freq=2000,
        num_ep_eval=100, log_freq=2000, logdir=None, verbose=False,
        exploration_policy=EpsGreedyPolicy(
            LinearDecaySchedule(1.0, 0.01, 5000)),
        double_q=True, dueling=True, prioritized_replay=True)
    t0 = time.perf_counter()
    policy = solver.solve(mdp)
    dt = time.perf_counter() - t0
    r, steps, _ = basic_evaluation(policy.network, policy.params, mdp, 100,
                                   100, 7)
    _check(r >= 1.5, f"learning on the card: greedy return {r} < 1.5")
    return r, steps, dt


def _solve_learning_drqn(torch, name):
    """``tests/test_learning.py``'s ``test_testmdp_drqn`` (TestMDP((5, 5),
    1, 6): partially observable; ``Chain(Flatten(), LSTM(25, 8),
    Dense(8, 4))``, double-Q, not dueling, trace 10) or
    ``test_gridworld_ddrqn`` (SimpleGridWorld, ``Chain(Flatten(), LSTM(2,
    32), Dense(32, 4))``, lr 1e-3, uniform replay, double dueling, trace
    10; evaluated over 10 steps) on the card: 6000 steps, the tests'
    solver defaults (``tests/test_torch_learning_drqn.py::solver``), the
    greedy return of 100 episodes from a generator seeded 7. Returns
    ``(return, env-steps/s over the whole solve, collect steps per
    iteration)``; the threshold 0.0 is the test's."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, Flatten,
        LinearDecaySchedule, SimpleGridWorld, TestMDP, basic_evaluation)

    kw = dict(max_steps=6000, learning_rate=0.005, eval_freq=2000,
              num_ep_eval=100, log_freq=2000, logdir=None, verbose=False,
              exploration_policy=EpsGreedyPolicy(
                  LinearDecaySchedule(1.0, 0.01, 3000)),
              recurrence=True, trace_length=10, double_q=True)
    if name == "test_testmdp_drqn":
        env, eval_steps = TestMDP((5, 5), 1, 6), 100
        kw.update(qnetwork=Chain(Flatten(), LSTM(25, 8),
                                 Dense(8, env.num_actions)), dueling=False)
    else:
        env, eval_steps = SimpleGridWorld(), 10
        kw.update(qnetwork=Chain(Flatten(), LSTM(2, 32),
                                 Dense(32, env.num_actions)),
                  learning_rate=0.001, prioritized_replay=False,
                  dueling=True)
    solver = DeepQLearningSolver(**kw)
    _check(solver.device is None, f"{name}: runs with device=None")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy = solver.solve(env)
    dt = time.perf_counter() - t0
    _check(all(p.is_cuda for p in policy.params.values()),
           f"{name}: params on the card")
    r, _, _ = basic_evaluation(policy.network, policy.params, env, 100,
                               eval_steps, 7)
    _check(r >= 0.0, f"{name} on the card: greedy return {r} < 0.0")
    return r, 6000 / dt, solver.config.steps_per_iter


def phase_solve(torch, dev, card, run_path):
    """``DeepQLearningSolver.solve``, the users' front door, on the card:
    (a) the feed-forward solve, ``restore_best_model`` and a resumed solve
    (U = 1, populate and the iterations as graph replays: K4 is launched
    by the populate graph's warm-up and capture and the segment's, K1 and
    K2 by the segment's, K3 never; the resumed solve runs
    under ``torch.profiler``, whose trace must hold K1, K2 and K4 once per
    replayed iteration or populate step and eager warm-up, and the same
    device events in every replay of a graph; each graph's first launch,
    the guard's replay, is left out: the profiler can lose its head);
    (b) the DRQN solve (K5 at U = 1 and K6; populate and the segments as
    graph replays, so the launch counts hold warm-ups and captures only);
    (c) a learning threshold of the JAX package's tests."""
    import tempfile

    from deepqlearning_tpu_torch.solver import checkpoint

    n = 100
    with tempfile.TemporaryDirectory() as logdir:
        (solver, policy, sps), ff = run_path(
            "solve (feed-forward)", lambda: _solve_ff(torch, dev, logdir, n),
            ("dq_td_loss", "dq_tree_sample", "dq_fused_collect",
             "dq_adam_update"), ("dq_fused_update",))
        _check(ff["dq_td_loss"] == ff["dq_tree_sample"]
               == ff["dq_adam_update"] == 2 and ff["dq_fused_collect"] == 4,
               f"solve: launches {ff}")
        _check(_train_state_counters(torch, logdir) == (n, n * 4096),
               "solve: saved train state")
        for f in (checkpoint.CKPT_NAME, checkpoint.TRAIN_STATE_NAME):
            _check(os.path.exists(os.path.join(logdir, f)), f"solve: {f}")
        _check(any("tfevents" in f for f in os.listdir(logdir)),
               "solve: no TensorBoard events")
        env = policy.problem
        restored = solver.restore_best_model(env)
        _check(all(torch.equal(restored.params[k], policy.params[k])
                   for k in policy.params), "restore_best_model differs")
        _check(restored.action(np.asarray([1.0, 1.0], np.float32))
               in env.action_map, "restored policy action")
        evals = solver.metrics["eval"]
        _say(f"solve (a) feed-forward: SimpleGridWorld, 4096 envs, U=1, "
             f"batch 512, 2^18 PER, {n} iterations: {sps:.1f} env-steps/s "
             f"over the whole solve (populate, {len(evals)} evaluations and "
             f"saves included), eval returns {[round(r, 3) for _, r in evals]}"
             f"; restore_best_model equals the returned policy | {card} | "
             f"launches {ff}")
        m = 5
        ((_, _, sps_r), seen, per_launch), rs = run_path(
            "solve (resume)", lambda: _graph_launch_trace(
                torch, lambda: _solve_ff(torch, dev, logdir, m, resume=True)),
            ("dq_td_loss", "dq_tree_sample", "dq_fused_collect",
             "dq_adam_update"), ("dq_fused_update",))
        _check(rs["dq_td_loss"] == rs["dq_tree_sample"]
               == rs["dq_adam_update"] == 2 and rs["dq_fused_collect"] == 4,
               f"resume: launches {rs}")
        # the segment: the eager warm-up and m replays; populate (4 steps,
        # train_start = 4 x 4096): the eager warm-up and 4 replays (each
        # graph's guard replay left out); K10 in each iteration of the
        # segment: three forwards of the 6 Dense layers and one backward
        # (populate's K4 runs no layer, no evaluation falls in the m
        # iterations)
        want = {"td_loss_kernel": m + 1, "tree_sample_kernel": m + 1,
                "adam_kernel": m + 1, "fc_kernel": m + 1 + 4 + 1,
                "bias_act_kernel": 6 * 3 * (m + 1),
                "bias_act_grad_kernel": 6 * (m + 1)}
        _check(seen == want, f"resume: the trace saw {seen}, not {want}")
        _check(len(per_launch) == 2 and all(len(x) == 1 for x in per_launch),
               f"resume: the graphs' replays differ in their device events "
               f"{per_launch} (populate, segment)")
        _check(_train_state_counters(torch, logdir) == (n + m,
                                                        (n + m) * 4096),
               "resume did not continue the counters")
        _say(f"solve (a) resume=True: {m} more iterations continue the "
             f"saved counters (iters {n} -> {n + m}): {sps_r:.1f} env-steps/s "
             f"under torch.profiler, whose trace saw the port's kernels "
             f"launched {seen} outside the guard replays, and "
             f"{per_launch} device events in each replay of populate's "
             f"graph and the segment's | {card} | launches {rs}")
    with tempfile.TemporaryDirectory() as logdir:
        nd = 30
        ((solver, sps_d), parts), rec = run_path(
            "solve (DRQN)", lambda: _solve_parts(
                torch, lambda: _solve_drqn(torch, logdir, nd)),
            ("dq_fused_drqn", "dq_fused_collect_rnn"))
        total = nd * 1024 / sps_d
        # populate and the segments as graph replays: the library is called
        # by populate's warm-up and capture (K6) and the segment's (K5, K6),
        # where the eager solve launched every step (K6 131, K5 30)
        _check(rec["dq_fused_drqn"] == 2 and rec["dq_fused_collect_rnn"] == 4,
               f"DRQN solve: launches {rec}, not K5 2 and K6 4")
        _say(f"solve (b) DRQN: LSTM(2,32), dueling, episode replay, 1024 "
             f"envs, U=1, batch 512, trace 8, {nd} iterations, populate "
             f"and the segments as graph replays: {sps_d:.1f} env-steps/s "
             f"over the whole solve ({total:.4f} s, of which "
             f"{ {k: round(v, 4) for k, v in parts.items()} } s, the rest "
             f"the segments' replays and the solve's own host work), eval "
             f"returns {[round(r, 3) for _, r in solver.metrics['eval']]} "
             f"| {card} | launches {rec}")
    (r, steps, dt), lrn = run_path(
        "solve (learning)", lambda: _solve_learning(torch),
        ("dq_td_loss", "dq_tree_sample"))
    _say(f"solve (c) learning: test_prioritized_ddqn's config on TestMDP, "
         f"10000 steps in {dt:.2f} s: greedy return {r:.4f} (>= 1.5, "
         f"optimum 2.1), {steps:.2f} steps | {card} | launches {lrn}")


def phase_drqn_learning(torch, card, run_path):
    """11 (f): ``tests/test_learning.py``'s two DRQN learning tests'
    configurations through ``solve(device=None)``, populate and the
    segments as graph replays, each held to its test's threshold."""
    for name, cols in (("test_testmdp_drqn", False),
                       ("test_gridworld_ddrqn", True)):
        (r, sps_l, spi), drq = run_path(
            f"solve (f) {name}", lambda: _solve_learning_drqn(torch, name),
            ("dq_fused_drqn",))
        # graph routes: a kernel is launched by the graphs' warm-ups and
        # captures only, never once per iteration: K5 by the segment's
        # (one update per iteration), K6 (SimpleGridWorld; TestMDP has no
        # cols) by populate's (one collect step) and the segment's (spi
        # collect steps per iteration)
        want = {"dq_fused_drqn": 2,
                "dq_fused_collect_rnn": 2 + 2 * spi if cols else 0}
        _check(all(drq.get(k, 0) == v for k, v in want.items()),
               f"solve (f) {name}: launches {drq}, not {want}")
        _say(f"solve (f) learning: {name}'s configuration (6000 steps, "
             f"one env, {spi} collect steps and one update per iteration) "
             f"through solve(device=None) as graph replays: "
             f"greedy return {r:.4f} (>= 0.0), {sps_l:.1f} env-steps/s over "
             f"the whole solve | {card} | launches {drq}")


# examples/cartpole_dqn.py's configuration (its model: _cartpole_model)
CARTPOLE_CFG = dict(
    max_steps=400_000, num_envs=256, train_freq=16, batch_size=256,
    buffer_size=1 << 16, learning_rate=1e-3, target_update_freq=2_000,
    eval_freq=100_000, log_freq=50_000, num_ep_eval=64,
    max_episode_length=200, double_q=True, dueling=True,
    prioritized_replay=True)
CARTPOLE_EPS = (1.0, 0.05, 150_000)  # LinearDecaySchedule


SEEDS = (0, 1, 2)  # the learning gates' seeds (0: the examples' own)


def _solve_cartpole(torch, logdir, seed=0):
    """``DeepQLearningSolver.solve`` on CartPole at ``examples/
    cartpole_dqn.py``'s configuration (dueling 4-64-64-2 tanh, double-Q,
    2^16 PER, batch 256, 256 envs, train_freq 16: U = 16 updates per
    iteration of 256 env steps, 400,000 steps, 4 evaluations of 64
    episodes) on the card (``device=None``). Returns ``(solver, policy,
    iterations, env-steps/s over the whole solve)``."""
    from deepqlearning_tpu_torch import (
        CartPole, DeepQLearningSolver, EpsGreedyPolicy, LinearDecaySchedule)

    solver = DeepQLearningSolver(
        qnetwork=_cartpole_model(torch), logdir=logdir, verbose=True,
        exploration_policy=EpsGreedyPolicy(LinearDecaySchedule(
            *CARTPOLE_EPS)), seed=seed, **CARTPOLE_CFG)
    _check(solver.device is None, "the CartPole solve runs with device=None")
    cfg = solver.config
    iters = -(-cfg.max_steps // cfg.env_steps_per_iter)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    policy = solver.solve(CartPole())
    dt = time.perf_counter() - t0
    _check(all(p.is_cuda and bool(torch.isfinite(p).all())
               for p in policy.params.values()), "CartPole solve: params")
    _check(len(solver.metrics["eval"]) == 4, "CartPole solve: evaluations")
    return solver, policy, iters, iters * cfg.env_steps_per_iter / dt


def phase_cartpole_solve(torch, dev, card, run_path):
    """The slice's path: the CartPole solve on each of ``SEEDS``, each
    with the counters from zero. Every iteration launches K4 (on
    CartPole), K2 and K3 once (U = 16, B = 256), as graph replays (phase
    19's CartPole route reads them from a trace): the kernels are
    launched by the warm-ups and captures alone, K4 twice for populate and
    twice for the segment, K2 and K3 twice, K1 never. The returned
    policy's greedy return over 64 episodes (a
    generator seeded 7) must reach 150 of 200, the example's full-episode
    balance (``docs/PARITY.md``), on every seed."""
    import tempfile

    from deepqlearning_tpu_torch import CartPole, basic_evaluation

    returns = {}
    for seed in SEEDS:
        with tempfile.TemporaryDirectory() as logdir:
            (solver, policy, iters, sps), cnt = run_path(
                f"CartPole solve (seed {seed})",
                lambda: _solve_cartpole(torch, logdir, seed),
                ("dq_fused_collect", "dq_tree_sample", "dq_fused_update"),
                ("dq_td_loss", "dq_fused_collect_rnn", "dq_fused_grads"))
        _check(cnt["dq_fused_collect"] == 4
               and cnt["dq_tree_sample"] == cnt["dq_fused_update"] == 2,
               f"CartPole solve: {iters} iterations, launches {cnt}")
        r, steps, _ = basic_evaluation(policy.network, policy.params,
                                       CartPole(), 64, 200, 7)
        returns[seed] = r
        evals = [(t, round(v, 3)) for t, v in solver.metrics["eval"]]
        _say(f"CartPole solve (examples/cartpole_dqn.py), seed {seed}: 256 "
             f"envs, U=16, batch 256, 2^16 PER, {iters} iterations: "
             f"{sps:.1f} env-steps/s over the whole solve (populate, 4 "
             f"evaluations of 64 episodes and saves included; the verbose "
             f"lines above give each segment's loop rate), eval returns "
             f"{evals}; greedy return of the returned policy {r:.4f} over 64 "
             f"episodes ({steps:.2f} steps) | {card} | launches {cnt}")
    _check(all(r >= 150.0 for r in returns.values()),
           f"CartPole solve: greedy returns by seed {returns}, threshold 150")


def phase_conv_forward(torch, dev):
    """Conv2D on the card against the port's CPU forward: the full conv net
    of ``examples/image_conv_dqn.py`` (dueling, 4-32-64-128 with the
    3200-512 heads) at B = 512, f32 and bf16 parameters, the same
    parameters and observations. cuDNN's TF32 is switched ON for this
    phase, so the f32 check proves that the layer turns it off itself (its
    forward and, through the gradients at B = 64, its backward): f32 Q
    values within 1e-4 · max|Q|, gradients within 1e-4 · max|g| per tensor;
    bf16 Q values (every layer rounded to bf16, sums in other orders) within
    2^-5 · max|Q|, 8 bf16 ulps of the largest. The control: the same f32
    forward with the layer's convolutions replaced by a bare ``F.conv2d``
    (TF32 on) must miss the f32 tolerance, so the check can fail. Then the
    heads' bf16 GEMM with an f32 result (``_DotBF16``) against the GEMM of
    its operands promoted to f32: forward within 1e-5 · max|y|, gradients
    within 1e-6 of their max."""
    import copy

    from deepqlearning_tpu_torch.models import chain
    from deepqlearning_tpu_torch.ops.cuda.kernel_events import conv_net

    g = torch.Generator().manual_seed(11)
    obs = torch.rand(512, 20, 20, 4, generator=g)
    prev = torch.backends.cudnn.allow_tf32
    torch.backends.cudnn.allow_tf32 = True
    try:
        for bf16 in (False, True):
            dtype = torch.bfloat16 if bf16 else torch.float32
            host = conv_net(torch, "cpu", bf16)
            params = host.init(g, dtype)
            card = copy.deepcopy(host).to(dev)
            pc = {k: v.to(dev) for k, v in params.items()}
            with torch.no_grad():
                q_host = host.apply(params, obs)[0].float()
                q_card = card.apply(pc, obs.to(dev))[0].float().cpu()
            scale = q_host.abs().max().item()
            tol = (2 ** -5 if bf16 else 1e-4) * scale
            err = (q_host - q_card).abs().max().item()
            _check(err <= tol, f"Conv2D {dtype} on the card vs the CPU: max "
                               f"abs err {err} > {tol}")
            msg = (f"Conv2D net {dtype} B=512 on the card vs the CPU: max abs "
                   f"err {err:.3g} (tolerance {tol:.3g}, max|Q| {scale:.3g})")
            if not bf16:
                chain._ConvNoTF32.apply = (
                    lambda x, w, st, pad: torch.nn.functional.conv2d(
                        x, w, None, st, pad))
                try:
                    with torch.no_grad():
                        q_ctl = card.apply(pc, obs.to(dev))[0].float().cpu()
                finally:
                    del chain._ConvNoTF32.apply
                ctl = (q_host - q_ctl).abs().max().item()
                _check(ctl > tol, f"control: a bare TF32 conv2d is within the "
                                  f"f32 tolerance ({ctl} <= {tol})")
                msg += (f"; control (bare F.conv2d, TF32 on): max abs err "
                        f"{ctl:.3g}, above the tolerance")
                gerr = 0.0
                for net, p, x in ((host, params, obs[:64]),
                                  (card, pc, obs[:64].to(dev))):
                    p = {k: v.detach().requires_grad_() for k, v in p.items()}
                    loss = net.apply(p, x)[0].square().sum()
                    grads = torch.autograd.grad(loss, list(p.values()))
                    if net is host:
                        ref = [gr.clone() for gr in grads]
                    else:
                        for a, b in zip(grads, ref):
                            e = (a.cpu() - b).abs().max().item()
                            gt = 1e-4 * b.abs().max().item()
                            _check(e <= gt, f"Conv2D f32 gradient on the "
                                            f"card: max abs err {e} > {gt}")
                            gerr = max(gerr, e / max(b.abs().max().item(),
                                                     1e-30))
                msg += (f"; gradients at B=64 within {gerr:.3g} of each "
                        f"tensor's max (tolerance 1e-4); cuDNN TF32 flag on "
                        f"throughout")
            _say(msg)
        # the heads' bf16 GEMM (3200 -> 512 at B = 512) against the GEMM of
        # the operands promoted to f32, forward and backward
        x = torch.randn(512, 3200, generator=g).bfloat16().to(dev)
        w = (0.02 * torch.randn(3200, 512, generator=g)).bfloat16().to(dev)
        gy = torch.randn(512, 512, generator=g).to(dev)
        out = []
        for f in (chain._DotBF16.apply, lambda a, b: a.float() @ b.float()):
            a, b = x.clone().requires_grad_(), w.clone().requires_grad_()
            y = f(a, b)
            out.append((y.detach(), *torch.autograd.grad(y, (a, b), gy)))
        (y, gx, gw), (y0, gx0, gw0) = out
        ey = ((y - y0).abs().max() / y0.abs().max()).item()
        eg = max(((u.float() - v.float()).abs().max()
                  / v.float().abs().max()).item()
                 for u, v in ((gx, gx0), (gw, gw0)))
        _check(y.dtype == torch.float32 and ey <= 1e-5 and eg <= 1e-6
               and gx.dtype == gw.dtype == torch.bfloat16,
               f"bf16 GEMM with an f32 result: forward {ey}, backward {eg}")
        _say(f"Dense 3200->512 bf16 GEMM (f32 result) at B=512 vs the GEMM "
             f"of the promoted operands: forward max err {ey:.3g} of max|y| "
             f"(tolerance 1e-5), gradients {eg:.3g} of their max (tolerance "
             f"1e-6)")
    finally:
        torch.backends.cudnn.allow_tf32 = prev


def phase_conv_solve(torch, dev, card, run_path):
    """11 (e): ``examples/image_conv_dqn.py``'s solve at full width, its
    configuration unchanged (TestMDP with (20, 20, 4) obs, 2048 envs, the
    bf16 dueling conv net 4-32-64-128 with 3200-512 heads, 2^15 bf16 PER,
    batch 512, U = 4, 400,000 steps, 8 evaluations of 128 episodes), through
    the example's ``main`` with ``device=None`` (the card) and a temporary
    logdir. As graph replays (phase 19's conv route reads their launches
    from a trace): K1 launched U times and K2 once by each of the segment's
    warm-up and capture, K3, K4 and K7 never. A save and a restore: ``restore_best_model`` equals the
    returned policy (the best model, restored at the end). The best greedy
    evaluation return (128 episodes; the optimum is 2.1) must reach 1.0,
    the threshold of ``tests/test_learning.py::test_bf16_replay_storage``
    on this MDP family, on each of ``SEEDS``."""
    tops = {}
    for seed in SEEDS:
        tops[seed] = _conv_solve_seed(torch, card, run_path, seed)
    _check(all(v >= 1.0 for v in tops.values()),
           f"conv solve: best greedy returns by seed {tops}, threshold 1.0")


def _conv_solve_seed(torch, card, run_path, seed):
    """One seed of 11 (e): its checks and its best greedy return."""
    import tempfile

    from deepqlearning_tpu_torch import TestMDP
    from deepqlearning_tpu_torch.examples import image_conv_dqn
    from deepqlearning_tpu_torch.solver import checkpoint

    with tempfile.TemporaryDirectory() as logdir:
        t0 = time.perf_counter()
        (solver, policy), cnt = run_path(
            f"conv solve (seed {seed})",
            lambda: image_conv_dqn.main(logdir=logdir, seed=seed),
            ("dq_td_loss", "dq_tree_sample", "dq_adam_update"),
            ("dq_fused_update", "dq_fused_collect", "dq_fused_grads"))
        secs = time.perf_counter() - t0
        cfg = solver.config
        _check(solver.device is None, "the conv solve runs with device=None")
        iters = -(-cfg.max_steps // cfg.env_steps_per_iter)
        U = cfg.updates_per_iter
        _check(cnt["dq_td_loss"] == cnt["dq_adam_update"] == 2 * U
               and cnt["dq_tree_sample"] == 2,
               f"conv solve: {iters} iterations of U={U}, launches {cnt}")
        _check(all(p.dtype == torch.bfloat16 and p.device.type == "cuda"
                   and bool(torch.isfinite(p).all())
                   for p in policy.params.values()),
               "conv solve: parameters bf16, on the card, finite")
        _check(os.path.exists(os.path.join(logdir, checkpoint.CKPT_NAME)),
               "conv solve: no saved model")
        best = solver.restore_best_model(TestMDP((20, 20), 4, 6))
        _check(all(torch.equal(best.params[k], v)
                   for k, v in policy.params.items()),
               "conv solve: the restored model differs from the returned one")
    evals = [(t, round(v, 4)) for t, v in solver.metrics["eval"]]
    top = max(v for _, v in solver.metrics["eval"])
    _say(f"conv solve (examples/image_conv_dqn.py), seed {seed}: 2048 "
         f"envs, bf16 conv "
         f"4-32-64-128 + dueling 3200-512, 2^15 bf16 PER, batch 512, U={U}, "
         f"{iters} iterations in {secs:.2f} s "
         f"({iters * cfg.env_steps_per_iter / secs:.1f} env-steps/s over the "
         f"whole solve, populate, 8 evaluations of 128 episodes and saves "
         f"included); eval returns {evals}; best greedy return {top:.4f} "
         f"(optimum 2.1, threshold 1.0); save and restore ok | {card} | "
         f"launches {cnt}")
    return top


def _vmap_draws(torch, dev, E):
    """Whether ``torch.func.vmap(..., randomness="different")`` takes a
    CUDA generator, and its two draws of ``torch.rand((), generator=g)``
    inside the vmapped function against the same generator state drawn
    batched: ``(equal to two draws of E, equal to one draw of [2, E])``.
    The first is the per-instance protocol's claim and must hold; the
    second is whether the built-in env's ``[2, E]`` rows line up."""
    g = torch.Generator(device=dev).manual_seed(11)
    start = g.get_state()

    def two(_):
        return (torch.rand((), generator=g, device=dev),
                torch.rand((), generator=g, device=dev))

    a, b = torch.func.vmap(two, randomness="different")(
        torch.empty(E, device=dev))
    g.set_state(start)
    rows = [torch.rand(E, generator=g, device=dev) for _ in range(2)]
    g.set_state(start)
    block = torch.rand(2, E, generator=g, device=dev)
    return (torch.equal(a, rows[0]) and torch.equal(b, rows[1]),
            torch.equal(torch.stack([a, b]), block))


def _row_draw_gridworld(torch):
    """SimpleGridWorld's own dynamics (``reset_cols`` / ``step_cols``) on
    uniforms drawn one row of E at a time, as the vmapped per-instance
    env draws them: the reference where one ``[2, E]`` draw does not line
    up with two draws of E."""
    from deepqlearning_tpu_torch import SimpleGridWorld

    def rows(n, generator):
        return torch.stack([torch.rand(n, generator=generator,
                                       device=generator.device)
                            for _ in range(2)])

    class RowDrawGridWorld(SimpleGridWorld):
        def reset_batch(self, num, generator):
            return self.reset_cols(rows(num, generator))

        def step_batch(self, state, action, generator):
            return self.step_cols(state, action, rows(state.shape[0],
                                                      generator))

    return RowDrawGridWorld()


def _pi_headline(torch, dev, env, n_cmp, **cfg_kw):
    """The headline loop (131072 envs, 2^20 PER, batch 512, train_freq
    4096, so U = 32; dueling 2-64-64-4 tanh, 2 populate steps) on ``env``:
    ``n_cmp`` iterations as replays of the loop's CUDA graph
    (``make_segment``, as ``solve`` runs them), then a snapshot of the
    carry, the env state as ``[E, 3]`` (px, py, terminal), and 20 more
    iterations that must finish episodes: ``(snapshot, cfg)``."""
    from deepqlearning_tpu_torch.learner.segment import (
        CompiledSegment, make_segment)

    it, c, cfg, (_, buf) = _loop_setup(torch, dev, 131072, 1 << 20, 512,
                                       4096, 2, env=env, **cfg_kw)
    run = make_segment(it, c, cfg, env, buf,
                       f"chip_smoke {type(env).__name__} headline")
    _check(isinstance(run, CompiledSegment),
           f"{type(env).__name__}: the headline loop is not captured")
    c = run(c, n_cmp)
    st = c.actor.env_state
    if not torch.is_tensor(st):
        st = torch.cat([st.pos, st.terminal[:, None]], dim=1)
    snap = dict(state=st, obs=c.actor.obs, ep_step=c.actor.ep_step,
                ep_ret=c.actor.ep_ret, rows=c.replay.rows,
                leaves=c.replay.tree[0], loss=c.loss, **c.params)
    snap = {k: v.clone() for k, v in snap.items()}
    c = run(c, 20)
    _check(np.isfinite(float(c.loss)), "per-instance headline: loss finite")
    _check(int(c.actor.ep_count) > 0, "per-instance headline: progress")
    return snap, cfg


def _solve_static_mdp(torch, dev, StaticArrayMDP):
    """``tests/test_compat.py::test_functional_mdp_adapter``'s solve of the
    per-instance StaticArrayMDP with ``device=None`` (the card): returns
    the greedy return of 20 episodes of 100 steps (the test's threshold is
    1.0) and the solve's number of iterations."""
    from deepqlearning_tpu_torch import (
        Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy,
        LinearDecaySchedule, basic_evaluation)

    solver = DeepQLearningSolver(
        qnetwork=Chain(Dense(1, 32), Dense(32, 2)), max_steps=64,
        learning_rate=0.005, logdir=None, verbose=False, double_q=True,
        dueling=True, prioritized_replay=True, train_start=64,
        buffer_size=256,
        exploration_policy=EpsGreedyPolicy(LinearDecaySchedule(1.0, 0.01, 5)))
    policy = solver.solve(StaticArrayMDP())
    cfg = solver.config
    n_iters = -(-cfg.max_steps // cfg.env_steps_per_iter)
    env = policy.problem
    _check(not env.batched and all(p.is_cuda for p in policy.params.values()),
           "StaticArrayMDP solve: a per-instance problem on the card")
    r, _, _ = basic_evaluation(policy.network, policy.params, env, 20, 100,
                               0)
    # a raw per-instance state goes through the env's observe
    state, obs = env.reset(torch.Generator(device=dev).manual_seed(0))
    _check(state.is_cuda and policy.action(state) == policy.action(obs),
           "StaticArrayMDP: the policy on a raw state")
    return r, n_iters


def _solve_mini_pomdp(torch, MiniPOMDP, n_iters):
    """A DRQN solve of the per-instance MiniPOMDP on the card:
    ``Chain(LSTM(1, 8), Dense(8, 2))``, dueling, double-Q, episode replay
    (batch 32, trace 8), episodes cut at 16 steps, num_envs = train_freq =
    64 (U = 1). Returns ``(solver, policy)``."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, DeepQLearningSolver, Dense)

    E = 64
    solver = DeepQLearningSolver(
        qnetwork=Chain(LSTM(1, 8), Dense(8, 2)), recurrence=True,
        num_envs=E, train_freq=E, batch_size=32, trace_length=8,
        max_episode_length=16, buffer_size=512, prioritized_replay=False,
        dueling=True, double_q=True, learning_rate=1e-3,
        max_steps=n_iters * E, train_start=E, target_update_freq=8 * E,
        eval_freq=10 * E, log_freq=10 * E, num_ep_eval=64, logdir=None,
        verbose=False)
    policy = solver.solve(MiniPOMDP())
    _check(all(p.is_cuda and bool(torch.isfinite(p).all())
               for p in policy.params.values()), "MiniPOMDP solve: params")
    _check(all(np.isfinite(v) for v in solver.metrics["loss"]),
           "MiniPOMDP solve: loss finite")
    state, _ = policy.problem.reset(torch.Generator(
        device=policy.device).manual_seed(0))
    _check(policy.action(state) in policy.problem.action_map,
           "MiniPOMDP: the policy on a raw (state, obs) tuple")
    return solver, policy


def phase_per_instance(torch, dev, card, run_path):
    """Envs and problems written one instance at a time (:func:`user_envs`)
    on the card, batched by ``torch.func.vmap``: first vmap with a CUDA
    generator; then, each as replays of its CUDA graph, (a) the
    per-instance GridWorld through ``build_loop`` at the headline's shape
    (K3 and K2 launched by the graph's warm-up and capture, K4 and K1
    never: the collect kernel serves no env without cols; once per replay
    in phase 19's trace of the route), its first iterations equal bit for
    bit to the built-in SimpleGridWorld's plain collect loop from the same
    seed (or, where one ``[2, E]`` draw does not line up with the vmapped
    draws, to the built-in dynamics on row-wise draws); (b) the per-instance StaticArrayMDP through
    ``solve(device=None)`` (K1 and K2 once per replay in its trace; greedy
    return > 1.0); (c) the per-instance MiniPOMDP through a DRQN ``solve``
    (K5 once per replay in its trace, K6 never)."""
    GridWorld, StaticArrayMDP, MiniPOMDP = user_envs()
    E = 131072
    per_row, one_block = _vmap_draws(torch, dev, E)
    _check(per_row, "vmap on the card: torch.rand((), generator=g) inside "
                    "the vmapped function did not draw torch.rand(E, "
                    "generator=g)")
    _say(f"per-instance envs: torch.func.vmap takes a CUDA generator; "
         f"each vmapped draw equals torch.rand(E) from the same state: "
         f"{per_row}; two equal one [2, E] draw: {one_block} (E = {E})")

    from deepqlearning_tpu_torch import SimpleGridWorld

    n_cmp = 2
    kernels = ("dq_tree_sample", "dq_fused_update")
    absent = ("dq_fused_collect", "dq_td_loss")
    ref_env = SimpleGridWorld() if one_block else _row_draw_gridworld(torch)
    (ref, cfg), built = run_path(
        "built-in GridWorld, plain collect",
        lambda: _pi_headline(torch, dev, ref_env, n_cmp,
                             fused_collect=False), kernels, absent)
    (pis, cfg), pi = run_path(
        "per-instance GridWorld",
        lambda: _pi_headline(torch, dev, GridWorld(), n_cmp), kernels, absent)
    # graph replays: the counts hold the segment's warm-up and capture;
    # phase 19 reads both routes' launches per replay from a trace
    for name, counts in (("per-instance", pi), ("built-in", built)):
        _check(counts["dq_fused_update"] == counts["dq_tree_sample"] == 2,
               f"{name} GridWorld loop: launches {counts}, not K3 = K2 = 2 "
               f"(the graph's warm-up and capture)")
    differ = [k for k in ref if not torch.equal(ref[k], pis[k])]
    _check(not differ, f"per-instance GridWorld vs the built-in env after "
                       f"{n_cmp} iterations: {differ} differ")
    U = cfg.updates_per_iter
    ref_name = ("built-in env" if one_block else
                "built-in dynamics on row-wise draws")
    _say(f"per-instance (a): GridWorld written one instance at a time "
         f"(NamedTuple state, no cols) through build_loop at the headline's "
         f"shape (131072 envs, 2^20 PER, batch 512, U={U}, dueling 2-64-64-4 "
         f"tanh), as graph replays, and the built-in SimpleGridWorld with "
         f"fused_collect=False the same way: after {n_cmp} iterations "
         f"equal bit for bit (params, env state, obs, replay, loss) to the "
         f"{ref_name} | {card} | launches {pi}")

    # (b) and (c) run under torch.profiler: the trace (each graph's guard
    # replay left out) sees a kernel in the segment's eager warm-up and in
    # every replay, and the launch counts hold the warm-up and the capture
    ((r, n_b), seen_b, per_b), mdp = run_path(
        "per-instance StaticArrayMDP solve",
        lambda: _graph_launch_trace(
            torch, lambda: _solve_static_mdp(torch, dev, StaticArrayMDP)),
        ("dq_td_loss", "dq_tree_sample", "dq_adam_update"),
        ("dq_fused_update", "dq_fused_collect"))
    _check(r > 1.0, f"per-instance StaticArrayMDP: greedy return {r} <= 1.0")
    _check(mdp["dq_td_loss"] == mdp["dq_tree_sample"]
           == mdp["dq_adam_update"] == 2, f"StaticArrayMDP solve: launches "
                                          f"{mdp}")
    # K10 on the dueling net's 4 Dense layers: a backward in each update,
    # and forwards in the updates (three each), the plain collect and the
    # evaluations, whole nets
    rest = dict(seen_b)
    fwd, bwd = (rest.pop(k, 0) for k in ("bias_act_kernel",
                                          "bias_act_grad_kernel"))
    want = {"td_loss_kernel": n_b + 1, "tree_sample_kernel": n_b + 1,
            "adam_kernel": n_b + 1}
    _check(rest == want, f"StaticArrayMDP solve: the trace saw {seen_b}, "
                         f"not {want} beside K10")
    _check(bwd == 4 * (n_b + 1) and fwd >= 3 * bwd and fwd % 4 == 0,
           f"StaticArrayMDP solve: K10 launched {fwd} forward and {bwd} "
           f"backward, not 4 backward per update and whole nets of 4 layers "
           f"forward")
    _say(f"per-instance (b): StaticArrayMDP (initial_state(generator)) "
         f"through solve(device=None), test_compat's configuration, as "
         f"graph replays: greedy return {r:.4f} (> 1.0); the trace saw "
         f"{seen_b} over {n_b} replays and the warm-up, {per_b} device "
         f"events per replay (populate, segment) | {card} | launches {mdp}")

    n = 30
    ((solver, policy), seen_c, per_c), rec = run_path(
        "per-instance MiniPOMDP DRQN solve",
        lambda: _graph_launch_trace(
            torch, lambda: _solve_mini_pomdp(torch, MiniPOMDP, n)),
        ("dq_fused_drqn",), ("dq_fused_collect_rnn", "dq_fused_collect"))
    _check(rec["dq_fused_drqn"] == 2,
           f"MiniPOMDP solve: K5 launched {rec['dq_fused_drqn']} times, not "
           f"2 (the graph's warm-up and capture)")
    # K10 on the dueling head's 2 Dense layers: forward only (K5 takes the
    # backward, K11 the target unroll), in each iteration the plain
    # collect, and the evaluations, whole heads
    rest = dict(seen_c)
    fwd = rest.pop("bias_act_kernel", 0)
    _check(rest == {"dr_group_kernel": n + 1, "dr_target_kernel": n + 1},
           f"MiniPOMDP solve: the trace saw {seen_c}, not K5 and K11 once "
           f"per replay ({n}) and in the warm-up beside K10's forward")
    _check(fwd >= 2 * (n + 1) and fwd % 2 == 0,
           f"MiniPOMDP solve: K10 launched {fwd} forward, not a head in "
           f"each iteration and whole heads in all")
    _say(f"per-instance (c): MiniPOMDP through a DRQN solve (LSTM(1,8), "
         f"dueling, 64 envs, U=1, batch 32, trace 8, {n} iterations) as "
         f"graph replays: eval returns "
         f"{[round(v, 3) for _, v in solver.metrics['eval']]}; the trace "
         f"saw {seen_c}, {per_c} device events per replay (populate, "
         f"segment) | {card} | launches {rec}")


# launches per iteration of :func:`_dp_setup`'s routes by entry point,
# headline (False) and DRQN (True): per sub-update K7 (K8), the all-reduce
# and an Adam launch; one collect step (and PER draw); the target's
# forward: K10 on its 6 Dense layers, or K11 for the DRQN net
DP_ITERATION = {
    False: {"dq_fused_grads": 32, "dq_fused_adam": 32, "dq_tree_sample": 1,
            "dq_fused_collect": 1, "dq_bias_act": 6},
    True: {"dq_fused_drqn_grads": 4, "dq_drqn_adam": 4,
           "dq_fused_collect_rnn": 1, "dq_drqn_target": 1}}


def _dp_setup(torch, dev, recurrent, dcn_sync_every=1):
    """``(runner, carry, cfg)``: the headline (or, ``recurrent``, the DRQN)
    configuration through ``DataParallelRunner`` over the one-rank NCCL
    mesh (with ``dcn_sync_every > 1``, local SGD over the ``(1, 1)``
    ``hybrid_mesh``): the data-parallel route (K7 / K8, ``pmean_flat``, one
    Adam launch per sub-update), populated through its populate graph
    (open episodes stay open, as in the JAX runner)."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, Dense, DQNConfig, EpisodeReplayBuffer, Flatten,
        LinearDecaySchedule, PrioritizedReplayBuffer, SimpleGridWorld,
        create_dueling_network)
    from deepqlearning_tpu_torch.parallel.mesh import (
        DataParallelRunner, make_mesh)
    from deepqlearning_tpu_torch.parallel.multihost import hybrid_mesh

    env = SimpleGridWorld()
    if recurrent:
        net = Chain(LSTM(2, 32, device=dev), Dense(32, 4, device=dev))
        cfg = DQNConfig(num_envs=16384, batch_size=512, buffer_size=4096,
                        train_freq=4096, trace_length=8,
                        max_episode_length=100, recurrence=True,
                        double_q=True)
        buf = EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, cfg.trace_length,
                                  cfg.max_episode_length,
                                  num_envs=cfg.num_envs, device=dev)
        n_pop = cfg.max_episode_length + 1
    else:
        net = create_dueling_network(Chain(
            Flatten(), Dense(2, 64, torch.tanh, device=dev),
            Dense(64, 64, torch.tanh, device=dev), Dense(64, 4, device=dev)))
        cfg = DQNConfig(num_envs=131072, batch_size=512, buffer_size=1 << 20,
                        train_freq=4096, max_episode_length=100,
                        double_q=True, dueling=True, prioritized_replay=True)
        buf = PrioritizedReplayBuffer(
            env.obs_shape, cfg.buffer_size, cfg.batch_size,
            alpha=cfg.prioritized_replay_alpha,
            beta=cfg.prioritized_replay_beta,
            eps=cfg.prioritized_replay_epsilon, prioritized=True, device=dev)
        n_pop = 2
    mesh = hybrid_mesh() if dcn_sync_every > 1 else make_mesh(1)
    runner = DataParallelRunner(env, net, buf, cfg,
                                LinearDecaySchedule(1.0, 0.01, 100_000),
                                env.discount, mesh=mesh,
                                dcn_sync_every=dcn_sync_every)
    _check(runner.graphed, "the NCCL runner is not on the graph route")
    c = runner.run_populate(runner.init_carry(0), n_pop)
    if recurrent:
        _check(bool(c.replay.cur_len.any()) and int(c.replay.t) == n_pop,
               "DP populate graph: the open episodes were dropped")
    return runner, c, cfg


def _dp_loop(torch, dev, recurrent, n_iters, n_trace=3):
    """:func:`_dp_setup`'s loop as ``solve`` would run it: the first
    ``run_segment`` call captures the iteration, warm-up and ``n_iters``
    replays, then a trace of ``n_trace`` replays after one that primes the
    session: ``(cfg, loss, {kernel symbol: launches in the trace})``."""
    runner, c, cfg = _dp_setup(torch, dev, recurrent)
    warmup = 3 if recurrent else 1
    c = runner.run_segment(c, 0)
    c = runner.run_segment(c, warmup + n_iters)
    loss = float(c.loss)
    _check(np.isfinite(loss) and np.isfinite(float(c.gnorm)), "loss finite")
    _check(all(bool(torch.isfinite(p).all()) for p in c.params.values()),
           "params finite")
    c, seen = _traced_launches(torch, lambda: runner.run_segment(c, 1),
                               lambda: runner.run_segment(c, n_trace))
    _check(int(c.actor.ep_count) > 0
           and int(c.iters) == warmup + n_iters + n_trace + 1,
           "loop progress")
    return cfg, loss, seen


def _clone_carry(torch, c):
    """A copy of a carry: every tensor cloned, each generator a new one in
    the same state."""
    from torch.utils._pytree import tree_map

    def one(x):
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        return x.clone() if isinstance(x, torch.Tensor) else x

    return tree_map(one, c)


def _carry_diff(torch, a, b):
    """``{leaf index: max abs difference}`` of the leaves of two carries
    that are not equal bit for bit (a generator by its state, as -1)."""
    from torch.utils._pytree import tree_flatten

    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    _check(len(la) == len(lb), "carries of different structure")
    out = {}
    for i, (x, y) in enumerate(zip(la, lb)):
        if isinstance(x, torch.Generator):
            if not torch.equal(x.get_state(), y.get_state()):
                out[i] = -1.0
        elif not torch.equal(x, y):
            out[i] = float((x.double() - y.double()).abs().max())
    return out


def _dp_route(torch, dev, recurrent, dcn_sync_every=1):
    """A phase 19 setup on ``DataParallelRunner`` (:func:`_dp_setup`):
    the eager iteration reads the local-SGD period from the device after
    each iteration, as the runner did before its graphs; ``make_run(g)``
    captures the runner's graphs on ``g`` (its first ``run_segment``
    call) and gives ``(run_segment, [graphs])``."""
    runner, c, cfg = _dp_setup(torch, dev, recurrent, dcn_sync_every)
    k = dcn_sync_every

    def eager(x):
        x = runner._iteration(x)
        if k > 1 and int(x.iters) % k == 0:
            runner._average_across_dcn(x)
        return x

    def make_run(g):
        runner.run_segment(g, 0)
        return runner.run_segment, [x for kind, x in runner._graphs.items()
                                    if kind != "populate"]

    return eager, c, cfg, make_run


def _segment_routes(torch, dev):
    """Phase 19's routes at full width: ``{name: (setup, launches per
    iteration by entry point)}``, ``setup()`` giving ``(eager iteration,
    carry, cfg, make_run)`` after populate, ``make_run(carry)`` the graphs
    captured on that carry: ``(run_segment, [CompiledSegment])``."""
    from deepqlearning_tpu_torch import (
        CartPole, DQNConfig, LinearDecaySchedule, PrioritizedReplayBuffer,
        TestMDP)
    from deepqlearning_tpu_torch.learner.loop import (
        build_loop, init_carry, populate)
    from deepqlearning_tpu_torch.learner.segment import make_segment
    from deepqlearning_tpu_torch.ops.cuda.kernel_events import conv_net

    def cartpole():
        env = CartPole()
        net = _cartpole_net(torch, dev)
        cfg = DQNConfig(**CARTPOLE_CFG, logdir=None)
        buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                      cfg.batch_size, device=dev)
        it, pop, opt = build_loop(env, net, buf, cfg,
                                  LinearDecaySchedule(*CARTPOLE_EPS),
                                  env.discount)
        c = populate(pop, buf, init_carry(env, net, buf, cfg, opt, dev), 1)
        return it, c, cfg, (env, buf)

    def single(setup, name):
        """A single-card route: its graph from ``make_segment``."""
        def run():
            it, c, cfg, (env, buf) = setup()

            def make_run(g):
                seg = make_segment(it, g, cfg, env, buf, f"chip_smoke {name}")
                return seg, [seg]

            return it, c, cfg, make_run

        return run

    GridWorld, _, MiniPOMDP = user_envs()

    def mini_pomdp():
        """Phase 18 (c)'s loop: the per-instance MiniPOMDP, LSTM(1, 8)
        dueling, 64 envs, batch 32, trace 8, U = 1 (K5; no cols, so the
        plain collect)."""
        from deepqlearning_tpu_torch import (
            LSTM, Chain, Dense, EpisodeReplayBuffer, POMDPEnv,
            create_dueling_network)
        from deepqlearning_tpu_torch.learner.segment import (
            make_collect_graph)

        env = POMDPEnv(MiniPOMDP())
        net = create_dueling_network(Chain(LSTM(1, 8, device=dev),
                                           Dense(8, 2, device=dev)))
        cfg = DQNConfig(num_envs=64, train_freq=64, batch_size=32,
                        trace_length=8, max_episode_length=16,
                        buffer_size=512, recurrence=True, double_q=True,
                        learning_rate=1e-3, target_update_freq=8 * 64)
        buf = EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, cfg.trace_length,
                                  cfg.max_episode_length, num_envs=64,
                                  device=dev)
        it, pop, opt = build_loop(env, net, buf, cfg,
                                  LinearDecaySchedule(1.0, 0.01, 640),
                                  env.discount)
        c = init_carry(env, net, buf, cfg, opt, dev)
        c = make_collect_graph(pop, c, cfg, env, buf,
                               "chip_smoke MiniPOMDP populate")(
                                   c, cfg.max_episode_length + 1)
        return it, c, cfg, (env, buf)

    # K10 per iteration: a forward launch (dq_bias_act) per Conv2D and
    # Dense layer of each net forward in ATen (the dueling Dense nets have
    # 6 such layers, the conv net 7, the DRQN net's head 1, MiniPOMDP's
    # dueling head 2): the target's over U·B rows beside K3 (beside K5 the
    # target's unroll is K11, dq_drqn_target), three per autograd update
    # (target and online on s', online on s; the grouped step's target
    # once for all U), the plain collect's one; and a backward launch
    # (dq_bias_act_grad) per layer of each autograd update
    head = {"dq_tree_sample": 1, "dq_fused_update": 1}
    routes = {
        "headline": (lambda: _loop_setup(torch, dev, 131072, 1 << 20, 512,
                                         4096, 2),
                     dict(head, dq_fused_collect=1, dq_bias_act=6)),
        "U=1": (lambda: _loop_setup(torch, dev, 4096, 1 << 18, 512, 4096, 4,
                                    target_update_freq=2 * 4096),
                {"dq_td_loss": 1, "dq_tree_sample": 1, "dq_fused_collect": 1,
                 "dq_adam_update": 1, "dq_bias_act": 6 * 3,
                 "dq_bias_act_grad": 6}),
        "grouped plain": (
            lambda: _loop_setup(torch, dev, 2048, 1 << 15, 512, 512, 2,
                                net=_dueling_net(torch, dev, 512, torch.relu),
                                target_update_freq=2 * 2048),
            {"dq_td_loss": 4, "dq_tree_sample": 1, "dq_adam_update": 4,
             "dq_bias_act": 6 * (1 + 2 * 4 + 1), "dq_bias_act_grad": 6 * 4}),
        "conv": (lambda: _loop_setup(
            torch, dev, 2048, 1 << 15, 512, 512, 1, net=conv_net(torch, dev),
            env=TestMDP((20, 20), 4, 6), max_episode_length=6,
            target_update_freq=2 * 2048, learning_rate=1e-3,
            dtype=torch.bfloat16),
            {"dq_td_loss": 4, "dq_tree_sample": 1, "dq_adam_update": 4,
             "dq_bias_act": 7 * (1 + 2 * 4 + 1), "dq_bias_act_grad": 7 * 4}),
        # the same net and loop in f32, where no K3, K4 or K7 plan takes
        # the conv net either
        "conv f32": (lambda: _loop_setup(
            torch, dev, 2048, 1 << 15, 512, 512, 1,
            net=conv_net(torch, dev, bf16=False),
            env=TestMDP((20, 20), 4, 6), max_episode_length=6,
            target_update_freq=2 * 2048, learning_rate=1e-3),
            {"dq_td_loss": 4, "dq_tree_sample": 1, "dq_adam_update": 4,
             "dq_bias_act": 7 * (1 + 2 * 4 + 1), "dq_bias_act_grad": 7 * 4}),
        "CartPole": (cartpole, dict(head, dq_fused_collect=1, dq_bias_act=6)),
        "DRQN": (lambda: _drqn_setup(torch, dev),
                 {"dq_fused_drqn": 1, "dq_fused_collect_rnn": 1,
                  "dq_drqn_target": 1}),
        # autograd BPTT, Adam (K9) per sub-update and the plain recurrent
        # collect
        "DRQN plain": (lambda: _drqn_setup(torch, dev, fused_updates=False,
                                           fused_collect=False),
                       {"dq_adam_update": 4, "dq_bias_act": 3 * 4 + 1,
                        "dq_bias_act_grad": 4}),
        "per-instance GridWorld": (
            lambda: _loop_setup(torch, dev, 131072, 1 << 20, 512, 4096, 2,
                                env=GridWorld()),
            dict(head, dq_bias_act=6 * 2)),
        # the built-in env on the plain collect step, beside the
        # per-instance one
        "built-in GridWorld, plain collect": (
            lambda: _loop_setup(torch, dev, 131072, 1 << 20, 512, 4096, 2,
                                fused_collect=False),
            dict(head, dq_bias_act=6 * 2)),
        "per-instance MiniPOMDP DRQN": (mini_pomdp,
                                        {"dq_fused_drqn": 1,
                                         "dq_drqn_target": 1,
                                         "dq_bias_act": 2}),
    }
    routes = {name: (single(setup, name), per_iter)
              for name, (setup, per_iter) in routes.items()}
    # the data-parallel routes in the one-rank NCCL world
    routes["DP headline"] = (lambda: _dp_route(torch, dev, False),
                             DP_ITERATION[False])
    routes["DP DRQN"] = (lambda: _dp_route(torch, dev, True),
                         DP_ITERATION[True])
    # local SGD, k = 2, on the (1, 1) mesh: two graphs, the second with
    # the DCN average after the iteration
    routes["DP local SGD (k=2)"] = (lambda: _dp_route(torch, dev, False, 2),
                                    DP_ITERATION[False])
    return routes


def _capture_failure(torch):
    """A ``select_fn`` that reads the device from the host (``.item()``)
    makes ``solve`` raise on the card instead of running eagerly."""
    from deepqlearning_tpu_torch import (
        Chain, DeepQLearningSolver, Dense, Flatten, SimpleGridWorld,
        VectorizedStrategy)

    def select(q, t, generator):
        if q[0, 0].item() > 1e30:       # a host read inside the iteration
            raise AssertionError("unreachable")
        return torch.argmax(q, dim=-1), torch.zeros((), device=q.device)

    solver = DeepQLearningSolver(
        qnetwork=Chain(Flatten(), Dense(2, 16, torch.tanh), Dense(16, 4)),
        exploration_policy=VectorizedStrategy(select), num_envs=256,
        train_freq=256, batch_size=32, buffer_size=1 << 12, train_start=256,
        max_steps=4 * 256, logdir=None, verbose=False)
    try:
        solver.solve(SimpleGridWorld())
    except RuntimeError as e:
        msg = str(e)
        _check("capturing one iteration as a CUDA graph failed" in msg,
               f"capture failure: another error: {msg}")
        return msg
    raise AssertionError("capture failure: solve ran a select_fn with a "
                         "host read without raising")


# the kernel each entry point of the library (``ops/cuda/build.py``)
# launches, by its symbol in a trace (K5's global-memory variant
# ``dr_group_gm_kernel`` serves wide nets on no traced route)
KERNELS = {"dq_td_loss": "td_loss_kernel", "dq_empty": "empty_kernel",
           "dq_tree_sample": "tree_sample_kernel",
           "dq_fused_update": "fu_group_kernel",
           "dq_fused_grads": "fu_group_kernel",
           "dq_fused_adam": "dq_adam_flat_kernel",
           "dq_fused_collect": "fc_kernel",
           "dq_fused_collect_rnn": "fc_rnn_kernel",
           "dq_fused_drqn": "dr_group_kernel",
           "dq_fused_drqn_grads": "dr_group_kernel",
           "dq_drqn_adam": "dq_adam_flat_kernel",
           "dq_adam_update": "adam_kernel",
           "dq_bias_act": "bias_act_kernel",
           "dq_bias_act_grad": "bias_act_grad_kernel",
           "dq_drqn_target": "dr_target_kernel"}


def _launches():
    """The recorder's kernel launches since its last reset, by entry point
    (those that launched)."""
    from deepqlearning_tpu_torch.utils import profiling

    counts = {e: profiling.counter("kernels.launches", e) for e in KERNELS}
    return {e: n for e, n in counts.items() if n}


def _symbols(per_entry):
    """Launches by entry point summed by kernel symbol."""
    out = {}
    for e, n in per_entry.items():
        out[KERNELS[e]] = out.get(KERNELS[e], 0) + n
    return out


def _traced_launches(torch, prime, fn):
    """``(fn(), {kernel symbol: launches})``: ``prime()`` and ``fn()`` in
    one ``torch.profiler`` session (``port_bench/harness/trace.py::
    traced``: ``prime()`` gives each graph its first launch in the session,
    whose first records the profiler can lose), and the launches of the
    port's kernels that the trace saw on the device during ``fn()`` (a
    graph's replays included)."""
    from port_bench.harness.trace import kernel_symbol, traced

    out, events, _, _ = traced(torch, prime, fn)
    ours, seen = set(KERNELS.values()), {}
    for name, _, _ in events:
        sym = kernel_symbol(name)
        if sym in ours:
            seen[sym] = seen.get(sym, 0) + 1
    return out, seen


def _graph_launch_trace(torch, fn):
    """``(fn(), {kernel symbol: launches}, [{device events per launch}])``:
    ``fn()``, which makes its CUDA graphs itself, under ``torch.profiler``.
    The launches of the port's kernels leave out each graph's first launch
    (the first ``cudaGraphLaunch`` after each ``cudaGraphInstantiate``: the
    segment's guard replay), whose first records the profiler can lose
    (``port_bench/harness/trace.py``); the list gives, for each graph in the order
    of instantiation, the set of device event counts of its other launches
    (one number where every replay was recorded whole)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from port_bench.harness.trace import kernel_symbol

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        out = fn()
        torch.cuda.synchronize()
    events = prof.events()
    # a launch's device events carry the correlation id of its
    # cudaGraphLaunch
    host = sorted((e for e in events if e.device_type != DeviceType.CUDA
                   and ("GraphInstantiate" in e.name
                        or "GraphLaunch" in e.name)),
                  key=lambda e: e.time_range.start)
    first, graphs, fresh = set(), [], False
    for e in host:
        if "GraphInstantiate" in e.name:
            graphs.append({})
            fresh = True
        elif not graphs:
            raise AssertionError("the trace launches a graph made before it")
        elif fresh:
            first.add(e.id)
            fresh = False
        else:
            graphs[-1][e.id] = 0
    ours, seen = set(KERNELS.values()), {}
    for e in events:
        if e.device_type != DeviceType.CUDA or e.id in first:
            continue
        for g in graphs:
            if e.id in g:
                g[e.id] += 1
        sym = kernel_symbol(e.name)
        if sym in ours:
            seen[sym] = seen.get(sym, 0) + 1
    return out, seen, [sorted(set(g.values())) for g in graphs]


def _drift_env(torch, host_counter):
    """A user env written batched on ``[0, 1]``: an action moves each
    state by a step; with ``host_counter`` the step grows with a Python
    count of the env's steps, host state that a graph replay repeats as it
    was at capture."""
    from deepqlearning_tpu_torch.envs.base import Env

    class Drift(Env):
        num_actions, obs_shape, discount = 2, (1,), 0.9
        steps = 0

        def reset_batch(self, num, generator):
            s = torch.rand(num, generator=generator, device=generator.device)
            return s, s[:, None]

        def observe_batch(self, state):
            return state[:, None]

        def step_batch(self, state, action, generator):
            self.steps += 1
            d = 0.01 * (self.steps if host_counter else 1)
            s = (state + torch.where(action == 1, d, -d)).clamp(0.0, 1.0)
            return s, s[:, None], s, (s >= 1.0).float()

    return Drift()


def _host_state_guard(torch, dev):
    """``make_segment`` on a user env that keeps a Python counter must
    raise (its first replay differs from the eager iteration); the same
    env without the counter is captured. Returns the error's text."""
    from deepqlearning_tpu_torch import (
        Chain, Dense, DQNConfig, LinearDecaySchedule, PrioritizedReplayBuffer)
    from deepqlearning_tpu_torch.learner.loop import (
        build_loop, init_carry, populate)
    from deepqlearning_tpu_torch.learner.segment import (
        CompiledSegment, make_segment)

    def segment(host_counter):
        env = _drift_env(torch, host_counter)
        net = Chain(Dense(1, 16, torch.tanh, device=dev),
                    Dense(16, 2, device=dev))
        cfg = DQNConfig(num_envs=256, batch_size=32, buffer_size=1 << 12,
                        train_freq=256, max_episode_length=20,
                        double_q=True, prioritized_replay=True)
        buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                      cfg.batch_size, device=dev)
        it, pop, opt = build_loop(env, net, buf, cfg,
                                  LinearDecaySchedule(1.0, 0.05, 10_000),
                                  env.discount)
        c = populate(pop, buf, init_carry(env, net, buf, cfg, opt, dev), 2)
        return make_segment(it, it(c), cfg, env, buf,
                            f"chip_smoke Drift (host counter {host_counter})")

    _check(isinstance(segment(False), CompiledSegment),
           "the Drift env without host state is not captured")
    try:
        segment(True)
    except RuntimeError as e:
        msg = str(e)
        _check("differs from the eager iteration" in msg,
               f"host state guard: another error: {msg}")
        return msg
    raise AssertionError("host state guard: an env with a Python counter "
                         "was captured without raising")


def _eval_routes(torch, dev):
    """The greedy evaluations of 11 (a), (b) and (e), each with parameters
    from a seeded generator: ``{name: (env, network, params, n_eval,
    max_episode_length)}``."""
    from deepqlearning_tpu_torch import (
        LSTM, Chain, Dense, SimpleGridWorld, TestMDP,
        create_dueling_network)
    from deepqlearning_tpu_torch.ops.cuda.kernel_events import conv_net

    g = torch.Generator(device=dev).manual_seed(11)
    ff = _dueling_net(torch, dev, 64, torch.tanh)
    drqn = create_dueling_network(Chain(LSTM(2, 32, device=dev),
                                        Dense(32, 4, device=dev)))
    conv = conv_net(torch, dev)
    return {
        "11 (a) SimpleGridWorld, dueling 2-64-64-4": (
            SimpleGridWorld(), ff, ff.init(g), 100, 100),
        "11 (b) SimpleGridWorld, DRQN LSTM(2,32) dueling": (
            SimpleGridWorld(), drqn, drqn.init(g), 100, 100),
        "11 (e) TestMDP (20,20,4) images, bf16 conv": (
            TestMDP((20, 20), 4, 6), conv, conv.init(g, torch.bfloat16),
            128, 6),
    }


def phase_eval_graph(torch, dev, card):
    """19 (g): ``basic_evaluation``'s graphs (``solver/evaluation.py``) on
    the evaluations of 11 (a), (b) and (e): the reset and N = 3 greedy
    step replays against N eager steps from a cloned carry, bit for bit
    (every tensor and the generator's state); three whole evaluations
    against the eager rollout (``_eval_rollout``) on the same seeds, the
    means and the caller's generator state bit for bit; memory flat over
    100 step replays; then an env with a Python counter makes the
    evaluation raise."""
    from deepqlearning_tpu_torch.solver import evaluation as ev

    N = 3
    for name, (env, net, params, n, L) in _eval_routes(torch, dev).items():
        graph = ev.eval_graph(net, params, env, n, dev)
        # the step graph against eager steps from one reset state
        gen = torch.Generator(device=dev).manual_seed(5)
        torch._foreach_copy_(list(graph.params.values()),
                             [params[k] for k in graph.params])
        graph.carry.generator.set_state(gen.get_state())
        graph.reset(graph.carry, 1)
        e = _clone_carry(torch, graph.carry)
        step = ev.eval_step(env, net, graph.params)
        with torch.no_grad():
            for _ in range(N):
                e = step(e)
        graph.step(graph.carry, N)
        diff = _carry_diff(torch, graph.carry, e)
        _check(not diff, f"eval {name}: {N} step replays differ from eager "
                         f"steps at leaves {diff}")
        # whole evaluations against the eager rollout
        for seed in (1, 2, 3):
            ours = torch.Generator(device=dev).manual_seed(seed)
            ref = torch.Generator(device=dev).manual_seed(seed)
            got = ev.basic_evaluation(net, params, env, n, L, ours)[:2]
            want = tuple(float(x) for x in ev._eval_rollout(
                env, params, net, n, L, ref))
            _check(got == want, f"eval {name}: graph {got} vs eager {want}")
            _check(torch.equal(ours.get_state(), ref.get_state()),
                   f"eval {name}: the caller's generator differs")
        _check(ev.eval_graph(net, params, env, n, dev) is graph,
               f"eval {name}: the graphs were captured again")
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        graph.step(graph.carry, 100)
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_allocated(dev)
        _check(m1 == m0, f"eval {name}: memory {m0} -> {m1} over 100 "
                         "replays")
        _say(f"evaluation graph, {name} ({n} episodes, {L + 1} steps): "
             f"reset and {N} step replays = eager steps bit for bit; 3 "
             f"evaluations = the eager rollout bit for bit (means and the "
             f"caller's generator); memory flat at {m1} bytes over 100 "
             f"replays | {card}")
        del graph
    from deepqlearning_tpu_torch import Chain, Dense

    drift_net = Chain(Dense(1, 8, torch.tanh, device=dev),
                      Dense(8, 2, device=dev))
    drift_params = drift_net.init(torch.Generator(device=dev).manual_seed(0))
    ev.basic_evaluation(drift_net, drift_params, _drift_env(torch, False),
                        32, 10, 1)
    try:
        ev.basic_evaluation(drift_net, drift_params,
                            _drift_env(torch, True), 32, 10, 1)
    except RuntimeError as e:
        _check("differs from the eager iteration" in str(e),
               f"eval host state guard: another error: {e}")
        _say(f"evaluation graph: an env with a Python counter makes "
             f"basic_evaluation raise: {str(e)[:200]!r}")
    else:
        raise AssertionError("eval host state guard: an env with a Python "
                             "counter was captured without raising")
    torch.cuda.empty_cache()


def phase_compiled_segment(torch, dev, card):
    """19: the compiled segment (``learner/segment.py``) on each route it
    captures, at full width, the data-parallel routes of phases 8 and 9
    and local SGD (k = 2, on the ``(1, 1)`` mesh) in a one-rank NCCL world
    included: (a) N = 3 replays from a cloned carry against N eager
    iterations, every carry tensor and the generator's state bit for bit
    (two eager runs first: where they differ, the graph is held to the
    eager runs' own spread); (b) the replays draw fresh numbers: they
    differ from eager iterations that reuse one generator state; (c) the
    warm-up and the capture of each graph launch each kernel as often as
    one iteration does (:func:`_segment_routes`' table, by entry point),
    the replays call the library never, and a ``torch.profiler`` trace of
    N more replays (after one that primes the session) sees each kernel N
    times as often; (d) ``torch.cuda.memory_allocated`` is flat over 100
    replays. (f) a user env with a Python counter makes ``make_segment``
    raise. (g) the greedy evaluation's graphs (:func:`phase_eval_graph`).
    Last, (e): a ``select_fn`` with a host read makes ``solve`` raise on
    the card."""
    import torch.distributed as dist

    from deepqlearning_tpu_torch.learner.segment import CompiledSegment
    from deepqlearning_tpu_torch.utils import profiling

    own_world = not dist.is_initialized()
    if own_world:
        from deepqlearning_tpu_torch.parallel.launch import free_port
        from deepqlearning_tpu_torch.parallel.multihost import (
            initialize_multihost)

        initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0,
                             backend="nccl")
    N = 3
    for name, (setup, per_iter) in _segment_routes(torch, dev).items():
        it, c, cfg, make_run = setup()
        c = it(c)  # fills the replay past one batch, as a solve's first
        torch.cuda.synchronize()
        base = _clone_carry(torch, c)
        runs = []
        for _ in range(2):
            e = _clone_carry(torch, base)
            for _ in range(N):
                e = it(e)
            runs.append(e)
        spread = _carry_diff(torch, runs[0], runs[1])
        stale = _clone_carry(torch, base)
        g0 = stale.generator.get_state()
        for _ in range(N):
            stale.generator.set_state(g0)
            stale = it(stale)
        g = _clone_carry(torch, base)
        profiling.reset()
        run, graphs = make_run(g)
        _check(graphs and all(isinstance(x, CompiledSegment)
                              for x in graphs), f"{name}: not captured")
        built = _launches()
        want = {e: 2 * len(graphs) * v for e, v in per_iter.items()}
        _check(built == want,
               f"{name}: the warm-ups and captures of {len(graphs)} graphs "
               f"launched {built}, not {want}")
        profiling.reset()
        g = run(g, N)
        diff = _carry_diff(torch, g, runs[0])
        if not spread:
            _check(not diff, f"{name}: graph vs eager differ at leaves "
                             f"{diff} (two eager runs agree bit for bit)")
        else:
            bad = {i: d for i, d in diff.items()
                   if d < 0 or d > 4 * max(spread.get(i, 0.0), 1e-30)}
            _check(not bad, f"{name}: graph vs eager {diff} beyond 4x the "
                            f"eager-vs-eager spread {spread}")
        _check(_carry_diff(torch, g, stale),
               f"{name}: the replays equal iterations that reuse one "
               "generator state")
        # (c) N more replays under the profiler, after one that primes it
        g, seen = _traced_launches(torch, lambda: run(g, 1),
                                   lambda: run(g, N))
        _check(not _launches(), f"{name}: {2 * N + 1} replays called the "
                                f"library: {_launches()}")
        want = {sym: v * N for sym, v in _symbols(per_iter).items()}
        _check(seen == want, f"{name}: the trace of {N} replays saw "
                             f"{seen}, not {want}")
        torch.cuda.synchronize()
        m0 = torch.cuda.memory_allocated(dev)
        g = run(g, 100)
        torch.cuda.synchronize()
        m1 = torch.cuda.memory_allocated(dev)
        _check(m1 == m0, f"{name}: memory {m0} -> {m1} over 100 replays")
        _check(bool(torch.isfinite(g.loss)), f"{name}: loss not finite")
        _say(f"compiled segment, {name} (U={cfg.updates_per_iter}, "
             f"{cfg.num_envs} envs, {cfg.dtype}): graph = eager over {N} "
             f"iterations ({'bit for bit' if not spread else 'within 4x the eager spread ' + str(spread)}), "
             f"fresh draws, launches at the warm-ups and captures of "
             f"{len(graphs)} graph(s) {built}, in the trace of {N} replays "
             f"{seen}, memory flat at {m1} bytes over 100 replays | {card}")
        del run, graphs, g, base, runs, stale, c
        torch.cuda.empty_cache()
    if own_world:
        dist.destroy_process_group()
    _say(f"compiled segment (f): a user env with a Python counter makes "
         f"make_segment raise: {_host_state_guard(torch, dev)[:300]!r}")
    phase_eval_graph(torch, dev, card)


def _two_rank_slice(rank, world, device):
    """One rank of a small data-parallel slice (1024 envs per rank, U = 4,
    batch 32) with injected uniforms, on ``device``; returns its params and
    its replay's action column."""
    import torch

    from deepqlearning_tpu_torch import (
        Chain, Dense, DQNConfig, Flatten, LinearDecaySchedule,
        PrioritizedReplayBuffer, SimpleGridWorld, create_dueling_network)
    from deepqlearning_tpu_torch.learner.loop import init_carry
    from deepqlearning_tpu_torch.models.chain import params_of
    from deepqlearning_tpu_torch.parallel.mesh import (
        DataParallelRunner, make_mesh)

    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(0)  # both ranks share the one card
        torch.backends.cuda.matmul.allow_tf32 = False
    env = SimpleGridWorld()
    net = create_dueling_network(Chain(
        Flatten(), Dense(2, 16, torch.tanh), Dense(16, 16, torch.tanh),
        Dense(16, 4)))
    net.init(torch.Generator().manual_seed(0))  # same weights everywhere
    net.to(dev)
    E = 1024
    cfg = DQNConfig(num_envs=E, batch_size=32, buffer_size=8192,
                    train_freq=256, max_episode_length=5,
                    target_update_freq=2048, learning_rate=1e-3)
    buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, device=dev)
    runner = DataParallelRunner(env, net, buf, cfg,
                                LinearDecaySchedule(1.0, 0.05, 500), 0.95,
                                mesh=make_mesh(world))
    c = init_carry(env, net, buf, cfg, runner.optimizer, dev,
                   params=params_of(net))
    rng = np.random.default_rng(100 + rank)
    u = lambda *s: torch.from_numpy(rng.random(s, np.float32)).to(dev)
    st, obs = env.reset_cols(u(2, E))
    c = c._replace(actor=c.actor._replace(env_state=st, obs=obs))
    c = runner.run_populate(c, 2, [u(6, E), u(6, E)])
    U, n = cfg.updates_per_iter, 3
    c = runner.run_segment(c, n, [[u(6, E)] for _ in range(n)],
                           [[u(U * cfg.batch_size)] for _ in range(n)])
    return ({k: t.cpu().numpy() for k, t in c.params.items()},
            c.replay.rows[:, 4].cpu().numpy(), float(c.loss), runner.graphed)


def phase_two_ranks():
    """Two gloo ranks on the one card (NCCL refuses two ranks on one
    device), against the same two-rank program on CPU tensors (the plain
    twins). Params equal across the card's ranks bit for bit; card vs CPU
    params rtol 1e-3 / atol 1e-4 and replay actions equal on >= 99% of
    slots (the card sums in other orders, as phase 4)."""
    from deepqlearning_tpu_torch.parallel.launch import spawn

    gpu = spawn(_two_rank_slice, 2, "cuda")
    cpu = spawn(_two_rank_slice, 2, "cpu")
    _check(not any(r[3] for r in gpu + cpu),
           "two ranks: a gloo runner is not on the eager route")
    err = 0.0
    for k in gpu[0][0]:
        _check(np.array_equal(gpu[0][0][k], gpu[1][0][k]),
               f"two ranks: {k} differs across the card's ranks")
        _check(np.array_equal(cpu[0][0][k], cpu[1][0][k]),
               f"two ranks: {k} differs across the CPU ranks")
        np.testing.assert_allclose(gpu[0][0][k], cpu[0][0][k], rtol=1e-3,
                                   atol=1e-4, err_msg=f"two ranks {k}")
        err = max(err, float(np.abs(gpu[0][0][k] - cpu[0][0][k]).max()))
    agree = min(float((g[1] == c[1]).mean()) for g, c in zip(gpu, cpu))
    _check(agree >= 0.99, f"two ranks: replay actions agree on {agree}")
    _check(not np.array_equal(gpu[0][1], gpu[1][1]),
           "two ranks: the ranks collected the same data")
    _say(f"two gloo ranks on one card vs CPU (1024 envs per rank, U=4, "
         f"B=32, 3 iterations; eager iterations, as the gate states for "
         f"gloo, which reduces through host memory and takes injected "
         f"draws): ok, params equal across ranks, card vs CPU "
         f"max_abs_err {err:.3g}, replay actions agree {agree:.4f}")


def main():
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    import torch.distributed as dist

    from deepqlearning_tpu_torch.ops.cuda import build
    from deepqlearning_tpu_torch.parallel.launch import free_port
    from deepqlearning_tpu_torch.parallel.multihost import (
        initialize_multihost)
    from deepqlearning_tpu_torch.utils import profiling

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

    phase_default_device(torch)
    if "--segment-only" in sys.argv[1:]:
        # phase 19 alone, for work on the compiled segment (no result line)
        phase_compiled_segment(torch, dev, card)
        _say(f"capture failure raises: {_capture_failure(torch)[:200]}")
        return 0

    # 3. kernels vs plain, and the short kernels by their device events
    results = {}
    phase_kernels(torch, dev, results)
    phase_adam_kernel(torch, dev, results)
    phase_bias_act_kernel(torch, dev, results)
    phase_drqn_target_kernel(torch, dev, results)
    phase_device_events(results)

    # 4. the small slices on the card vs the CPU, and the conv net
    phase_slice(torch, dev)
    phase_drqn_slice(torch, dev)
    phase_conv_forward(torch, dev)

    # 5. - 7. the main paths, each with the recorder emptied before it
    launches = {}

    def run_path(name, fn, kernels, absent=()):
        """``(fn(), launches by entry point, of those that launched, and
        "pmean_flat" calls)``,
        each main path with the recorder emptied before it. Every path
        trains a net on the card, and each of its routes runs at least the
        target's forward: through Dense (and Conv2D) layers in ATen, where
        K10 takes every one of their epilogues (the recorder's
        ``model.bias_act_kernel`` forwards, > 0, each one K10 forward
        launch) and the ATen chain none (``model.bias_act_plain`` 0), or,
        beside K5 and K8, in K11 (``dq_drqn_target``)."""
        profiling.reset()
        out = fn()
        counts = _launches()
        counts["pmean_flat"] = profiling.counter("train.pmean_flat")
        fwd, plain = (profiling.counter(f"model.{k}")
                      for k in ("bias_act_kernel", "bias_act_plain"))
        _check(fwd == counts.get("dq_bias_act", 0) and not plain
               and (fwd > 0 or "dq_drqn_target" in counts),
               f"{name}: {fwd} Conv2D and Dense forwards took K10 and "
               f"{plain} the ATen chain, and K10's forward launched "
               f"{counts.get('dq_bias_act', 0)} times, K11 "
               f"{counts.get('dq_drqn_target', 0)}")
        for k in kernels:
            _check(k in counts, f"{name} did not launch {k}")
        for k in absent:
            _check(k not in counts, f"{name} launched {k}")
        for k, v in counts.items():
            launches[k] = launches.get(k, 0) + v
        return out, counts

    (cfg, loss), head = run_path(
        "headline loop",
        lambda: _loop(torch, dev, 131072, 1 << 20, 512, 4096, 20, 2),
        ("dq_tree_sample", "dq_fused_update", "dq_fused_collect"),
        ("dq_adam_update",))
    _say(f"headline loop: 131072 envs, 2^20 replay, batch 512, U="
         f"{cfg.updates_per_iter}, 20 iterations: loss {loss:.5g} | {card} "
         f"| launches {head}")
    (cfg, loss2), _ = run_path(
        "ungrouped loop", lambda: _loop(torch, dev, 128, 4096, 32, 128, 20, 4),
        ("dq_td_loss", "dq_tree_sample", "dq_fused_collect",
         "dq_adam_update"))
    _say(f"ungrouped loop: 128 envs, batch 32, U={cfg.updates_per_iter}: "
         f"loss {loss2:.5g} | {card}")
    (cfg, loss_w), wide = run_path(
        "grouped plain loop", lambda: _wide_loop(torch, dev, 20),
        ("dq_td_loss", "dq_tree_sample", "dq_adam_update"),
        ("dq_fused_update", "dq_fused_grads", "dq_fused_collect"))
    U = cfg.updates_per_iter
    # U loss heads and U Adam launches (K9) in each of the eager warm-up
    # iteration and make_segment's warm-up and capture; the replays call
    # the library never
    _check(wide["dq_td_loss"] == wide["dq_adam_update"] == U * 3,
           f"grouped plain loop: K1 and K9 launched {wide['dq_td_loss']} and "
           f"{wide['dq_adam_update']} times, not U x (eager warm-up, graph "
           f"warm-up, capture) = {U * 3}")
    _say(f"grouped plain loop: 2048 envs, dueling 2-512-512-4 relu (the K3 "
         f"and K4 plans refuse it), 2^15 PER, batch 512, U={U}: loss "
         f"{loss_w:.5g} | {card} | launches {wide}")
    (cfg, loss3), rec = run_path(
        "DRQN loop", lambda: _drqn_loop(torch, dev, 16384, 50),
        ("dq_fused_drqn", "dq_fused_collect_rnn", "dq_drqn_target"),
        ("dq_adam_update", "dq_bias_act"))
    _check(rec["dq_fused_collect_rnn"] == 5
           and rec["dq_fused_drqn"] == rec["dq_drqn_target"] == 3,
           f"DRQN loop: launches {rec}, not K6 5 and K5 and K11 3 (graph "
           "warm-ups and captures and one eager iteration)")
    _say(f"DRQN loop: 16384 envs, LSTM(2,32), episode replay 4096, batch "
         f"512, trace 8, U={cfg.updates_per_iter}, populate and 50 "
         f"iterations as graph replays: loss {loss3:.5g} | {card} | "
         f"launches {rec}")
    # K4 on a second env at full width inside a loop: MountainCar at the
    # headline's shape (2 populate steps, a warm-up and 5 iterations, the
    # 5 as graph replays), with episodes cut at 4 steps so that K4 resets
    # envs within those 8 steps (the car needs ~100 steps to reach the
    # goal). The counts hold the 2 populate steps, the eager warm-up and
    # make_segment's warm-up and capture
    from deepqlearning_tpu_torch import MountainCar

    (cfg, loss_m), mc = run_path(
        "MountainCar loop",
        lambda: _loop(torch, dev, 131072, 1 << 20, 512, 4096, 5, 2,
                      net=_dueling_net(torch, dev, 64, torch.tanh, 2, 3),
                      env=MountainCar(), max_episode_length=4),
        ("dq_tree_sample", "dq_fused_update", "dq_fused_collect"),
        ("dq_td_loss", "dq_adam_update"))
    _check(mc["dq_fused_collect"] == 2 + 3 and mc["dq_tree_sample"] == 3
           and mc["dq_fused_update"] == 3, f"MountainCar loop: launches {mc}")
    _say(f"MountainCar loop: 131072 envs, 2^20 replay, batch 512, U="
         f"{cfg.updates_per_iter}, dueling 2-64-64-3 tanh: loss "
         f"{loss_m:.5g} | {card} | launches {mc}")

    # 8. - 9. the data-parallel routes in a one-rank NCCL world
    torch.cuda.set_device(dev)
    initialize_multihost(f"127.0.0.1:{free_port()}", 1, 0, backend="nccl")
    N = 3
    for name, recurrent, update, adam, kernels, absent in (
            ("DP headline loop", False, "dq_fused_grads", "dq_fused_adam",
             ("dq_tree_sample", "dq_fused_collect"),
             ("dq_fused_update", "dq_adam_update")),
            ("DP DRQN loop", True, "dq_fused_drqn_grads", "dq_drqn_adam",
             ("dq_fused_collect_rnn", "dq_drqn_target"),
             ("dq_fused_drqn", "dq_adam_update", "dq_bias_act"))):
        (cfg, loss, seen), dp = run_path(
            name, lambda: _dp_loop(torch, dev, recurrent, 20, N),
            (update, adam, *kernels), absent)
        U = cfg.updates_per_iter
        # the iteration's graph is captured once: its warm-up and capture
        # launch K7 (K8) and the Adam and call pmean_flat U times each; the
        # replays call none
        _check(dp["pmean_flat"] == 2 * U == dp[update] == dp[adam],
               f"{name}: counts {dp}")
        want = {sym: v * N
                for sym, v in _symbols(DP_ITERATION[recurrent]).items()}
        _check(seen == want, f"{name}: the trace of {N} replays saw {seen}, "
                             f"not {want}")
        _say(f"{name} (NCCL, world 1) as graph replays: "
             f"{cfg.num_envs} envs, U={U}: loss {loss:.5g}; the trace of {N} "
             f"replays saw {seen} | {card} | launches {dp}")
    # the NCCL world stays for phase 19's data-parallel routes

    # 10. two gloo ranks on the one card vs the same program on the CPU
    phase_two_ranks()

    # 11. solve, the users' entry point, each part with the recorder from 0
    phase_solve(torch, dev, card, run_path)
    # 11 (d). the CartPole solve (examples/cartpole_dqn.py)
    phase_cartpole_solve(torch, dev, card, run_path)
    # 11 (e). the image-observation DQN's solve (examples/image_conv_dqn.py)
    phase_conv_solve(torch, dev, card, run_path)
    # 11 (f). the JAX package's DRQN learning tests on the card
    phase_drqn_learning(torch, card, run_path)

    # 18. envs and problems written one instance at a time
    phase_per_instance(torch, dev, card, run_path)

    # 19. the compiled segment: graph replays against eager iterations on
    # each route it captures (the data-parallel ones in phase 8's NCCL
    # world) and the evaluation's graphs
    phase_compiled_segment(torch, dev, card)
    dist.destroy_process_group()

    # each kernel's entry points, source and the TPU kernel it replaces
    src = {
        "td_loss": (("dq_td_loss",),
                    "deepqlearning_tpu_torch/csrc/td_kernel.cu",
                    "deepqlearning_tpu/ops/pallas/td_kernel.py:72"),
        "tree_sample": (("dq_tree_sample",),
                        "deepqlearning_tpu_torch/csrc/tree_sample.cu",
                        "deepqlearning_tpu/ops/pallas/tree_sample.py:195"),
        "fused_group_update": (
            ("dq_fused_update",),
            "deepqlearning_tpu_torch/csrc/fused_update.cu",
            "deepqlearning_tpu/ops/pallas/fused_update.py:421"),
        "fused_collect": (("dq_fused_collect",),
                          "deepqlearning_tpu_torch/csrc/fused_collect.cu",
                          "deepqlearning_tpu/ops/pallas/fused_collect.py:434"),
        "fused_drqn_group_update": (
            ("dq_fused_drqn",), "deepqlearning_tpu_torch/csrc/fused_drqn.cu",
            "deepqlearning_tpu/ops/pallas/fused_drqn.py:662"),
        "fused_collect_rnn": (
            ("dq_fused_collect_rnn",),
            "deepqlearning_tpu_torch/csrc/fused_collect.cu",
            "deepqlearning_tpu/ops/pallas/fused_collect.py:434"),
        "fused_grads": (("dq_fused_grads", "dq_fused_adam"),
                        "deepqlearning_tpu_torch/csrc/fused_update.cu",
                        "deepqlearning_tpu/ops/pallas/fused_update.py:575"),
        "fused_drqn_grads": (
            ("dq_fused_drqn_grads", "dq_drqn_adam"),
            "deepqlearning_tpu_torch/csrc/fused_drqn.cu",
            "deepqlearning_tpu/ops/pallas/fused_drqn.py:773"),
        "adam_update": (("dq_adam_update",),
                        "deepqlearning_tpu_torch/csrc/adam.cu",
                        "none: optax's Adam, fused by XLA on the TPU"),
        "bias_act": (("dq_bias_act", "dq_bias_act_grad"),
                     "deepqlearning_tpu_torch/csrc/bias_act.cu",
                     "none: XLA fuses the epilogue into the product on the "
                     "TPU"),
        "drqn_target": (("dq_drqn_target",),
                        "deepqlearning_tpu_torch/csrc/fused_drqn.cu",
                        "none: XLA fuses the target net's unroll on the TPU "
                        "(deepqlearning_tpu/learner/train_step.py:464)"),
    }
    # no single PyTorch call computes any of these functions (a fused
    # TD head, a sum-tree descent, whole train phases, env steps)
    symbols = {"td_loss": "td_loss_kernel",
               "tree_sample": "tree_sample_kernel (16 lanes per draw)",
               "fused_group_update": "fu_group_kernel (cooperative)",
               "fused_collect": "fc_kernel (SimpleGridWorld, CartPole, "
                                "MountainCar)",
               "fused_drqn_group_update": "dr_group_kernel (cooperative; "
                                          "in the DRQN routes' CUDA "
                                          "graphs)",
               "fused_collect_rnn": "fc_rnn_kernel (tiles of envs; "
                                    "SimpleGridWorld, CartPole, "
                                    "MountainCar; in the DRQN routes' "
                                    "CUDA graphs)",
               "fused_grads": "fu_group_kernel (cooperative, U=1; in the "
                              "data-parallel routes' CUDA graphs)",
               "fused_drqn_grads": "dr_group_kernel (cooperative, U=1; in "
                                   "the data-parallel routes' CUDA "
                                   "graphs)",
               "adam_update": "adam_kernel (the plain steps' Adam and "
                              "gradient max-abs, one launch per update)",
               "bias_act": "bias_act_kernel and bias_act_grad_kernel "
                           "(every Conv2D and Dense layer's epilogue on the "
                           "card, forward and backward)",
               "drqn_target": "dr_target_kernel (the target net's Q(s') "
                              "over every window of a recurrent step; in "
                              "the DRQN routes' CUDA graphs)"}
    kernels = [dict(name=k, kernel=symbols[k], route="cuda",
                    source=source, replaces=replaces,
                    launches=sum(launches.get(e, 0) for e in entries),
                    **results[k], library_ms=None)
               for k, (entries, source, replaces) in src.items()]
    # 19 (e), last: a capture that fails raises (nothing runs after it)
    _say(f"compiled segment: a select_fn with a host read makes solve "
         f"raise: {_capture_failure(torch)[:300]!r}")
    _say(card)
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
