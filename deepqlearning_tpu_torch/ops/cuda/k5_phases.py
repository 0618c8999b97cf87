"""Where K5's time goes on the card: a diagnostic build of the kernel
library (``-DDR_TRACE``) in which block 0 of ``dr_group_kernel`` stamps
``clock64`` at each phase of each sub-update and at each block-wide step
of one unroll step and one BPTT step.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 -m deepqlearning_tpu_torch.ops.cuda.k5_phases [--timed | --precision]

It prints ptxas's registers, stack and spills for ``dr_group_kernel``
(and ``dr_group_gm_kernel``, the T-step regions in global memory),
then for the DRQN loop's shapes (U = 4 sub-updates of B = 512 windows of
T = 8 steps, LSTM(2, 32) + Dense(32, 4) with double-Q, and the dueling GRU
net of ``chip_smoke.py`` with max targets) the cycles per sub-update of
each phase (the param copy, block 0's tile: its input copy, the s'/s
unrolls, the BPTT and the partial write; the two grid barriers and phase
B), the cycles of each block-wide step of unroll step 1 and BPTT step
T-2, and K5's time by CUDA events in the regular build. With
``--timed`` only that last time, through the wrapper ``fused_drqn.
fused_drqn_group_update_cuda`` of the package it is run in: copied into an
older checkout's ``ops/cuda/``, it times that checkout's K5 the same way.

With ``--precision`` it holds K5 (U = 2) and the float32 tile-order
reference ``fused_drqn_group_update_tiled`` against the same reference in
float64, for the nets of ``chip_smoke.py``'s K5 phase on five seeds each:
per net, the largest excess of a parameter's error over 1e-6 + 1e-5·|ref|
(the tolerance ``chip_smoke.py`` holds K5 to against the float32
reference; positive means outside it) and the loss's relative error,
the same excess of K5 against the float32 reference, and K8's gradient
error over its largest entry.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ...models.chain import GRU, LSTM, Chain, Dense
from ...models.dueling import create_dueling_network
from . import build, fused_drqn as fd
from .k3_phases import _ptxas

U, B, T = 4, 512, 8
NMARK, NSTEP = 9, 12  # DR_NMARK, DR_NSTEP of csrc/fused_drqn.cu
PHASES = ("param copy", "input copy", "s'/s unrolls", "BPTT",
          "partial write", "barrier 1", "phase B", "barrier 2")
STEPS = ("pre", "gates and cell", "-", "head", "TD")
BSTEPS = ("-", "head", "gate cotangents", "dh·Whᵀ", "pre")


def _case(dev, kind):
    """A K5 call at the DRQN loop's shapes on fresh inputs, as a closure."""
    if kind == "lstm":
        net, double_q = Chain(LSTM(2, 32, device=dev),
                              Dense(32, 4, device=dev)), True
    else:
        net, double_q = create_dueling_network(Chain(
            Dense(2, 16, torch.tanh, device=dev), GRU(16, 32, device=dev),
            Dense(32, 32, torch.tanh, device=dev),
            Dense(32, 4, device=dev))), False
    plan = fd.drqn_plan_for(net, T, B, double_q)
    params = net.init(torch.Generator(device=dev).manual_seed(5))
    g = torch.Generator(device=dev).manual_seed(6)
    n = U * B
    lens = torch.randint(1, T + 1, (n, 1), generator=g, device=dev)
    data = dict(obs=torch.rand(n, T, 2, generator=g, device=dev) * 10,
                nobs=torch.rand(n, T, 2, generator=g, device=dev) * 10,
                action=torch.randint(0, 4, (n, T), generator=g, device=dev),
                reward=torch.randn(n, T, generator=g, device=dev),
                done=(torch.rand(n, T, generator=g, device=dev) < 0.1).float(),
                mask=(torch.arange(T, device=dev)[None] < lens).float(),
                q_sp_tgt=torch.randn(n, T, 4, generator=g, device=dev))
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    state = (params, zeros, {k: v.clone() for k, v in zeros.items()},
             torch.zeros((), dtype=torch.int32, device=dev))
    kw = dict(gamma=0.95, double_q=double_q, lr=1e-3, batch_size=B,
              n_updates=U)
    return lambda: fd.fused_drqn_group_update_cuda(plan, *state, **data,
                                                   **kw)


def _rebuild(flags) -> ctypes.CDLL:
    build.NVCC_FLAGS[:] = flags
    build.library.cache_clear()
    fd._MAX_GRID.clear()
    return build.library()


def _traced(dev, flags) -> None:
    lib = _rebuild(flags + ["-DDR_TRACE"])
    lib.dq_dr_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for kind in ("lstm", "gru"):
        run = _case(dev, kind)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        marks = (ctypes.c_longlong * (64 * NMARK))()
        steps = (ctypes.c_longlong * (64 * NSTEP))()
        build.check(lib.dq_dr_trace(ctypes.addressof(marks),
                                    ctypes.addressof(steps)), "trace")
        us = range(1, U - 1)  # neither the first copy nor the last u
        per = [sum(marks[u * NMARK + j + 1] - marks[u * NMARK + j]
                   for u in us) / len(us) for j in range(NMARK - 1)]
        total = sum(marks[(u + 1) * NMARK] - marks[u * NMARK]
                    for u in us) / len(us)
        inner = [sum(steps[u * NSTEP + j + 1] - steps[u * NSTEP + j]
                     for u in us) / len(us) for j in range(NSTEP - 1)]
        print(f"{kind}: {total:.0f} cycles per sub-update; " + ", ".join(
            f"{n} {c:.0f}" for n, c in zip(PHASES, per)))
        print("  unroll step 1: " + ", ".join(
            f"{n} {c:.0f}" for n, c in zip(STEPS, inner[:5])))
        print(f"  BPTT step T-2: " + ", ".join(
            f"{n} {c:.0f}" for n, c in zip(BSTEPS, inner[6:])))


def _timed(dev) -> None:
    for kind in ("lstm", "gru"):
        run = _case(dev, kind)
        run()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            run()
        e1.record()
        e1.synchronize()
        print(f"{kind}: K5 U={U} B={B} T={T} "
              f"{e0.elapsed_time(e1) / 20:.4f} ms (regular build)")


def _precision(dev) -> None:
    wide = create_dueling_network(Chain(
        Dense(2, 128, torch.relu, device=dev), LSTM(128, 16, device=dev),
        Dense(16, 128, torch.tanh, device=dev), Dense(128, 4, device=dev)))
    nets = (("LSTM(2,32)+Dense(32,4) double-Q", Chain(
                LSTM(2, 32, device=dev), Dense(32, 4, device=dev)), True,
             512, T),
            ("dueling GRU max", create_dueling_network(Chain(
                Dense(2, 16, torch.tanh, device=dev), GRU(16, 32, device=dev),
                Dense(32, 32, torch.tanh, device=dev),
                Dense(32, 4, device=dev))), False, 512, T),
            ("dueling Dense(2,128)+LSTM(128,16) double-Q", wide, True, 64, T),
            ("LSTM(4,48)+Dense(48,128) max", Chain(
                LSTM(4, 48, device=dev), Dense(48, 128, device=dev)), False,
             24, 32))
    f64 = lambda d: {k: v.double() if v.is_floating_point() else v
                     for k, v in d.items()}
    for name, net, double_q, nb, nt in nets:
        for seed in range(5):
            g = torch.Generator(device=dev).manual_seed(100 + seed)
            plan = fd.drqn_plan_for(net, nt, nb, double_q)
            params = net.init(g)
            n, A = 2 * nb, plan.head.num_actions
            r = lambda *s: torch.rand(*s, generator=g, device=dev)
            lens = torch.randint(1, nt + 1, (n, 1), generator=g, device=dev)
            data = dict(
                obs=r(n, nt, plan.in_dim) * 10,
                nobs=r(n, nt, plan.in_dim) * 10,
                action=torch.randint(0, A, (n, nt), generator=g, device=dev),
                reward=torch.randn(n, nt, generator=g, device=dev),
                done=(r(n, nt) < 0.1).float(),
                mask=(torch.arange(nt, device=dev)[None] < lens).float(),
                q_sp_tgt=torch.randn(n, nt, A, generator=g, device=dev))
            kw = dict(gamma=0.95, double_q=double_q, lr=1e-3, batch_size=nb,
                      n_updates=2)
            out = {}
            for tag, fn, p, d in (
                    ("kernel", fd.fused_drqn_group_update_cuda, params, data),
                    ("f32", fd.fused_drqn_group_update_tiled, params, data),
                    ("f64", fd.fused_drqn_group_update_tiled, f64(params),
                     f64(data))):
                z = {k: torch.zeros_like(v) for k, v in p.items()}
                st = ({k: v.clone() for k, v in p.items()}, z,
                      {k: v.clone() for k, v in z.items()},
                      torch.zeros((), dtype=torch.int32, device=dev))
                out[tag] = (st[0], fn(plan, *st, **d, **kw)[0])
            excess = lambda p, ref: max(float(
                ((p[k].double() - ref[k].double()).abs() - 1e-6
                 - 1e-5 * ref[k].double().abs()).max()) for k in plan.names)
            ref, rl = out["f64"]
            line = [f"{tag}: excess {excess(out[tag][0], ref):.3g}, loss rel "
                    f"{abs(float(out[tag][1]) / float(rl) - 1):.2g}"
                    for tag in ("kernel", "f32")]
            line.append(f"kernel against the float32 reference: excess "
                        f"{excess(out['kernel'][0], out['f32'][0]):.3g}")
            first = {k: v[:nb] for k, v in data.items()}
            gk = fd.fused_drqn_grads_cuda(plan, params, **first,
                                          gamma=0.95, double_q=double_q)[0]
            g64 = fd.fused_drqn_grads_tiled(plan, f64(params), **f64(first),
                                            gamma=0.95,
                                            double_q=double_q)[0]
            gerr = float((gk.double() - g64).abs().max() / g64.abs().max())
            print(f"{name} B={nb} T={nt} seed {seed}: against the float64 "
                  f"tile-order reference, " + "; ".join(line)
                  + f"; K8 gradient error / max |g| {gerr:.3g}")


def main(argv) -> int:
    if not torch.cuda.is_available():
        print("k5_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    if "--precision" in argv:
        _precision(dev)
        return 0
    if "--timed" not in argv:
        flags = list(build.NVCC_FLAGS)
        _ptxas(("dr_group_kernel", "dr_group_gm_kernel", "fu_group_kernel"))
        _traced(dev, flags)
        _rebuild(flags)
    _timed(dev)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
