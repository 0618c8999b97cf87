"""Where K3's time goes on the card: a diagnostic build of the kernel
library (``-DFU_TRACE``) in which block 0 of ``fu_group_kernel`` stamps
``clock64`` at each phase and each block-wide step of its tile.

Run on a machine with an NVIDIA GPU, from the repository root::

    python3 -m deepqlearning_tpu_torch.ops.cuda.k3_phases

It prints ptxas's registers, stack and spills for ``fu_group_kernel`` and
``fc_kernel``, then for the headline shapes (U = 32 sub-updates of B = 512,
the 2->64->64->{1,4} dueling net with double-Q, and the plain chain with
max targets) the cycles per sub-update of each phase (the param copy,
block 0's tile, the two grid barriers, phase B), the cycles of each step
inside the tile, and K3's time by CUDA events in the regular build.
"""
from __future__ import annotations

import ctypes
import subprocess
import sys

import torch

from ...models.chain import Chain, Dense, Flatten
from ...models.dueling import create_dueling_network
from . import build, fused_update as fu

U, B = 32, 512
PHASES = ("param copy", "tiles", "barrier 1", "phase B", "barrier 2")
STEPS = ("input copy", "forward 0", "forward 1", "forward 2", "Q", "TD",
         "dz", "backward 0", "backward 1", "backward 2")


def _ptxas(kernels=("fu_group_kernel", "fc_kernel")) -> None:
    for name, line in build.ptxas_report(kernels).items():
        print(f"ptxas {name}: {line}")


def _case(dev, dueling, double_q):
    """A K3 call at the headline shapes on fresh inputs, as a closure."""
    chain = Chain(Flatten(), Dense(2, 64, torch.tanh, device=dev),
                  Dense(64, 64, torch.tanh, device=dev),
                  Dense(64, 4, device=dev))
    net = create_dueling_network(chain) if dueling else chain
    plan = fu.plan_for(net)
    params = net.init(torch.Generator(device=dev).manual_seed(5))
    g = torch.Generator(device=dev).manual_seed(6)
    n = U * B
    data = dict(obs=torch.rand(n, 2, generator=g, device=dev) * 10,
                nobs=torch.rand(n, 2, generator=g, device=dev) * 10,
                action=torch.randint(0, 4, (n,), generator=g, device=dev),
                reward=torch.randn(n, generator=g, device=dev),
                done=(torch.rand(n, generator=g, device=dev) < 0.05).float(),
                weights=torch.rand(n, generator=g, device=dev) + 0.5,
                q_sp_tgt=torch.randn(n, 4, generator=g, device=dev))
    zeros = {k: torch.zeros_like(v) for k, v in params.items()}
    state = (params, zeros, {k: v.clone() for k, v in zeros.items()},
             torch.zeros((), dtype=torch.int32, device=dev))
    kw = dict(gamma=0.95, double_q=double_q, lr=1e-4, alpha=0.6, eps=1e-3,
              batch_size=B, n_updates=U)
    return lambda: fu.fused_group_update_cuda(plan, *state, **data, **kw)


def _traced(dev, flags) -> None:
    build.NVCC_FLAGS[:] = flags + ["-DFU_TRACE"]
    build.library.cache_clear()
    fu._MAX_GRID.clear()
    lib = build.library()
    lib.dq_fu_trace.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    for dueling, double_q in ((True, True), (False, False)):
        run = _case(dev, dueling, double_q)
        for _ in range(3):
            run()
        torch.cuda.synchronize()
        phases = (ctypes.c_longlong * (64 * 6))()
        steps = (ctypes.c_longlong * (64 * 16))()
        build.check(lib.dq_fu_trace(ctypes.addressof(phases),
                                    ctypes.addressof(steps)), "trace")
        per = [sum(phases[u * 6 + j + 1] - phases[u * 6 + j]
                   for u in range(1, U)) / (U - 1) for j in range(5)]
        inner = [sum(steps[u * 16 + j + 1] - steps[u * 16 + j]
                     for u in range(1, U)) / (U - 1) for j in range(10)]
        total = (phases[(U - 1) * 6 + 5] - phases[6]) / (U - 1)
        print(f"dueling={dueling} double_q={double_q}: {total:.0f} cycles "
              "per sub-update; " + ", ".join(
                  f"{n} {c:.0f}" for n, c in zip(PHASES, per)))
        print("  block 0's tile: " + ", ".join(
            f"{n} {c:.0f}" for n, c in zip(STEPS, inner)))


def _timed(dev, flags) -> None:
    build.NVCC_FLAGS[:] = flags
    build.library.cache_clear()
    fu._MAX_GRID.clear()
    for dueling, double_q in ((True, True), (False, False)):
        run = _case(dev, dueling, double_q)
        run()
        torch.cuda.synchronize()
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(20):
            run()
        e1.record()
        e1.synchronize()
        print(f"dueling={dueling} double_q={double_q}: K3 U={U} B={B} "
              f"{e0.elapsed_time(e1) / 20:.4f} ms (regular build)")


def main() -> int:
    if not torch.cuda.is_available():
        print("k3_phases: no CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    flags = list(build.NVCC_FLAGS)
    _ptxas()
    _traced(dev, flags)
    _timed(dev, flags)
    return 0


if __name__ == "__main__":
    sys.exit(main())
