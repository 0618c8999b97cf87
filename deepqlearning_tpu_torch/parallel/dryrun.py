"""``dryrun_multichip(n)``: the full data-parallel training step over n
gloo CPU ranks on tiny shapes (the port's counterpart of the JAX package's
``__graft_entry__.dryrun_multichip``).

Three parts on TestMDP, each populate then train through
``DataParallelRunner``, each checking a finite loss and parameters equal
on every rank: the fused feed-forward route (kernel K7's twin, 2 grouped
sub-updates per iteration), the fused recurrent route (K8's twin, LSTM),
and, for an even n >= 4, the hierarchical 2-D ``(dcn, ici)`` mesh of two
simulated hosts. Run: ``python -m deepqlearning_tpu_torch.parallel.dryrun
4``.
"""
from __future__ import annotations

import os
import sys

import torch
import torch.distributed as dist

from .launch import spawn


def _check_replicated(params, what: str) -> None:
    """Every rank holds rank 0's parameters bit for bit."""
    from ..ops.helpers import flatten

    flat = flatten(params, list(params))
    ref = flat.clone()
    dist.broadcast(ref, src=0)
    bad = torch.tensor([float(not torch.equal(flat, ref))])
    dist.all_reduce(bad)
    if bad.item():
        raise AssertionError(f"{what}: parameters differ across ranks")


def _run(runner, seed: int, n_iters: int, what: str) -> float:
    carry = runner.run_populate(runner.init_carry(seed), 8)
    carry = runner.run_segment(carry, n_iters)
    if not bool(torch.isfinite(carry.loss)):
        raise AssertionError(f"{what}: loss is not finite")
    _check_replicated(carry.params, what)
    return float(carry.loss)


def _rank(rank: int, world: int):
    from .. import (
        LSTM, Chain, Dense, DQNConfig, EpisodeReplayBuffer, Flatten,
        LinearDecaySchedule, PrioritizedReplayBuffer, create_dueling_network)
    from ..envs.test_mdp import TestMDP
    from .mesh import DataParallelRunner, make_mesh
    from .multihost import hybrid_mesh

    sched = LinearDecaySchedule(1.0, 0.1, 100)
    env = TestMDP((5, 5), 4, 6)
    net = create_dueling_network(Chain(Flatten(), Dense(100, 16, torch.tanh),
                                       Dense(16, env.num_actions)))
    # updates_per_iter = 2 grouped sub-updates: the fused route (K7)
    cfg = DQNConfig(num_envs=4, batch_size=8, buffer_size=64, train_freq=2,
                    train_start=8, max_episode_length=6, fused_updates=True)
    buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, device="cpu")
    mesh = make_mesh(world)
    loss = _run(DataParallelRunner(env, net, buf, cfg, sched, env.discount,
                                   mesh=mesh), 0, 2, "feed-forward")

    renv = TestMDP((5, 5), 1, 6)
    rnet = Chain(Flatten(), LSTM(25, 8), Dense(8, renv.num_actions))
    rcfg = DQNConfig(num_envs=4, batch_size=8, buffer_size=32, train_freq=2,
                     train_start=8, max_episode_length=6, recurrence=True,
                     trace_length=5, dueling=False, fused_updates=True)
    rbuf = EpisodeReplayBuffer(renv.obs_shape, rcfg.buffer_size,
                               rcfg.batch_size, rcfg.trace_length,
                               rcfg.max_episode_length,
                               num_envs=rcfg.num_envs, device="cpu")
    rloss = _run(DataParallelRunner(renv, rnet, rbuf, rcfg, sched,
                                    renv.discount, mesh=mesh),
                 1, 1, "recurrent")

    hloss = float("nan")
    if world % 2 == 0 and world >= 4:
        os.environ["LOCAL_WORLD_SIZE"] = str(world // 2)  # two hosts
        hloss = _run(DataParallelRunner(env, net, buf, cfg, sched,
                                        env.discount, mesh=hybrid_mesh()),
                     2, 1, "hierarchical")
    return loss, rloss, hloss


def dryrun_multichip(n_devices: int) -> str:
    """Run the three parts over ``n_devices`` gloo CPU ranks; returns (and
    prints) the summary line. Raises if any rank fails."""
    loss, rloss, hloss = spawn(_rank, int(n_devices))[0]
    line = (f"dryrun_multichip({n_devices}): OK, loss={loss:.4f}, "
            f"drqn_loss={rloss:.4f}, hier_loss={hloss:.4f}")
    print(line)
    return line


if __name__ == "__main__":
    dryrun_multichip(int(sys.argv[1]) if len(sys.argv) > 1 else 4)
