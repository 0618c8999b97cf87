"""Data-parallel actor-learner over ``torch.distributed`` ranks.

Counterpart of ``deepqlearning_tpu.parallel.mesh``. The JAX runner holds
every device's shard of the carry in one program under ``shard_map``; here
every rank is one process that holds its own shard (its envs and its whole
replay), and :class:`DataParallelRunner` runs in every rank. Parameters
start equal on every rank and stay equal, because every rank applies the
same averaged gradient. The only collectives are the per-sub-update
gradient all-reduce (``learner/train_step.py::pmean_flat``) and, with
local SGD, the periodic average of the parameters and Adam moments.

A JAX ``Mesh`` becomes a ``torch.distributed.device_mesh.DeviceMesh`` over
the world, whose per-dimension process groups (``mesh.get_group(name)``)
are what the train steps take as ``axis_name``:

* 1-D ``(data,)``: a flat all-reduce over the world;
* 2-D ``(dcn, ici)`` (``parallel.multihost.hybrid_mesh``): a hierarchical
  all-reduce per update, ICI group first, then DCN; or, with
  ``dcn_sync_every = k > 1``, local SGD: gradients reduce over ICI only, and
  every k iterations the parameters and the float Adam moments ``m``, ``v``
  are averaged across DCN (the Adam count is not, nor are the target
  parameters, as in the JAX runner). The port counts those k iterations
  over the whole run, across ``run_segment`` calls, with the carry's
  ``iters``; the JAX runner counts them within each call.

``cfg.num_envs`` is per rank; the aggregate env throughput is ``num_envs *
world_size``.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist

from ..config import DQNConfig
from ..device import counter
from ..learner.actor import init_actor
from ..learner.loop import LoopCarry, build_loop
from ..learner.train_step import pmean_flat


def _device_type() -> str:
    """The DeviceMesh device type of the default group's backend: ``cuda``
    for NCCL, ``cpu`` for gloo (gloo also reduces CUDA tensors, through
    host memory)."""
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_mesh(n_devices: Optional[int] = None, axis_name: str = "data"):
    """A 1-D ``DeviceMesh`` named ``axis_name`` over every rank of the
    initialised process group. Every rank must call it. ``n_devices``, if
    given, must be the world size: a rank outside the mesh would run no
    program."""
    from torch.distributed.device_mesh import init_device_mesh

    world = dist.get_world_size()
    if n_devices is not None and int(n_devices) != world:
        raise ValueError(f"n_devices={n_devices}: the mesh spans the whole "
                         f"world of {world} ranks")
    return init_device_mesh(_device_type(), (world,),
                            mesh_dim_names=(axis_name,))


class DataParallelRunner:
    """Runs the DQN loop on this rank's env/replay shard, with gradients
    averaged over the mesh. Construct it, and call every method, in every
    rank of the mesh.

    The carry lives on ``buffer.device`` (the network's parameters must
    too). ``run_populate`` and ``run_segment`` take the injected uniforms /
    draws of ``build_loop``'s ``populate_step`` and ``iteration``, one entry
    per collect step or per iteration."""

    def __init__(self, env, network, buffer, cfg: DQNConfig, eps_fn,
                 gamma: float, mesh=None, dcn_sync_every: int = 1):
        self.env, self.network, self.buffer, self.cfg = env, network, buffer, cfg
        self.mesh = mesh if mesh is not None else make_mesh()
        self.axes = tuple(self.mesh.mesh_dim_names)
        self.n_devices = self.mesh.size()
        self.dcn_sync_every = int(dcn_sync_every)
        if self.dcn_sync_every > 1 and len(self.axes) != 2:
            raise ValueError(
                "dcn_sync_every > 1 needs a 2-D (dcn, ici) mesh "
                "(parallel.multihost.hybrid_mesh)")
        group = self.mesh.get_group
        if len(self.axes) == 1:
            grad_axis = group(self.axes[0])
        elif self.dcn_sync_every > 1:
            # local SGD: per-update grads reduce over ICI only
            grad_axis = group(self.axes[1])
        else:
            # hierarchical per-update reduction, innermost (ICI) first
            grad_axis = (group(self.axes[1]), group(self.axes[0]))
        self._dcn = group(self.axes[0]) if len(self.axes) == 2 else None
        self._iteration, self._populate_step, self.optimizer = build_loop(
            env, network, buffer, cfg, eps_fn, gamma, axis_name=grad_axis)
        self.device = buffer.device

    def init_carry(self, seed: int) -> LoopCarry:
        """A fresh carry: the parameters from ``seed`` (equal on every
        rank), and this rank's own generator for its envs, collect and
        sample, seeded from the rank's entry of a list drawn after the
        parameters (the JAX runner splits its actor and learner keys per
        device)."""
        dev = self.device
        gen = torch.Generator(device=dev).manual_seed(int(seed))
        params = self.network.init(gen)
        seeds = torch.randint(1, 1 << 62, (dist.get_world_size(),),
                              generator=gen, device=dev).tolist()
        rank_gen = torch.Generator(device=dev).manual_seed(
            seeds[dist.get_rank()])
        zero = torch.zeros((), dtype=torch.float32, device=dev)
        return LoopCarry(
            actor=init_actor(self.env, self.network, self.cfg.num_envs,
                             rank_gen, dev),
            replay=self.buffer.init(), params=params,
            target_params={k: p.clone() for k, p in params.items()},
            opt_state=self.optimizer.init(params), generator=rank_gen,
            loss=zero, gnorm=zero.clone(), sync_acc=counter(0, dev),
            iters=counter(0, dev))

    def run_populate(self, carry: LoopCarry, n_iters: int,
                     collect_u: Optional[Sequence] = None) -> LoopCarry:
        """``n_iters`` ε=1 collect steps into this rank's replay (open
        episodes stay open, as in the JAX runner)."""
        cc = (carry.actor, carry.replay, carry.params)
        for i in range(n_iters):
            cc = self._populate_step(
                cc, carry.generator, None if collect_u is None else collect_u[i])
        return carry._replace(actor=cc[0], replay=cc[1])

    def run_segment(self, carry: LoopCarry, n_iters: int,
                    collect_u: Optional[Sequence] = None,
                    sample_u: Optional[Sequence] = None) -> LoopCarry:
        """``n_iters`` loop iterations; ``collect_u[i]`` / ``sample_u[i]``
        are iteration i's injected uniforms (lists, as ``iteration`` takes
        them). With local SGD, the carry's parameters and Adam moments are
        averaged across DCN after every ``dcn_sync_every``-th iteration of
        the run."""
        k = self.dcn_sync_every
        for i in range(n_iters):
            carry = self._iteration(
                carry, collect_u=None if collect_u is None else collect_u[i],
                sample_u=None if sample_u is None else sample_u[i])
            # the data-parallel route runs eagerly: the period is read
            # from the device counter
            if k > 1 and int(carry.iters) % k == 0:
                self._average_across_dcn(carry)
        return carry

    @torch.no_grad()
    def _average_across_dcn(self, carry: LoopCarry) -> None:
        """Local-SGD sync, in place: one flat all-reduce of params, m, v."""
        p, m, v = carry.params, carry.opt_state.m, carry.opt_state.v
        parts = {**{("p", n): t for n, t in p.items()},
                 **{("m", n): t for n, t in m.items()},
                 **{("v", n): t for n, t in v.items()}}
        for key, t in pmean_flat(parts, self._dcn).items():
            parts[key].copy_(t)

    def device_get_params(self, carry: LoopCarry):
        """The parameters of rank 0 (equal on every rank unless local SGD
        is between syncs), as new tensors on every rank."""
        from ..ops.helpers import flatten, unflatten

        names = list(carry.params)
        flat = flatten(carry.params, names)
        dist.broadcast(flat, src=0)
        return unflatten(flat, carry.params, names)
