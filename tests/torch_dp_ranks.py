"""Rank programs of the port's data-parallel tests.

``deepqlearning_tpu_torch.parallel.launch.spawn`` starts them in fresh
gloo CPU processes, so this module imports PyTorch and the port only, never
JAX: the test modules that hold the JAX side import it for its configs.
Each program returns numpy arrays.
"""
import os

import numpy as np
import torch

import deepqlearning_tpu_torch as dt
from deepqlearning_tpu_torch.ops.helpers import flatten
from deepqlearning_tpu_torch.parallel.mesh import DataParallelRunner, make_mesh
from deepqlearning_tpu_torch.parallel.multihost import (
    global_data_mesh, hybrid_mesh, local_shard_info, pod_data_mesh,
    pod_shard_plan)

# the slice configurations: (num_envs, buffer, batch, train_freq,
# max_episode_length, target_update_freq[, trace_length])
FF = dict(fused=(128, 1024, 32, 32, 5, 256), plain=(128, 1024, 32, 32, 5, 256),
          ungrouped=(128, 1024, 32, 128, 5, 256))
DRQN = (128, 256, 16, 64, 5, 256, 4)
EPS = (1.0, 0.05, 500)  # LinearDecaySchedule


def ff_cfg(mod, route):
    E, C, B, TF, MAXLEN, TUF = FF[route]
    return mod.DQNConfig(num_envs=E, batch_size=B, buffer_size=C,
                         train_freq=TF, max_episode_length=MAXLEN,
                         target_update_freq=TUF, learning_rate=1e-2,
                         double_q=True, dueling=True, prioritized_replay=True,
                         fused_collect=True, fused_updates={
                             "fused": True, "plain": False,
                             "ungrouped": None}[route])


def drqn_cfg(mod):
    E, C, B, TF, MAXLEN, TUF, T = DRQN
    return mod.DQNConfig(num_envs=E, batch_size=B, buffer_size=C,
                         train_freq=TF, trace_length=T,
                         max_episode_length=MAXLEN, target_update_freq=TUF,
                         learning_rate=1e-2, recurrence=True, double_q=True,
                         fused_collect=True, fused_updates=True)


def _setup(kind, route):
    env = dt.SimpleGridWorld()
    if kind == "drqn":
        net = dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
        cfg = drqn_cfg(dt)
        buf = dt.EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size,
                                     cfg.batch_size, cfg.trace_length,
                                     cfg.max_episode_length,
                                     num_envs=cfg.num_envs, device="cpu")
    else:
        net = dt.create_dueling_network(dt.Chain(
            dt.Flatten(), dt.Dense(2, 16, torch.tanh),
            dt.Dense(16, 16, torch.tanh), dt.Dense(16, 4)))
        cfg = ff_cfg(dt, route)
        buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                         cfg.batch_size, device="cpu")
    return env, net, cfg, buf


def snapshot(carry):
    """The carry's state as numpy arrays."""
    n = lambda t: t.detach().cpu().numpy().copy()
    out = {"loss": n(carry.loss), "gnorm": n(carry.gnorm),
           "count": int(carry.opt_state.count), "sync_acc": carry.sync_acc,
           "obs": n(carry.actor.obs), "ep_step": n(carry.actor.ep_step)}
    for name, d in (("params", carry.params),
                    ("target", carry.target_params),
                    ("m", carry.opt_state.m), ("v", carry.opt_state.v)):
        out.update({f"{name}/{k}": n(t) for k, t in d.items()})
    r = carry.replay
    if hasattr(r, "rows"):
        out.update(rows=n(r.rows), leaves=n(r.tree[0]), size=r.size)
    else:
        out.update({k: n(getattr(r, k)) for k in (
            "data", "ep_start", "ep_len", "rec_count", "cur_len")})
    return out


def slice_rank(rank, world, path):
    """Populate and two iterations from this rank's shard of a JAX carry,
    with injected uniforms and draws; a snapshot after each iteration."""
    inp = torch.load(path, weights_only=False)
    env, net, cfg, buf = _setup(inp["kind"], inp["route"])
    runner = DataParallelRunner(env, net, buf, cfg,
                                dt.LinearDecaySchedule(*EPS), env.discount,
                                mesh=make_mesh(world))
    carry = inp["carries"][rank]._replace(
        generator=torch.Generator().manual_seed(rank))
    for u in inp["pop_u"]:
        carry = runner.run_populate(carry, 1, collect_u=[u[rank]])
    snaps = []
    for cu, su in zip(inp["it_u"], inp["sample_u"]):
        carry = runner.run_segment(carry, 1, collect_u=[[cu[rank]]],
                                   sample_u=[[su[rank]]])
        snaps.append(snapshot(carry))
    return snaps


def _testmdp_runner(mesh, dcn_sync_every=1):
    env = dt.TestMDP((5, 5), 4, 6)
    net = dt.create_dueling_network(dt.Chain(
        dt.Flatten(), dt.Dense(100, 16, torch.tanh),
        dt.Dense(16, env.num_actions)))
    cfg = dt.DQNConfig(num_envs=2, batch_size=8, buffer_size=64,
                       train_freq=2, train_start=8, max_episode_length=6)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                     cfg.batch_size, device="cpu")
    return DataParallelRunner(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.1, 100),
                              env.discount, mesh=mesh,
                              dcn_sync_every=dcn_sync_every)


def _flat(params):
    return flatten(params, sorted(params)).numpy().copy()


def hier_rank(rank, world):
    """The flat 4-rank mesh and the 2 x 2 (dcn, ici) mesh from one seed:
    rank 0's parameters after populate 8 + 4 iterations of each."""
    out = []
    for mesh in (make_mesh(world), hybrid_mesh()):
        runner = _testmdp_runner(mesh)
        carry = runner.run_populate(runner.init_carry(3), 8)
        carry = runner.run_segment(carry, 4)
        out.append(_flat(runner.device_get_params(carry)))
    return out


def local_sgd_rank(rank, world):
    """Local SGD (k = 2) on a 2 x 2 mesh in segments of one iteration:
    this rank's parameters after each of 2 segments, and the refusal of
    ``dcn_sync_every > 1`` on a 1-D mesh."""
    try:
        _testmdp_runner(make_mesh(world), dcn_sync_every=2)
        refused = ""
    except ValueError as e:
        refused = str(e)
    runner = _testmdp_runner(hybrid_mesh(), dcn_sync_every=2)
    carry = runner.run_populate(runner.init_carry(5), 8)
    out = []
    for _ in range(2):
        carry = runner.run_segment(carry, 1)
        out.append(_flat(carry.params))
    return refused, out, carry.iters


def multihost_rank(rank, world):
    """The multihost helpers' answers on this rank (2 simulated hosts)."""
    hm = hybrid_mesh()
    flat = pod_data_mesh()
    plan = pod_shard_plan(global_num_envs=32, batch_size=8, mesh=flat)
    try:
        pod_shard_plan(global_num_envs=33, batch_size=8, mesh=flat)
        refused = ""
    except ValueError as e:
        refused = str(e)
    return dict(
        hybrid_shape=tuple(hm.shape), hybrid_names=hm.mesh_dim_names,
        hybrid_mesh=hm.mesh.tolist(), ici_coord=hm.get_local_rank("ici"),
        dcn_coord=hm.get_local_rank("dcn"), flat_size=flat.size(),
        flat_mesh=flat.mesh.tolist(), global_size=global_data_mesh().size(),
        plan=plan, refused=refused, info=local_shard_info(flat),
        local_world=int(os.environ["LOCAL_WORLD_SIZE"]))
