"""The port's data parallelism across simulated hosts: hierarchical and
local-SGD reduction, the multihost helpers and ``dryrun_multichip``.

Spawned gloo CPU ranks (``parallel/launch.py::spawn``, 1 torch thread
each) run the rank programs of ``torch_dp_ranks.py``; ``LOCAL_WORLD_SIZE=2``
makes 4 ranks two hosts of two, so ``hybrid_mesh`` is the 2 x 2 ``(dcn,
ici)`` mesh. The JAX side runs on the virtual CPU devices of
tests/conftest.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
from deepqlearning_tpu.parallel.mesh import (  # noqa: E402
    DataParallelRunner as JRunner)
from deepqlearning_tpu_torch import dryrun_multichip  # noqa: E402
from deepqlearning_tpu_torch.parallel.launch import spawn  # noqa: E402
from deepqlearning_tpu_torch.parallel.multihost import ShardPlan  # noqa: E402

import torch_dp_ranks as ranks  # noqa: E402


def test_hierarchical_matches_flat():
    """``all_reduce`` over ICI then DCN on the 2 x 2 mesh gives the flat
    4-rank run's parameters (same seed, same rank order) up to the order of
    the sums: rtol 2e-4 / atol 2e-6, as tests/test_distributed.py:156-171."""
    out = spawn(ranks.hier_rank, 4, local_world_size=2)
    for flat, hier in out:
        np.testing.assert_allclose(hier, flat, rtol=2e-4, atol=2e-6)
        np.testing.assert_array_equal(flat, out[0][0])
        np.testing.assert_array_equal(hier, out[0][1])


def _jax_local_sgd_rows_after(n_segments):
    """The JAX runner, local SGD k = 2 on a 2 x 2 (dcn, ici) mesh, run in
    segments of one iteration: the first leaf's two dcn rows."""
    env = dq.TestMDP((5, 5), 4, 6)
    net = dq.create_dueling_network(dq.Chain(
        dq.Flatten(), dq.Dense(100, 16, jnp.tanh),
        dq.Dense(16, env.num_actions)))
    cfg = dq.DQNConfig(num_envs=2, batch_size=8, buffer_size=64,
                       train_freq=2, train_start=8, max_episode_length=6)
    buf = dq.PrioritizedReplayBuffer(env.obs_shape, 64, 8)
    mesh = Mesh(np.asarray(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    r = JRunner(env, net, buf, cfg, dq.LinearDecaySchedule(1.0, 0.1, 100),
                gamma=env.discount, mesh=mesh, dcn_sync_every=2)
    c = r.run_populate(r.init_carry(jax.random.PRNGKey(5)), 8)
    for _ in range(n_segments):
        c = r.run_segment(c, 1)
    leaf = np.asarray(jax.tree_util.tree_leaves(c.params)[0])
    return leaf[0, 0], leaf[1, 0]


def test_local_sgd_drift_resync_and_counter():
    """k = 2, segments of one iteration. Drift: after iteration 1 (no
    sync) the two hosts' parameters differ, while the ranks inside a host
    agree. Resync: after iteration 2 every rank agrees. The counter runs
    across segments; the JAX runner counts within a segment, so its
    single-iteration segments never sync (ROADMAP C.5)."""
    out = spawn(ranks.local_sgd_rank, 4, local_world_size=2)
    for refused, _, iters in out:
        assert "2-D" in refused
        assert iters == 2
    (p0, p1), (q0, q1), (r0, r1), (s0, s1) = (o[1] for o in out)
    # ranks 0, 1 are host 0; ranks 2, 3 host 1
    np.testing.assert_array_equal(p0, q0)
    np.testing.assert_array_equal(r0, s0)
    assert not np.allclose(p0, r0, rtol=1e-6, atol=0.0)
    for x in (q1, r1, s1):
        np.testing.assert_array_equal(p1, x)
    a, b = _jax_local_sgd_rows_after(2)
    assert not np.allclose(a, b, rtol=1e-6, atol=0.0)


def test_multihost_helpers_two_hosts():
    """2 hosts x 2 ranks: the mesh shapes, the rank order (ICI-major), the
    shard plan's arithmetic and its refusal of an indivisible env count."""
    out = spawn(ranks.multihost_rank, 4, local_world_size=2)
    for rank, r in enumerate(out):
        assert r["hybrid_shape"] == (2, 2)
        assert r["hybrid_names"] == ("dcn", "ici")
        assert r["hybrid_mesh"] == [[0, 1], [2, 3]]
        assert (r["dcn_coord"], r["ici_coord"]) == divmod(rank, 2)
        assert r["flat_size"] == r["global_size"] == 4
        assert r["flat_mesh"] == [0, 1, 2, 3]
        assert r["plan"] == ShardPlan(
            global_devices=4, local_devices=1, process_index=rank,
            process_count=4, envs_per_device=8, local_envs=8, global_envs=32,
            batch_per_device=8)
        assert "divisible" in r["refused"]
        assert r["info"] == (1, 4, rank)
        assert r["local_world"] == 2


def test_dryrun_multichip_four_ranks():
    line = dryrun_multichip(4)
    assert line.startswith("dryrun_multichip(4): OK")
    assert "hier_loss=nan" not in line
