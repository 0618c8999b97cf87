"""The port's data-parallel runner against the JAX package's, two ranks.

JAX: ``DataParallelRunner(mesh=make_mesh(2))`` on two of the 8 virtual CPU
devices, its collect kernel and fused updates in interpret mode under
``shard_map``. Port: two spawned gloo CPU ranks
(``parallel/launch.py::spawn``) running ``torch_dp_ranks.py``, which
imports no JAX. The inputs travel by a file in ``tmp_path``: each rank's
shard of the JAX carry after ``init_carry`` (``convert.
loop_carry_from_numpy``) and the uniforms / episode draws derived from that
shard's ``actor.key`` and ``lkey`` exactly as JAX draws them (as
test_torch_slice.py and test_torch_drqn_slice.py do for one device).
Populate, then 2 iterations (the second crosses a target sync); after each
iteration every shard's params, target, Adam state, loss, gnorm and replay
are compared, and the ranks' params must be equal bit for bit.

Routes: the fused grouped step (kernel K7's twin), the plain grouped and
the ungrouped (K1) steps, and the fused DRQN step (K8's twin).
Tolerances as the one-device slices: params/target/m/v rtol 2e-4 / atol
2e-5, loss rtol 1e-4, gnorm rtol 1e-3, replay rows and episode rings 1e-6
(elementwise f32 on identical inputs), tree leaves rtol 2e-3 / atol 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
from deepqlearning_tpu.parallel.mesh import (  # noqa: E402
    DataParallelRunner as JRunner, make_mesh as j_make_mesh)
from deepqlearning_tpu.models.chain import LSTM as JLSTM  # noqa: E402
from deepqlearning_tpu.replay.episode import (  # noqa: E402
    EpisodeReplayBuffer as JBuf)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.parallel.launch import spawn  # noqa: E402

import torch_dp_ranks as ranks  # noqa: E402
from test_torch_episode_replay import jax_draws  # noqa: E402

torch.set_num_threads(2)
D = 2
N_U8 = 8  # rows of the JAX collect kernel's host uniforms for GridWorld
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _jax_runner(kind, route):
    env = dq.SimpleGridWorld()
    if kind == "drqn":
        net = dq.Chain(JLSTM(2, 8), dq.Dense(8, 4))
        cfg = ranks.drqn_cfg(dq)
        buf = JBuf(env.obs_shape, cfg.buffer_size, cfg.batch_size,
                   cfg.trace_length, cfg.max_episode_length,
                   num_envs=cfg.num_envs)
    else:
        net = dq.create_dueling_network(dq.Chain(
            dq.Flatten(), dq.Dense(2, 16, jnp.tanh),
            dq.Dense(16, 16, jnp.tanh), dq.Dense(16, 4)))
        cfg = ranks.ff_cfg(dq, route)
        buf = dq.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                         cfg.batch_size)
    runner = JRunner(env, net, buf, cfg, dq.LinearDecaySchedule(*ranks.EPS),
                     gamma=env.discount, mesh=j_make_mesh(D))
    return runner, cfg


def _collect_u(carry, E):
    """Per shard: split(actor.key, 3) -> k_u -> uniform [8, E], rows :6."""
    return [torch.from_numpy(np.array(jax.random.uniform(
        jax.random.split(carry.actor.key[d], 3)[2], (N_U8, E),
        jnp.float32)[:6])) for d in range(D)]


def _sample_u(kind, carry, cfg, M=None):
    """Per shard: ``loop.py``: lkey, k = split(lkey); then the sample's
    draws from k (PER uniforms, or the episode sample's draws on the
    shard's replay after this iteration's collect)."""
    out = []
    for d in range(D):
        k = jax.random.split(carry.lkey[d])[1]
        n = cfg.batch_size * (cfg.updates_per_iter
                              if cfg.grouped_updates else 1)
        if kind == "drqn":
            rep = jax.tree_util.tree_map(lambda x: x[d], carry.replay)
            out.append(jax_draws(rep, k, n, M))
        else:
            out.append(torch.from_numpy(np.array(jax.random.uniform(k, (n,)))))
    return out


def _close(a, b, rtol, atol=0.0, err=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=err)


def _compare(kind, tnet, snap, jc, d, i, U):
    c = np_(jax.tree_util.tree_map(lambda x: x[d], jc))
    for name, tree in (("params", c.params), ("target", c.target_params)):
        for k, t in convert._as_dict(tnet, tree, "cpu").items():
            _close(snap[f"{name}/{k}"], t, 2e-4, 2e-5, f"{name} {k} {d}")
    adam = convert.adam_from_optax(c.params, c.opt_state)
    for name in ("m", "v"):
        for k, t in getattr(adam, name).items():
            _close(snap[f"{name}/{k}"], t, 2e-4, 2e-5, f"{name} {k} {d}")
    assert snap["count"] == int(adam.count) == U * (i + 1)
    _close(snap["loss"], c.loss, 1e-4, err=f"loss {d}")
    _close(snap["gnorm"], c.gnorm, 1e-3, 1e-6, f"gnorm {d}")
    assert snap["sync_acc"] == int(c.sync_acc)
    _close(snap["obs"], c.actor.obs, 1e-6, err="obs")
    np.testing.assert_array_equal(snap["ep_step"], c.actor.ep_step)
    if kind == "drqn":
        ref = convert.episode_replay_from_numpy(c.replay)
        _close(snap["data"], ref.data, 1e-6, 1e-6, "ring")
        for name in ("ep_start", "ep_len", "rec_count", "cur_len"):
            np.testing.assert_array_equal(snap[name],
                                          getattr(ref, name).numpy(), name)
    else:
        _close(snap["rows"], c.replay.rows, 1e-6, 1e-6, "replay rows")
        assert snap["size"] == int(c.replay.size)
        _close(snap["leaves"], c.replay.tree[0], 2e-3, 1e-5, "leaves")


def _run(tmp_path, kind, route):
    jr, cfg = _jax_runner(kind, route)
    _, tnet, _, tbuf = ranks._setup(kind, route)
    E, U = cfg.num_envs, (cfg.updates_per_iter if cfg.grouped_updates
                          else 1)
    jc = jr.init_carry(jax.random.PRNGKey(0))
    carries = [convert.loop_carry_from_numpy(tnet, np_(jc), index=d)
               ._replace(generator=None) for d in range(D)]
    n_pop = cfg.max_episode_length + 1 if kind == "drqn" else 2
    pop_u = []
    for _ in range(n_pop):
        pop_u.append(_collect_u(jc, E))
        jc = jr.run_populate(jc, 1)
    it_u, sample_u, jcs = [], [], []
    for _ in range(2):
        it_u.append(_collect_u(jc, E))
        prev, jc = jc, jr.run_segment(jc, 1)
        # the key before the iteration; the episode draws read the replay
        # after its collect step
        sample_u.append(_sample_u(kind, prev._replace(replay=jc.replay), cfg,
                                  getattr(tbuf, "records_per_env", None)))
        jcs.append(jc)
    path = tmp_path / "inputs.pt"
    torch.save(dict(kind=kind, route=route, carries=carries, pop_u=pop_u,
                    it_u=it_u, sample_u=sample_u), path)
    snaps = spawn(ranks.slice_rank, D, str(path))
    for i in range(2):
        for k in snaps[0][i]:
            if k.startswith("params/"):
                assert np.array_equal(snaps[0][i][k], snaps[1][i][k]), k
        for d in range(D):
            _compare(kind, tnet, snaps[d][i], jcs[i], d, i, U)
    # the ranks learned from different data
    assert not np.array_equal(snaps[0][1]["obs"], snaps[1][1]["obs"])
    # the second iteration crossed target_update_freq: target == params
    for k in snaps[0][1]:
        if k.startswith("params/"):
            assert np.array_equal(snaps[0][1][k],
                                  snaps[0][1]["target/" + k[7:]])


@pytest.mark.parametrize("route", ["fused", "plain", "ungrouped"])
def test_feed_forward_dp_matches_jax_runner(tmp_path, route):
    """fused: grouped, K7 (U = 4); plain: grouped, autograd; ungrouped:
    one update per iteration with K1's loss head."""
    _run(tmp_path, "ff", route)


def test_drqn_dp_matches_jax_runner(tmp_path):
    """The fused recurrent route (K8, U = 2) with the recurrent collect."""
    _run(tmp_path, "drqn", None)


@pytest.fixture
def world_of_one():
    """A one-rank gloo process group in this process; its WORLD group is
    the data axis."""
    import torch.distributed as dist

    from deepqlearning_tpu_torch.parallel.launch import free_port

    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    yield dist.group.WORLD
    dist.destroy_process_group()


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("recurrent,fused,grouped,factory,kernel", [
    (False, None, True, "make_fused_dp_train_step", "fused_grads_plain"),
    (False, False, True, "make_grouped_dqn_train_step", None),
    (False, None, False, "make_dqn_train_step", "td_loss_plain"),
    (True, None, True, "make_fused_dp_drqn_train_step",
     "fused_drqn_grads_plain"),
    (True, False, True, "make_grouped_drqn_train_step", None),
])
def test_build_loop_routes_under_axis(world_of_one, monkeypatch, recurrent,
                                      fused, grouped, factory, kernel):
    """Under an axis, K7 (grouped feed-forward) and K8 (recurrent) replace
    the whole-phase kernels K3/K5, which never run; the plain steps average
    over the axis. Every sub-update issues one ``pmean_flat``, even over a
    group of one rank."""
    import deepqlearning_tpu_torch as dt
    from deepqlearning_tpu_torch.learner import loop
    from deepqlearning_tpu_torch.ops.cuda import (
        fused_drqn, fused_update, td_kernel)
    from deepqlearning_tpu_torch.utils import profiling

    calls = []
    _spy(monkeypatch, loop, factory, calls)
    for mod, name in ((fused_update, "fused_group_update_plain"),
                      (fused_drqn, "fused_drqn_group_update_plain"),
                      (fused_update, "fused_grads_plain"),
                      (fused_drqn, "fused_drqn_grads_plain"),
                      (td_kernel, "td_loss_plain")):
        _spy(monkeypatch, mod, name, calls)
    env = dt.SimpleGridWorld()
    kw = dict(num_envs=128, batch_size=8, fused_updates=fused,
              grouped_updates=grouped, max_episode_length=5)
    if recurrent:
        net = dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
        cfg = dt.DQNConfig(train_freq=64, buffer_size=256, trace_length=4,
                           recurrence=True, **kw)
        buf = dt.EpisodeReplayBuffer(env.obs_shape, 256, 8, 4, 5,
                                     num_envs=128, device="cpu")
    else:
        net = dt.create_dueling_network(dt.Chain(
            dt.Flatten(), dt.Dense(2, 8, torch.tanh), dt.Dense(8, 4)))
        cfg = dt.DQNConfig(train_freq=64, buffer_size=512, **kw)
        buf = dt.PrioritizedReplayBuffer(env.obs_shape, 512, 8, device="cpu")
    it, pop, opt = loop.build_loop(env, net, buf, cfg,
                                   dt.LinearDecaySchedule(), env.discount,
                                   axis_name=world_of_one)
    c = loop.populate(pop, buf, loop.init_carry(env, net, buf, cfg, opt,
                                                device="cpu"), 6)
    calls.clear()
    n0 = profiling.counter("train.pmean_flat")
    c = it(c)
    assert torch.isfinite(c.loss) and int(c.opt_state.count) == 2
    assert profiling.counter("train.pmean_flat") - n0 == 2  # U = 2 sub-updates
    assert "fused_group_update_plain" not in calls
    assert "fused_drqn_group_update_plain" not in calls
    if kernel is not None:
        assert calls.count(kernel) == 2


def test_axis_name_must_be_process_groups(world_of_one):
    import deepqlearning_tpu_torch as dt
    from deepqlearning_tpu_torch.learner.loop import build_loop
    from deepqlearning_tpu_torch.learner.train_step import pmean_flat

    env = dt.SimpleGridWorld()
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 512, 8, device="cpu")
    cfg = dt.DQNConfig(num_envs=128, train_freq=64, batch_size=8,
                       buffer_size=512)
    net = dt.Chain(dt.Dense(2, 8, torch.sin), dt.Dense(8, 4))
    sched = dt.LinearDecaySchedule()
    for bad in ("data", (), (world_of_one, "ici")):
        with pytest.raises(TypeError, match="axis_name"):
            build_loop(env, net, buf, cfg, sched, 0.95, axis_name=bad)
    with pytest.raises(ValueError, match="fused_updates=True"):
        build_loop(env, net, buf, cfg.replace(fused_updates=True), sched,
                   0.95, axis_name=world_of_one)
    # pmean_flat: a dict comes back as new tensors, a flat vector in place,
    # and a tuple of groups divides by the product of their sizes
    g = {"a": torch.arange(6.0).reshape(2, 3), "b": torch.ones(2)}
    out = pmean_flat(g, (world_of_one, world_of_one))
    assert out.keys() == g.keys() and out["a"].shape == (2, 3)
    assert torch.equal(out["a"], g["a"]) and out["a"] is not g["a"]
    flat = torch.arange(4.0)
    assert pmean_flat(flat, world_of_one) is flat
