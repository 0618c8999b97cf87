"""The compiled segment's preconditions on the CPU
(``deepqlearning_tpu_torch/learner/segment.py``).

(a) One populate step and two iterations of each route that the segment
captures on the card read nothing back to the host: a dispatch mode
refuses ``aten._local_scalar_dense`` (what ``.item()``, ``bool(t)`` and
``int(t)`` reach) and the ops with data-dependent shapes (``nonzero``,
``masked_select``), which a CUDA graph cannot hold. Each route first runs
one iteration unguarded, as ``make_segment`` warms one up before its
capture.

(b) The carry's device counters against the JAX package's ``build_loop``
carry on the same injected uniforms, over a ring wrap, two target syncs
and the end of the ε schedule: exact for the counters and ε, the slice
test's tolerance for the parameters.

(c) ``run_segment`` and ``make_collect_graph`` on CPU tensors equal the
eager iterations and collect steps bit for bit.

The routes: the feed-forward PER routes (K1-K4's twins), DRQN over the
episode replay (K5 and K6's twins, the plain recurrent steps, bf16) and
envs and problems written one instance at a time (``chip_smoke.
user_envs``, batched by ``torch.func.vmap``).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

import chip_smoke  # noqa: E402
import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.actor import init_actor as j_init_actor  # noqa: E402
from deepqlearning_tpu.learner.loop import LoopCarry as JLoopCarry  # noqa: E402
from deepqlearning_tpu.learner.loop import build_loop as j_build_loop  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.envs.base import Env  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    LoopCarry, build_loop, init_carry, populate)
from deepqlearning_tpu_torch.learner.segment import (  # noqa: E402
    graph_route, make_collect_graph, make_segment)

torch.set_num_threads(2)

HOST_READS = {torch.ops.aten._local_scalar_dense, torch.ops.aten.nonzero,
              torch.ops.aten.masked_select}
# indexing by a bool mask takes its shape from the data (a nonzero inside)
INDEXING = {torch.ops.aten.index, torch.ops.aten.index_put,
            torch.ops.aten.index_put_, torch.ops.aten._index_put_impl_}


class NoHostRead(TorchDispatchMode):
    """Raises on an op that reads the device from the host or makes a
    shape from data."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if func.overloadpacket in HOST_READS or (
                func.overloadpacket in INDEXING and any(
                    torch.is_tensor(i) and i.dtype == torch.bool
                    for i in args[1] if i is not None)):
            raise AssertionError(f"host read inside an iteration: {func}")
        return func(*args, **(kwargs or {}))


def _dueling(no, width, act, A):
    return dt.create_dueling_network(dt.Chain(
        dt.Flatten(), dt.Dense(no, width, act), dt.Dense(width, width, act),
        dt.Dense(width, A)))


GridWorld, StaticArrayMDP, MiniPOMDP = chip_smoke.user_envs()


def _drqn(**kw):
    """DRQN on SimpleGridWorld: ``Chain(LSTM(2, 8), Dense(8, 4))``, 64
    envs, batch 16, trace 4, U = 2 (K5 and K6, their CPU twins, unless
    ``kw`` turn them off)."""
    return (dt.SimpleGridWorld(), dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4)),
            dict(num_envs=64, buffer_size=256, batch_size=16, train_freq=32,
                 trace_length=4, recurrence=True, **kw))


def _route(name):
    """``(env, network, DQNConfig kwargs)`` of a route the segment
    captures, cut to a CPU size."""
    if name == "drqn":          # K6, K5
        return _drqn()
    if name == "drqn_plain":    # plain recurrent collect, U = 2 plain steps
        return _drqn(fused_updates=False, fused_collect=False,
                     grouped_updates=False)
    if name == "drqn_plain_grouped":  # plain collect, the grouped step
        return _drqn(fused_updates=False, fused_collect=False)
    if name == "drqn_bf16":     # bf16 parameters and ring: the plain steps
        return _drqn(dtype=torch.bfloat16)
    if name == "per_instance":  # vmapped GridWorld: plain collect, K2, K3
        return (GridWorld(), _dueling(2, 64, torch.tanh, 4),
                dict(num_envs=64, buffer_size=1 << 10, batch_size=32,
                     train_freq=32))
    if name == "per_instance_mdp":  # vmapped StaticArrayMDP: K2, K1
        return (dt.MDPEnv(StaticArrayMDP()),
                dt.Chain(dt.Dense(1, 32), dt.Dense(32, 2)),
                dict(num_envs=16, buffer_size=256, batch_size=16,
                     train_freq=16))
    if name == "per_instance_pomdp_drqn":  # vmapped MiniPOMDP: K5
        return (dt.POMDPEnv(MiniPOMDP()),
                dt.create_dueling_network(
                    dt.Chain(dt.LSTM(1, 8), dt.Dense(8, 2))),
                dict(num_envs=16, buffer_size=128, batch_size=8,
                     train_freq=16, trace_length=4, recurrence=True))
    if name == "headline":      # K4, K2, K3: the headline's net, E = 256
        return (dt.SimpleGridWorld(), _dueling(2, 64, torch.tanh, 4),
                dict(num_envs=256, buffer_size=1 << 12, batch_size=32,
                     train_freq=64))
    if name == "u1":            # K4, K2, K1 at U = 1
        return (dt.SimpleGridWorld(), _dueling(2, 64, torch.tanh, 4),
                dict(num_envs=64, buffer_size=1 << 10, batch_size=32,
                     train_freq=64))
    if name == "grouped_plain":  # plain collect, K2, K1 x U (K3/K4 refuse)
        return (dt.SimpleGridWorld(), _dueling(2, 160, torch.relu, 4),
                dict(num_envs=64, buffer_size=1 << 10, batch_size=32,
                     train_freq=32))
    if name == "conv_bf16":     # the conv route: bf16 conv net, K2, K1 x U
        env = dt.TestMDP((6, 6), 2, 6, 0.99)
        net = dt.Chain(dt.Conv2D(2, 4, (3, 3), activation=torch.relu),
                       dt.Flatten(), dt.Dense(144, 16, torch.relu),
                       dt.Dense(16, 4))
        return (env, dt.create_dueling_network(net),
                dict(num_envs=32, buffer_size=1 << 9, batch_size=16,
                     train_freq=16, dtype=torch.bfloat16))
    if name == "mountaincar":   # K4 (MountainCar), K2, K3
        return (dt.MountainCar(), _dueling(2, 64, torch.tanh, 3),
                dict(num_envs=64, buffer_size=1 << 10, batch_size=32,
                     train_freq=32))
    assert name == "cartpole"   # K4 (CartPole), K2, K3
    return (dt.CartPole(), _dueling(4, 64, torch.tanh, 2),
            dict(num_envs=64, buffer_size=1 << 10, batch_size=32,
                 train_freq=32))


ROUTES = ("headline", "u1", "grouped_plain", "conv_bf16", "cartpole",
          "mountaincar", "drqn", "drqn_plain", "drqn_plain_grouped",
          "drqn_bf16", "per_instance", "per_instance_mdp",
          "per_instance_pomdp_drqn")
MAXLEN = 5


def _build(name, seed=0):
    env, net, kw = _route(name)
    cfg = dt.DQNConfig(max_episode_length=MAXLEN, target_update_freq=128,
                       learning_rate=1e-3, seed=seed, **kw)
    if cfg.recurrence:
        buf = dt.EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size,
                                     cfg.batch_size, cfg.trace_length,
                                     MAXLEN, num_envs=cfg.num_envs,
                                     obs_dtype=cfg.dtype, device="cpu")
    else:
        buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                         cfg.batch_size, obs_dtype=cfg.dtype,
                                         device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.05, 200),
                              env.discount)
    carry = init_carry(env, net, buf, cfg, opt, device="cpu")
    return env, buf, cfg, it, pop, carry


def _n_pop(cfg):
    """Populate steps before the first iteration: one, or for DRQN enough
    that every env commits an episode (``solve``'s count)."""
    return MAXLEN + 1 if cfg.recurrence else 1


@pytest.mark.parametrize("name", ROUTES)
def test_no_host_read_in_an_iteration(name):
    env, buf, cfg, it, pop, c = _build(name)
    assert graph_route(cfg, env, buf)
    n_pop = _n_pop(cfg)
    c = populate(pop, buf, c, n_pop)
    c = it(c)  # the warm-up make_segment runs before its capture
    with NoHostRead():
        c = populate(pop, buf, c, 1)
        for _ in range(2):
            c = it(c)
    leaves = tree_flatten(c)[0]
    assert all(isinstance(x, (torch.Tensor, torch.Generator))
               for x in leaves)
    steps = n_pop + 1 + 3 * cfg.steps_per_iter
    assert int(c.iters) == 3 and int(c.actor.t) == steps * cfg.num_envs
    assert torch.isfinite(c.loss)
    if cfg.recurrence:
        t = c.replay.t
        assert t.dim() == 0 and t.dtype == torch.int64 and int(t) == steps
        assert int(c.replay.rec_count.min()) > 0
    else:
        assert int(c.replay.size) > 0


def test_the_guard_sees_a_host_read():
    """The dispatch mode does catch what makes a capture fail."""
    x = torch.arange(4)
    with NoHostRead():
        with pytest.raises(AssertionError, match="_local_scalar_dense"):
            int(x.sum())
        with pytest.raises(AssertionError, match="index"):
            x[x > 1]
        with pytest.raises(AssertionError, match="index_put"):
            x[x > 1] = 0


def test_graph_route_gate():
    env, buf, cfg, *_ = _build("headline")
    assert graph_route(cfg, env, buf)
    assert not graph_route(cfg, env, buf, axis_name=object())
    assert not graph_route(dataclasses.replace(cfg, dtype=torch.float16),
                           env, buf)

    class PerInstance(Env):
        num_actions, obs_shape = 2, (1,)

        def reset(self, generator):
            return torch.zeros(()), torch.zeros(1)

        def step(self, state, action, generator):
            return state, torch.zeros(1), torch.zeros(()), torch.zeros(())

    # per-instance envs and problems, batched by vmap, are graph routes
    assert graph_route(cfg, PerInstance(), buf)
    assert graph_route(cfg, dt.MDPEnv(StaticArrayMDP()), buf)
    # a recurrent loop over the episode replay is one; over PER there is
    # no such loop
    ebuf = dt.EpisodeReplayBuffer((2,), 64, 8, 4, 10, num_envs=8,
                                  device="cpu")
    rcfg = dt.DQNConfig(recurrence=True)
    assert graph_route(rcfg, env, ebuf)
    assert graph_route(rcfg.replace(dtype=torch.bfloat16), env, ebuf)
    assert graph_route(rcfg, dt.POMDPEnv(MiniPOMDP()), ebuf)
    assert not graph_route(dataclasses.replace(cfg, recurrence=True), env,
                           buf)
    assert not graph_route(cfg, env, ebuf)
    assert not graph_route(rcfg, env, ebuf, axis_name=object())
    assert not graph_route(rcfg.replace(dtype=torch.float16), env, ebuf)
    # a host env is stepped on the host (solve_host)
    assert not graph_route(cfg, dt.HostEnv(), buf)


# --- (b) the counters against the JAX package -----------------------------
E, C, B, MAXLEN, TUF, EPS_STEPS = 128, 512, 32, 5, 256, 384


def _cfg(mod):
    # U = 4, one collect step of E per iteration: the ring (C = 4·E) wraps
    # in the second iteration after 2 populate steps, a target sync falls
    # on every second iteration, and ε reaches its floor at t = 384
    return mod.DQNConfig(num_envs=E, batch_size=B, buffer_size=C,
                         train_freq=32, max_episode_length=MAXLEN,
                         target_update_freq=TUF, learning_rate=1e-2,
                         double_q=True, dueling=True, prioritized_replay=True,
                         fused_collect=True, fused_updates=True)


def _nets():
    jnet = dq.create_dueling_network(dq.Chain(
        dq.Flatten(), dq.Dense(2, 16, jnp.tanh), dq.Dense(16, 16, jnp.tanh),
        dq.Dense(16, 4)))
    tnet = dt.create_dueling_network(dt.Chain(
        dt.Flatten(), dt.Dense(2, 16, torch.tanh),
        dt.Dense(16, 16, torch.tanh), dt.Dense(16, 4)))
    return jnet, tnet


def _collect_u(key):
    """The JAX fused collect step's uniforms (as ``test_torch_slice``)."""
    _, _, k_u = jax.random.split(key, 3)
    u = jax.random.uniform(k_u, (8, E), jnp.float32)[:6]
    return torch.from_numpy(np.array(u))


def _sample_u(lkey, n):
    _, k = jax.random.split(lkey)
    return torch.from_numpy(np.array(jax.random.uniform(k, (n,))))


def test_counters_match_jax_over_wrap_syncs_and_schedule_end():
    jsched = dq.LinearDecaySchedule(1.0, 0.05, EPS_STEPS)
    tsched = dt.LinearDecaySchedule(1.0, 0.05, EPS_STEPS)
    jenv, tenv = dq.SimpleGridWorld(), dt.SimpleGridWorld()
    jnet, tnet = _nets()
    jbuf = dq.PrioritizedReplayBuffer(jenv.obs_shape, C, B)
    jit_, jpop, jopt = j_build_loop(jenv, jnet, jbuf, _cfg(dq), jsched,
                                    gamma=jenv.discount)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(1), 3)
    params = jnet.init(k1)
    jc = JLoopCarry(actor=j_init_actor(jenv, jnet, E, k2),
                    replay=jbuf.init(), params=params, target_params=params,
                    opt_state=jopt.init(params), lkey=k3,
                    loss=jnp.asarray(0.0), gnorm=jnp.asarray(0.0),
                    sync_acc=jnp.asarray(0, jnp.int32))

    cfg = _cfg(dt)
    tbuf = dt.PrioritizedReplayBuffer(tenv.obs_shape, C, B, device="cpu")
    it, pop, opt = build_loop(tenv, tnet, tbuf, cfg, tsched,
                              gamma=tenv.discount)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tparams = convert.params_from_numpy(tnet, np_(jc.params))
    zero_i = torch.zeros((), dtype=torch.int64)
    tc = LoopCarry(
        actor=convert.actor_from_numpy(np_(jc.actor)), replay=tbuf.init(),
        params=tparams,
        target_params={k: p.clone() for k, p in tparams.items()},
        opt_state=opt.init(tparams), generator=torch.Generator(),
        loss=torch.zeros(()), gnorm=torch.zeros(()), sync_acc=zero_i,
        iters=zero_i.clone())
    U = cfg.updates_per_iter

    jpop, jit_ = jax.jit(jpop), jax.jit(jit_)
    ja, jr = jc.actor, jc.replay
    cc = (tc.actor, tc.replay, tc.params)
    for _ in range(2):
        u = _collect_u(ja.key)
        (ja, jr, _), _ = jpop((ja, jr, jc.params), None)
        cc = pop(cc, None, u)
    jc = jc._replace(actor=ja, replay=jr)
    tc = tc._replace(actor=cc[0], replay=cc[1])

    seen = dict(wrap=False, syncs=0, floor=False)
    for i in range(4):
        u = _collect_u(jc.actor.key)
        su = _sample_u(jc.lkey, U * B)
        jc, _ = jit_(jc, None)
        tc = it(tc, collect_u=[u], sample_u=[su])
        ja, ta = jc.actor, tc.actor
        for ours, theirs in ((ta.t, ja.t), (ta.tick, ja.tick),
                             (tc.replay.insert_pos, jc.replay.insert_pos),
                             (tc.replay.size, jc.replay.size),
                             (tc.sync_acc, jc.sync_acc)):
            assert ours.dim() == 0 and not ours.is_floating_point()
            assert int(ours) == int(theirs)
        assert int(tc.iters) == i + 1
        # ε from the device t, bit for bit
        eps_t, eps_j = tsched(ta.t), jsched(ja.t)
        assert eps_t.dtype == torch.float32 and eps_t.dim() == 0
        assert np.float32(eps_t.item()).tobytes() == \
            np.asarray(eps_j, np.float32).tobytes()
        ref = convert._as_dict(tnet, np_(jc.target_params), "cpu")
        for k in ref:
            np.testing.assert_allclose(tc.target_params[k].numpy(),
                                       ref[k].numpy(), rtol=2e-4, atol=2e-5,
                                       err_msg=k)
        if int(jc.sync_acc) == 0:
            seen["syncs"] += 1
            for k, p in tc.params.items():
                assert torch.equal(tc.target_params[k], p)
        seen["wrap"] |= int(jc.replay.insert_pos) < (2 + i) * E
        seen["floor"] |= int(ja.t) >= EPS_STEPS
    assert seen == dict(wrap=True, syncs=2, floor=True)


# --- (c) run_segment on the CPU is the eager loop ------------------------
def _equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert torch.equal(x, y)


@pytest.mark.parametrize("name", ("headline", "grouped_plain", "drqn",
                                  "drqn_plain", "drqn_plain_grouped",
                                  "drqn_bf16", "per_instance",
                                  "per_instance_mdp",
                                  "per_instance_pomdp_drqn"))
def test_run_segment_on_cpu_is_eager(name):
    env, buf, cfg, it, pop, c1 = _build(name, seed=3)
    _, buf2, _, it2, pop2, c2 = _build(name, seed=3)
    n_pop = _n_pop(cfg) + 1
    c1 = make_collect_graph(pop, c1, cfg, env, buf)(c1, n_pop)
    c2 = populate(pop2, buf2, c2, n_pop)
    _equal(c1, c2)
    if cfg.recurrence:  # populate ends by dropping the open episodes
        assert not c1.replay.cur_len.any()
        assert int(c1.replay.t) == n_pop
    c1 = make_segment(it, c1, cfg, env, buf)(c1, 3)
    for _ in range(3):
        c2 = it2(c2)
    _equal(c1, c2)
    assert int(c1.iters) == 3


@pytest.mark.parametrize("sync", [False, True])
def test_sync_target_selects_on_a_device_bool(sync):
    """The target copy decided on the device, over parameters of two
    dtypes: bit for bit the parameters, or the targets as they were."""
    g = torch.Generator().manual_seed(0)
    params = {"w": torch.randn(3, 4, generator=g),
              "b": torch.randn(4, generator=g).to(torch.bfloat16),
              "v": torch.randn(5, generator=g)}
    target = {k: torch.randn(p.shape, generator=g).to(p.dtype)
              for k, p in params.items()}
    before = {k: t.clone() for k, t in target.items()}
    ptrs = {k: t.data_ptr() for k, t in target.items()}
    from deepqlearning_tpu_torch.learner.train_step import sync_target

    out = sync_target(params, target, torch.tensor(sync))
    for k, t in out.items():
        assert t.data_ptr() == ptrs[k]          # in place
        assert torch.equal(t, params[k] if sync else before[k])
        assert t.dtype == params[k].dtype
