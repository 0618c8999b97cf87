"""The port's recurrent (DRQN) loop against the JAX package's, end to end,
and the recurrent routing of ``build_loop``.

Both packages run ``build_loop`` with ``recurrence=True``, the recurrent
collect kernel and the fused DRQN update (JAX: Pallas in interpret mode on
the CPU; port: the kernels' plain twins on CPU tensors) from the same
parameters and actor state, copied through ``deepqlearning_tpu_torch.
convert``. The port's uniforms and draws are derived from the JAX key chain
exactly as JAX draws them (collect: ``actor.py`` split -> the kernel's host
uniforms, first 6 rows; sample: ``loop.py`` split -> the episode sample's
three draws). Populate ``max_episode_length + 1`` steps and drop the open
episodes, then 2 iterations (the second crosses a target sync), and compare
every piece of state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.actor import init_actor as j_init_actor  # noqa: E402
from deepqlearning_tpu.learner.loop import LoopCarry as JLoopCarry  # noqa: E402
from deepqlearning_tpu.learner.loop import build_loop as j_build_loop  # noqa: E402
from deepqlearning_tpu.models.chain import LSTM as JLSTM  # noqa: E402
from deepqlearning_tpu.replay.episode import (  # noqa: E402
    EpisodeReplayBuffer as JBuf)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    LoopCarry, build_loop, populate)
from deepqlearning_tpu_torch.ops.cuda import (  # noqa: E402
    fused_collect, fused_drqn)

from test_torch_episode_replay import jax_draws  # noqa: E402

torch.set_num_threads(2)

E, C, B, T, TF, MAXLEN, TUF = 128, 256, 16, 4, 64, 5, 256
N_U8 = 8  # rows of the JAX kernel's host uniforms for SimpleGridWorld
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _cfg(mod, **kw):
    return mod.DQNConfig(num_envs=E, batch_size=B, buffer_size=C,
                         train_freq=TF, trace_length=T,
                         max_episode_length=MAXLEN, target_update_freq=TUF,
                         learning_rate=1e-2, recurrence=True, double_q=True,
                         **kw)


def _jax_side():
    env = dq.SimpleGridWorld()
    net = dq.Chain(JLSTM(2, 8), dq.Dense(8, 4))
    cfg = _cfg(dq, fused_collect=True, fused_updates=True)
    buf = JBuf(env.obs_shape, C, B, T, MAXLEN, num_envs=E)
    it, pop, opt = j_build_loop(env, net, buf, cfg,
                                dq.LinearDecaySchedule(1.0, 0.05, 500),
                                gamma=env.discount)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = net.init(k1)
    carry = JLoopCarry(actor=j_init_actor(env, net, E, k2), replay=buf.init(),
                       params=params, target_params=params,
                       opt_state=opt.init(params), lkey=k3,
                       loss=jnp.asarray(0.0), gnorm=jnp.asarray(0.0),
                       sync_acc=jnp.asarray(0, jnp.int32))
    return buf, it, pop, carry


def _torch_side(jcarry, **kw):
    env = dt.SimpleGridWorld()
    net = dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
    cfg = _cfg(dt, **kw)
    buf = dt.EpisodeReplayBuffer(env.obs_shape, C, B, T, MAXLEN, num_envs=E,
                                 device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.05, 500),
                              gamma=env.discount)
    params = convert.params_from_numpy(net, np_(jcarry.params))
    carry = LoopCarry(
        actor=convert.actor_from_numpy(np_(jcarry.actor)), replay=buf.init(),
        params=params, target_params={k: p.clone() for k, p in params.items()},
        opt_state=opt.init(params), generator=torch.Generator().manual_seed(0),
        loss=torch.zeros(()), gnorm=torch.zeros(()),
        sync_acc=torch.zeros((), dtype=torch.int64),
        iters=torch.zeros((), dtype=torch.int64))
    return net, cfg, buf, it, pop, carry


def _collect_u(key):
    """split(actor.key, 3) -> k_u -> uniform [nu8, E], first 6 rows."""
    _, _, k_u = jax.random.split(key, 3)
    return torch.from_numpy(np.array(
        jax.random.uniform(k_u, (N_U8, E), jnp.float32)[:6]))


def _sample_draws(lkey, jreplay, M, U):
    """``loop.py``: lkey, k = split(lkey); then the draws of the episode
    sample ``sample_n(state, k, U)``."""
    _, k = jax.random.split(lkey)
    return jax_draws(jreplay, k, U * B, M)


def _close(a, b, rtol, atol=0.0, err=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=err)


def test_drqn_slice_matches_jax_loop():
    jbuf, jit_, jpop, jc = _jax_side()
    net, cfg, buf, it, pop, tc = _torch_side(jc)
    U = cfg.updates_per_iter
    assert U == 2 and cfg.steps_per_iter == 1

    jpop, jit_ = jax.jit(jpop), jax.jit(jit_)
    ja, jr = jc.actor, jc.replay
    collect_u = []
    for _ in range(MAXLEN + 1):
        collect_u.append(_collect_u(ja.key))
        (ja, jr, _), _ = jpop((ja, jr, jc.params), None)
    jc = jc._replace(actor=ja, replay=jbuf.reset_in_progress(jr))
    tc = populate(pop, buf, tc, MAXLEN + 1, collect_u)

    for i in range(2):
        u = _collect_u(jc.actor.key)
        lkey = jc.lkey
        jc, _ = jit_(jc, None)
        draws = _sample_draws(lkey, jc.replay, buf.records_per_env, U)
        tc = it(tc, collect_u=[u], sample_u=[draws])

        # tolerances: collect fields, replay rows and actor state are f32
        # elementwise math on identical inputs (1e-6, as
        # tests/test_fused_collect.py); the LSTM state 1e-5 (gate sums in
        # other orders); params/Adam and the loss follow
        # tests/test_fused_drqn.py (rtol 2e-4 / atol 2e-5, loss rtol 1e-4)
        ref = convert.episode_replay_from_numpy(np_(jc.replay))
        _close(tc.replay.data, ref.data, 1e-6, 1e-6, "ring")
        for name in ("ep_start", "ep_len", "rec_count", "cur_len"):
            np.testing.assert_array_equal(getattr(tc.replay, name).numpy(),
                                          getattr(ref, name).numpy(), name)
        assert tc.replay.t.dim() == 0 and tc.replay.t.dtype == torch.int64
        assert int(tc.replay.t) == int(jc.replay.t) == MAXLEN + 2 + i
        ja, ta = jc.actor, tc.actor
        _close(ta.obs, ja.obs, 1e-6, err="obs")
        _close(ta.env_state,
               convert.gridworld_state_from_numpy(ja.env_state.pos,
                                                  ja.env_state.terminal),
               1e-6, err="env state")
        np.testing.assert_array_equal(ta.ep_step.numpy(), np.asarray(ja.ep_step))
        _close(ta.ep_ret, ja.ep_ret, 1e-6, 1e-6, "ep_ret")
        for ours, theirs in zip(ta.net_state[0], ja.net_state[0]):
            _close(ours, theirs, 1e-5, 1e-5, "net_state")
        for name in ("ret_ring", "step_ring", "cnt_ring"):
            _close(getattr(ta, name), getattr(ja, name), 1e-5, 1e-6, name)
        assert int(ta.ep_count) == int(ja.ep_count) > 0
        assert ta.tick == int(ja.tick) and ta.t == int(ja.t)

        for ours, theirs in ((tc.params, jc.params),
                             (tc.target_params, jc.target_params),
                             (tc.opt_state.m, jc.opt_state.m),
                             (tc.opt_state.v, jc.opt_state.v)):
            ref = convert._as_dict(net, np_(theirs), "cpu")
            for k in ref:
                _close(ours[k], ref[k], 2e-4, 2e-5, k)
        assert int(tc.opt_state.count) == int(jc.opt_state.count) == U * (i + 1)
        _close(float(tc.loss), float(jc.loss), 1e-4, err="loss")
        _close(float(tc.gnorm), float(jc.gnorm), 1e-3, 1e-6, "gnorm")
        assert tc.sync_acc == int(jc.sync_acc)
    # the second iteration crossed target_update_freq: target == params
    for k, p in tc.params.items():
        assert torch.equal(tc.target_params[k], p)


def _spy(monkeypatch, module, name, calls):
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(name)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)


@pytest.mark.parametrize("fused,grouped", [(None, True), (None, False),
                                           (False, True), (False, False)])
def test_recurrent_routes(monkeypatch, fused, grouped):
    """Kernel routes (None) reach the K5/K6 twins on CPU tensors, with one
    call of U = 2 sub-updates (grouped) or two calls of U = 1; the plain
    routes (False) never touch them."""
    calls = []
    _spy(monkeypatch, fused_drqn, "fused_drqn_group_update_plain", calls)
    _spy(monkeypatch, fused_collect, "fused_collect_plain", calls)
    env = dt.SimpleGridWorld()
    net = dt.create_dueling_network(
        dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 6, torch.tanh), dt.Dense(6, 4)))
    cfg = _cfg(dt, fused_updates=fused, fused_collect=fused,
               grouped_updates=grouped)
    buf = dt.EpisodeReplayBuffer(env.obs_shape, C, B, T, MAXLEN, num_envs=E,
                                 device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(),
                              env.discount)
    c = dt.init_carry(env, net, buf, cfg, opt, device="cpu")
    p0 = {k: v.clone() for k, v in c.params.items()}
    c = populate(pop, buf, c, MAXLEN + 1)
    assert not c.replay.cur_len.any() and int(c.replay.rec_count.min()) > 0
    c = it(c)
    assert np.isfinite(float(c.loss)) and int(c.opt_state.count) == 2
    assert any(not torch.equal(p0[k], c.params[k]) for k in p0)
    if fused is None:
        assert calls.count("fused_collect_plain") == MAXLEN + 2
        assert calls.count("fused_drqn_group_update_plain") == \
            (1 if grouped else 2)
    else:
        assert calls == []


def test_recurrent_forced_kernels_and_axis_name_raise():
    env = dt.SimpleGridWorld()
    buf = dt.EpisodeReplayBuffer(env.obs_shape, C, B, T, MAXLEN, num_envs=E,
                                 device="cpu")
    sched = dt.LinearDecaySchedule()
    # a cell after a Dense layer: K5 takes it, K6 does not
    pre = dt.Chain(dt.Dense(2, 8, torch.tanh), dt.LSTM(8, 8), dt.Dense(8, 4))
    with pytest.raises(ValueError, match="fused_collect=True"):
        build_loop(env, pre, buf, _cfg(dt, fused_collect=True), sched, 0.95)
    two = dt.Chain(dt.LSTM(2, 8), dt.LSTM(8, 8), dt.Dense(8, 4))
    with pytest.raises(ValueError, match="fused_updates=True"):
        build_loop(env, two, buf, _cfg(dt, fused_updates=True), sched, 0.95)
    sel = dt.epsilon_greedy_select(dt.ConstantEpsilon(0.1))
    with pytest.raises(ValueError, match="fused_collect=True"):
        build_loop(env, dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4)), buf,
                   _cfg(dt, fused_collect=True), sched, 0.95, select_fn=sel)
    # the data axis is a torch.distributed process group, not a name
    with pytest.raises(TypeError, match="axis_name"):
        build_loop(env, pre, buf, _cfg(dt), sched, 0.95, axis_name="data")
    with pytest.raises(ValueError, match="recurrent"):
        build_loop(env, pre, buf, _cfg(dt).replace(recurrence=False), sched,
                   0.95)
    # auto (None) routes around what the kernels cannot take
    build_loop(env, pre, buf, _cfg(dt), sched, 0.95)
    build_loop(env, two, buf, _cfg(dt), sched, 0.95)
