"""K4 (``ops/cuda/fused_collect.py``): its plain twin against the JAX
Pallas ``fused_collect`` (host uniforms, interpret mode) and its
``_collect_block`` body, with the same uniforms."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.ops.pallas.fused_collect import (  # noqa: E402
    _collect_block, _pack8, collect_plan_for as j_collect_plan_for,
    fused_collect as j_fused_collect)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import build_loop  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda import fused_collect  # noqa: E402

torch.set_num_threads(2)
E, MAXLEN = 256, 50


def _nets(dueling, hidden=32):
    jc = dq.Chain(dq.Flatten(), dq.Dense(2, hidden, jnp.tanh),
                  dq.Dense(hidden, hidden, jnp.tanh), dq.Dense(hidden, 4))
    tc = dt.Chain(dt.Flatten(), dt.Dense(2, hidden, torch.tanh),
                  dt.Dense(hidden, hidden, torch.tanh), dt.Dense(hidden, 4))
    if dueling:
        return dq.create_dueling_network(jc), dt.create_dueling_network(tc)
    return jc, tc


def _setup(dueling, seed):
    jenv, tenv = dq.SimpleGridWorld(), dt.SimpleGridWorld()
    jnet, tnet = _nets(dueling)
    jplan = j_collect_plan_for(jenv, jnet, None)
    tplan = fused_collect.collect_plan_for(tenv, tnet, None)
    assert jplan is not None and tplan is not None
    key = jax.random.PRNGKey(seed)
    jparams = jnet.init(key)
    params = convert.params_from_numpy(
        tnet, jax.tree_util.tree_map(np.asarray, jparams))
    st, obs = jenv.reset_batch(key, E)
    rng = np.random.default_rng(seed)
    # some envs already terminal, varied episode clocks (truncation at 50)
    term = rng.random(E) < 0.1
    st = st._replace(terminal=jnp.asarray(term))
    obs = jnp.where(term[:, None], -1.0, obs)
    ep_step = rng.integers(0, MAXLEN, E).astype(np.float32)
    ep_ret = rng.normal(size=E).astype(np.float32)
    return (jenv, jnet, jplan, jparams, st, obs, ep_step, ep_ret,
            tenv, tplan, params)


@pytest.mark.parametrize("dueling,eps", [(True, 0.3), (False, 0.3),
                                         (True, 1.0), (True, 0.0)])
def test_twin_matches_pallas_kernel_and_block(dueling, eps):
    (jenv, jnet, jplan, jparams, st, obs, ep_step, ep_ret,
     tenv, tplan, params) = _setup(dueling, 3)
    obs_t = jnp.pad(obs.T, ((0, jplan.no8 - jplan.no), (0, 0)))
    cols = jnp.pad(jenv.state_to_cols(st), ((0, jplan.W8 - jplan.W), (0, 0)))
    k_u = jax.random.PRNGKey(7)
    jf, jobs, jcols, jstep, jret, jtot = j_fused_collect(
        jenv, jnet, jplan, jparams, obs=obs_t, cols=cols,
        ep_step=jnp.asarray(ep_step)[None], ep_ret=jnp.asarray(ep_ret)[None],
        seeds=jnp.zeros((1, 2), jnp.int32), eps=eps,
        max_episode_length=MAXLEN, host_key=k_u, interpret=True)
    u = jax.random.uniform(k_u, (jplan.nu8, E), jnp.float32)
    p_list = _pack8(jnet, jparams, jplan)
    ref = _collect_block(jplan, jenv, MAXLEN, lambda k: p_list[k],
                         jnp.float32(eps), u, obs_t, cols,
                         jnp.asarray(ep_step)[None], jnp.asarray(ep_ret)[None])

    out = fused_collect.fused_collect(
        tenv, tplan, params, obs=torch.tensor(np.array(obs)),
        state=convert.gridworld_state_from_numpy(st.pos, st.terminal),
        ep_step=torch.tensor(ep_step).to(torch.int32),
        ep_ret=torch.tensor(ep_ret), u=torch.tensor(np.array(u[:6])),
        eps=eps, max_episode_length=MAXLEN)
    fields, obs_n, state_n, step_n, ret_n, totals = (x.numpy() for x in out)
    # elementwise f32 env math on identical inputs: 1e-6, as
    # tests/test_fused_collect.py; totals sum E terms in another order (1e-5)
    for jfields in (jf, ref["fields"]):
        np.testing.assert_allclose(fields, np.asarray(jfields).T, rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(obs_n, np.asarray(jobs[:2]).T, rtol=1e-6)
    np.testing.assert_allclose(state_n, np.asarray(jcols[:3]).T, rtol=1e-6)
    np.testing.assert_array_equal(step_n, np.asarray(jstep[0]))
    np.testing.assert_allclose(ret_n, np.asarray(jret[0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(totals, np.asarray(jtot), rtol=1e-5,
                               atol=1e-5)
    assert fields[:, 7].sum() > 0  # some episodes ended (done or truncated)


def test_greedy_actions_match_network_apply():
    (jenv, jnet, _, jparams, st, obs, ep_step, ep_ret,
     tenv, tplan, params) = _setup(True, 5)
    u = torch.rand(6, E, generator=torch.Generator().manual_seed(1))
    out = fused_collect.fused_collect(
        tenv, tplan, params, obs=torch.tensor(np.array(obs)),
        state=convert.gridworld_state_from_numpy(st.pos, st.terminal),
        ep_step=torch.zeros(E, dtype=torch.int32), ep_ret=torch.zeros(E),
        u=u, eps=0.0, max_episode_length=MAXLEN)
    q, _ = jnet.apply(jparams, obs)
    np.testing.assert_array_equal(out[0][:, 4].numpy(),
                                  np.asarray(jnp.argmax(q, axis=-1)))


def test_collect_plan_gate():
    env = dt.SimpleGridWorld()
    _, net = _nets(True)
    assert fused_collect.collect_plan_for(env, net, None) is not None
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 1024, 32, device="cpu")
    assert fused_collect.collect_plan_for(env, net, buf) is not None
    # wider than the kernel's per-thread activations
    assert fused_collect.collect_plan_for(env, _nets(True, 256)[1],
                                          None) is None
    assert fused_collect.collect_plan_for("not an env", net, None) is None
    assert fused_collect.collect_plan_for(
        env, dt.Chain(dt.Dense(3, 4)), None) is None  # obs width


def test_fused_collect_true_that_cannot_be_honoured_raises():
    env = dt.SimpleGridWorld()
    _, net = _nets(True)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 1024, 32, device="cpu")
    cfg = dt.DQNConfig(num_envs=128, train_freq=128, batch_size=32,
                       buffer_size=1024, fused_collect=True)
    sel = dt.epsilon_greedy_select(dt.ConstantEpsilon(0.1))
    with pytest.raises(ValueError, match="fused_collect=True"):
        build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(), 0.95,
                   select_fn=sel)
    with pytest.raises(ValueError, match="fused_collect=True"):
        build_loop(env, dt.Chain(dt.Dense(2, 4, torch.sin)), buf, cfg,
                   dt.LinearDecaySchedule(), 0.95)
    # auto (None) takes the plain keyed collect step instead
    build_loop(env, net, buf, cfg.replace(fused_collect=None),
               dt.LinearDecaySchedule(), 0.95, select_fn=sel)


def test_bad_uniforms_raise_value_error():
    (_, _, _, _, st, obs, _, _, tenv, tplan, params) = _setup(True, 0)
    with pytest.raises(ValueError, match="uniforms"):
        fused_collect.fused_collect(
            tenv, tplan, params, obs=torch.tensor(np.array(obs)),
            state=convert.gridworld_state_from_numpy(st.pos, st.terminal),
            ep_step=torch.zeros(E, dtype=torch.int32), ep_ret=torch.zeros(E),
            u=torch.rand(6, E - 1), eps=0.1, max_episode_length=MAXLEN)


def test_plain_keyed_collect_loop_runs():
    """The plain keyed collect step (custom select_fn) drives the loop."""
    env = dt.SimpleGridWorld()
    _, net = _nets(True)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 1024, 32, device="cpu")
    cfg = dt.DQNConfig(num_envs=128, train_freq=128, batch_size=32,
                       buffer_size=1024, max_episode_length=10)
    sel = dt.epsilon_greedy_select(dt.ConstantEpsilon(0.1))
    it, pop, opt = build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(),
                              0.95, select_fn=sel)
    c = dt.init_carry(env, net, buf, cfg, opt, device="cpu")
    cc = pop((c.actor, c.replay, c.params), c.generator)
    c = it(c._replace(actor=cc[0], replay=cc[1]))
    assert c.replay.size == 256 and c.actor.t == 256
    assert np.isfinite(float(c.loss))
    o = c.actor.obs.numpy()
    assert ((o >= 1) & (o <= 10)).all()


@pytest.mark.parametrize("u_dir,u_other", [(0.0, 0.0), (0.99, 0.05),
                                           (0.99, 0.4), (0.99, 0.9)])
def test_gridworld_step_and_reset_match_jax(u_dir, u_other):
    """SimpleGridWorld dynamics, every cell x action x terminal flag, against
    the JAX cols protocol (exact: the same f32 elementwise math)."""
    jenv, tenv = dq.SimpleGridWorld(), dt.SimpleGridWorld()
    xs, ys = np.meshgrid(np.arange(1, 11), np.arange(1, 11))
    pos = np.stack([xs.ravel(), ys.ravel()]).astype(np.float32)
    for term in (0.0, 1.0):
        cols = np.concatenate([pos, np.full((1, 100), term, np.float32)])
        for a in range(4):
            act = np.full((1, 100), float(a), np.float32)
            u = np.stack([np.full(100, u_dir), np.full(100, u_other)]
                         ).astype(np.float32)
            jc, jo, jr, jd = jenv.step_cols(jnp.asarray(cols),
                                            jnp.asarray(act), jnp.asarray(u))
            tc, to, tr, td = tenv.step_cols(torch.tensor(cols.T),
                                            torch.tensor(act[0]),
                                            torch.tensor(u))
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).T)
            np.testing.assert_array_equal(to.numpy(), np.asarray(jo).T)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr)[0])
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[0])
    u = np.random.default_rng(0).random((2, 512)).astype(np.float32)
    jc, jo = jenv.reset_cols(jnp.asarray(u))
    tc, to = tenv.reset_cols(torch.tensor(u))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).T)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo).T)


def test_avg_recent_matches_jax():
    from deepqlearning_tpu.learner.actor import avg_recent as javg
    from deepqlearning_tpu_torch.learner.actor import RETURN_RING, avg_recent

    rng = np.random.default_rng(1)
    ret = rng.normal(size=RETURN_RING).astype(np.float32)
    cnt = rng.integers(0, 3, RETURN_RING).astype(np.float32)
    np.testing.assert_allclose(
        float(avg_recent(torch.tensor(ret), torch.tensor(cnt))),
        float(javg(jnp.asarray(ret), jnp.asarray(cnt))), rtol=1e-5)
    assert float(avg_recent(torch.zeros(4), torch.zeros(4))) == 0.0


def _k4_nets():
    """The headline head, a plain chain, and a net at the edge of the
    gates: 128 wide, ~37.7K parameters (``plan_for``'s 200 KB under the
    replaced K3 design)."""
    wide = dt.Chain(dt.Flatten(), dt.Dense(2, 128, torch.tanh),
                    dt.Dense(128, 128, torch.tanh),
                    dt.Dense(128, 128, torch.tanh),
                    dt.Dense(128, 32, torch.tanh), dt.Dense(32, 4))
    return {"headline": (_nets(True, 64)[1], 128),
            "plain": (_nets(False, 32)[1], 128), "widest": (wide, 64)}


@pytest.mark.parametrize("name", ["headline", "plain", "widest"])
def test_k4_tile_fits_every_net_the_gate_takes(name):
    net, tile = _k4_nets()[name]
    plan = fused_collect.collect_plan_for(dt.SimpleGridWorld(), net, None)
    assert plan is not None and plan.cell is None
    assert plan.tile == tile == fused_collect.k4_tile(plan.net)
    assert fused_collect.k4_smem_bytes(plan.net, tile) <= \
        fused_collect.K4_MAX_SMEM
    if tile < fused_collect.K4_TILES[0]:
        bigger = fused_collect.K4_TILES[fused_collect.K4_TILES.index(tile) - 1]
        assert fused_collect.k4_smem_bytes(plan.net, bigger) > \
            fused_collect.K4_MAX_SMEM


def test_k4_smem_bytes_follows_the_tile_layout():
    net, _ = _k4_nets()["headline"]
    plan = fused_collect.collect_plan_for(dt.SimpleGridWorld(), net, None)
    # W and b of each layer on 16-byte boundaries: the value head's 1-float
    # bias pads 3 floats
    assert fused_collect.k4_smem_params(plan.net) == 9029 + 3
    # params + 128 envs x (2 inputs + two 64-wide buffers + the value) +
    # 3 accumulators per thread
    assert fused_collect.k4_smem_bytes(plan.net, 128) == \
        4 * (9032 + 131 * 128 + 3 * 256) == 106272
    # the recurrent plan takes K6's tile (K6_TILES, its own layout)
    lstm = dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
    rplan = fused_collect.collect_plan_for(dt.SimpleGridWorld(), lstm, None)
    assert rplan is not None and rplan.tile == 32 == fused_collect.k6_tile(
        rplan.net, rplan.cell)
