"""K6 (``ops/cuda/fused_collect.py``, recurrent plan): its plain twin
against the JAX Pallas ``fused_collect`` with an LSTM/GRU cell plan
(host uniforms, interpret mode) and its ``_collect_block`` body, with the
same uniforms and state; and the actor's recurrent state handling.

Tolerances: fields, obs, env state at 1e-6 (the same f32 elementwise env
math, as tests/test_fused_collect.py); the new cell state at rtol/atol 1e-5
(gate sums in other orders); episode totals at 1e-5.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.models.chain import GRU as JGRU, LSTM as JLSTM  # noqa: E402
from deepqlearning_tpu.models.dueling import DuelingNetwork as JDuel  # noqa: E402
from deepqlearning_tpu.ops.pallas.fused_collect import (  # noqa: E402
    _collect_block, _pack8, collect_plan_for as j_collect_plan_for,
    fused_collect as j_fused_collect)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner.actor import (  # noqa: E402
    init_actor, make_collect_step, make_fused_collect_step)
from deepqlearning_tpu_torch.ops.cuda import (  # noqa: E402
    fused_collect, fused_drqn)
from deepqlearning_tpu_torch.ops.cuda.fused_update import (  # noqa: E402
    q_values)

torch.set_num_threads(2)
E, MAXLEN = 256, 50


def _nets(kind):
    if kind == "lstm":
        return (dq.Chain(JLSTM(2, 32), dq.Dense(32, 4)),
                dt.Chain(dt.LSTM(2, 32), dt.Dense(32, 4)))
    if kind == "gru":
        return (dq.Chain(JGRU(2, 16), dq.Dense(16, 32, jnp.tanh),
                         dq.Dense(32, 4)),
                dt.Chain(dt.GRU(2, 16), dt.Dense(16, 32, torch.tanh),
                         dt.Dense(32, 4)))
    # a dueling net whose base is exactly the cell (test_fused_collect.py:473)
    return (JDuel(dq.Chain(JLSTM(2, 16)),
                  dq.Chain(dq.Dense(16, 32, jnp.tanh), dq.Dense(32, 1)),
                  dq.Chain(dq.Dense(16, 32, jnp.tanh), dq.Dense(32, 4))),
            dt.DuelingNetwork(dt.Chain(dt.LSTM(2, 16)),
                              dt.Chain(dt.Dense(16, 32, torch.tanh),
                                       dt.Dense(32, 1)),
                              dt.Chain(dt.Dense(16, 32, torch.tanh),
                                       dt.Dense(32, 4))))


@pytest.mark.parametrize("kind,eps", [("lstm", 0.3), ("gru", 0.3),
                                      ("dueling_lstm", 0.3), ("lstm", 0.0)])
def test_twin_matches_pallas_kernel_and_block(kind, eps):
    jenv, tenv = dq.SimpleGridWorld(), dt.SimpleGridWorld()
    jnet, tnet = _nets(kind)
    jplan = j_collect_plan_for(jenv, jnet, None)
    tplan = fused_collect.collect_plan_for(tenv, tnet, None)
    assert jplan.cell is not None and tplan.cell is not None
    assert tplan.cell.kind == jplan.cell.kind
    key = jax.random.PRNGKey(0)
    jparams = jnet.init(key)
    params = convert.params_from_numpy(
        tnet, jax.tree_util.tree_map(np.asarray, jparams))
    st, obs = jenv.reset_batch(key, E)
    rng = np.random.default_rng(1)
    term = rng.random(E) < 0.1
    st = st._replace(terminal=jnp.asarray(term))
    obs = jnp.where(term[:, None], -1.0, obs)
    ep_step = rng.integers(0, MAXLEN, E).astype(np.float32)
    ep_ret = rng.normal(size=E).astype(np.float32)
    ns0 = (rng.normal(size=(jplan.cell.srows, E)) * 0.3).astype(np.float32)
    obs_t = jnp.pad(obs.T, ((0, jplan.no8 - jplan.no), (0, 0)))
    cols = jnp.pad(jenv.state_to_cols(st), ((0, jplan.W8 - jplan.W), (0, 0)))
    k_u = jax.random.PRNGKey(42)
    jf, jobs, jcols, jstep, jret, jtot, jns = j_fused_collect(
        jenv, jnet, jplan, jparams, obs=obs_t, cols=cols,
        ep_step=jnp.asarray(ep_step)[None], ep_ret=jnp.asarray(ep_ret)[None],
        seeds=jnp.zeros((1, 2), jnp.int32), eps=eps,
        max_episode_length=MAXLEN, nstate=jnp.asarray(ns0), host_key=k_u,
        interpret=True)
    u = jax.random.uniform(k_u, (jplan.nu8, E), jnp.float32)
    p_list = _pack8(jnet, jparams, jplan)
    ref = _collect_block(jplan, jenv, MAXLEN, lambda k: p_list[k],
                         jnp.float32(eps), u, obs_t, cols,
                         jnp.asarray(ep_step)[None], jnp.asarray(ep_ret)[None],
                         nstate=jnp.asarray(ns0))

    out = fused_collect.fused_collect(
        tenv, tplan, params, obs=torch.tensor(np.array(obs)),
        state=convert.gridworld_state_from_numpy(st.pos, st.terminal),
        ep_step=torch.tensor(ep_step).to(torch.int32),
        ep_ret=torch.tensor(ep_ret), u=torch.tensor(np.array(u[:6])),
        eps=eps, max_episode_length=MAXLEN, nstate=torch.tensor(ns0.T.copy()))
    fields, obs_n, state_n, step_n, ret_n, totals, ns_n = (
        x.numpy() for x in out)
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
    for jn in (jns, ref["nstate_new"]):
        np.testing.assert_allclose(ns_n, np.asarray(jn).T, rtol=1e-5,
                                   atol=1e-5)
    # K6's tile-order reference against the same JAX outputs
    tiled = fused_collect.fused_collect_rnn_tiled(
        tenv, tplan, params, obs=torch.tensor(np.array(obs)),
        state=convert.gridworld_state_from_numpy(st.pos, st.terminal),
        ep_step=torch.tensor(ep_step).to(torch.int32),
        ep_ret=torch.tensor(ep_ret), u=torch.tensor(np.array(u[:6])),
        eps=eps, max_episode_length=MAXLEN, nstate=torch.tensor(ns0.T.copy()))
    np.testing.assert_allclose(tiled[0].numpy(), np.asarray(jf).T,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tiled[5].numpy(), np.asarray(jtot), rtol=1e-5,
                               atol=1e-5)
    np.testing.assert_allclose(tiled[6].numpy(), np.asarray(jns).T,
                               rtol=1e-5, atol=1e-5)
    # the state is zeroed exactly where the episode ended, and only there
    ended = fields[:, 7] > 0.5
    assert ended.any() and (ns_n[ended] == 0).all()
    assert (np.abs(ns_n[~ended]).sum(axis=1) > 0).all()


def test_greedy_actions_match_network_apply():
    jenv, tenv = dq.SimpleGridWorld(), dt.SimpleGridWorld()
    jnet, tnet = _nets("gru")
    jparams = jnet.init(jax.random.PRNGKey(5))
    params = convert.params_from_numpy(
        tnet, jax.tree_util.tree_map(np.asarray, jparams))
    st, obs = jenv.reset_batch(jax.random.PRNGKey(6), E)
    h = np.random.default_rng(2).normal(size=(E, 16)).astype(np.float32)
    out = fused_collect.fused_collect(
        tenv, fused_collect.collect_plan_for(tenv, tnet, None), params,
        obs=torch.tensor(np.array(obs)),
        state=convert.gridworld_state_from_numpy(st.pos, st.terminal),
        ep_step=torch.zeros(E, dtype=torch.int32), ep_ret=torch.zeros(E),
        u=torch.rand(6, E, generator=torch.Generator().manual_seed(1)),
        eps=0.0, max_episode_length=MAXLEN, nstate=torch.tensor(h))
    q, _ = jnet.apply(jparams, obs, ((jnp.asarray(h),), (), ()))
    np.testing.assert_array_equal(out[0][:, 4].numpy(),
                                  np.asarray(jnp.argmax(q, axis=-1)))


def test_recurrent_collect_plan_gate():
    env = dt.SimpleGridWorld()
    ok = [_nets(k)[1] for k in ("lstm", "gru", "dueling_lstm")]
    for net in ok:
        assert fused_collect.collect_plan_for(env, net, None) is not None
    buf = dt.EpisodeReplayBuffer(env.obs_shape, 64, 8, 4, 10, num_envs=16,
                                 device="cpu")
    assert fused_collect.collect_plan_for(env, ok[0], buf) is not None
    refused = [
        dt.Chain(dt.Dense(2, 8), dt.LSTM(8, 8), dt.Dense(8, 4)),  # pre-cell
        dt.Chain(dt.LSTM(2, 8), dt.LSTM(8, 8), dt.Dense(8, 4)),   # two cells
        dt.Chain(dt.LSTM(2, 8)),                                  # no head
        dt.Chain(dt.LSTM(2, 200), dt.Dense(200, 4)),      # shared memory
        dt.Chain(dt.LSTM(3, 8), dt.Dense(8, 4)),                  # obs width
        # the cell's and the head's parameters together overflow shared
        # memory (the JAX plan has no such budget)
        dt.Chain(dt.LSTM(2, 128), dt.Dense(128, 4)),
        dt.create_dueling_network(dt.Chain(dt.Dense(2, 8, torch.tanh),
                                           dt.GRU(8, 8), dt.Dense(8, 4))),
    ]
    for net in refused:
        assert fused_collect.collect_plan_for(env, net, None) is None, net


@pytest.mark.parametrize("fused", [True, False])
def test_actor_carries_and_zeroes_the_state(fused):
    """The collect steps carry the LSTM state from step to step and zero it
    exactly for the envs whose episode ended."""
    env = dt.SimpleGridWorld()
    net = dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
    params = net.init(torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    actor = init_actor(env, net, 64, gen)
    assert [tuple(s.shape) for s in actor.net_state[0]] == [(64, 8)] * 2
    buf = dt.EpisodeReplayBuffer(env.obs_shape, 64, 8, 4, 5, num_envs=64,
                                 device="cpu")
    if fused:
        step = make_fused_collect_step(
            env, net, 5, lambda t: 0.5, buf.add_step,
            fused_collect.collect_plan_for(env, net, buf))
    else:
        step = make_collect_step(env, net, 5, lambda t: 0.5, buf.add_step)
    cc = (actor, buf.init(), params)
    for i in range(6):
        prev = cc[0]
        cc = step(cc, gen)
        h, c = cc[0].net_state[0]
        ended = cc[0].ep_step == 0
        assert ended.any() or i < 4
        assert (h[ended] == 0).all() and (c[ended] == 0).all()
        # the other envs stepped their cell from the previous state
        q, (cell, _) = net.apply(params, prev.obs, prev.net_state)
        np.testing.assert_allclose(h[~ended].numpy(), cell[0][~ended].numpy(),
                                   rtol=1e-6, atol=1e-7)
    assert cc[1].t == 6 and int(cc[1].rec_count.sum()) > 0


# ------------------------------------------- the tiled K6 (its plan and order)

def _old_gate(net):
    """The recurrent gate before K6 took tiles: the cell's hidden width
    within the per-thread arrays (``MAX_WIDTH``) and the cell, the head and
    the block's sums within ``MAX_SMEM``."""
    rp = fused_collect._recurrent_plan(net)
    if rp is None:
        return False
    head, cell = rp
    if any(lp.dout > fused_collect.MAX_WIDTH for lp in head.layers) or \
            cell.hidden > fused_collect.MAX_WIDTH:
        return False
    g = cell.n_gates * cell.hidden
    return 4 * (head.desc().n_params + g * (cell.in_dim + cell.hidden + 1)
                + 3 * fused_collect.THREADS) <= fused_collect.MAX_SMEM


def _sweep():
    """LSTM and GRU cells from 8 to ``MAX_WIDTH`` wide under a one-layer,
    a two-layer, a 128-wide and a dueling head."""
    for cell in (dt.LSTM, dt.GRU):
        for H in (8, 16, 32, 48, 64, 96, 104, 110, 111, 120, 126, 127, 128):
            yield dt.Chain(cell(2, H), dt.Dense(H, 4))
            yield dt.Chain(cell(2, H), dt.Dense(H, 32, torch.tanh),
                           dt.Dense(32, 4))
            yield dt.Chain(cell(2, H), dt.Dense(H, 128, torch.relu),
                           dt.Dense(128, 4))
            yield dt.DuelingNetwork(
                dt.Chain(cell(2, H)),
                dt.Chain(dt.Dense(H, 32, torch.tanh), dt.Dense(32, 1)),
                dt.Chain(dt.Dense(H, 32, torch.tanh), dt.Dense(32, 4)))


def test_k6_tile_for_every_net_the_old_gate_took():
    """No net that ran K6 before its tiles loses its plan: each gets the
    largest tile of ``K6_TILES`` within the card's per-block shared memory,
    and the gate takes no net the old one refused."""
    env = dt.SimpleGridWorld()
    taken, tiles = 0, set()
    for net in _sweep():
        plan = fused_collect.collect_plan_for(env, net, None)
        assert (plan is not None) == _old_gate(net), net
        if plan is None:
            continue
        taken += 1
        te = plan.tile
        tiles.add(te)
        assert te == fused_collect.k6_tile(plan.net, plan.cell)
        assert fused_collect.k6_smem_bytes(plan.net, plan.cell, te) <= \
            fused_collect.K4_MAX_SMEM
        if te < fused_collect.K6_TILES[0]:
            bigger = fused_collect.K6_TILES[
                fused_collect.K6_TILES.index(te) - 1]
            assert fused_collect.k6_smem_bytes(
                plan.net, plan.cell, bigger) > fused_collect.K4_MAX_SMEM
    assert taken == 64 and tiles == {8, 16, 32}


def test_k6_smem_bytes_follows_its_layout():
    """LSTM(2, 32) + Dense(32, 4) at a tile of 32: the head's 132 floats,
    the cell's 34 x 128 weights and 128 biases, 34 + 32 + 32 cell rows of
    36 floats, two 32-wide head buffers, the value output, the end flags
    and 3 sums per thread; 512 blocks at 16384 envs."""
    env = dt.SimpleGridWorld()
    plan = fused_collect.collect_plan_for(
        env, dt.Chain(dt.LSTM(2, 32), dt.Dense(32, 4)), None)
    assert plan.tile == 32 and -(-16384 // plan.tile) == 512
    assert fused_collect.k6_smem_bytes(plan.net, plan.cell, 32) == 4 * (
        132 + 34 * 128 + 128 + 98 * 36 + 2 * 32 * 32 + 2 * 32 + 3 * 256)
    gru = fused_collect.collect_plan_for(
        env, dt.Chain(dt.GRU(2, 30), dt.Dense(30, 4)), None)
    # 3H = 90 gate columns: the weights and bias pad to 4 floats; no c rows
    assert fused_collect.k6_smem_bytes(gru.net, gru.cell, 64) == 4 * (
        124 + 2880 + 92 + 62 * 68 + 2 * 30 * 64 + 2 * 64 + 3 * 256)


@pytest.mark.parametrize("kind,n_envs", [("lstm", 256), ("gru", 250),
                                         ("dueling_lstm", 200)])
def test_tile_order_reference_matches_twin(kind, n_envs):
    """``fused_collect_rnn_tiled`` (K6's sum order; totals per tile of
    ``plan.tile`` envs, the last one ragged for 250 and 200 envs) against
    the twin at this file's tolerances; actions equal where the top two Q
    values are not within 1e-5."""
    env = dt.SimpleGridWorld()
    _, net = _nets(kind)
    plan = fused_collect.collect_plan_for(env, net, None)
    params = net.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(4)
    g = torch.Generator().manual_seed(5)
    st, obs = env.reset_batch(n_envs, g)
    st[:, 2] = torch.from_numpy((rng.random(n_envs) < 0.1)
                                .astype(np.float32))
    ins = dict(obs=obs, state=st,
               ep_step=torch.from_numpy(rng.integers(0, MAXLEN, n_envs)
                                        .astype(np.int32)),
               ep_ret=torch.from_numpy(rng.normal(size=n_envs)
                                       .astype(np.float32)),
               u=torch.rand(6, n_envs, generator=g), eps=0.3,
               max_episode_length=MAXLEN,
               nstate=torch.from_numpy((rng.normal(size=(
                   n_envs, plan.state_width)) * 0.5).astype(np.float32)))
    ref = fused_collect.fused_collect_rnn_tiled(env, plan, params, **ins)
    twin = fused_collect.fused_collect_plain(env, plan, params, **ins)
    agree = ref[0][:, 4] == twin[0][:, 4]
    if not bool(agree.all()):
        H = plan.cell.hidden
        ns = ins["nstate"][~agree]
        h, _ = fused_drqn.cell_step(
            plan.cell, params, obs[~agree], ns[:, :H],
            ns[:, H:] if plan.cell.kind == "lstm" else None)
        top2 = q_values(plan.net, params, h)[0].topk(2, dim=1).values
        assert bool(((top2[:, 0] - top2[:, 1]) <= 1e-5).all())
    for r, t, tol in zip(ref[:5], twin[:5], (1e-6,) * 5):
        np.testing.assert_allclose(r[agree].numpy(), t[agree].numpy(),
                                   rtol=tol, atol=tol)
    np.testing.assert_allclose(ref[6][agree].numpy(), twin[6][agree].numpy(),
                               rtol=1e-5, atol=1e-5)
    if bool(agree.all()):
        np.testing.assert_allclose(ref[5].numpy(), twin[5].numpy(),
                                   rtol=1e-5, atol=1e-5)
