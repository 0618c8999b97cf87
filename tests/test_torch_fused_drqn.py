"""K5 (``ops/cuda/fused_drqn.py``): its plain twin against the JAX Pallas
``fused_drqn_group_update`` in interpret mode, through the grouped fused
DRQN train steps of both packages on the same windows, and directly.

Tolerances are the JAX package's fused-vs-XLA ones
(tests/test_fused_drqn.py:50-53, 101-105): params and Adam moments rtol
2e-4 / atol 2e-5, loss rtol 1e-4, gnorm rtol 1e-3.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.train_step import (  # noqa: E402
    make_fused_grouped_drqn_train_step as j_fused_drqn_step)
from deepqlearning_tpu.models.chain import GRU as JGRU, LSTM as JLSTM  # noqa: E402
from deepqlearning_tpu.ops.pallas.fused_drqn import (  # noqa: E402
    drqn_plan_for as j_drqn_plan_for,
    fused_drqn_group_update as j_fused_drqn_group_update)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import build_loop  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    make_fused_grouped_drqn_train_step)
from deepqlearning_tpu_torch.ops.cuda import fused_drqn  # noqa: E402
from deepqlearning_tpu_torch.ops.helpers import huber_loss  # noqa: E402

from test_torch_drqn_train_step import (  # noqa: E402
    B, OBS, T, close_params, filled_buffers, nets, np_)
from test_torch_episode_replay import jax_draws  # noqa: E402

torch.set_num_threads(2)
KINDS = ["plain", "deep", "dueling", "gru", "gru_dueling"]


def check_fused_step(kind, double_q, U=3):
    """Two grouped calls of U sub-updates (Adam past t=U) of the port's
    fused DRQN step (the K5 twin on CPU tensors) and JAX's (Pallas in
    interpret mode) on the same windows."""
    jnet, tnet = nets(kind)
    assert j_drqn_plan_for(jnet, T, B, double_q) is not None
    assert fused_drqn.drqn_plan_for(tnet, T, B, double_q) is not None
    jb, js, tb, ts = filled_buffers()
    jparams = jnet.init(jax.random.PRNGKey(1))
    params = convert.params_from_numpy(tnet, np_(jparams))
    target = {k: p.clone() for k, p in params.items()}
    jstep, jopt = j_fused_drqn_step(jnet, jb, 0.95, double_q, 1e-2, U,
                                    interpret=True)
    step, opt = make_fused_grouped_drqn_train_step(tnet, tb, 0.95, double_q,
                                                   1e-2, U)
    jstep = jax.jit(jstep)
    jo, to, jp = jopt.init(jparams), opt.init(params), jparams
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jres = jstep(jp, jparams, jo, js, key)
        tres = step(params, target, to, ts,
                    u=jax_draws(js, key, U * B, tb.records_per_env))
        jp, jo = jres.params, jres.opt_state
        np.testing.assert_allclose(float(tres.loss), float(jres.loss),
                                   rtol=1e-4, atol=1e-7)
        np.testing.assert_allclose(float(tres.grad_norm),
                                   float(jres.grad_norm), rtol=1e-3,
                                   atol=1e-6)
        close_params(tnet, params, jp)
        close_params(tnet, to.m, jo.m)
        close_params(tnet, to.v, jo.v)
    assert int(to.count) == int(jo.count) == 2 * U


@pytest.mark.parametrize("kind", KINDS)
def test_fused_step_matches_jax_fused_step(kind):
    """Double-Q targets; max targets in test_torch_fused_drqn_max.py."""
    check_fused_step(kind, True)


def test_single_sub_update_matches_jax():
    """U=1 (the route of an ungrouped loop): one direct call of the twin
    against ``fused_drqn_group_update(interpret=True)`` on the same arrays,
    with a nonzero Adam count and ragged masks."""
    jnet, tnet = nets("dueling")
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, nobs = f(1, B, T, OBS), f(1, B, T, OBS)
    act = rng.integers(0, 4, (1, B, T)).astype(np.int32)
    rew, qsp = f(1, B, T), f(1, B, T, 4)
    done = (rng.random((1, B, T)) < 0.2).astype(np.float32)
    lens = rng.integers(1, T + 1, B)
    mask = (np.arange(T)[None, None] < lens[None, :, None]).astype(np.float32)
    jparams = jnet.init(jax.random.PRNGKey(4))
    z = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    jplan = j_drqn_plan_for(jnet, T, B, True)
    a = jnp.asarray
    jp, jm, jv, jcount, jloss, jgn = j_fused_drqn_group_update(
        jnet, jplan, jparams, z, z, jnp.asarray(3, jnp.int32), a(obs),
        a(nobs), a(act), a(rew), a(done), a(mask), a(qsp), gamma=0.9,
        double_q=True, lr=5e-3, interpret=True)
    params = convert.params_from_numpy(tnet, np_(jparams))
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    count = torch.tensor(3, dtype=torch.int32)
    t = lambda x: torch.from_numpy(x[0])
    loss, gn = fused_drqn.fused_drqn_group_update(
        fused_drqn.drqn_plan_for(tnet, T, B, True), params, m, v, count,
        t(obs), t(nobs), t(act), t(rew), t(done), t(mask), t(qsp),
        gamma=0.9, double_q=True, lr=5e-3, batch_size=B, n_updates=1)
    close_params(tnet, params, jp)
    close_params(tnet, m, jm)
    close_params(tnet, v, jv)
    assert int(count) == int(jcount) == 4
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-3)


def test_plan_gate_matches_jax_family():
    """The port accepts and refuses the JAX kernel's network family."""
    from deepqlearning_tpu.models.dueling import DuelingNetwork as JDuel

    cases = [
        (dq.Chain(JGRU(3, 8), dq.Dense(8, 2)),
         dt.Chain(dt.GRU(3, 8), dt.Dense(8, 2)), True),
        (dq.Chain(JLSTM(3, 8), JLSTM(8, 8), dq.Dense(8, 2)),
         dt.Chain(dt.LSTM(3, 8), dt.LSTM(8, 8), dt.Dense(8, 2)), False),
        (dq.Chain(JGRU(3, 8), JLSTM(8, 8), dq.Dense(8, 2)),
         dt.Chain(dt.GRU(3, 8), dt.LSTM(8, 8), dt.Dense(8, 2)), False),
        (dq.Chain(dq.Dense(3, 8), dq.Dense(8, 2)),
         dt.Chain(dt.Dense(3, 8), dt.Dense(8, 2)), False),
        (dq.Chain(JLSTM(3, 8)), dt.Chain(dt.LSTM(3, 8)), False),  # no head
        (dq.Chain(JLSTM(3, 8), dq.Dense(8, 2, jnp.sin)),
         dt.Chain(dt.LSTM(3, 8), dt.Dense(8, 2, torch.sin)), False),
        (JDuel(dq.Chain(JLSTM(3, 8)), dq.Chain(dq.Dense(8, 2)),
               dq.Chain(dq.Dense(8, 4))),
         dt.DuelingNetwork(dt.Chain(dt.LSTM(3, 8)), dt.Chain(dt.Dense(8, 2)),
                           dt.Chain(dt.Dense(8, 4))), False),  # value head
    ] + [(*nets(k), True) for k in KINDS]
    for jnet, tnet, ok in cases:
        assert (j_drqn_plan_for(jnet, 8, 8) is not None) == ok
        assert (fused_drqn.drqn_plan_for(tnet, 8, 8) is not None) == ok
    plan = fused_drqn.drqn_plan_for(dt.Chain(dt.GRU(3, 8), dt.Dense(8, 2)),
                                    8, 8)
    assert plan.cell.kind == "gru" and plan.cell.n_gates == 3
    # this card's budget: a block's padded parameters and one window's
    # state must fit its shared memory
    big = dt.Chain(dt.LSTM(256, 256), dt.Dense(256, 4))
    assert fused_drqn.drqn_plan_for(big, 64, 1024) is None
    lstm32 = fused_drqn.drqn_plan_for(
        dt.Chain(dt.LSTM(2, 32), dt.Dense(32, 4)), 8, 512)
    assert lstm32.desc(8).tile >= 1
    assert lstm32.smem_bytes(8) <= fused_drqn.MAX_SMEM


def test_shape_mismatch_raises():
    _, tnet = nets("plain")
    plan = fused_drqn.drqn_plan_for(tnet, T, B, True)
    params = tnet.init()
    z = {k: torch.zeros_like(p) for k, p in params.items()}
    x = torch.zeros(2 * B, T, OBS)
    r = torch.zeros(2 * B - 1, T)
    with pytest.raises(ValueError, match="reward"):
        fused_drqn.fused_drqn_group_update(
            plan, params, z, dict(z), torch.tensor(0, dtype=torch.int32), x,
            x, torch.zeros(2 * B, T, dtype=torch.long), r,
            torch.zeros(2 * B, T), torch.zeros(2 * B, T),
            torch.zeros(2 * B, T, 4), gamma=0.9, double_q=True, lr=1e-3,
            batch_size=B, n_updates=2)


def test_fused_updates_true_that_cannot_be_honoured_raises():
    env = dt.SimpleGridWorld()
    cfg = dt.DQNConfig(num_envs=16, train_freq=16, batch_size=B,
                       buffer_size=32, trace_length=T, max_episode_length=8,
                       recurrence=True, fused_updates=True,
                       fused_collect=False)
    buf = dt.EpisodeReplayBuffer(env.obs_shape, 32, B, T, 8, num_envs=16,
                                 device="cpu")
    two_cells = dt.Chain(dt.LSTM(2, 8), dt.LSTM(8, 8), dt.Dense(8, 4))
    with pytest.raises(ValueError, match="fused_updates=True"):
        build_loop(env, two_cells, buf, cfg, dt.LinearDecaySchedule(), 0.95)
    # auto (None) takes the plain DRQN step instead
    build_loop(env, two_cells, buf, cfg.replace(fused_updates=None),
               dt.LinearDecaySchedule(), 0.95)


# --------------------------------------------- the redesigned K5's layout

def _window_arrays(rng, U, Bt, actions=(0, 4)):
    """Random u-major windows ``[U, Bt, T, ...]`` as numpy arrays with
    ragged masks, actions drawn from ``[actions[0], actions[1])`` (A = 4:
    the default keeps them in range)."""
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lens = rng.integers(1, T + 1, (U, Bt))
    return dict(
        obs=f(U, Bt, T, OBS), nobs=f(U, Bt, T, OBS),
        action=rng.integers(*actions, (U, Bt, T)).astype(np.int32),
        reward=f(U, Bt, T),
        done=(rng.random((U, Bt, T)) < 0.2).astype(np.float32),
        mask=(np.arange(T)[None, None] < lens[..., None]).astype(np.float32),
        q_sp_tgt=f(U, Bt, T, 4))


@pytest.mark.parametrize("kind,double_q", [("plain", True), ("dueling", False),
                                           ("gru", False),
                                           ("gru_dueling", True)])
def test_tiled_reference_matches_pallas_call(kind, double_q):
    """The kernel's sum order (per-tile partials, summed in tile order)
    against ``fused_drqn_group_update(interpret=True)``, with B = 10 so the
    last tile of ``TILE`` windows is ragged, within the JAX package's
    fused-vs-XLA tolerances."""
    jnet, tnet = nets(kind)
    U, Bt = 2, 10
    x = _window_arrays(np.random.default_rng(11), U, Bt)
    jparams = jnet.init(jax.random.PRNGKey(7))
    z = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    jp, jm, jv, jcount, jloss, jgn = j_fused_drqn_group_update(
        jnet, j_drqn_plan_for(jnet, T, Bt, double_q), jparams, z, z,
        jnp.asarray(2, jnp.int32), *(jnp.asarray(v) for v in x.values()),
        gamma=0.9, double_q=double_q, lr=5e-3, interpret=True)
    plan = fused_drqn.drqn_plan_for(tnet, T, Bt, double_q)
    assert plan.desc(T).tile == fused_drqn.TILE == 4 and Bt % 4 == 2
    params = convert.params_from_numpy(tnet, np_(jparams))
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    count = torch.tensor(2, dtype=torch.int32)
    flat = lambda a: torch.from_numpy(a.reshape((U * Bt,) + a.shape[2:]))
    loss, gn = fused_drqn.fused_drqn_group_update_tiled(
        plan, params, m, v, count, *(flat(a) for a in x.values()),
        gamma=0.9, double_q=double_q, lr=5e-3, batch_size=Bt, n_updates=U)
    close_params(tnet, params, jp)
    close_params(tnet, m, jm)
    close_params(tnet, v, jv)
    assert int(count) == int(jcount) == 2 + U
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-3)


@pytest.mark.parametrize("Bt", [12, 10])
def test_tile_partials_are_each_tiles_own_gradient(Bt):
    """Partial t is the gradient of tile t's windows alone, with the
    batch's 1/(B·T) (the last tile ragged when TILE does not divide B), its
    Huber sum the tile's; their tile-order sum is the whole batch's
    gradient and loss."""
    _, tnet = nets("gru_dueling")
    plan = fused_drqn.drqn_plan_for(tnet, T, Bt, True)
    params = tnet.init(torch.Generator().manual_seed(3))
    x = {k: torch.from_numpy(a[0]) for k, a in
         _window_arrays(np.random.default_rng(8), 1, Bt).items()}
    kw = dict(gamma=0.9, double_q=True)
    parts, hubs = fused_drqn.tile_partials(plan, params, *x.values(), **kw)
    nt, W = -(-Bt // 4), fused_drqn.TILE
    assert tuple(parts.shape) == (nt, plan.desc(T).n_params)
    for ti in range(nt):
        sl = slice(ti * W, (ti + 1) * W)
        own, loss, _ = fused_drqn.fused_drqn_grads_plain(
            plan, params, *(t[sl] for t in x.values()), **kw)
        rows = len(range(Bt)[sl])
        # the tile's own call scales by 1/(rows·T); the partial by 1/(B·T)
        np.testing.assert_allclose(parts[ti].numpy(),
                                   own.numpy() * rows / Bt, rtol=1e-5,
                                   atol=1e-7)
        np.testing.assert_allclose(float(hubs[ti]), float(loss) * rows * T,
                                   rtol=1e-5)
    whole, wloss, wgn = fused_drqn.fused_drqn_grads_plain(
        plan, params, *x.values(), **kw)
    flat, loss, gn = fused_drqn.fused_drqn_grads_tiled(plan, params,
                                                       *x.values(), **kw)
    np.testing.assert_allclose(flat.numpy(), whole.numpy(), rtol=1e-5,
                               atol=1e-7)
    np.testing.assert_allclose(float(loss), float(wloss), rtol=1e-5)
    np.testing.assert_allclose(float(gn), float(wgn), rtol=1e-5)


@pytest.mark.parametrize("kind", ["plain", "gru_dueling"])
def test_actions_outside_range_select_nothing(kind):
    """Actions -1 and A (= 4) select no Q value (the one-hot select the
    kernel's guard mirrors): the tile-order reference equals the autograd
    twin on such windows, and a tile whose actions all lie outside [0, A)
    has a zero partial gradient and the Huber sum of its masked targets
    alone. Port only: the JAX kernel treats such actions otherwise
    (ROADMAP C.6)."""
    _, tnet = nets(kind)
    U, Bt = 2, 10
    x = _window_arrays(np.random.default_rng(5), U, Bt, actions=(-1, 5))
    assert (x["action"] == -1).any() and (x["action"] == 4).any()
    params = tnet.init(torch.Generator().manual_seed(4))
    plan = fused_drqn.drqn_plan_for(tnet, T, Bt, True)
    flat = lambda a: torch.from_numpy(a.reshape((U * Bt,) + a.shape[2:]))
    out = []
    for fn in (fused_drqn.fused_drqn_group_update_plain,
               fused_drqn.fused_drqn_group_update_tiled):
        p = {k: v.clone() for k, v in params.items()}
        m = {k: torch.zeros_like(v) for k, v in params.items()}
        v = {k: torch.zeros_like(t) for k, t in params.items()}
        loss, gn = fn(plan, p, m, v, torch.tensor(0, dtype=torch.int32),
                      *(flat(a) for a in x.values()), gamma=0.9,
                      double_q=True, lr=5e-3, batch_size=Bt, n_updates=U)
        out.append((p, m, v, loss, gn))
    (pp, pm, pv, pl, pg), (tp, tm, tv, tl, tg) = out
    for a, b in ((pp, tp), (pm, tm), (pv, tv)):
        for k in plan.names:
            np.testing.assert_allclose(b[k].numpy(), a[k].numpy(),
                                       rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(float(tl), float(pl), rtol=1e-4)
    np.testing.assert_allclose(float(tg), float(pg), rtol=1e-3)
    # tile 0 with every action out of range: no gradient, and its Huber sum
    # is that of the masked targets (Q(s, a) taken as 0)
    w = {k: torch.from_numpy(a[0]) for k, a in x.items()}
    w["action"][:fused_drqn.TILE] = torch.tensor([-1, 4]).repeat(
        fused_drqn.TILE * T // 2).reshape(fused_drqn.TILE, T)
    parts, hubs = fused_drqn.tile_partials(plan, params, *w.values(),
                                           gamma=0.9, double_q=True)
    assert float(parts[0].abs().max()) == 0.0
    assert float(parts[1].abs().max()) > 0.0
    sl = slice(0, fused_drqn.TILE)
    best = torch.argmax(fused_drqn._unroll(
        plan, params, w["nobs"][sl].transpose(0, 1)), dim=-1).transpose(0, 1)
    q_sp = torch.gather(w["q_sp_tgt"][sl], -1, best[..., None])[..., 0]
    target = w["reward"][sl] + (1.0 - w["done"][sl]) * 0.9 * q_sp
    np.testing.assert_allclose(
        float(hubs[0]), float(huber_loss(w["mask"][sl] * -target).sum()),
        rtol=1e-6)


def _old_fits(plan, T):
    """Whether the replaced design (one warp per window, each warp with its
    own gradient copy) fit one warp in MAX_SMEM: the gate
    ``drqn_plan_for`` used to apply."""
    cp, d = plan.cell, plan.desc(T)
    H, G, A = cp.hidden, d.G, d.A
    maxw = max([plan.in_dim, cp.in_dim, H] + [lp.dout for lp in plan.dense])
    a = d.step_floats
    warp = (d.n_params + T * a + plan.in_dim + 2 * H + a + 2 * A + 5 * H
            + 2 * G + 2 * maxw + 2 * T)
    return 4 * (d.n_params + warp + 1) <= fused_drqn.MAX_SMEM


def test_plan_gate_takes_what_the_old_gate_took():
    """Every network and trace length the old gate took (widths up to
    MAX_WIDTH, so G up to 1024; trace lengths up to the old limit) the new
    gate takes, its tile shrinking or its T-step regions moving to global
    scratch where shared memory runs out."""
    cases = [dt.Chain(dt.LSTM(2, 32), dt.Dense(32, 4)),
             dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4)),
             dt.Chain(dt.GRU(2, 64), dt.Dense(64, 4)),
             dt.Chain(dt.LSTM(4, 48), dt.Dense(48, 128)),
             dt.create_dueling_network(dt.Chain(
                 dt.Dense(2, 128, torch.relu), dt.LSTM(128, 16),
                 dt.Dense(16, 128, torch.tanh), dt.Dense(128, 4))),
             nets("deep")[1], nets("gru_dueling")[1]]
    seen_shrunk = seen_global = False
    for net in cases:
        plan = fused_drqn.drqn_plan_for(net, 1, 8)
        assert plan is not None and _old_fits(plan, 1)
        t_max = 1
        while _old_fits(plan, 2 * t_max):
            t_max *= 2
        lo, hi = t_max, 2 * t_max  # the old gate's last T in [lo, hi)
        while hi - lo > 1:
            mid = (lo + hi) // 2
            lo, hi = (mid, hi) if _old_fits(plan, mid) else (lo, mid)
        for Tn in (1, 8, lo // 2, lo):
            assert fused_drqn.drqn_plan_for(net, Tn, 8) is not None, (net, Tn)
            d = plan.desc(Tn)
            assert 1 <= d.tile <= fused_drqn.TILE
            assert plan.smem_bytes(Tn) <= fused_drqn.MAX_SMEM
            seen_shrunk |= d.tile < fused_drqn.TILE
            seen_global |= bool(d.act_global)
    assert seen_shrunk and seen_global
    refuses = [dt.Chain(dt.LSTM(2, 300), dt.Dense(300, 4)),
               dt.Chain(dt.LSTM(256, 256), dt.Dense(256, 4)),
               dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 200))]
    for net in refuses:
        assert fused_drqn.drqn_plan_for(net, 8, 8) is None


def test_smem_bytes_follows_the_new_layout():
    """LSTM(2,32)+Dense(32,4) at T = 8: the params with 16-byte aligned
    rows at a stride of 4 (mod 8), two s' step blocks and three H-wide BPTT
    states per window, the rows' h and input feature-major (one
    copy per step parity), then
    four windows' T-step regions (cotangents, steps, inputs, per-step
    scalars); no per-window gradient copy."""
    plan = fused_drqn.drqn_plan_for(dt.Chain(dt.LSTM(2, 32),
                                             dt.Dense(32, 4)), 8, 512)
    d = plan.desc(8)
    assert d.n_params == 32 * 4 + 4 + 2 * 128 + 32 * 128 + 128 == 4612
    # w 32 x 4, b 4, wi 2 x 132, wh 32 x 132, b 128
    assert [d.t_ld[k] for k in range(5)] == [4, 0, 132, 132, 0]
    assert [d.t_dst[k] for k in range(5)] == [0, 128, 132, 396, 4620]
    assert d.n_sp == 4748
    assert d.step_floats == 128 + 3 * 32 + 4 == 228
    assert d.cot_floats == 4 + 128 == 132
    assert d.region_floats == 8 * (132 + 228 + 2 * 2 + 4 + 5) == 2984
    assert (d.tile, d.act_global, d.rp) == (4, 0, 8)
    # hT [2, 32, 8] and xT [2, 2, 8]: one per step parity
    assert (d.f_state, d.f_ht, d.f_xt, d.f_region) == (
        4748 + 2 * 4 * 228, 6572 + 3 * 4 * 32, 6956 + 2 * 32 * 8, 7500)
    assert plan.smem_bytes(8) == 4 * (7500 + 4 * 2984) == 77744
    # the gradient pass: 4 x 4 entries per item
    assert d.n_witems == 8 * 1 + 1 + 1 * 32 + 8 * 32 + 32 == 329
    offs = [d.r_cot, d.r_steps, d.r_x, d.r_x2, d.r_tgt, d.r_rew, d.r_done,
            d.r_mask, d.r_act, d.r_hub, d.region_floats]
    assert offs == sorted(offs) and offs[0] == 0
    pg, pl = fused_drqn.partials(plan, 8, 10, "cpu")
    assert tuple(pg.shape) == (3, 4612) and tuple(pl.shape) == (3,)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel's wrapper launches on CUDA tensors or raises: on CPU
    tensors it neither builds nor falls back to the twin."""
    _, tnet = nets("plain")
    plan = fused_drqn.drqn_plan_for(tnet, T, B, True)
    params = tnet.init()
    z = {k: torch.zeros_like(p) for k, p in params.items()}
    x = _window_arrays(np.random.default_rng(0), 1, B)
    with pytest.raises(ValueError, match="CUDA"):
        fused_drqn.fused_drqn_group_update_cuda(
            plan, params, z, dict(z), torch.tensor(0, dtype=torch.int32),
            *(torch.from_numpy(a[0]) for a in x.values()), gamma=0.9,
            double_q=True, lr=1e-3, batch_size=B, n_updates=1)
