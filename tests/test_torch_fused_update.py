"""K3 (``ops/cuda/fused_update.py``): its plain twin against the JAX Pallas
``fused_group_update`` in interpret mode and against the JAX grouped XLA
path (``make_grouped_dqn_train_step(use_pallas=False)``)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.train_step import (  # noqa: E402
    make_fused_grouped_train_step as j_fused_step,
    make_grouped_dqn_train_step as j_grouped_step)
from deepqlearning_tpu.ops.pallas.fused_update import (  # noqa: E402
    fused_group_update as j_fused_group_update, plan_for as j_plan_for)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import build_loop  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    make_fused_grouped_train_step, make_grouped_dqn_train_step)
from deepqlearning_tpu_torch.ops.cuda import fused_update  # noqa: E402

torch.set_num_threads(2)
OBS, A, B, U, N = 5, 4, 8, 3, 64
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _nets(dueling):
    jc = dq.Chain(dq.Flatten(), dq.Dense(OBS, 16, jnp.tanh),
                  dq.Dense(16, 16, jax.nn.relu), dq.Dense(16, A))
    tc = dt.Chain(dt.Flatten(), dt.Dense(OBS, 16, torch.tanh),
                  dt.Dense(16, 16, torch.relu), dt.Dense(16, A))
    if dueling:
        return dq.create_dueling_network(jc), dt.create_dueling_network(tc)
    return jc, tc


def _buffers():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(N, OBS)).astype(np.float32)
    nobs = rng.normal(size=(N, OBS)).astype(np.float32)
    act = rng.integers(0, A, N).astype(np.int32)
    rew = rng.normal(size=N).astype(np.float32)
    done = (rng.random(N) < 0.1).astype(np.float32)
    jb = dq.PrioritizedReplayBuffer((OBS,), N, B)
    js = jb.insert(jb.init(), dq.TransitionBatch(
        jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
        jnp.asarray(nobs), jnp.asarray(done)))
    tb = dt.PrioritizedReplayBuffer((OBS,), N, B, device="cpu")
    ts = tb.insert(tb.init(), dt.TransitionBatch(
        torch.tensor(obs), torch.tensor(act).long(), torch.tensor(rew),
        torch.tensor(nobs), torch.tensor(done)))
    return jb, js, tb, ts


def _close_params(tnet, ours, theirs, rtol=2e-4, atol=2e-5):
    """The JAX package's fused-vs-XLA tolerances
    (tests/test_fused_update.py: params rtol 2e-4 / atol 2e-5)."""
    ref = convert._as_dict(tnet, np_(theirs), "cpu")
    assert ref.keys() <= ours.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("dueling", [True, False])
def test_fused_step_matches_jax_fused_and_grouped(dueling, double_q):
    jnet, tnet = _nets(dueling)
    jb, js, tb, ts = _buffers()
    jparams = jnet.init(jax.random.PRNGKey(1))
    params = convert.params_from_numpy(tnet, np_(jparams))
    target = {k: p.clone() for k, p in params.items()}

    ref_step, ref_opt = j_grouped_step(jnet, jb, 0.95, double_q, 1e-2, U,
                                       use_pallas=False)
    fus_step, fus_opt = j_fused_step(jnet, jb, 0.95, double_q, 1e-2, U,
                                     interpret=True)
    step, opt = make_fused_grouped_train_step(tnet, tb, 0.95, double_q,
                                              1e-2, U)
    ro, fo, to = ref_opt.init(jparams), fus_opt.init(jparams), \
        opt.init(params)
    rp, fp, rst, fst = jparams, jparams, js, js
    # two grouped calls, so Adam's bias correction past t=U is covered
    for i in range(2):
        k = jax.random.PRNGKey(10 + i)
        u = torch.tensor(np.array(jax.random.uniform(k, (U * B,))))
        rres = ref_step(rp, jparams, ro, rst, k)
        fres = fus_step(fp, jparams, fo, fst, k)
        tres = step(params, target, to, ts, u=u)
        rp, ro, rst = rres.params, rres.opt_state, rres.replay_state
        fp, fo, fst = fres.params, fres.opt_state, fres.replay_state
        params, to, ts = tres.params, tres.opt_state, tres.replay_state
        for jres in (rres, fres):
            # loss rtol 1e-4, gnorm rtol 1e-3 (tests/test_fused_update.py)
            np.testing.assert_allclose(float(tres.loss), float(jres.loss),
                                       rtol=1e-4)
            np.testing.assert_allclose(float(tres.grad_norm),
                                       float(jres.grad_norm), rtol=1e-3,
                                       atol=1e-6)
            np.testing.assert_allclose(ts.tree[0].numpy(),
                                       np.asarray(jres.replay_state.tree[0]),
                                       rtol=2e-3, atol=1e-5)
        _close_params(tnet, params, rp)
        _close_params(tnet, params, fp)
        _close_params(tnet, to.m, fo.m)
        _close_params(tnet, to.v, fo.v)
    assert int(to.count) == int(fo.count) == 2 * U


@pytest.mark.parametrize("double_q", [True, False])
def test_plain_grouped_step_matches_jax_grouped(double_q):
    jnet, tnet = _nets(True)
    jb, js, tb, ts = _buffers()
    jparams = jnet.init(jax.random.PRNGKey(2))
    params = convert.params_from_numpy(tnet, np_(jparams))
    target = {k: p.clone() for k, p in params.items()}
    ref_step, ref_opt = j_grouped_step(jnet, jb, 0.95, double_q, 1e-2, U,
                                       use_pallas=False)
    step, opt = make_grouped_dqn_train_step(tnet, tb, 0.95, double_q, 1e-2,
                                            U)
    ro, to, rp = ref_opt.init(jparams), opt.init(params), jparams
    for i in range(2):
        k = jax.random.PRNGKey(20 + i)
        u = torch.tensor(np.array(jax.random.uniform(k, (U * B,))))
        rres = ref_step(rp, jparams, ro, js, k)
        tres = step(params, target, to, ts, u=u)
        rp, ro, js = rres.params, rres.opt_state, rres.replay_state
        to, ts = tres.opt_state, tres.replay_state
        np.testing.assert_allclose(float(tres.loss), float(rres.loss),
                                   rtol=1e-4)
        _close_params(tnet, params, rp)
        np.testing.assert_allclose(ts.tree[0].numpy(), np.asarray(js.tree[0]),
                                   rtol=2e-3, atol=1e-5)
    assert int(to.count) == 2 * U


def test_twin_matches_pallas_call_directly():
    """One direct call: the twin's (params, m, v, tds, prios, loss, gnorm)
    against ``fused_group_update(interpret=True)`` on the same arrays."""
    jnet, tnet = _nets(True)
    rng = np.random.default_rng(5)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, nobs = f(U * B, OBS), f(U * B, OBS)
    act = rng.integers(0, A, U * B).astype(np.int32)
    rew, done = f(U * B), (rng.random(U * B) < 0.2).astype(np.float32)
    w, qsp = (rng.random(U * B) + 0.5).astype(np.float32), f(U * B, A)
    jparams = jnet.init(jax.random.PRNGKey(4))
    z = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    de = lambda x: jnp.asarray(x).reshape((U, B) + x.shape[1:])
    obs_cat = jnp.concatenate([de(obs), de(nobs)], axis=1)
    jp, jm, jv, jcount, jtds, jprios, jloss, jgn = j_fused_group_update(
        jnet, j_plan_for(jnet), jparams, z, z, jnp.asarray(3, jnp.int32),
        obs_cat, de(act), de(rew), de(done), de(w), de(qsp), gamma=0.9,
        double_q=True, lr=1e-2, alpha=0.6, eps=1e-3, batch_size=B,
        interpret=True)
    params = convert.params_from_numpy(tnet, np_(jparams))
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    count = torch.tensor(3, dtype=torch.int32)
    t = lambda x: torch.tensor(x)
    tds, prios, loss, gn = fused_update.fused_group_update(
        fused_update.plan_for(tnet), params, m, v, count, t(obs), t(nobs),
        t(act), t(rew), t(done), t(w), t(qsp), gamma=0.9, double_q=True,
        lr=1e-2, alpha=0.6, eps=1e-3, batch_size=B, n_updates=U)
    _close_params(tnet, params, jp)
    _close_params(tnet, m, jm)
    _close_params(tnet, v, jv)
    assert int(count) == int(jcount) == 3 + U
    np.testing.assert_allclose(tds.numpy(), np.asarray(jtds), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(prios.numpy(), np.asarray(jprios), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-3)


def test_plan_for_gate():
    from deepqlearning_tpu_torch.models.dueling import DuelingNetwork

    _, tnet = _nets(True)
    assert fused_update.plan_for(tnet) is not None
    assert fused_update.plan_for(dt.Chain(dt.Dense(4, 8, torch.sin),
                                          dt.Dense(8, 2))) is None
    assert fused_update.plan_for("not a network") is None
    assert fused_update.plan_for(dt.Chain(dt.Dense(4, 8, use_bias=False),
                                          dt.Dense(8, 2))) is None
    assert fused_update.plan_for(DuelingNetwork(
        dt.Chain(dt.Flatten()), dt.Chain(dt.Dense(8, 3)),
        dt.Chain(dt.Dense(8, 4)))) is None  # value head must be scalar
    assert fused_update.plan_for(dt.Chain(dt.Dense(4, 300),
                                          dt.Dense(300, 2))) is None  # width
    assert fused_update.plan_for(dt.Chain(dt.Dense(4, 8),
                                          dt.Dense(8, 200))) is None  # actions


def test_fused_updates_true_on_unsupported_net_raises():
    env = dt.SimpleGridWorld()
    net = dt.Chain(dt.Dense(2, 8, torch.sin), dt.Dense(8, 4))
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 1024, 32, device="cpu")
    cfg = dt.DQNConfig(num_envs=128, train_freq=32, batch_size=32,
                       buffer_size=1024, fused_updates=True,
                       fused_collect=False)
    with pytest.raises(ValueError, match="fused_updates=True"):
        build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(), 0.95)
    # auto (None) takes the plain grouped path as a gate instead
    build_loop(env, net, buf, cfg.replace(fused_updates=None),
               dt.LinearDecaySchedule(), 0.95)


def test_mismatched_shapes_raise_value_error():
    _, tnet = _nets(False)
    plan = fused_update.plan_for(tnet)
    params = tnet.init(torch.Generator().manual_seed(0))
    z = {k: torch.zeros_like(p) for k, p in params.items()}
    x = torch.zeros(U * B, OBS)
    r = torch.zeros(U * B - 1)
    with pytest.raises(ValueError, match="reward"):
        fused_update.fused_group_update(
            plan, params, z, dict(z), torch.tensor(0, dtype=torch.int32), x,
            x, torch.zeros(U * B, dtype=torch.long), r, torch.zeros(U * B),
            torch.zeros(U * B), torch.zeros(U * B, A), gamma=0.9,
            double_q=True, lr=1e-3, alpha=0.6, eps=1e-3, batch_size=B,
            n_updates=U)


def _old_smem_bytes(plan):
    """The shared-memory sum of the launch design this kernel replaced
    (16-row tiles, unpadded params), the gate ``plan_for`` used to apply."""
    d, t = plan.desc(), 16
    return 4 * (d.n_params + 2 * t * d.in_dim + t * d.h_per_row
                + 2 * t * d.maxw + 2 * t * d.num_actions + 3 * t)


def _widest():
    """256 wide, 195 KB under the replaced design's sum (200 KB gate)."""
    return dt.Chain(dt.Dense(2, 256, torch.relu),
                    dt.Dense(256, 128, torch.tanh), dt.Dense(128, 4))


def _headline(dueling=True):
    chain = dt.Chain(dt.Flatten(), dt.Dense(2, 64, torch.tanh),
                     dt.Dense(64, 64, torch.tanh), dt.Dense(64, 4))
    return dt.create_dueling_network(chain) if dueling else chain


@pytest.mark.parametrize("B", [512, 10, 3])
def test_partials_are_one_row_per_tile(B):
    plan = fused_update.plan_for(_headline())
    pg, pl = fused_update.partials(plan, B, "cpu")
    nt = -(-B // fused_update.TILE)
    assert tuple(pg.shape) == (nt, plan.desc().n_params) == (nt, 9029)
    assert tuple(pl.shape) == (nt,)
    assert fused_update.TILE == 4


def test_smem_bytes_follows_the_padded_layout():
    plan = fused_update.plan_for(_headline())
    # each W row stride odd (65 for 64 outputs, 5 for 4, 1 for 1)
    assert plan.smem_params() == (2 * 65 + 64 + 64 * 65 + 64 + 64 * 1 + 1
                                  + 2 * 65 + 64 + 64 * 65 + 64 + 64 * 5 + 4)
    # + 8 forward rows x (2 inputs + 261 outputs + 4 Q) + 4 rows x (4
    # targets + 4 scalars) + 12 + 4 x 4 x 64
    assert plan.smem_bytes() == 4 * (9225 + 8 * 267 + 32 + 12 + 1024) == 49716
    # never above the replaced design's sum, which the gate used to apply
    for net in (_headline(), _headline(False), _nets(True)[1], _widest()):
        p = fused_update.plan_for(net)
        assert p.smem_bytes() < _old_smem_bytes(p)


def test_plan_gate_takes_what_the_old_gate_took():
    takes = [_headline(), _headline(False), _nets(True)[1], _nets(False)[1],
             _widest()]
    for net in takes:
        plan = fused_update.plan_for(net)
        assert plan is not None
        assert _old_smem_bytes(plan) <= fused_update.MAX_SMEM
    refuses = [dt.Chain(dt.Dense(4, 300), dt.Dense(300, 2)),
               dt.Chain(dt.Dense(4, 8), dt.Dense(8, 200)),
               # over 200 KB of parameters alone
               dt.Chain(*[dt.Dense(256, 256) for _ in range(4)])]
    for net in refuses:
        assert fused_update.plan_for(net) is None


@pytest.mark.parametrize("double_q", [True, False])
def test_tiled_reference_matches_pallas_call(double_q):
    """The kernel's sum order (per-tile partials, summed in tile order)
    against ``fused_group_update(interpret=True)``, within the JAX
    package's fused-vs-XLA tolerances."""
    jnet, tnet = _nets(True)
    rng = np.random.default_rng(7)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    obs, nobs = f(U * B, OBS), f(U * B, OBS)
    act = rng.integers(0, A, U * B).astype(np.int32)
    rew, done = f(U * B), (rng.random(U * B) < 0.2).astype(np.float32)
    w, qsp = (rng.random(U * B) + 0.5).astype(np.float32), f(U * B, A)
    jparams = jnet.init(jax.random.PRNGKey(6))
    z = jax.tree_util.tree_map(jnp.zeros_like, jparams)
    de = lambda x: jnp.asarray(x).reshape((U, B) + x.shape[1:])
    obs_cat = (jnp.concatenate([de(obs), de(nobs)], axis=1) if double_q
               else de(obs))
    jp, jm, jv, jcount, jtds, jprios, jloss, jgn = j_fused_group_update(
        jnet, j_plan_for(jnet), jparams, z, z, jnp.asarray(0, jnp.int32),
        obs_cat, de(act), de(rew), de(done), de(w), de(qsp), gamma=0.9,
        double_q=double_q, lr=1e-2, alpha=0.6, eps=1e-3, batch_size=B,
        interpret=True)
    params = convert.params_from_numpy(tnet, np_(jparams))
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    count = torch.tensor(0, dtype=torch.int32)
    t = lambda x: torch.tensor(x)
    assert B // fused_update.TILE == 2  # two tiles per sub-update
    tds, prios, loss, gn = fused_update.fused_group_update_tiled(
        fused_update.plan_for(tnet), params, m, v, count, t(obs), t(nobs),
        t(act), t(rew), t(done), t(w), t(qsp), gamma=0.9, double_q=double_q,
        lr=1e-2, alpha=0.6, eps=1e-3, batch_size=B, n_updates=U)
    _close_params(tnet, params, jp)
    _close_params(tnet, m, jm)
    _close_params(tnet, v, jv)
    assert int(count) == int(jcount) == U
    np.testing.assert_allclose(tds.numpy(), np.asarray(jtds), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(prios.numpy(), np.asarray(jprios), rtol=1e-4)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-4)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-3)


@pytest.mark.parametrize("Bt", [12, 10])
def test_tile_partials_are_each_tiles_own_gradient(Bt):
    """Partial t is the gradient of tile t's rows alone (with the batch's
    1/B), the last tile ragged when TILE does not divide B; and their
    tile-order sum is the whole batch's gradient."""
    _, tnet = _nets(True)
    plan = fused_update.plan_for(tnet)
    params = tnet.init(torch.Generator().manual_seed(3))
    rng = np.random.default_rng(8)
    f = lambda *s: torch.tensor(rng.normal(size=s).astype(np.float32))
    rows = dict(obs_s=f(Bt, OBS), obs_sp=f(Bt, OBS),
                action=torch.tensor(rng.integers(0, A, Bt)), reward=f(Bt),
                done=torch.zeros(Bt), weights=f(Bt).abs() + 0.5,
                q_sp_tgt=f(Bt, A))
    kw = dict(gamma=0.9, double_q=True, alpha=0.6, eps=1e-3)
    args = lambda sl: [rows[k][sl] for k in ("obs_s", "obs_sp", "action",
                                              "reward", "done", "weights",
                                              "q_sp_tgt")]
    parts, _, _, _ = fused_update._fwd_bwd(plan, params, *args(slice(None)),
                                           kw["gamma"], True, 0.6, 1e-3,
                                           tile=fused_update.TILE)
    nt = -(-Bt // fused_update.TILE)
    whole, _, _, _ = fused_update._fwd_bwd(plan, params, *args(slice(None)),
                                           0.9, True, 0.6, 1e-3)
    for k in plan.names:
        assert parts[k].shape[0] == nt
        for ti in range(nt):
            sl = slice(ti * fused_update.TILE, (ti + 1) * fused_update.TILE)
            own, _, _, _ = fused_update._fwd_bwd(plan, params, *args(sl), 0.9,
                                                 True, 0.6, 1e-3)
            # the tile's own call scales by 1/rows; the partial by 1/B
            rows_t = len(range(Bt)[sl])
            np.testing.assert_allclose(parts[k][ti].numpy(),
                                       own[k].numpy() * rows_t / Bt,
                                       rtol=1e-5, atol=1e-7, err_msg=k)
        np.testing.assert_allclose(
            fused_update._tile_order_sum(parts[k]).numpy(), whole[k].numpy(),
            rtol=1e-5, atol=1e-7, err_msg=k)
