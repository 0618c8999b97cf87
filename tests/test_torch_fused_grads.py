"""K7 (``ops/cuda/fused_update.py::fused_grads``): its plain twin against
the JAX Pallas ``fused_grads`` in interpret mode, and the flat Adam step of
the data-parallel route against optax.

Tolerances: grads rtol 1e-5 / atol 1e-6 and td atol 1e-6, loss and prio
rtol 1e-5: the same f32 forward/backward, whose sums over the batch rows
run in another order (the JAX package holds the Pallas kernel to
``jax.grad`` at rtol 1e-5 / atol 1e-7, tests/test_fused_update.py:178-185;
atol is 1e-6 here because two summation orders meet, not one). Adam: params
and moments rtol 1e-6 / atol 1e-6: the same elementwise f32 update, whose
bias corrections the port multiplies by ``1/(1-β^t)`` where optax divides by
``1-β^t`` (a rounding of the last bit of ``lr · m̂/(√v̂+ε)``, ~1e-7 here).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.train_step import make_optimizer  # noqa: E402
from deepqlearning_tpu.ops.pallas.fused_update import (  # noqa: E402
    fused_grads as j_fused_grads, plan_for as j_plan_for)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda import fused_update  # noqa: E402
from deepqlearning_tpu_torch.ops.helpers import flatten  # noqa: E402

torch.set_num_threads(2)
OBS, A = 5, 4
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)


def _nets(dueling):
    jc = dq.Chain(dq.Flatten(), dq.Dense(OBS, 16, jnp.tanh),
                  dq.Dense(16, 16, jax.nn.relu), dq.Dense(16, A))
    tc = dt.Chain(dt.Flatten(), dt.Dense(OBS, 16, torch.tanh),
                  dt.Dense(16, 16, torch.relu), dt.Dense(16, A))
    if dueling:
        return dq.create_dueling_network(jc), dt.create_dueling_network(tc)
    return jc, tc


def _inputs(B, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    return dict(obs_s=f(B, OBS), obs_sp=f(B, OBS),
                action=rng.integers(0, A, B).astype(np.int32),
                reward=f(B), done=(rng.random(B) < 0.2).astype(np.float32),
                weights=(rng.random(B) + 0.5).astype(np.float32),
                q_sp_tgt=f(B, A))


@pytest.mark.parametrize("B", [16, 20])
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("dueling", [True, False])
def test_twin_matches_jax_fused_grads(dueling, double_q, B):
    """B = 20 is not a multiple of the kernel's 16-row tile."""
    jnet, tnet = _nets(dueling)
    jparams = jnet.init(jax.random.PRNGKey(1))
    x = _inputs(B)
    kw = dict(gamma=0.95, double_q=double_q, alpha=0.6, eps=1e-3)
    jg, jtd, jprio, jloss, jgn = j_fused_grads(
        jnet, j_plan_for(jnet), jparams,
        *(jnp.asarray(v) for v in x.values()), interpret=True, **kw)
    params = convert.params_from_numpy(tnet, np_(jparams))
    plan = fused_update.plan_for(tnet)
    grads, td, prio, loss, gn = fused_update.fused_grads(
        plan, params, *(torch.from_numpy(v) for v in x.values()), **kw)
    ref = convert._as_dict(tnet, np_(jg), "cpu")
    assert ref.keys() == grads.keys() == set(plan.names)
    for k in ref:
        np.testing.assert_allclose(grads[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(td.numpy(), np.asarray(jtd), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(prio.numpy(), np.asarray(jprio), rtol=1e-5)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-5)


def test_flat_layout_follows_plan_names():
    """The flat gradient is every tensor raveled, in ``plan.names`` order
    (the kernels' packed layout ``w0, b0, w1, b1, ...``), and ``fused_grads``
    returns views of it."""
    _, tnet = _nets(True)
    params = tnet.init(torch.Generator().manual_seed(3))
    plan = fused_update.plan_for(tnet)
    x = {k: torch.from_numpy(v) for k, v in _inputs(16, 1).items()}
    kw = dict(gamma=0.9, double_q=True, alpha=0.6, eps=1e-3)
    flat, *_ = fused_update.fused_grads_plain(plan, params, *x.values(),
                                              **kw)
    grads, *_ = fused_update.fused_grads(plan, params, *x.values(), **kw)
    d = plan.desc()
    assert flat.shape == (d.n_params,)
    off = 0
    for l, lp in enumerate(plan.layers):
        assert (d.off_w[l], d.off_b[l]) == (off, off + lp.din * lp.dout)
        for name in (lp.w_name, lp.b_name):
            n = params[name].numel()
            assert torch.equal(flat[off:off + n], grads[name].reshape(-1))
            assert grads[name].shape == params[name].shape
            off += n
    assert off == d.n_params


@pytest.mark.parametrize("dueling", [True, False])
def test_flat_adam_matches_optax(dueling):
    """Two Adam steps from flat gradients (``adam_flat_plain``, the Adam of
    the data-parallel update's twin, ``u`` = 0 and 1 on one count) against
    the JAX package's ``optax.flatten(adam)``, starting from a JAX state
    read through ``convert.adam_from_optax``."""
    jnet, tnet = _nets(dueling)
    jparams = jnet.init(jax.random.PRNGKey(2))
    opt = make_optimizer(1e-2)
    jstate = opt.init(jparams)
    rng = np.random.default_rng(4)
    rand_like = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), t)
    # one JAX step first, so the moments and the count are not zero
    upd, jstate = opt.update(rand_like(jparams), jstate, jparams)
    jparams = optax.apply_updates(jparams, upd)
    params = convert._as_dict(tnet, np_(jparams), "cpu")
    st = convert.adam_from_optax(np_(jparams), np_(jstate))
    assert int(st.count) == 1
    plan = fused_update.plan_for(tnet)
    for u in range(2):
        g = rand_like(jparams)
        upd, jstate = opt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        flat = flatten(convert._as_dict(tnet, np_(g), "cpu"), plan.names)
        gn = fused_update.adam_flat_plain(plan.names, params, st.m, st.v,
                                          st.count, flat, u=u, lr=1e-2)
        assert float(gn) == float(flat.abs().max())
    st.count.add_(2)
    ref = convert.adam_from_optax(np_(jparams), np_(jstate))
    assert int(st.count) == int(ref.count) == 3
    want = convert._as_dict(tnet, np_(jparams), "cpu")
    for ours, theirs in ((params, want), (st.m, ref.m), (st.v, ref.v)):
        for k in plan.names:
            np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_shape_mismatch_raises():
    _, tnet = _nets(False)
    plan = fused_update.plan_for(tnet)
    params = tnet.init(torch.Generator().manual_seed(0))
    x = {k: torch.from_numpy(v) for k, v in _inputs(16).items()}
    x["q_sp_tgt"] = x["q_sp_tgt"][:, :3]
    with pytest.raises(ValueError, match="q_sp_tgt"):
        fused_update.fused_grads(plan, params, *x.values(), gamma=0.9,
                                 double_q=False, alpha=0.6, eps=1e-3)


@pytest.mark.parametrize("double_q", [True, False])
def test_dp_group_update_with_identity_reduce_is_k3(double_q):
    """``fused_dp_group_update`` (its twin) with a reduce that leaves the
    gradient as it is makes exactly the U sub-updates of K3's twin: the same
    gradients, Adam steps and outputs, bit for bit; ``reduce`` sees each
    sub-update's flat gradient once."""
    _, tnet = _nets(True)
    params = tnet.init(torch.Generator().manual_seed(6))
    plan = fused_update.plan_for(tnet)
    U, B = 3, 20
    rng = np.random.default_rng(7)
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    x = dict(obs=f(U * B, OBS), nobs=f(U * B, OBS),
             action=torch.from_numpy(rng.integers(0, A, U * B)),
             reward=f(U * B), done=(f(U * B) > 1.0).float(),
             weights=f(U * B).abs() + 0.5, q_sp_tgt=f(U * B, A))
    kw = dict(gamma=0.9, double_q=double_q, lr=1e-2, alpha=0.6, eps=1e-3,
              batch_size=B, n_updates=U)
    state = lambda: ({k: t.clone() for k, t in params.items()},
                     {k: torch.zeros_like(t) for k, t in params.items()},
                     {k: torch.zeros_like(t) for k, t in params.items()},
                     torch.tensor(2, dtype=torch.int32))
    seen = []
    dp, k3 = state(), state()
    out = fused_update.fused_dp_group_update(
        plan, *dp, *x.values(), reduce=seen.append, **kw)
    ref = fused_update.fused_group_update(plan, *k3, *x.values(), **kw)
    assert len(seen) == U and seen[0].shape == (plan.desc().n_params,)
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    for i in range(3):
        for k in plan.names:
            assert torch.equal(dp[i][k], k3[i][k]), k
    assert int(dp[3]) == int(k3[3]) == 2 + U


@pytest.mark.parametrize("B", [16, 18])
@pytest.mark.parametrize("dueling", [True, False])
def test_k7_flat_gradient_is_the_tile_order_sum(dueling, B):
    """K7 and K3 share one scratch layout, ``[ceil(B/TILE), n_params]``
    indexed by tile, and one reduce: the tile partials summed in tile
    order. That sum (the tiled reference's gradient) is K7's flat gradient
    within the f32 reordering tolerance of the module docstring."""
    _, tnet = _nets(dueling)
    plan = fused_update.plan_for(tnet)
    params = tnet.init(torch.Generator().manual_seed(9))
    x = {k: torch.from_numpy(v) for k, v in _inputs(B, seed=4).items()}
    pg, pl = fused_update.partials(plan, B, "cpu")
    nt = -(-B // fused_update.TILE)
    assert tuple(pg.shape) == (nt, plan.desc().n_params)
    assert tuple(pl.shape) == (nt,)
    parts, td, _, loss = fused_update._fwd_bwd(
        plan, params, x["obs_s"], x["obs_sp"], x["action"].long(),
        x["reward"], x["done"], x["weights"], x["q_sp_tgt"], 0.9, True, 0.6,
        1e-3, tile=fused_update.TILE)
    tiled = fused_update._tile_order_sum(torch.cat(
        [parts[k].reshape(nt, -1) for k in plan.names], dim=1))
    assert tiled.shape == pg.shape[1:]
    flat, td7, _, loss7, gn7 = fused_update.fused_grads_plain(
        plan, params, **x, gamma=0.9, double_q=True, alpha=0.6, eps=1e-3)
    np.testing.assert_allclose(tiled.numpy(), flat.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(loss), float(loss7), rtol=1e-5)
    assert torch.equal(td, td7)
    np.testing.assert_allclose(float(tiled.abs().max()), float(gn7),
                               rtol=1e-5)
