"""K8 (``ops/cuda/fused_drqn.py::fused_drqn_grads``): its plain twin (the
autograd ``_drqn_grads``) against the JAX Pallas ``fused_drqn_grads`` in
interpret mode, the flat gradient's layout, and the flat Adam step of the
data-parallel route against optax.

Tolerances: grads rtol 1e-5 / atol 1e-6, loss and gnorm rtol 1e-5: the
same f32 unrolls and BPTT, summed over windows and time in another order
(the JAX package holds the Pallas kernel to ``jax.grad`` at rtol 1e-5 /
atol 1e-7, tests/test_fused_drqn.py:254-259; atol is 1e-6 here because two
summation orders meet). Adam: rtol 1e-6 / atol 1e-6, as in
test_torch_fused_grads.py.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import optax  # noqa: E402

from deepqlearning_tpu.learner.train_step import make_optimizer  # noqa: E402
from deepqlearning_tpu.ops.pallas.fused_drqn import (  # noqa: E402
    drqn_plan_for as j_drqn_plan_for, fused_drqn_grads as j_fused_drqn_grads)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda import fused_drqn  # noqa: E402
from deepqlearning_tpu_torch.ops.helpers import flatten  # noqa: E402

from test_torch_drqn_train_step import A, OBS, nets, np_  # noqa: E402

torch.set_num_threads(2)
B, T = 12, 5


def _inputs(seed=0, B=B):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    lens = rng.integers(1, T + 1, B)  # ragged valid prefixes
    return dict(obs=f(B, T, OBS), nobs=f(B, T, OBS),
                action=rng.integers(0, A, (B, T)).astype(np.int32),
                reward=f(B, T),
                done=(rng.random((B, T)) < 0.2).astype(np.float32),
                mask=(np.arange(T)[None] < lens[:, None]).astype(np.float32),
                q_sp_tgt=f(B, T, A))


@pytest.mark.parametrize("kind,double_q", [("plain", True), ("plain", False),
                                           ("gru_dueling", True)])
def test_twin_matches_jax_fused_drqn_grads(kind, double_q):
    """LSTM (double-Q and max targets) and the dueling GRU net with a Dense
    layer before the cell."""
    jnet, tnet = nets(kind)
    assert j_drqn_plan_for(jnet, T, B, double_q) is not None
    jparams = jnet.init(jax.random.PRNGKey(1))
    x = _inputs()
    jg, jloss, jgn = j_fused_drqn_grads(
        jnet, j_drqn_plan_for(jnet, T, B, double_q), jparams,
        *(jnp.asarray(v) for v in x.values()), gamma=0.95,
        double_q=double_q, interpret=True)
    params = convert.params_from_numpy(tnet, np_(jparams))
    plan = fused_drqn.drqn_plan_for(tnet, T, B, double_q)
    grads, loss, gn = fused_drqn.fused_drqn_grads(
        plan, params, *(torch.from_numpy(v) for v in x.values()),
        gamma=0.95, double_q=double_q)
    ref = convert._as_dict(tnet, np_(jg), "cpu")
    assert ref.keys() == grads.keys() == set(plan.names)
    for k in ref:
        np.testing.assert_allclose(grads[k].numpy(), ref[k].numpy(),
                                   rtol=1e-5, atol=1e-6, err_msg=k)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-5)


def test_flat_layout_follows_plan_names():
    """The flat gradient is each tensor raveled in ``plan.names`` order,
    which is the kernels' packed order (``DrqnDesc.t_off``): the Dense
    layers' w, b, then the cell's wi, wh, b."""
    _, tnet = nets("gru_dueling")
    params = tnet.init()
    plan = fused_drqn.drqn_plan_for(tnet, T, B, True)
    x = {k: torch.from_numpy(v) for k, v in _inputs(2).items()}
    flat, _, gn = fused_drqn.fused_drqn_grads_plain(
        plan, params, *x.values(), gamma=0.9, double_q=True)
    grads, _, _ = fused_drqn.fused_drqn_grads(
        plan, params, *x.values(), gamma=0.9, double_q=True)
    d = plan.desc(T)
    assert flat.shape == (d.n_params,) and d.n_tensors == len(plan.names)
    for k, name in enumerate(plan.names):
        n = params[name].numel()
        assert d.t_size[k] == n
        assert torch.equal(flat[d.t_off[k]:d.t_off[k] + n],
                           grads[name].reshape(-1))
    assert float(gn) == float(flat.abs().max())


def test_flat_adam_matches_optax():
    """Two steps of ``adam_flat_plain`` (the Adam of the data-parallel
    update's twin) against the JAX package's ``optax.flatten(adam)`` from a
    nonzero state."""
    jnet, tnet = nets("plain")
    jparams = jnet.init(jax.random.PRNGKey(3))
    opt = make_optimizer(1e-2)
    rng = np.random.default_rng(5)
    rand_like = lambda t: jax.tree_util.tree_map(
        lambda x: jnp.asarray(rng.normal(size=x.shape).astype(np.float32)), t)
    upd, jstate = opt.update(rand_like(jparams), opt.init(jparams), jparams)
    jparams = optax.apply_updates(jparams, upd)
    params = convert._as_dict(tnet, np_(jparams), "cpu")
    st = convert.adam_from_optax(np_(jparams), np_(jstate))
    plan = fused_drqn.drqn_plan_for(tnet, T, B, True)
    for u in range(2):
        g = rand_like(jparams)
        upd, jstate = opt.update(g, jstate, jparams)
        jparams = optax.apply_updates(jparams, upd)
        flat = flatten(convert._as_dict(tnet, np_(g), "cpu"), plan.names)
        fused_drqn.adam_flat_plain(plan.names, params, st.m, st.v, st.count,
                                   flat, u=u, lr=1e-2)
    st.count.add_(2)
    ref = convert.adam_from_optax(np_(jparams), np_(jstate))
    assert int(st.count) == int(ref.count) == 3
    want = convert._as_dict(tnet, np_(jparams), "cpu")
    for ours, theirs in ((params, want), (st.m, ref.m), (st.v, ref.v)):
        for k in plan.names:
            np.testing.assert_allclose(ours[k].numpy(), theirs[k].numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=k)


def test_shape_mismatch_raises():
    _, tnet = nets("plain")
    plan = fused_drqn.drqn_plan_for(tnet, T, B, True)
    x = {k: torch.from_numpy(v) for k, v in _inputs().items()}
    x["mask"] = x["mask"][:, :T - 1]
    with pytest.raises(ValueError, match="mask"):
        fused_drqn.fused_drqn_grads(plan, tnet.init(), *x.values(),
                                    gamma=0.9, double_q=True)


def test_dp_group_update_with_identity_reduce_is_k5():
    """``fused_drqn_dp_group_update`` (its twin) with a reduce that leaves
    the gradient as it is makes exactly the U sub-updates of K5's twin, bit
    for bit."""
    _, tnet = nets("gru_dueling")
    params = tnet.init()
    plan = fused_drqn.drqn_plan_for(tnet, T, B, True)
    U = 2
    a, b = _inputs(3), _inputs(4)
    x = {k: torch.from_numpy(np.concatenate([a[k], b[k]])) for k in a}
    kw = dict(gamma=0.9, double_q=True, lr=1e-2, batch_size=B, n_updates=U)
    state = lambda: ({k: t.clone() for k, t in params.items()},
                     {k: torch.zeros_like(t) for k, t in params.items()},
                     {k: torch.zeros_like(t) for k, t in params.items()},
                     torch.tensor(0, dtype=torch.int32))
    seen = []
    dp, k5 = state(), state()
    out = fused_drqn.fused_drqn_dp_group_update(
        plan, *dp, *x.values(), reduce=seen.append, **kw)
    ref = fused_drqn.fused_drqn_group_update(plan, *k5, *x.values(), **kw)
    assert len(seen) == U
    for a, b in zip(out, ref):
        assert torch.equal(a, b)
    for i in range(3):
        for k in plan.names:
            assert torch.equal(dp[i][k], k5[i][k]), k
    assert int(dp[3]) == int(k5[3]) == U


@pytest.mark.parametrize("kind,double_q,Bt", [("plain", True, 10),
                                              ("gru_dueling", False, 12)])
def test_tiled_reference_matches_jax_fused_drqn_grads(kind, double_q, Bt):
    """K8's tile-order reference (the kernel's sum order; the last tile
    ragged at B = 10) against the JAX ``fused_drqn_grads`` in interpret
    mode, at the twin's tolerances."""
    jnet, tnet = nets(kind)
    jparams = jnet.init(jax.random.PRNGKey(2))
    x = _inputs(6, Bt)
    jg, jloss, jgn = j_fused_drqn_grads(
        jnet, j_drqn_plan_for(jnet, T, Bt, double_q), jparams,
        *(jnp.asarray(v) for v in x.values()), gamma=0.95,
        double_q=double_q, interpret=True)
    params = convert.params_from_numpy(tnet, np_(jparams))
    plan = fused_drqn.drqn_plan_for(tnet, T, Bt, double_q)
    flat, loss, gn = fused_drqn.fused_drqn_grads_tiled(
        plan, params, *(torch.from_numpy(v) for v in x.values()),
        gamma=0.95, double_q=double_q)
    ref = flatten(convert._as_dict(tnet, np_(jg), "cpu"), plan.names)
    np.testing.assert_allclose(flat.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    np.testing.assert_allclose(float(gn), float(jgn), rtol=1e-5)


def test_dp_update_on_tiled_grads_is_tiled_k5():
    """The data-parallel update's arithmetic on the tile-order references:
    K8's reference, an identity reduce and the flat Adam make exactly the
    U sub-updates of K5's reference, bit for bit, as K8, the reduce and the
    Adam launch do K5's on the card."""
    _, tnet = nets("plain")
    params = tnet.init()
    plan = fused_drqn.drqn_plan_for(tnet, T, 10, True)
    U, Bt = 2, 10
    a, b = _inputs(3, Bt), _inputs(4, Bt)
    x = {k: torch.from_numpy(np.concatenate([a[k], b[k]])) for k in a}
    kw = dict(gamma=0.9, double_q=True)
    state = lambda: ({k: t.clone() for k, t in params.items()},
                     {k: torch.zeros_like(t) for k, t in params.items()},
                     {k: torch.zeros_like(t) for k, t in params.items()},
                     torch.tensor(0, dtype=torch.int32))
    dp, k5 = state(), state()
    for u in range(U):
        sl = slice(u * Bt, (u + 1) * Bt)
        flat, loss, _ = fused_drqn.fused_drqn_grads_tiled(
            plan, dp[0], *(v[sl] for v in x.values()), **kw)
        gn = fused_drqn.adam_flat_plain(plan.names, *dp, flat, u=u, lr=1e-2)
    dp[3].add_(U)
    rl, rg = fused_drqn.fused_drqn_group_update_tiled(
        plan, *k5, *x.values(), lr=1e-2, batch_size=Bt, n_updates=U, **kw)
    assert torch.equal(loss, rl) and torch.equal(gn, rg)
    for i in range(3):
        for k in plan.names:
            assert torch.equal(dp[i][k], k5[i][k]), k
    assert int(dp[3]) == int(k5[3]) == U
