"""Port parity: LSTM/GRU cells, recurrent Chains and dueling recurrent bases.

Weights made by the JAX package move through ``convert``; inputs and states
are made with numpy from a seed. Tolerance rtol/atol 1e-5: the same f32
gate math, with matrix products summed in other orders.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.models.chain import GRU as JGRU, LSTM as JLSTM  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402

torch.set_num_threads(2)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
TOL = dict(rtol=1e-5, atol=1e-5)


def _nets(kind):
    """(JAX net, port net) of the same structure."""
    if kind == "lstm":
        return (dq.Chain(JLSTM(3, 8), dq.Dense(8, 4)),
                dt.Chain(dt.LSTM(3, 8), dt.Dense(8, 4)))
    if kind == "gru":
        return (dq.Chain(dq.Flatten(), JGRU(3, 8), dq.Dense(8, 5, jnp.tanh),
                         dq.Dense(5, 4)),
                dt.Chain(dt.Flatten(), dt.GRU(3, 8), dt.Dense(8, 5, torch.tanh),
                         dt.Dense(5, 4)))
    if kind == "deep":
        return (dq.Chain(dq.Dense(3, 6, jax.nn.relu), JLSTM(6, 8),
                         dq.Dense(8, 4)),
                dt.Chain(dt.Dense(3, 6, torch.relu), dt.LSTM(6, 8),
                         dt.Dense(8, 4)))
    jd, td = _nets("deep" if kind == "dueling_lstm" else "gru")
    return dq.create_dueling_network(jd), dt.create_dueling_network(td)


def _state_pair(jnet, B, rng):
    """Random nonzero states for both packages (the JAX pytree and the
    port's tuples)."""
    jstate = jax.tree_util.tree_map(
        lambda z: jnp.asarray(rng.normal(size=z.shape).astype(np.float32)),
        jnet.init_state(B))
    return jstate, convert.net_state_from_numpy(np_(jstate))


KINDS = ["lstm", "gru", "deep", "dueling_lstm", "dueling_gru"]


@pytest.mark.parametrize("kind", KINDS)
def test_apply_and_apply_sequence_match_jax(kind):
    jnet, tnet = _nets(kind)
    assert tnet.recurrent and jnet.recurrent
    jparams = jnet.init(jax.random.PRNGKey(0))
    params = convert.params_from_numpy(tnet, np_(jparams))
    rng = np.random.default_rng(1)
    B, T = 5, 4
    x = rng.normal(size=(B, 3)).astype(np.float32)
    xs = rng.normal(size=(T, B, 3)).astype(np.float32)
    jstate, tstate = _state_pair(jnet, B, rng)

    jq, jns = jnet.apply(jparams, jnp.asarray(x), jstate)
    tq, tns = tnet.apply(params, torch.tensor(x), tstate)
    np.testing.assert_allclose(tq.detach().numpy(), np.asarray(jq), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(tns),
                    jax.tree_util.tree_leaves(jns)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)

    jys, jss = jnet.apply_sequence(jparams, jnp.asarray(xs), jstate)
    tys, tss = tnet.apply_sequence(params, torch.tensor(xs), tstate)
    assert tuple(tys.shape) == (T, B, 4)
    np.testing.assert_allclose(tys.detach().numpy(), np.asarray(jys), **TOL)
    for a, b in zip(jax.tree_util.tree_leaves(tss),
                    jax.tree_util.tree_leaves(jss)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b), **TOL)

    # the hoisted-projection unroll equals T single steps
    s = tstate
    for t in range(T):
        y, s = tnet.apply(params, torch.tensor(xs[t]), s)
        np.testing.assert_allclose(y.detach().numpy(),
                                   tys[t].detach().numpy(), **TOL)


@pytest.mark.parametrize("kind", KINDS)
def test_params_and_state_round_trip(kind):
    jnet, tnet = _nets(kind)
    jparams = np_(jnet.init(jax.random.PRNGKey(3)))
    params = convert.params_from_numpy(tnet, jparams)
    back = convert.params_to_numpy(tnet, params)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jparams)):
        np.testing.assert_array_equal(a, b)
    # init_state: the JAX structure (one entry per layer), zeros
    jst = np_(jnet.init_state(6))
    tst = tnet.init_state(6)
    assert jax.tree_util.tree_structure(jst) == \
        jax.tree_util.tree_structure(
            jax.tree_util.tree_map(lambda t: t.numpy(), tst))
    for a in jax.tree_util.tree_leaves(jax.tree_util.tree_map(
            lambda t: t.numpy(), tst)):
        assert a.shape == (6, 8) and not a.any()


def test_lstm_init_forget_bias_and_glorot():
    cell = dt.LSTM(3, 8)
    cell.reset_parameters(torch.Generator().manual_seed(0))
    b = cell.b.detach().numpy()
    np.testing.assert_array_equal(b[8:16], 1.0)   # forget gate (i,f,g,o)
    np.testing.assert_array_equal(np.delete(b, np.s_[8:16]), 0.0)
    jb = np.asarray(JLSTM(3, 8).init(jax.random.PRNGKey(0))["b"])
    np.testing.assert_array_equal(b, jb)
    gru = dt.GRU(3, 8)
    gru.reset_parameters(torch.Generator().manual_seed(0))
    assert not gru.b.detach().numpy().any()
    for w, shape in ((cell.wi, (3, 32)), (cell.wh, (8, 32)),
                     (gru.wi, (3, 24)), (gru.wh, (8, 24))):
        assert tuple(w.shape) == shape
        lim = np.sqrt(6.0 / sum(shape))
        assert np.abs(w.detach().numpy()).max() <= lim


def test_recurrent_chain_requires_explicit_state():
    net = dt.Chain(dt.LSTM(2, 4), dt.Dense(4, 2))
    params = net.init()
    with pytest.raises(ValueError, match="requires explicit state"):
        net.apply(params, torch.zeros(3, 2))
    with pytest.raises(ValueError, match="requires explicit state"):
        dq.Chain(JLSTM(2, 4), dq.Dense(4, 2)).apply(
            dq.Chain(JLSTM(2, 4), dq.Dense(4, 2)).init(jax.random.PRNGKey(0)),
            jnp.zeros((3, 2)))
    # feed-forward nets keep their stateless apply
    ff = dt.Chain(dt.Dense(2, 3))
    y, s = ff.apply(ff.init(), torch.zeros(4, 2))
    assert s == () and not ff.recurrent
    assert dt.isrecurrent(net) and not dt.isrecurrent(ff)


def test_dueling_recurrent_split_and_out_dim():
    _, tnet = _nets("dueling_gru")
    assert isinstance(tnet, dt.DuelingNetwork) and tnet.recurrent
    assert [type(l).__name__ for l in tnet.base.layers] == ["Flatten", "GRU"]
    assert tnet.out_dim == 4
    assert dt.Chain(dt.LSTM(2, 7)).out_dim == 7
    assert dt.Chain(dt.GRU(2, 5)).out_dim == 5
