"""Port parity: config, parameter conversion, Chain/dueling networks.

Inputs are made with numpy from a seed and fed to the JAX package and to
``deepqlearning_tpu_torch``; weights move through ``convert``.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402

torch.set_num_threads(2)


def test_config_defaults_match_jax():
    jf = {f.name: f.default for f in dataclasses.fields(dq.DQNConfig)}
    tf = {f.name: f.default for f in dataclasses.fields(dt.DQNConfig)}
    assert jf.keys() == tf.keys()
    for k in jf:
        if k != "dtype":
            assert jf[k] == tf[k], k
    assert dt.DQNConfig().dtype == torch.float32
    assert dt.DQNConfig(dtype="float32").dtype == torch.float32


@pytest.mark.parametrize("num_envs,train_freq", [(1, 4), (128, 32), (4, 4096),
                                                 (131072, 4096)])
def test_config_derived_sizes_match_jax(num_envs, train_freq):
    j = dq.DQNConfig(num_envs=num_envs, train_freq=train_freq)
    t = dt.DQNConfig(num_envs=num_envs, train_freq=train_freq)
    assert (t.steps_per_iter, t.updates_per_iter, t.env_steps_per_iter) == (
        j.steps_per_iter, j.updates_per_iter, j.env_steps_per_iter)


def test_config_nesting_error():
    with pytest.raises(ValueError, match="divide one another"):
        dq.DQNConfig(num_envs=3, train_freq=4)
    with pytest.raises(ValueError, match="divide one another"):
        dt.DQNConfig(num_envs=3, train_freq=4)


def _nets(dueling, act="tanh"):
    ja = {"tanh": jnp.tanh, "relu": jax.nn.relu}[act]
    ta = {"tanh": torch.tanh, "relu": torch.relu}[act]
    jc = dq.Chain(dq.Flatten(), dq.Dense(2, 16, ja), dq.Dense(16, 16, ja),
                  dq.Dense(16, 4))
    tc = dt.Chain(dt.Flatten(), dt.Dense(2, 16, ta), dt.Dense(16, 16, ta),
                  dt.Dense(16, 4))
    if dueling:
        return dq.create_dueling_network(jc), dt.create_dueling_network(tc)
    return jc, tc


@pytest.mark.parametrize("dueling", [True, False])
def test_convert_round_trip(dueling):
    jnet, tnet = _nets(dueling)
    jp = jax.tree_util.tree_map(np.asarray, jnet.init(jax.random.PRNGKey(3)))
    params = convert.params_from_numpy(tnet, jp)
    back = convert.params_to_numpy(tnet, params)
    assert jax.tree_util.tree_structure(back) == \
        jax.tree_util.tree_structure(jp)
    for a, b in zip(jax.tree_util.tree_leaves(back),
                    jax.tree_util.tree_leaves(jp)):
        np.testing.assert_array_equal(a, b)
    # the module's own parameters now hold the JAX weights too
    for k, p in tnet.named_parameters():
        assert torch.equal(p.detach(), params[k])


@pytest.mark.parametrize("act", ["tanh", "relu"])
@pytest.mark.parametrize("dueling", [True, False])
def test_forward_matches_network_apply(dueling, act):
    jnet, tnet = _nets(dueling, act)
    jp = jnet.init(jax.random.PRNGKey(1))
    params = convert.params_from_numpy(
        tnet, jax.tree_util.tree_map(np.asarray, jp))
    x = np.random.default_rng(0).normal(size=(64, 2)).astype(np.float32)
    qj, _ = jnet.apply(jp, jnp.asarray(x))
    qt, state = tnet.apply(params, torch.from_numpy(x))
    assert state == ()
    # f32 matmuls summed in different orders (XLA vs ATen): rtol 1e-5
    np.testing.assert_allclose(qt.detach().numpy(), np.asarray(qj),
                               rtol=1e-5, atol=1e-6)
    # the module's own forward gives the same values
    np.testing.assert_allclose(tnet(torch.from_numpy(x)).detach().numpy(),
                               qt.detach().numpy(), rtol=0, atol=0)


def test_init_is_seeded_and_in_range():
    _, tnet = _nets(True)
    a = {k: v.clone() for k, v in tnet.init(torch.Generator().manual_seed(5)).items()}
    b = tnet.init(torch.Generator().manual_seed(5))
    for k in a:
        assert torch.equal(a[k], b[k])
    w = b["adv.layers.1.w"]
    limit = np.sqrt(6.0 / (2 + 16))
    assert float(w.abs().max()) <= limit and float(w.std()) > 0.1 * limit
    assert float(b["adv.layers.1.b"].abs().max()) == 0.0


def test_dueling_heads_do_not_share_parameters():
    _, tnet = _nets(True)
    names = [k for k, _ in tnet.named_parameters()]
    assert len(names) == 12 and len(set(map(id, tnet.parameters()))) == 12
    assert tnet.val.layers[-1].out_dim == 1 and tnet.out_dim == 4


def test_create_dueling_network_error_case():
    with pytest.raises(ValueError, match="incompatible with dueling"):
        dq.create_dueling_network(dq.Chain(dq.Dense(2, 4), dq.Flatten()))
    with pytest.raises(ValueError, match="incompatible with dueling"):
        dt.create_dueling_network(dt.Chain(dt.Dense(2, 4), dt.Flatten()))
    with pytest.raises(TypeError):
        dt.create_dueling_network("not a chain")


def test_adam_and_replay_state_from_numpy():
    from deepqlearning_tpu.learner.train_step import FusedAdamState

    jnet, tnet = _nets(True)
    jp = jnet.init(jax.random.PRNGKey(0))
    m = jax.tree_util.tree_map(lambda x: x + 1.0, jp)
    v = jax.tree_util.tree_map(lambda x: x * x, jp)
    st = FusedAdamState(m=m, v=v, count=jnp.asarray(7, jnp.int32))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    adam = convert.adam_from_numpy(tnet, np_(st.m), np_(st.v), st.count)
    assert int(adam.count) == 7 and adam.count.dtype == torch.int32
    for ours, theirs in ((adam.m, m), (adam.v, v)):
        back = convert.params_to_numpy(tnet, ours)
        for a, b in zip(jax.tree_util.tree_leaves(back),
                        jax.tree_util.tree_leaves(np_(theirs))):
            np.testing.assert_array_equal(a, b)

    jb = dq.PrioritizedReplayBuffer((2,), 128, 8)
    rng = np.random.default_rng(0)
    js = jb.insert(jb.init(), dq.TransitionBatch(
        jnp.asarray(rng.normal(size=(64, 2)), jnp.float32),
        jnp.arange(64, dtype=jnp.int32) % 4,
        jnp.asarray(rng.normal(size=64), jnp.float32),
        jnp.asarray(rng.normal(size=(64, 2)), jnp.float32),
        jnp.zeros(64)))
    rs = convert.replay_from_numpy(np_(js.rows), np_(js.tree),
                                   js.insert_pos, js.size)
    assert (rs.insert_pos, rs.size) == (64, 64)
    for a, b in zip((rs.rows,) + rs.tree, (js.rows,) + tuple(js.tree)):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the port's buffer samples from the converted state
    tb = dt.PrioritizedReplayBuffer((2,), 128, 8, device="cpu")
    batch, idx, w = tb.sample(rs, u=torch.rand(8))
    assert (idx < 64).all() and torch.isfinite(w).all()


@pytest.mark.parametrize("t", [0, 1, 777, 4999, 5000, 123456, 1 << 30])
def test_schedules_match_jax_in_f32(t):
    """ε(t) is compared against uniforms in f32 on both sides: equal bits."""
    j = dq.LinearDecaySchedule(1.0, 0.05, 5000)(jnp.asarray(t, jnp.int32))
    assert np.float32(dt.LinearDecaySchedule(1.0, 0.05, 5000)(t)) == \
        np.float32(j)
    assert np.float32(dt.ConstantEpsilon(0.1)(t)) == \
        np.float32(dq.ConstantEpsilon(0.1)(t))


def test_epsilon_greedy_select():
    sel = dt.epsilon_greedy_select(dt.ConstantEpsilon(0.0))
    q = torch.tensor([[0.0, 2.0, 2.0, 1.0], [3.0, 0.0, 0.0, 0.0]])
    a, eps = sel(q, 0, torch.Generator().manual_seed(0))
    assert a.tolist() == [1, 0] and eps == 0.0  # first-max greedy
    sel = dt.epsilon_greedy_select(dt.ConstantEpsilon(1.0))
    a, _ = sel(torch.zeros(4000, 4), 0, torch.Generator().manual_seed(0))
    counts = np.bincount(a.numpy(), minlength=4)
    assert counts.min() > 800  # uniform over all actions when exploring
