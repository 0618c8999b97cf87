"""The solver layer's parts, the port against the JAX package, module by
module: exploration (ε equal in float32), TigerPOMDP (every tiger side,
action and listen outcome; the port's listen accuracy), ``NNPolicy`` with
parameters converted from JAX (rtol 1e-5), ``basic_evaluation`` on the
deterministic TestMDP (mean steps exactly, mean return to the order of an
f32 sum) and ``TBWriter`` (byte for byte).
Inputs come from numpy seeds."""
import os
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.envs.tiger import TigerState  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402

SCHEDULES = [(1.0, 0.01, 5000), (0.5, 0.1, 1), (1.0, 0.05, 7)]
STEPS = [0, 1, 3, 7, 2499, 2500, 4999, 5000, 10 ** 6]


@pytest.mark.parametrize("sched", SCHEDULES)
def test_eps_greedy_eps_equals_jax(sched):
    pj = dq.EpsGreedyPolicy(dq.LinearDecaySchedule(*sched))
    pt = dt.EpsGreedyPolicy(dt.LinearDecaySchedule(*sched))
    for t in STEPS:
        want = np.float32(pj.eps(jnp.asarray(t)))
        assert np.float32(pt.eps(t)) == want, t
        assert pt.loginfo(t) == pj.loginfo(t)
    lj = dq.linear_epsilon_greedy(1000, 0.3, 0.02)
    lt = dt.linear_epsilon_greedy(1000, 0.3, 0.02)
    for t in STEPS:
        assert np.float32(lt.eps(t)) == np.float32(lj.eps(jnp.asarray(t)))
    vt = dt.VectorizedStrategy(lambda q, t, g: None,
                               dt.LinearDecaySchedule(*sched))
    vj = dq.VectorizedStrategy(lambda q, t, k: None,
                               dq.LinearDecaySchedule(*sched))
    for t in STEPS:
        assert np.float32(vt.eps(t)) == np.float32(vj.eps(jnp.asarray(t)))
    assert dt.VectorizedStrategy(lambda q, t, g: None).eps(5) == 0.0


def test_eps_greedy_select_limits():
    q = torch.from_numpy(np.random.RandomState(0).randn(64, 4).astype(
        np.float32))
    greedy = torch.argmax(q, dim=-1)
    g = torch.Generator().manual_seed(1)
    a0, e0 = dt.epsilon_greedy_select(lambda t: 0.0)(q, 10, g)
    assert torch.equal(a0, greedy) and e0 == 0.0
    sel1 = dt.epsilon_greedy_select(lambda t: 1.0)
    seen = set()
    for _ in range(8):
        seen.update(sel1(q, 10, g)[0].tolist())
    assert seen == {0, 1, 2, 3}
    pol = dt.EpsGreedyPolicy(dt.LinearDecaySchedule(1.0, 0.0, 100))
    a, e = pol.select(q, 1_000_000, g)
    assert torch.equal(a, greedy) and e == 0.0
    # the function-valued dispatch passes its arguments through
    assert dt.exploration(lambda *a: a, 1, 2, 3, 4, 5) == (1, 2, 3, 4, 5)


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("action", [0, 1, 2])
def test_tiger_step_equals_jax(left, action):
    ej, et = dq.TigerPOMDP(), dt.TigerPOMDP()
    outcomes = set()
    for seed in range(12):
        key = jax.random.PRNGKey(seed)
        # the JAX reset's Bernoulli draw, pinned into the port's uniform
        sj, oj = ej.reset(key)
        u0 = torch.tensor([[0.0 if bool(sj.tiger_left) else 1.0]])
        st, ot = et.reset_cols(u0)
        assert float(st[0, 0]) == float(sj.tiger_left)
        np.testing.assert_array_equal(ot[0].numpy(), np.asarray(oj))
        last = float(seed % 2)
        sj = TigerState(tiger_left=jnp.asarray(left),
                        last_obs=jnp.asarray(last, jnp.float32),
                        opened=jnp.asarray(False))
        st = torch.tensor([[float(left), last, 0.0]])
        correct = bool(jax.random.bernoulli(key, ej.p_correct))
        outcomes.add(correct)
        sj2, oj2, rj, dj = ej.step(sj, jnp.asarray(action), key)
        st2, ot2, rt, d_t = et.step_cols(
            st, torch.tensor([action]),
            torch.tensor([[0.0 if correct else 1.0]]))
        assert float(rt[0]) == float(rj)
        assert float(d_t[0]) == float(dj)
        np.testing.assert_array_equal(ot2[0].numpy(), np.asarray(oj2))
        assert float(st2[0, 1]) == float(sj2.last_obs)
        assert float(st2[0, 2]) == float(sj2.opened)
    assert outcomes == {True, False}  # both listen outcomes were pinned


def test_tiger_listen_accuracy():
    env = dt.TigerPOMDP()
    g = torch.Generator().manual_seed(0)
    state, _ = env.reset_batch(100_000, g)
    state, obs, r, done = env.step_batch(
        state, torch.full((100_000,), 2), g)
    acc = float((obs[:, 0] == state[:, 0]).float().mean())
    assert abs(acc - 0.85) <= 0.005
    assert bool((r == -1.0).all()) and not bool(done.any())


def _pair(make_j, make_t, in_dim, key=0):
    nj, nt = make_j(), make_t()
    pj = nj.init(jax.random.PRNGKey(key))
    pt = convert.params_from_numpy(nt, jax.tree_util.tree_map(np.asarray,
                                                              pj))
    return nj, pj, nt, pt


NETS = {
    "dueling_mlp": (
        lambda: dq.create_dueling_network(dq.Chain(
            dq.Dense(3, 16, jnp.tanh), dq.Dense(16, 8, jnp.tanh),
            dq.Dense(8, 4))),
        lambda: dt.create_dueling_network(dt.Chain(
            dt.Dense(3, 16, torch.tanh), dt.Dense(16, 8, torch.tanh),
            dt.Dense(8, 4)))),
    "lstm": (lambda: dq.Chain(dq.LSTM(3, 8), dq.Dense(8, 4)),
             lambda: dt.Chain(dt.LSTM(3, 8), dt.Dense(8, 4))),
}


@pytest.mark.parametrize("name", sorted(NETS))
def test_nnpolicy_equals_jax(name):
    nj, pj, nt, pt = _pair(*NETS[name], 3)
    amap = ["a", "b", "c", "d"]
    polj = dq.NNPolicy(None, nj, pj, amap, 1)
    polt = dt.NNPolicy(None, nt, pt, amap, 1)
    obs = np.random.RandomState(3).randn(6, 3).astype(np.float32)
    for reset in (False, True):
        if reset:
            dq.resetstate(polj)
            dt.resetstate(polt)
        for o in obs:  # the recurrent state is carried from call to call
            st_j, st_t = polj._state, polt._state
            avj, avt = polj.actionvalues(o), polt.actionvalues(o)
            assert isinstance(avt, np.ndarray) and avt.shape == (4,)
            np.testing.assert_allclose(avt, avj, rtol=1e-5, atol=1e-6)
            # value and action from the same state as actionvalues
            polj._state, polt._state = st_j, st_t
            vj, vt = polj.value(o), polt.value(o)
            assert isinstance(vt, float)
            np.testing.assert_allclose(vt, vj, rtol=1e-5, atol=1e-6)
            polj._state, polt._state = st_j, st_t
            assert polt.action(o) == polj.action(o)
    assert dt.getnetwork(polt) is nt
    with pytest.raises(ValueError, match="NNPolicyError"):
        polt.action(np.zeros((2, 3), np.float32))


def test_nnpolicy_converts_raw_states():
    mdp = dt.TestMDP((3,), 2, 4)
    net = dt.Chain(dt.Flatten(), dt.Dense(6, mdp.num_actions))
    policy = dt.NNPolicy(mdp, net, net.init(torch.Generator().manual_seed(0)),
                         mdp.action_map, len(mdp.obs_shape))
    state, obs = mdp.reset(torch.Generator().manual_seed(1))
    assert state.dtype == torch.int32
    assert policy.action(state) == policy.action(obs)
    np.testing.assert_array_equal(policy.actionvalues(state),
                                  policy.actionvalues(obs.numpy()))


def test_basic_evaluation_equals_jax_on_testmdp():
    mj, mt = dq.TestMDP((3,), 2, 4), dt.TestMDP((3,), 2, 4)
    for key in range(3):
        nj, pj, nt, pt = _pair(
            lambda: dq.Chain(dq.Flatten(), dq.Dense(6, 8, jnp.tanh),
                             dq.Dense(8, 4)),
            lambda: dt.Chain(dt.Flatten(), dt.Dense(6, 8, torch.tanh),
                             dt.Dense(8, 4)), 6, key)
        for n_eval, max_len in ((10, 100), (7, 2), (100, 100), (3, 0)):
            rj, sj, ij = dq.basic_evaluation(nj, pj, mj, n_eval, max_len,
                                             jax.random.PRNGKey(7))
            rt, s_t, it = dt.basic_evaluation(nt, pt, mt, n_eval, max_len, 7)
            # steps exactly; the mean return to the order of its f32 sum
            # (XLA's CPU reduce adds in 4 lanes, torch in its own order):
            # n_eval roundings of 2^-24 relative at most
            assert (s_t, it) == (sj, ij)
            np.testing.assert_allclose(rt, rj, rtol=n_eval * 2.0 ** -24,
                                       atol=0)


def test_evaluation_dispatches_to_strategy():
    calls = []

    def f(*args):
        calls.append(args)
        return 1.0, 2.0, {"x": 3.0}

    assert dt.evaluation(f, "n", "p", "e", 4, 5, "g", True) == (
        1.0, 2.0, {"x": 3.0})
    assert calls == [("n", "p", "e", 4, 5, "g", True)]


def test_tb_writer_bytes_equal_jax(tmp_path, monkeypatch):
    from deepqlearning_tpu.utils.tb_writer import TBWriter as JW

    from deepqlearning_tpu_torch.utils.tb_writer import TBWriter as TW

    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
    out = {}
    for name, cls in (("jax", JW), ("port", TW)):
        w = cls(str(tmp_path / name))
        for step, (tag, v) in enumerate([("loss", 0.5), ("eval_reward", -3.25),
                                         ("eps", 1e-7), ("avg_reward", 2.1)]):
            w.log_value(tag, v, step=1000 * step + 7)
        w.close()
        (f,) = os.listdir(tmp_path / name)
        out[name] = (f, (tmp_path / name / f).read_bytes())
    assert out["port"][0] == out["jax"][0]
    assert out["port"][1] == out["jax"][1]
    assert len(out["port"][1]) > 100
