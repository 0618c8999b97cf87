"""K4 and K6 (``ops/cuda/fused_collect.py``) on CartPole and MountainCar:
their plain twins against the JAX Pallas ``fused_collect`` (host uniforms,
interpret mode) and its ``_collect_block`` body with the same uniforms, for
dueling and plain heads and LSTM/GRU cells; the gate against JAX's; each
env's uniform rows; and a small CartPole ``solve`` through the twin.

The interpret-mode kernel runs in the cases at ε = 0.3 with a dueling and a
plain head and an LSTM and a GRU cell, per env; the other cases (ε 0 and 1,
the dueling GRU head) hold the twins to ``_collect_block`` alone, the
body the kernel traces, with the same uniforms.

Tolerances: rtol/atol 1e-6 (``tests/test_fused_collect.py``'s) for the
fields, obs, env state, returns and the recurrent state; the totals sum
E terms in another order (1e-5).
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
    init_actor, make_fused_collect_step)
from deepqlearning_tpu_torch.ops.cuda import fused_collect as fc  # noqa: E402
from deepqlearning_tpu_torch.solver import solver as solver_mod  # noqa: E402

torch.set_num_threads(2)
E, MAXLEN = 256, 50
ENVS = {"cartpole": (dq.CartPole, dt.CartPole),
        "mountain_car": (dq.MountainCar, dt.MountainCar)}


def _dense(env, kind, hidden=32):
    """(JAX net, port net): a dueling or plain tanh stack on the env's obs."""
    no, A = env.obs_shape[0], env.num_actions
    jc = dq.Chain(dq.Flatten(), dq.Dense(no, hidden, jnp.tanh),
                  dq.Dense(hidden, hidden, jnp.tanh), dq.Dense(hidden, A))
    tc = dt.Chain(dt.Flatten(), dt.Dense(no, hidden, torch.tanh),
                  dt.Dense(hidden, hidden, torch.tanh), dt.Dense(hidden, A))
    if kind == "dueling":
        return dq.create_dueling_network(jc), dt.create_dueling_network(tc)
    return jc, tc


def _recurrent(env, kind):
    no, A = env.obs_shape[0], env.num_actions
    if kind == "lstm":
        return (dq.Chain(JLSTM(no, 16), dq.Dense(16, A)),
                dt.Chain(dt.LSTM(no, 16), dt.Dense(16, A)))
    if kind == "gru":
        return (dq.Chain(JGRU(no, 16), dq.Dense(16, 32, jnp.tanh),
                         dq.Dense(32, A)),
                dt.Chain(dt.GRU(no, 16), dt.Dense(16, 32, torch.tanh),
                         dt.Dense(32, A)))
    return (JDuel(dq.Chain(JGRU(no, 16)),
                  dq.Chain(dq.Dense(16, 32, jnp.tanh), dq.Dense(32, 1)),
                  dq.Chain(dq.Dense(16, 32, jnp.tanh), dq.Dense(32, A))),
            dt.DuelingNetwork(dt.Chain(dt.GRU(no, 16)),
                              dt.Chain(dt.Dense(16, 32, torch.tanh),
                                       dt.Dense(32, 1)),
                              dt.Chain(dt.Dense(16, 32, torch.tanh),
                                       dt.Dense(32, A))))


def _states(name, rng):
    """Cols ``[W, E]``: spread so that many steps end their episode."""
    if name == "cartpole":
        return np.stack([rng.uniform(-2.5, 2.5, E), rng.normal(0, 1, E),
                         rng.uniform(-0.22, 0.22, E),
                         rng.normal(0, 1, E)]).astype(np.float32)
    return np.stack([rng.uniform(-1.2, 0.55, E),
                     rng.uniform(-0.07, 0.07, E)]).astype(np.float32)


def _run_both(name, jnet, tnet, eps, recurrent, pallas):
    jenv, tenv = ENVS[name][0](), ENVS[name][1]()
    jplan = j_collect_plan_for(jenv, jnet, None)
    tplan = fc.collect_plan_for(tenv, tnet, None)
    assert jplan is not None and tplan is not None
    assert (tplan.cell is None) == (jplan.cell is None) == (not recurrent)
    assert tplan.n_uniforms == 2 + jplan.ns + jplan.nr
    key = jax.random.PRNGKey(3)
    jparams = jnet.init(key)
    params = convert.params_from_numpy(
        tnet, jax.tree_util.tree_map(np.asarray, jparams))
    rng = np.random.default_rng(4)
    cols = _states(name, rng)
    ep_step = rng.integers(0, MAXLEN, E).astype(np.float32)
    ep_ret = rng.normal(size=E).astype(np.float32)
    obs_t = jnp.pad(jnp.asarray(cols), ((0, jplan.no8 - jplan.no), (0, 0)))
    cols_p = jnp.pad(jnp.asarray(cols), ((0, jplan.W8 - jplan.W), (0, 0)))
    kw = {}
    ns0 = None
    if recurrent:
        ns0 = (rng.normal(size=(jplan.cell.srows, E)) * 0.3).astype(
            np.float32)
        kw["nstate"] = jnp.asarray(ns0)
    k_u = jax.random.PRNGKey(11)
    u = jax.random.uniform(k_u, (jplan.nu8, E), jnp.float32)
    p_list = _pack8(jnet, jparams, jplan)
    ref = _collect_block(jplan, jenv, MAXLEN, lambda k: p_list[k],
                         jnp.float32(eps), u, obs_t, cols_p,
                         jnp.asarray(ep_step)[None], jnp.asarray(ep_ret)[None],
                         **kw)
    if pallas:
        jout = j_fused_collect(
            jenv, jnet, jplan, jparams, obs=obs_t, cols=cols_p,
            ep_step=jnp.asarray(ep_step)[None],
            ep_ret=jnp.asarray(ep_ret)[None],
            seeds=jnp.zeros((1, 2), jnp.int32), eps=eps,
            max_episode_length=MAXLEN, host_key=k_u, interpret=True, **kw)
    else:
        # the block's outputs in the kernel's order (totals: lanes 0-2)
        jout = (ref["fields"], ref["obs_new"], ref["cols_new"],
                ref["ep_step_new"], ref["ep_ret_new"], ref["partial"][0, :3],
                ref.get("nstate_new"))
    ins = dict(obs=torch.tensor(cols.T.copy()),
               state=torch.tensor(cols.T.copy()),
               ep_step=torch.tensor(ep_step).to(torch.int32),
               ep_ret=torch.tensor(ep_ret),
               u=torch.tensor(np.array(u[:tplan.n_uniforms])), eps=eps,
               max_episode_length=MAXLEN)
    if recurrent:
        ins["nstate"] = torch.tensor(ns0.T.copy())
    return jplan, tplan, jout, ref, tenv, params, ins


def _check(jplan, out, jout, ref, recurrent):
    no, W = jplan.no, jplan.W
    fields, obs_n, state_n, step_n, ret_n, totals = (
        x.numpy() for x in out[:6])
    for jfields in (jout[0], ref["fields"]):
        np.testing.assert_allclose(fields, np.asarray(jfields).T, rtol=1e-6,
                                   atol=1e-6)
    np.testing.assert_allclose(obs_n, np.asarray(jout[1][:no]).T, rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(state_n, np.asarray(jout[2][:W]).T,
                               rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(step_n, np.asarray(jout[3][0]))
    np.testing.assert_allclose(ret_n, np.asarray(jout[4][0]), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(totals, np.asarray(jout[5]), rtol=1e-5,
                               atol=1e-5)
    if recurrent:
        for jn in (jout[6], ref["nstate_new"]):
            np.testing.assert_allclose(out[6].numpy(), np.asarray(jn).T,
                                       rtol=1e-6, atol=1e-6)
    # episodes ended by the env (done) and by truncation alone
    done, ended = fields[:, 2 * no + 2], fields[:, 2 * no + 3]
    assert done.sum() > 0 and (ended > done).sum() > 0


@pytest.mark.parametrize("name", ["cartpole", "mountain_car"])
@pytest.mark.parametrize("head,eps", [("dueling", 0.3), ("plain", 0.3),
                                      ("dueling", 1.0), ("dueling", 0.0)])
def test_k4_twin_matches_pallas_kernel_and_block(name, head, eps):
    jnet, tnet = _dense(ENVS[name][0](), head)
    jplan, tplan, jout, ref, tenv, params, ins = _run_both(
        name, jnet, tnet, eps, False, eps == 0.3)
    out = fc.fused_collect(tenv, tplan, params, **ins)
    _check(jplan, out, jout, ref, False)


@pytest.mark.parametrize("name", ["cartpole", "mountain_car"])
@pytest.mark.parametrize("kind,eps", [("lstm", 0.3), ("gru", 0.3),
                                      ("dueling_gru", 0.3), ("lstm", 1.0)])
def test_k6_twin_matches_pallas_kernel_and_block(name, kind, eps):
    jnet, tnet = _recurrent(ENVS[name][0](), kind)
    jplan, tplan, jout, ref, tenv, params, ins = _run_both(
        name, jnet, tnet, eps, True, eps == 0.3 and kind != "dueling_gru")
    out = fc.fused_collect(tenv, tplan, params, **ins)
    _check(jplan, out, jout, ref, True)
    # K6's tile-order reference against the same JAX outputs
    tiled = fc.fused_collect_rnn_tiled(tenv, tplan, params, **ins)
    _check(jplan, tiled, jout, ref, True)


def test_gate_takes_what_the_jax_gate_takes():
    """The same (env, net) pairs pass both gates: the three cols envs with
    Dense stacks and cells; Acrobot, Tiger and TestMDP (no cols protocol)
    are refused by both."""
    pairs = []
    for name in ENVS:
        jenv, tenv = ENVS[name][0](), ENVS[name][1]()
        for head in ("dueling", "plain"):
            pairs.append((jenv, tenv, *_dense(jenv, head)))
        for kind in ("lstm", "gru", "dueling_gru"):
            pairs.append((jenv, tenv, *_recurrent(jenv, kind)))
        # a net whose input is not the env's obs
        pairs.append((jenv, tenv, dq.Chain(dq.Dense(3, 8), dq.Dense(8, 2)),
                      dt.Chain(dt.Dense(3, 8), dt.Dense(8, 2))))
    pairs.append((dq.SimpleGridWorld(), dt.SimpleGridWorld(),
                  *_dense(dq.SimpleGridWorld(), "dueling")))
    pairs.append((dq.Acrobot(), dt.Acrobot(),
                  dq.Chain(dq.Dense(6, 8, jnp.tanh), dq.Dense(8, 3)),
                  dt.Chain(dt.Dense(6, 8, torch.tanh), dt.Dense(8, 3))))
    pairs.append((dq.TigerPOMDP(), dt.TigerPOMDP(),
                  dq.Chain(dq.Dense(2, 8, jnp.tanh), dq.Dense(8, 3)),
                  dt.Chain(dt.Dense(2, 8, torch.tanh), dt.Dense(8, 3))))
    pairs.append((dq.TestMDP((2, 2), 1), dt.TestMDP((2, 2), 1),
                  dq.Chain(dq.Flatten(), dq.Dense(4, 8), dq.Dense(8, 4)),
                  dt.Chain(dt.Flatten(), dt.Dense(4, 8), dt.Dense(8, 4))))
    taken = 0
    for jenv, tenv, jnet, tnet in pairs:
        j = j_collect_plan_for(jenv, jnet, None) is not None
        t = fc.collect_plan_for(tenv, tnet, None) is not None
        assert j == t, (type(tenv).__name__, tnet)
        taken += t
    assert taken == 11
    for env in (dt.Acrobot(), dt.TigerPOMDP(), dt.TestMDP((2, 2), 1)):
        assert fc.env_kind(env) is None


class _ShapedCartPole(dt.CartPole):
    """A CartPole whose reward the kernel's device code does not know."""

    def step_cols(self, state, action, u=None):
        new, obs, rew, done = super().step_cols(state, action, u)
        return new, obs, rew - new[:, 2].abs(), done


class _RenamedMountainCar(dt.MountainCar):
    pass


@pytest.mark.parametrize("cls", [_ShapedCartPole, _RenamedMountainCar])
def test_gate_refuses_subclasses(cls):
    """The kernels run their own copy of each env's step, so the gate takes
    the three envs by exact type: a subclass (which may override
    ``step_cols``/``reset_cols``) takes the plain collect step."""
    env = cls()
    _, net = _dense(env, "dueling", 16)
    assert fc.env_kind(env) is None
    assert fc.collect_plan_for(env, net, None) is None
    assert fc.collect_plan_for(cls.__mro__[1](), net, None) is not None


@pytest.mark.parametrize("name,rows", [("grid", 6), ("cartpole", 6),
                                       ("mountain_car", 3)])
def test_collect_step_draws_the_envs_uniform_rows(name, rows):
    """The fused collect step draws ``2 + ns + nr`` rows of uniforms from
    the generator: SimpleGridWorld exactly 6 (its stream unchanged), CartPole
    6, MountainCar 3. The step with those rows injected is the same step."""
    env = dt.SimpleGridWorld() if name == "grid" else ENVS[name][1]()
    _, net = _dense(env, "dueling", 16)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 256, 8, device="cpu")
    plan = fc.collect_plan_for(env, net, buf)
    assert plan.n_uniforms == rows
    params = net.init(torch.Generator().manual_seed(0))
    step = make_fused_collect_step(env, net, 20, lambda t: 0.5,
                                   lambda r, tr, ended: buf.insert(r, tr),
                                   plan)
    actor = init_actor(env, net, 64, torch.Generator().manual_seed(1))
    g = torch.Generator().manual_seed(2)
    a1, r1, _ = step((actor, buf.init(), params), g)
    g2 = torch.Generator().manual_seed(2)
    u = torch.rand(rows, 64, generator=g2)
    a2, r2, _ = step((actor, buf.init(), params), None, u)
    assert torch.equal(g.get_state(), g2.get_state())
    assert torch.equal(r1.rows, r2.rows)
    assert torch.equal(a1.env_state, a2.env_state)


def test_cartpole_solve_takes_the_collect_twin(monkeypatch):
    """A small CartPole ``solve`` on the CPU: the stock ε-greedy reaches the
    collect kernel's route (its plain twin on CPU tensors) at populate and
    at every iteration; the grouped update is K3's route (its twin)."""
    calls = {"collect": 0}
    real = fc.fused_collect_plain

    def plain(*args, **kw):
        calls["collect"] += 1
        return real(*args, **kw)

    monkeypatch.setattr(fc, "fused_collect_plain", plain)
    seen = []
    real_build = solver_mod.build_loop

    def build(*args, **kw):
        seen.append(kw.get("select_fn"))
        return real_build(*args, **kw)

    monkeypatch.setattr(solver_mod, "build_loop", build)
    solver = dt.DeepQLearningSolver(
        qnetwork=dt.Chain(dt.Dense(4, 16, torch.tanh),
                          dt.Dense(16, 16, torch.tanh), dt.Dense(16, 2)),
        max_steps=320, num_envs=16, train_freq=4, batch_size=16,
        buffer_size=1024, learning_rate=1e-3, target_update_freq=64,
        train_start=32, eval_freq=160, log_freq=160, num_ep_eval=8,
        max_episode_length=50, double_q=True, dueling=True,
        prioritized_replay=True, logdir=None, verbose=False, device="cpu",
        exploration_policy=dt.EpsGreedyPolicy(
            dt.LinearDecaySchedule(1.0, 0.05, 200)))
    policy = solver.solve(dt.CartPole())
    assert seen == [None]
    assert calls["collect"] == 2 + 20  # populate + one step per iteration
    assert len(solver.metrics["eval"]) == 2
    assert policy.action(np.zeros(4, np.float32)) in ("left", "right")
