"""Port parity: the plain recurrent (DRQN) train steps against the JAX
package's ``make_drqn_train_step`` and ``make_grouped_drqn_train_step``.

Both episode buffers hold the same streamed transitions; the port's sample
takes the JAX sample's draws (derived from the JAX key). Tolerances are the
JAX package's fused-vs-XLA ones (tests/test_fused_drqn.py): loss rtol 1e-4,
gnorm rtol 1e-3, params rtol 2e-4 / atol 2e-5 after two calls (Adam past
its first bias correction).
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.train_step import (  # noqa: E402
    make_drqn_train_step as j_drqn_step,
    make_grouped_drqn_train_step as j_grouped_drqn_step)
from deepqlearning_tpu.models.chain import GRU as JGRU, LSTM as JLSTM  # noqa: E402
from deepqlearning_tpu.replay.episode import (  # noqa: E402
    EpisodeReplayBuffer as JBuf)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    make_drqn_train_step, make_grouped_drqn_train_step)

from test_torch_episode_replay import jax_draws  # noqa: E402

torch.set_num_threads(2)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
OBS, A, B, T, E = 3, 4, 8, 5, 8


def nets(kind):
    """(JAX net, port net): the kinds of tests/test_fused_drqn.py."""
    if kind == "plain":
        return (dq.Chain(JLSTM(OBS, 12), dq.Dense(12, A)),
                dt.Chain(dt.LSTM(OBS, 12), dt.Dense(12, A)))
    if kind == "deep":
        return (dq.Chain(dq.Flatten(), dq.Dense(OBS, 10, jnp.tanh),
                         JLSTM(10, 12), dq.Dense(12, 8, jax.nn.relu),
                         dq.Dense(8, A)),
                dt.Chain(dt.Flatten(), dt.Dense(OBS, 10, torch.tanh),
                         dt.LSTM(10, 12), dt.Dense(12, 8, torch.relu),
                         dt.Dense(8, A)))
    if kind == "dueling":
        return (dq.create_dueling_network(dq.Chain(
                    JLSTM(OBS, 12), dq.Dense(12, 8, jnp.tanh), dq.Dense(8, A))),
                dt.create_dueling_network(dt.Chain(
                    dt.LSTM(OBS, 12), dt.Dense(12, 8, torch.tanh),
                    dt.Dense(8, A))))
    if kind == "gru":
        return (dq.Chain(JGRU(OBS, 12), dq.Dense(12, A)),
                dt.Chain(dt.GRU(OBS, 12), dt.Dense(12, A)))
    return (dq.create_dueling_network(dq.Chain(
                dq.Dense(OBS, 10, jnp.tanh), JGRU(10, 12),
                dq.Dense(12, 8, jnp.tanh), dq.Dense(8, A))),
            dt.create_dueling_network(dt.Chain(
                dt.Dense(OBS, 10, torch.tanh), dt.GRU(10, 12),
                dt.Dense(12, 8, torch.tanh), dt.Dense(8, A))))


def filled_buffers(seed=0, steps=40):
    """Both episode buffers after the same random lockstep stream (episodes
    end at random), open episodes dropped."""
    jb = JBuf((OBS,), 64, B, T, 16, num_envs=E)
    tb = dt.EpisodeReplayBuffer((OBS,), 64, B, T, 16, num_envs=E, device="cpu")
    js, ts = jb.init(), tb.init()
    jadd = jax.jit(jb.add_step)
    rng = np.random.default_rng(seed)
    for _ in range(steps):
        f = lambda *s: rng.normal(size=s).astype(np.float32)
        obs, nobs, rew = f(E, OBS), f(E, OBS), f(E)
        act = rng.integers(0, A, E).astype(np.int32)
        done = (rng.random(E) < 0.25).astype(np.float32)
        js = jadd(js, dq.TransitionBatch(
            jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
            jnp.asarray(nobs), jnp.asarray(done)), jnp.asarray(done > 0))
        ts = tb.add_step(ts, dt.TransitionBatch(
            torch.from_numpy(obs), torch.from_numpy(act).long(),
            torch.from_numpy(rew), torch.from_numpy(nobs),
            torch.from_numpy(done)), torch.from_numpy(done > 0))
    return jb, jb.reset_in_progress(js), tb, tb.reset_in_progress(ts)


def close_params(tnet, ours, theirs, rtol=2e-4, atol=2e-5):
    ref = convert._as_dict(tnet, np_(theirs), "cpu")
    assert ref.keys() == ours.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k].numpy(), ref[k].numpy(),
                                   rtol=rtol, atol=atol, err_msg=k)


@pytest.mark.parametrize("U", [1, 3])
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("kind", ["plain", "deep", "gru_dueling"])
def test_drqn_steps_match_jax(kind, double_q, U):
    """U=1: ``make_drqn_train_step``; U=3: the grouped step."""
    jnet, tnet = nets(kind)
    jb, js, tb, ts = filled_buffers()
    jparams = jnet.init(jax.random.PRNGKey(1))
    jtarget = jnet.init(jax.random.PRNGKey(2))
    params = convert.params_from_numpy(tnet, np_(jparams))
    target = convert._as_dict(tnet, np_(jtarget), "cpu")
    if U == 1:
        jstep, jopt = j_drqn_step(jnet, jb, 0.95, double_q, 1e-2)
        step, opt = make_drqn_train_step(tnet, tb, 0.95, double_q, 1e-2)
    else:
        jstep, jopt = j_grouped_drqn_step(jnet, jb, 0.95, double_q, 1e-2, U)
        step, opt = make_grouped_drqn_train_step(tnet, tb, 0.95, double_q,
                                                 1e-2, U)
    jstep = jax.jit(jstep)
    jo, to, jp = jopt.init(jparams), opt.init(params), jparams
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jres = jstep(jp, jtarget, jo, js, key)
        tres = step(params, target, to, ts,
                    u=jax_draws(js, key, U * B, tb.records_per_env))
        jp, jo = jres.params, jres.opt_state
        np.testing.assert_allclose(float(tres.loss), float(jres.loss),
                                   rtol=1e-4)
        np.testing.assert_allclose(float(tres.grad_norm),
                                   float(jres.grad_norm), rtol=1e-3,
                                   atol=1e-6)
        close_params(tnet, tres.params, jp)
    assert int(to.count) == 2 * U

