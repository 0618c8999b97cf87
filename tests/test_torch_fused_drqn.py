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
    # this card's budget: one warp's parameters, activations and gradient
    # copy must fit a block's shared memory
    big = dt.Chain(dt.LSTM(256, 256), dt.Dense(256, 4))
    assert fused_drqn.drqn_plan_for(big, 64, 1024) is None
    lstm32 = fused_drqn.drqn_plan_for(
        dt.Chain(dt.LSTM(2, 32), dt.Dense(32, 4)), 8, 512)
    assert lstm32.warps_per_block(8) >= 1
    assert lstm32.smem_bytes(8, lstm32.warps_per_block(8)) <= \
        fused_drqn.MAX_SMEM


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
