"""The port's actor-learner loop against the JAX package's, end to end.

Both packages run ``build_loop`` with the collect kernel and the fused
grouped update (JAX: Pallas in interpret mode on the CPU; port: the kernels'
plain twins on CPU tensors) from the same parameters and actor state, copied
through ``deepqlearning_tpu_torch.convert``. The port's uniforms are derived
from the JAX key chain exactly as JAX draws them (collect:
``actor.py`` split -> ``fused_collect`` host uniforms, first 6 rows; sample:
``loop.py`` split -> ``sumtree.sample``'s uniforms). Populate 2 steps, then 2
iterations (the second crosses a target sync), and compare every piece of
state.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.actor import init_actor as j_init_actor  # noqa: E402
from deepqlearning_tpu.learner.loop import LoopCarry as JLoopCarry  # noqa: E402
from deepqlearning_tpu.learner.loop import build_loop as j_build_loop  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import LoopCarry, build_loop  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import AdamState  # noqa: E402

torch.set_num_threads(2)

E, C, B, TF, MAXLEN, TUF = 128, 1024, 32, 32, 5, 256
N_U8 = 8  # rows of the JAX kernel's host uniforms for SimpleGridWorld


def _cfg(mod):
    return mod.DQNConfig(num_envs=E, batch_size=B, buffer_size=C,
                         train_freq=TF, max_episode_length=MAXLEN,
                         target_update_freq=TUF, learning_rate=1e-2,
                         double_q=True, dueling=True, prioritized_replay=True,
                         fused_collect=True, fused_updates=True)


def _jax_side():
    env = dq.SimpleGridWorld()
    net = dq.create_dueling_network(dq.Chain(
        dq.Flatten(), dq.Dense(2, 16, jnp.tanh), dq.Dense(16, 16, jnp.tanh),
        dq.Dense(16, 4)))
    cfg = _cfg(dq)
    buf = dq.PrioritizedReplayBuffer(env.obs_shape, C, B)
    it, pop, opt = j_build_loop(env, net, buf, cfg,
                                dq.LinearDecaySchedule(1.0, 0.05, 500),
                                gamma=env.discount)
    k1, k2, k3 = jax.random.split(jax.random.PRNGKey(0), 3)
    params = net.init(k1)
    carry = JLoopCarry(actor=j_init_actor(env, net, E, k2), replay=buf.init(),
                       params=params, target_params=params,
                       opt_state=opt.init(params), lkey=k3,
                       loss=jnp.asarray(0.0), gnorm=jnp.asarray(0.0),
                       sync_acc=jnp.asarray(0, jnp.int32))
    return env, net, cfg, buf, it, pop, carry


def _torch_side(jcarry):
    env = dt.SimpleGridWorld()
    net = dt.create_dueling_network(dt.Chain(
        dt.Flatten(), dt.Dense(2, 16, torch.tanh), dt.Dense(16, 16, torch.tanh),
        dt.Dense(16, 4)))
    cfg = _cfg(dt)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, C, B, device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.05, 500),
                              gamma=env.discount)
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    params = convert.params_from_numpy(net, np_(jcarry.params))
    gen = torch.Generator().manual_seed(0)
    carry = LoopCarry(
        actor=convert.actor_from_numpy(np_(jcarry.actor)), replay=buf.init(),
        params=params, target_params={k: p.clone() for k, p in params.items()},
        opt_state=opt.init(params), generator=gen,
        loss=torch.zeros(()), gnorm=torch.zeros(()), sync_acc=0)
    return net, cfg, it, pop, carry


def _collect_u(key):
    """The JAX fused collect step's uniforms: split(actor.key, 3) -> k_u ->
    uniform [nu8, E], first 6 rows. Returns (next actor key, u)."""
    key, _, k_u = jax.random.split(key, 3)
    u = jax.random.uniform(k_u, (N_U8, E), jnp.float32)[:6]
    return key, torch.from_numpy(np.array(u))


def _sample_u(lkey, n):
    """``loop.py``: lkey, k = split(lkey); ``sumtree.sample``: uniform(k)."""
    lkey, k = jax.random.split(lkey)
    return lkey, torch.from_numpy(np.array(jax.random.uniform(k, (n,))))


def _close(a, b, rtol, atol=0.0, err=""):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol, err_msg=err)


def test_slice_matches_jax_loop():
    env, jnet, jcfg, jbuf, jit_, jpop, jc = _jax_side()
    net, cfg, it, pop, tc = _torch_side(jc)
    U = cfg.updates_per_iter
    assert U == 4 and cfg.steps_per_iter == 1

    jpop = jax.jit(jpop)
    jit_ = jax.jit(jit_)
    # populate: 2 eps=1 collect steps
    ja, jr = jc.actor, jc.replay
    cc = (tc.actor, tc.replay, tc.params)
    for _ in range(2):
        _, u = _collect_u(ja.key)
        (ja, jr, _), _ = jpop((ja, jr, jc.params), None)
        cc = pop(cc, None, u)
    jc = jc._replace(actor=ja, replay=jr)
    tc = tc._replace(actor=cc[0], replay=cc[1])

    for i in range(2):
        _, u = _collect_u(jc.actor.key)
        _, su = _sample_u(jc.lkey, U * B)
        jc, _ = jit_(jc, None)
        tc = it(tc, collect_u=[u], sample_u=[su])

        # tolerances: collect fields and actor state are elementwise f32
        # math on identical inputs (1e-6, as tests/test_fused_collect.py);
        # params/Adam and the loss follow tests/test_fused_update.py
        # (params rtol 2e-4 / atol 2e-5, loss rtol 1e-4); tree leaves hold
        # (|td|+eps)^alpha of those tds (rtol 2e-3 / atol 1e-5)
        _close(tc.replay.rows, jc.replay.rows, 1e-6, 1e-6, "replay rows")
        assert tc.replay.size == int(jc.replay.size)
        assert tc.replay.insert_pos == int(jc.replay.insert_pos)
        _close(tc.replay.tree[0], jc.replay.tree[0], 2e-3, 1e-5, "leaves")
        ja, ta = jc.actor, tc.actor
        _close(ta.obs, ja.obs, 1e-6, err="obs")
        _close(ta.env_state,
               convert.gridworld_state_from_numpy(ja.env_state.pos,
                                                  ja.env_state.terminal),
               1e-6, err="env state")
        np.testing.assert_array_equal(ta.ep_step.numpy(), np.asarray(ja.ep_step))
        _close(ta.ep_ret, ja.ep_ret, 1e-6, 1e-6, "ep_ret")
        for name in ("ret_ring", "step_ring", "cnt_ring"):
            _close(getattr(ta, name), getattr(ja, name), 1e-5, 1e-6, name)
        assert int(ta.ep_count) == int(ja.ep_count) > 0
        assert ta.tick == int(ja.tick) and ta.t == int(ja.t)

        np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
        for ours, theirs in ((tc.params, jc.params),
                             (tc.target_params, jc.target_params),
                             (tc.opt_state.m, jc.opt_state.m),
                             (tc.opt_state.v, jc.opt_state.v)):
            ref = convert._as_dict(net, np_(theirs), "cpu")
            for k in ref:
                _close(ours[k], ref[k], 2e-4, 2e-5, k)
        assert int(tc.opt_state.count) == int(jc.opt_state.count) == U * (i + 1)
        _close(float(tc.loss), float(jc.loss), 1e-4, err="loss")
        _close(float(tc.gnorm), float(jc.gnorm), 1e-3, 1e-6, "gnorm")
        assert tc.sync_acc == int(jc.sync_acc)
    # the second iteration crossed target_update_freq: target == params
    for k, p in tc.params.items():
        assert torch.equal(tc.target_params[k], p)
    assert isinstance(tc.opt_state, AdamState)
