"""K1 on the grouped plain route (``make_grouped_dqn_train_step``).

Each of the U sub-updates takes its loss head from K1 (its twin on CPU
tensors) and hands K1's priorities, u-major, to the one merged priority
update, as the JAX grouped step runs its TD kernel
(``deepqlearning_tpu/learner/train_step.py:227-287``). ``build_loop`` takes
this route for a grouped network that the K3 plan refuses, such as a
512-wide dueling Dense head."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.train_step import (  # noqa: E402
    make_grouped_dqn_train_step as j_grouped_step)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner import loop  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    make_grouped_dqn_train_step)
from deepqlearning_tpu_torch.ops.cuda import fused_update, td_kernel  # noqa: E402
from test_torch_fused_update import (  # noqa: E402
    B, U, _buffers, _close_params, _nets, np_)

torch.set_num_threads(2)


def _count(monkeypatch, module, name):
    """Count the calls of ``module.name`` (still calling it)."""
    calls = []
    fn = getattr(module, name)

    def spy(*a, **kw):
        calls.append(1)
        return fn(*a, **kw)

    monkeypatch.setattr(module, name, spy)
    return calls


def _record_priority_updates(monkeypatch, buf):
    """The (td, priorities) of each ``buf.update_priorities`` call."""
    seen = []
    fn = buf.update_priorities

    def spy(state, idx, td, priorities=None):
        seen.append((td.clone(), None if priorities is None
                     else priorities.clone()))
        return fn(state, idx, td, priorities=priorities)

    monkeypatch.setattr(buf, "update_priorities", spy)
    return seen


# dueling with K1 is test_torch_fused_update.py's
# test_plain_grouped_step_matches_jax_grouped (use_kernel's default)
@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("use_kernel,dueling",
                         [(True, False), (False, True), (False, False)])
def test_grouped_plain_step_matches_jax_grouped(monkeypatch, use_kernel,
                                                dueling, double_q):
    """The port's grouped step, with K1 (its twin here) or with the loss
    head through autograd (``use_kernel=False``), against JAX's grouped
    step on its reference path (``use_pallas=False``): two calls of U
    sub-updates with the same sample uniforms."""
    jnet, tnet = _nets(dueling)
    jb, js, tb, ts = _buffers()
    jparams = jnet.init(jax.random.PRNGKey(2))
    params = convert.params_from_numpy(tnet, np_(jparams))
    target = {k: p.clone() for k, p in params.items()}
    heads = _count(monkeypatch, td_kernel, "td_loss_plain")
    seen = _record_priority_updates(monkeypatch, tb)
    ref_step, ref_opt = j_grouped_step(jnet, jb, 0.95, double_q, 1e-2, U,
                                       use_pallas=False)
    step, opt = make_grouped_dqn_train_step(tnet, tb, 0.95, double_q, 1e-2,
                                            U, use_kernel=use_kernel)
    ro, to, rp = ref_opt.init(jparams), opt.init(params), jparams
    for i in range(2):
        k = jax.random.PRNGKey(20 + i)
        u = torch.tensor(np.array(jax.random.uniform(k, (U * B,))))
        rres = ref_step(rp, jparams, ro, js, k)
        tres = step(params, target, to, ts, u=u)
        rp, ro, js = rres.params, rres.opt_state, rres.replay_state
        to, ts = tres.opt_state, tres.replay_state
        # the tolerances of test_plain_grouped_step_matches_jax_grouped:
        # loss rtol 1e-4, params rtol 2e-4 / atol 2e-5, leaves rtol 2e-3 /
        # atol 1e-5
        np.testing.assert_allclose(float(tres.loss), float(rres.loss),
                                   rtol=1e-4)
        _close_params(tnet, params, rp)
        np.testing.assert_allclose(ts.tree[0].numpy(), np.asarray(js.tree[0]),
                                   rtol=2e-3, atol=1e-5)
    assert int(to.count) == 2 * U
    assert len(heads) == (2 * U if use_kernel else 0)
    # one merged update per call, with K1's priorities for all U·B rows
    # (without K1 the buffer computes them from td)
    assert [td.shape for td, _ in seen] == [(U * B,)] * 2
    assert all((p is not None) == use_kernel for _, p in seen)
    if use_kernel:
        assert [p.shape for _, p in seen] == [(U * B,)] * 2


@pytest.mark.parametrize("double_q", [True, False])
def test_grouped_step_with_and_without_k1(monkeypatch, double_q):
    """``use_kernel=True`` against ``False`` in the port, two calls. The
    first sub-update's td is equal bit for bit (the same params and the
    same f32 operations in the same order); the gradients differ in the
    last bits (K1's closed form against autograd through the Huber terms),
    so the params and the tree leaves agree to rtol 1e-6 and the later td
    to rtol 1e-6 / atol 1e-6 (td = Q(s, a) - target cancels: an ulp of a
    target of |r + γ·Q| <= ~8)."""
    _, tnet = _nets(True)
    runs = []
    for use_kernel in (True, False):
        _, _, tb, ts = _buffers()
        params = tnet.init(torch.Generator().manual_seed(3))
        target = {k: p.clone() for k, p in params.items()}
        seen = _record_priority_updates(monkeypatch, tb)
        heads = _count(monkeypatch, td_kernel, "td_loss_plain")
        step, opt = make_grouped_dqn_train_step(
            tnet, tb, 0.95, double_q, 1e-2, U, use_kernel=use_kernel)
        to = opt.init(params)
        for i in range(2):
            u = torch.from_numpy(np.random.default_rng(40 + i).random(
                U * B).astype(np.float32))
            res = step(params, target, to, ts, u=u)
            to, ts = res.opt_state, res.replay_state
        runs.append((params, ts.tree, seen, len(heads)))
    (pk, tk, sk, nk), (pp, tp, sp, np_heads) = runs
    assert (nk, np_heads) == (2 * U, 0)
    assert all(p is not None for _, p in sk) and all(p is None for _, p in sp)
    assert torch.equal(sk[0][0][:B], sp[0][0][:B])
    for (tdk, _), (tdp, _) in zip(sk, sp):
        np.testing.assert_allclose(tdk.numpy(), tdp.numpy(), rtol=1e-6,
                                   atol=1e-6)
    for k in pk:
        np.testing.assert_allclose(pk[k].numpy(), pp[k].numpy(), rtol=1e-6,
                                   err_msg=k)
    for lk, lp in zip(tk, tp):
        np.testing.assert_allclose(lk.numpy(), lp.numpy(), rtol=1e-6)


def test_wide_net_takes_the_grouped_route_through_k1(monkeypatch):
    """``build_loop`` with the 512-wide dueling Dense head of
    ``examples/image_conv_dqn.py`` over SimpleGridWorld's observation: the
    K3 plan refuses it, so the loop takes the plain grouped step, whose U
    loss heads are K1 (the twin here) every iteration; with
    ``fused_updates=False`` none are."""
    env = dt.SimpleGridWorld()
    net = dt.create_dueling_network(dt.Chain(
        dt.Flatten(), dt.Dense(2, 512, torch.relu),
        dt.Dense(512, 512, torch.relu), dt.Dense(512, 4)))
    assert fused_update.plan_for(net) is None
    factory = _count(monkeypatch, loop, "make_grouped_dqn_train_step")
    for fused, per_iter in ((None, 4), (False, 0)):
        cfg = dt.DQNConfig(num_envs=64, train_freq=16, batch_size=8,
                           buffer_size=256, max_episode_length=10,
                           double_q=True, dueling=True, fused_updates=fused)
        assert cfg.updates_per_iter == 4
        buf = dt.PrioritizedReplayBuffer(
            env.obs_shape, 256, 8, alpha=cfg.prioritized_replay_alpha,
            beta=cfg.prioritized_replay_beta,
            eps=cfg.prioritized_replay_epsilon, device="cpu")
        it, pop, opt = loop.build_loop(env, net, buf, cfg,
                                       dt.LinearDecaySchedule(), env.discount)
        c = loop.populate(pop, buf, loop.init_carry(env, net, buf, cfg, opt,
                                                    device="cpu"), 2)
        heads = _count(monkeypatch, td_kernel, "td_loss_plain")
        for n in (1, 2):
            c = it(c)
            assert len(heads) == per_iter * n
        assert torch.isfinite(c.loss) and int(c.opt_state.count) == 8
    assert len(factory) == 2
