"""K1 (``ops/cuda/td_kernel.py``): its plain twin against the JAX Pallas
``td_loss_fused`` in interpret mode, forward and gradient."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepqlearning_tpu.ops.pallas.td_kernel import td_loss_fused  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda import td_kernel  # noqa: E402

torch.set_num_threads(2)
GAMMA, ALPHA, EPS = 0.95, 0.6, 1e-3


def _inputs(B, A, seed, act_dtype=np.int32, out_of_range=False):
    rng = np.random.default_rng(seed)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    q_s, q_onl, q_tgt = f(B, A) * 2, f(B, A), f(B, A)
    a = rng.integers(0, A, B).astype(act_dtype)
    if out_of_range:  # these rows select nothing
        a[1::5], a[3::5] = -1, A
    r = f(B)
    d = (rng.random(B) < 0.2).astype(np.float32)
    w = (rng.random(B) + 0.5).astype(np.float32)
    return q_s, q_onl, q_tgt, a, r, d, w


# the first three are the original cases (int32, actions in range); then
# the shapes K1's kernel cuts differently (one row, A = 5 without float4
# rows, past one block's rows, the largest), with int32 and int64 actions
# and actions -1 and A in some rows
TWIN_CASES = [pytest.param(B, A, np.int32, False, id=f"{B}-{A}")
              for B, A in ((32, 4), (512, 4), (37, 6))] + [
    pytest.param(B, A, dt, True, id=f"{B}-{A}-{np.dtype(dt).name}-range")
    for B, A in ((1, 4), (33, 5), (1025, 4), (4096, 4))
    for dt in (np.int32, np.int64)]


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("B,A,act_dtype,out_of_range", TWIN_CASES)
def test_twin_matches_pallas_kernel(B, A, act_dtype, out_of_range, double_q):
    q_s, q_onl, q_tgt, a, r, d, w = _inputs(B, A, B + A, act_dtype,
                                            out_of_range)
    # JAX runs without x64: its kernel takes the actions as int32
    jx = [jnp.asarray(x) for x in (q_s, q_onl, q_tgt, a.astype(np.int32),
                                   r, d, w)]

    def f_kernel(q):
        return td_loss_fused(q, *jx[1:], GAMMA, ALPHA, EPS, double_q, True)

    (jl, jtd, jprio) = f_kernel(jx[0])
    jgrad = jax.grad(lambda q: f_kernel(q)[0])(jx[0])

    tq = torch.from_numpy(q_s).requires_grad_()
    tx = [torch.from_numpy(x) for x in (q_onl, q_tgt, a, r, d, w)]
    assert tx[2].dtype == {np.int32: torch.int32,
                           np.int64: torch.int64}[act_dtype]
    tl, ttd, tprio = td_kernel.td_loss(tq, *tx, GAMMA, ALPHA, EPS, double_q)
    (tgrad,) = torch.autograd.grad(tl, tq)
    # same f32 elementwise math; the loss sums B terms in another order
    # (loss rtol 1e-5); the target r + (1-d)·γ·q may be rounded once (fused
    # multiply-add) or twice, an ulp of |target| <= ~8 (td atol 1e-6);
    # XLA's and ATen's f32 pow differ by an ulp or two (prio rtol 1e-5)
    np.testing.assert_allclose(float(tl.detach()), float(jl), rtol=1e-5)
    np.testing.assert_allclose(ttd.numpy(), np.asarray(jtd), rtol=1e-6,
                               atol=1e-6)
    np.testing.assert_allclose(tprio.numpy(), np.asarray(jprio), rtol=1e-5)
    np.testing.assert_allclose(tgrad.numpy(), np.asarray(jgrad), rtol=1e-6,
                               atol=1e-9)
    # the gradient is non-zero only at the taken action, and nowhere in a
    # row whose action lies outside [0, A)
    assert (tgrad.numpy() != 0).sum(axis=1).max() <= 1
    bad = (a < 0) | (a >= A)
    assert bad.any() == (out_of_range and B > 1)
    assert not tgrad.numpy()[bad].any()


def test_gradient_scales_with_upstream_and_skips_targets():
    q_s, q_onl, q_tgt, a, r, d, w = _inputs(16, 4, 0)
    tq = torch.from_numpy(q_s).requires_grad_()
    ttgt = torch.from_numpy(q_tgt).requires_grad_()
    tx = [torch.from_numpy(x) for x in (a, r, d, w)]
    loss, _, _ = td_kernel.td_loss(tq, torch.from_numpy(q_onl), ttgt, *tx,
                                   GAMMA, ALPHA, EPS, True)
    g1 = torch.autograd.grad(loss * 3.0, tq, retain_graph=True)[0]
    g0 = torch.autograd.grad(loss, tq, retain_graph=True)[0]
    torch.testing.assert_close(g1, 3.0 * g0)
    assert torch.autograd.grad(loss, ttgt, allow_unused=True)[0] is None


def test_cuda_tensors_never_take_the_plain_path(monkeypatch):
    """The wrapper dispatches on the tensors' device: CPU tensors use the
    twin; the CUDA route is chosen only for CUDA tensors (here never)."""
    called = []
    monkeypatch.setattr(td_kernel, "td_loss_cuda",
                        lambda *a, **k: called.append(1))
    q = _inputs(8, 4, 1)
    td_kernel.td_loss(*(torch.from_numpy(x) for x in q[:3]),
                      *(torch.from_numpy(x) for x in q[3:]),
                      GAMMA, ALPHA, EPS, True)
    assert called == []


def _ff_setup():
    import deepqlearning_tpu as dq
    import deepqlearning_tpu_torch as dt
    from deepqlearning_tpu_torch import convert

    jnet = dq.create_dueling_network(dq.Chain(
        dq.Flatten(), dq.Dense(3, 16, jnp.tanh), dq.Dense(16, 4)))
    tnet = dt.create_dueling_network(dt.Chain(
        dt.Flatten(), dt.Dense(3, 16, torch.tanh), dt.Dense(16, 4)))
    jp = jnet.init(jax.random.PRNGKey(0))
    jt = jnet.init(jax.random.PRNGKey(1))
    np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
    tp = convert.params_from_numpy(tnet, np_(jp))
    tt = convert._as_dict(tnet, np_(jt), "cpu")
    rng = np.random.default_rng(2)
    n = 256
    data = dict(obs=rng.normal(size=(n, 3)).astype(np.float32),
                action=rng.integers(0, 4, n).astype(np.int32),
                reward=rng.normal(size=n).astype(np.float32),
                next_obs=rng.normal(size=(n, 3)).astype(np.float32),
                done=(rng.random(n) < 0.1).astype(np.float32))
    return dq, dt, convert, jnet, tnet, jp, jt, tp, tt, data


@pytest.mark.parametrize("double_q", [True, False])
def test_bellman_targets_match(double_q):
    from deepqlearning_tpu.learner.train_step import _bellman_targets as jbt
    from deepqlearning_tpu_torch.learner.train_step import _bellman_targets

    dq, dt, _, jnet, tnet, jp, jt, tp, tt, d = _ff_setup()
    ref = jbt(jnet, jp, jt, jnp.asarray(d["next_obs"]),
              jnp.asarray(d["reward"]), jnp.asarray(d["done"]), 0.9, double_q)
    out = _bellman_targets(tnet, tp, tt, torch.tensor(d["next_obs"]),
                           torch.tensor(d["reward"]), torch.tensor(d["done"]),
                           0.9, double_q)
    # one f32 forward pass each side, summed in other orders: rtol 1e-5
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), rtol=1e-5,
                               atol=1e-6)


@pytest.mark.parametrize("double_q", [True, False])
def test_ungrouped_step_through_k1_matches_jax(double_q):
    """``make_dqn_train_step`` (loss head K1, its twin on the CPU) against
    the JAX step's plain path: two updates with the same sample uniforms."""
    from deepqlearning_tpu.learner.train_step import make_dqn_train_step as jm
    from deepqlearning_tpu_torch.learner.train_step import make_dqn_train_step

    dq, dt, convert, jnet, tnet, jp, jt, tp, tt, d = _ff_setup()
    jb = dq.PrioritizedReplayBuffer((3,), 256, 32)
    js = jb.insert(jb.init(), dq.TransitionBatch(
        *(jnp.asarray(d[k]) for k in ("obs", "action", "reward", "next_obs",
                                      "done"))))
    tb = dt.PrioritizedReplayBuffer((3,), 256, 32, device="cpu")
    ts = tb.insert(tb.init(), dt.TransitionBatch(
        torch.tensor(d["obs"]), torch.tensor(d["action"]).long(),
        torch.tensor(d["reward"]), torch.tensor(d["next_obs"]),
        torch.tensor(d["done"])))
    jstep, jopt = jm(jnet, jb, 0.9, double_q, 1e-2, use_pallas=False)
    tstep, topt = make_dqn_train_step(tnet, tb, 0.9, double_q, 1e-2)
    jo, to = jopt.init(jp), topt.init(tp)
    for i in range(2):
        k = jax.random.PRNGKey(30 + i)
        u = torch.tensor(np.array(jax.random.uniform(k, (32,))))
        jr = jstep(jp, jt, jo, js, k)
        tr = tstep(tp, tt, to, ts, u=u)
        jp, jo, js = jr.params, jr.opt_state, jr.replay_state
        to, ts = tr.opt_state, tr.replay_state
        # tests/test_fused_update.py tolerances: loss rtol 1e-4, params
        # rtol 2e-4 / atol 2e-5, leaves rtol 2e-3 / atol 1e-5
        np.testing.assert_allclose(float(tr.loss), float(jr.loss), rtol=1e-4)
        np.testing.assert_allclose(float(tr.grad_norm), float(jr.grad_norm),
                                   rtol=1e-3, atol=1e-6)
        ref = convert._as_dict(tnet, jax.tree_util.tree_map(np.asarray, jp),
                               "cpu")
        for key in ref:
            np.testing.assert_allclose(tp[key].numpy(), ref[key].numpy(),
                                       rtol=2e-4, atol=2e-5, err_msg=key)
        np.testing.assert_allclose(ts.tree[0].numpy(), np.asarray(js.tree[0]),
                                   rtol=2e-3, atol=1e-5)
    assert int(to.count) == 2
