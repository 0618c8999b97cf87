"""bf16 parameters and replay through the port's learner, against the JAX
package on the CPU.

* Grouped plain bf16 updates over a bf16 PER buffer of (8, 8, 4) obs
  against ``make_grouped_dqn_train_step(use_pallas=False)``; the port's
  loss heads take K1's twin on f32 casts of the Q values, as the JAX step
  feeds its TD kernel, and its Adam runs in bf16 as optax does. Loss, TD,
  priorities, parameters and Adam moments agree within 2 bf16 ulps on at
  least 99.9% of entries (the rest are listed in the failure message): a
  narrow bf16 Dense net at U = 2, B = 8, the narrow conv net and its
  dueling form (``examples/image_conv_dqn.py``'s net at small widths) at
  U = 1 and 2. The JAX step is compiled with XLA's
  ``xla_allow_excess_precision`` off: by default XLA's CPU backend keeps a
  fused bf16 intermediate in f32 instead of rounding it, so from the first
  update on its bf16 parameters differ from a computation that rounds every
  bf16 value (as PyTorch's eager ops and jnp's semantics do) in the last
  bits, and bf16 rounding carries that into multi-ulp differences (ROADMAP
  §C.10). Against the step as it runs by default the conv nets at U = 2
  are held on the first sub-update's TD and the loss (rtol 5e-3).
* The loop's gates: a non-f32 dtype never takes the f32 kernels K3/K7,
  K4/K6 or K5/K8, and ``fused_updates=True`` / ``fused_collect=True`` with
  it raise ``ValueError``."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.learner.train_step import (  # noqa: E402
    make_grouped_dqn_train_step as j_grouped_step)
from deepqlearning_tpu.models.chain import Conv2D as JConv2D  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.learner import loop  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    make_grouped_dqn_train_step)
from deepqlearning_tpu_torch.ops.cuda import td_kernel  # noqa: E402

torch.set_num_threads(2)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
OBS, A, B, U, N = (8, 8, 4), 3, 8, 2, 64


def _nets(kind):
    """The narrow bf16 nets on (8, 8, 4) obs: "conv" (channels 4-8-8, as
    ``examples/image_conv_dqn.py`` at small widths), "dueling" (that net
    with its Dense run split into dueling heads, as the example's) or
    "dense"."""
    def chain(m, conv, act):
        if kind == "dense":
            return m.Chain(m.Flatten(), m.Dense(256, 16, act),
                           m.Dense(16, 16, act), m.Dense(16, A))
        net = m.Chain(conv(4, 8, (3, 3), (1, 1), "SAME", act),
                      conv(8, 8, (3, 3), (2, 2), "SAME", act),
                      m.Flatten(), m.Dense(128, 16, act), m.Dense(16, A))
        return m.create_dueling_network(net) if kind == "dueling" else net

    return (chain(dq, JConv2D, jax.nn.relu),
            chain(dt, dt.Conv2D, torch.relu))


def _buffers():
    rng = np.random.default_rng(0)
    obs = rng.normal(size=(N,) + OBS).astype(np.float32)
    nobs = rng.normal(size=(N,) + OBS).astype(np.float32)
    act = rng.integers(0, A, N).astype(np.int32)
    rew = rng.normal(size=N).astype(np.float32)
    done = (rng.random(N) < 0.1).astype(np.float32)
    jb = dq.PrioritizedReplayBuffer(OBS, N, B, obs_dtype=jnp.bfloat16)
    js = jb.insert(jb.init(), dq.TransitionBatch(
        jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
        jnp.asarray(nobs), jnp.asarray(done)))
    tb = dt.PrioritizedReplayBuffer(OBS, N, B, obs_dtype=torch.bfloat16,
                                    device="cpu")
    ts = tb.insert(tb.init(), dt.TransitionBatch(
        torch.tensor(obs), torch.tensor(act).long(), torch.tensor(rew),
        torch.tensor(nobs), torch.tensor(done)))
    return jb, js, tb, ts


def _ulps_off(ours: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """|ours - ref| in bf16 ulps of the larger magnitude (an ulp of
    2^(e - 7) for |x| in [2^e, 2^(e+1)); the smallest normal's below)."""
    ours, ref = ours.astype(np.float64), ref.astype(np.float64)
    mag = np.maximum(np.maximum(np.abs(ours), np.abs(ref)), 2.0 ** -126)
    ulp = 2.0 ** (np.floor(np.log2(mag)) - 7)
    return np.abs(ours - ref) / ulp


def _agree(what, ours, ref, errors, max_ulps=2.0):
    """Record the entries of ``what`` more than ``max_ulps`` bf16 ulps off;
    returns (entries, entries off)."""
    ours = np.asarray(ours, np.float64).reshape(-1)
    ref = np.asarray(ref, np.float64).reshape(-1)
    off = np.nonzero(_ulps_off(ours, ref) > max_ulps)[0]
    errors.extend(f"{what}[{i}]: {ours[i]!r} vs {ref[i]!r}" for i in off)
    return ours.size, off.size


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def _grouped_pair(monkeypatch, kind, double_q, U, exact_bf16=False):
    """One grouped call of U sub-updates in both packages from the same
    bf16 parameters and sample uniforms; returns (port result, JAX result,
    port TDs, JAX TDs, the port's buffer state, the port's net, loss-head
    input dtypes). With ``exact_bf16`` the JAX step is jitted whole and
    compiled with ``xla_allow_excess_precision`` off, so XLA rounds every
    bf16 value it computes (see the module docstring); otherwise it runs as
    it comes."""
    jnet, tnet = _nets(kind)
    jb, js, tb, ts = _buffers()
    jparams = jnet.init(jax.random.PRNGKey(2), jnp.bfloat16)
    params = convert.params_from_numpy(tnet, np_(jparams))
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    target = {k: p.clone() for k, p in params.items()}
    seen, heads = [], []
    upd, head = tb.update_priorities, td_kernel.td_loss_plain
    monkeypatch.setattr(tb, "update_priorities", lambda s, i, td, priorities=None: (
        seen.append((td.clone(), priorities.clone())), upd(
            s, i, td, priorities=priorities))[1])
    monkeypatch.setattr(td_kernel, "td_loss_plain", lambda *a, **k: (
        heads.append(a[0].dtype), head(*a, **k))[1])
    jseen = []
    jupd = jb.update_priorities

    def jspy(state, idx, td, priorities=None):
        jax.debug.callback(lambda t: jseen.append(np.asarray(t)), td)
        return jupd(state, idx, td, priorities=priorities)

    jb.update_priorities = jspy
    ref_step, ref_opt = j_grouped_step(jnet, jb, 0.95, double_q, 1e-2, U,
                                       use_pallas=False)
    step, opt = make_grouped_dqn_train_step(tnet, tb, 0.95, double_q, 1e-2,
                                            U)
    k = jax.random.PRNGKey(20)
    u = torch.tensor(np.array(jax.random.uniform(k, (U * B,))))
    args = (jparams, jparams, ref_opt.init(jparams), js, k)
    if exact_bf16:
        ref_step = jax.jit(ref_step).lower(*args).compile(
            compiler_options={"xla_allow_excess_precision": False})
    rres = ref_step(*args)
    jax.effects_barrier()
    tres = step(params, target, opt.init(params), ts, u=u)
    return tres, rres, seen[0][0], jseen[0], tres.replay_state, tnet, heads


@pytest.mark.parametrize("kind,U", [("dense", 2), ("conv", 1), ("conv", 2),
                                    ("dueling", 1), ("dueling", 2)])
@pytest.mark.parametrize("double_q", [True, False])
def test_grouped_bf16_update_matches_jax(monkeypatch, kind, U, double_q):
    tres, rres, td, jtd, ts, tnet, heads = _grouped_pair(
        monkeypatch, kind, double_q, U, exact_bf16=True)
    assert heads == [torch.float32] * U  # K1 on f32 casts, per sub-update
    errors, n, bad = [], 0, 0
    tally = lambda t: (n + t[0], bad + t[1])
    n, bad = tally(_agree("loss", [float(tres.loss)], [float(rres.loss)],
                          errors))
    n, bad = tally(_agree("td", td.numpy(), jtd, errors))
    n, bad = tally(_agree("priority", ts.tree[0][:N].numpy(),
                          np.asarray(rres.replay_state.tree[0][:N]), errors))
    ref_p = convert._as_dict(tnet, np_(rres.params), "cpu")
    ref_o = convert.adam_from_optax(np_(rres.params), np_(rres.opt_state))
    for name in ref_p:
        assert tres.params[name].dtype == torch.bfloat16
        assert tres.opt_state.m[name].dtype == torch.bfloat16
        n, bad = tally(_agree(f"param {name}", _f32(tres.params[name]),
                              _f32(ref_p[name]), errors))
        n, bad = tally(_agree(f"m {name}", _f32(tres.opt_state.m[name]),
                              _f32(ref_o.m[name]), errors))
        n, bad = tally(_agree(f"v {name}", _f32(tres.opt_state.v[name]),
                              _f32(ref_o.v[name]), errors))
    assert int(tres.opt_state.count) == int(ref_o.count) == U
    assert bad <= 0.001 * n, (f"{bad} of {n} entries more than 2 bf16 ulps "
                              "off: " + "; ".join(errors[:40]))


@pytest.mark.parametrize("kind", ["conv", "dueling"])
def test_grouped_bf16_conv_update_two_sub_updates(monkeypatch, kind):
    """The conv nets at U = 2 against the JAX step as it runs by default:
    the first sub-update's TD within 2 bf16 ulps everywhere, the second's
    loss at rtol 5e-3 (see the module docstring), parameters bf16 and
    finite."""
    tres, rres, td, jtd, _, _, heads = _grouped_pair(monkeypatch, kind,
                                                     True, 2)
    assert heads == [torch.float32] * 2
    errors = []
    assert _agree("td", td[:B].numpy(), jtd[:B], errors)[1] == 0, errors
    np.testing.assert_allclose(float(tres.loss), float(rres.loss), rtol=5e-3)
    assert all(p.dtype == torch.bfloat16 and torch.isfinite(p).all()
               for p in tres.params.values())


def _routes(monkeypatch):
    """Which train-step factories and collect steps ``build_loop`` calls."""
    calls = []
    for name in ("make_fused_grouped_train_step",
                 "make_fused_grouped_drqn_train_step",
                 "make_grouped_dqn_train_step", "make_grouped_drqn_train_step",
                 "make_dqn_train_step", "make_drqn_train_step"):
        fn = getattr(loop, name)
        monkeypatch.setattr(loop, name, lambda *a, _f=fn, _n=name, **k: (
            calls.append(_n), _f(*a, **k))[1])
    from deepqlearning_tpu_torch.learner import actor

    fn = actor.make_fused_collect_step
    monkeypatch.setattr(actor, "make_fused_collect_step", lambda *a, **k: (
        calls.append("make_fused_collect_step"), fn(*a, **k))[1])
    return calls


@pytest.mark.parametrize("recurrent", [False, True])
def test_non_f32_dtype_refuses_the_f32_kernels(monkeypatch, recurrent):
    """With nets the K3/K4 (K5/K6) plans take, f32 takes the kernels and
    bf16 the plain steps and the plain collect; an iteration of the bf16
    loop runs (the twins of K1 and K2 on the feed-forward route)."""
    env = dt.SimpleGridWorld()
    calls = _routes(monkeypatch)
    for dtype in (torch.float32, torch.bfloat16):
        calls.clear()
        if recurrent:
            net = dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
            cfg = dt.DQNConfig(num_envs=128, train_freq=64, batch_size=8,
                               buffer_size=256, trace_length=4,
                               max_episode_length=5, recurrence=True,
                               dtype=dtype)
            buf = dt.EpisodeReplayBuffer(env.obs_shape, 256, 8, 4, 5,
                                         num_envs=128, obs_dtype=dtype,
                                         device="cpu")
        else:
            net = dt.create_dueling_network(dt.Chain(
                dt.Dense(2, 8, torch.tanh), dt.Dense(8, 4)))
            cfg = dt.DQNConfig(num_envs=128, train_freq=32, batch_size=8,
                               buffer_size=512, dtype=dtype)
            buf = dt.PrioritizedReplayBuffer(env.obs_shape, 512, 8,
                                             obs_dtype=dtype, device="cpu")
        it, pop, opt = loop.build_loop(env, net, buf, cfg,
                                       dt.LinearDecaySchedule(), env.discount)
        fused = "make_fused_collect_step" in calls and any(
            "fused_grouped" in c for c in calls)
        assert fused == (dtype == torch.float32), (dtype, calls)
        if dtype == torch.float32:
            continue
        assert calls == ["make_grouped_drqn_train_step" if recurrent
                         else "make_grouped_dqn_train_step"]
        c = loop.populate(pop, buf, loop.init_carry(env, net, buf, cfg, opt,
                                                    device="cpu"), 6)
        assert {p.dtype for p in c.params.values()} == {torch.bfloat16}
        c = it(c)
        assert torch.isfinite(c.loss) and int(c.opt_state.count) == \
            cfg.updates_per_iter
        assert {p.dtype for p in c.params.values()} == {torch.bfloat16}
        for flag in ("fused_updates", "fused_collect"):
            with pytest.raises(ValueError, match=f"{flag}=True"):
                loop.build_loop(env, net, buf, cfg.replace(**{flag: True}),
                                dt.LinearDecaySchedule(), env.discount)
