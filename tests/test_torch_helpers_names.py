"""The port's last public names against their JAX functions on the same
numpy-made inputs: the helper layer (``obs_dimensions``,
``default_discount``, ``hiddenstates`` / ``sethiddenstates`` on a Chain
with an LSTM, ``batch_trajectories``), ``sumtree.get_leaf``,
``transition.batch_from_experience`` and ``EpisodeReplayBuffer.size_fn``;
and an AST walk that finds no top-level name of a JAX module (nor the
envs' per-instance methods) missing from its port module, apart from
ROADMAP's "Not to port" list. CPU only."""
import ast
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.ops import helpers as jh  # noqa: E402
from deepqlearning_tpu.ops import sumtree as jtree  # noqa: E402
from deepqlearning_tpu.replay import transition as jtr  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.ops import helpers as th  # noqa: E402
from deepqlearning_tpu_torch.ops import sumtree as ttree  # noqa: E402
from deepqlearning_tpu_torch.replay import transition as ttr  # noqa: E402
from test_torch_episode_replay import _stream  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_obs_dimensions_and_default_discount():
    class Raw:  # a raw env without a discount
        obs_shape = [3, 2]

    for je, te in ((dq.SimpleGridWorld(), dt.SimpleGridWorld()),
                   (dq.TestMDP((5, 5), 4, 6), dt.TestMDP((5, 5), 4, 6)),
                   (dq.CartPole(), dt.CartPole()), (Raw(), Raw())):
        assert th.obs_dimensions(te) == jh.obs_dimensions(je)
        assert isinstance(th.obs_dimensions(te), tuple)
        assert th.default_discount(te) == jh.default_discount(je)
    assert th.default_discount(Raw()) == 1.0


@pytest.mark.parametrize("shape", [(4, 6), (4, 6, 3), (2, 5, 3, 2)])
def test_batch_trajectories_matches_jax(shape):
    x = np.random.default_rng(0).normal(size=shape).astype(np.float32)
    B, T = shape[:2]
    out = dt.batch_trajectories(torch.from_numpy(x), T, B)
    ref = np.asarray(dq.batch_trajectories(jnp.asarray(x), T, B))
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="batch_trajectories"):
        dt.batch_trajectories(torch.from_numpy(x), T + 1, B)
    assert "batch_trajectories" in dt.__all__
    assert dt.batch_trajectories is th.batch_trajectories


def test_hiddenstates_matches_jax_on_an_lstm_chain():
    nj = dq.Chain(dq.Dense(3, 8, jnp.tanh), dq.LSTM(8, 4), dq.Dense(4, 2))
    nt = dt.Chain(dt.Dense(3, 8, torch.tanh), dt.LSTM(8, 4), dt.Dense(4, 2))
    pj = nj.init(jax.random.PRNGKey(0))
    pt = convert.params_from_numpy(nt, jax.tree_util.tree_map(np.asarray,
                                                              pj))
    B = 5
    sj, st = nj.init_state(B), nt.init_state(B)
    hj, ht = jh.hiddenstates(sj), th.hiddenstates(st)
    assert len(hj) == len(ht) == 1 and len(ht[0]) == 2
    rng = np.random.default_rng(1)
    hs = [tuple(rng.normal(size=(B, 4)).astype(np.float32) for _ in range(2))]
    sj = jh.sethiddenstates(sj, [tuple(jnp.asarray(h) for h in hs[0])])
    st = th.sethiddenstates(st, [tuple(torch.from_numpy(h) for h in hs[0])])
    assert [s == () for s in st] == [s == () for s in sj] == [True, False,
                                                             True]
    x = rng.normal(size=(B, 3)).astype(np.float32)
    qj, sj2 = nj.apply(pj, jnp.asarray(x), sj)
    qt, st2 = nt.apply(pt, torch.from_numpy(x), st)
    np.testing.assert_allclose(qt.detach().numpy(), np.asarray(qj),
                               rtol=1e-5, atol=1e-6)
    for a, b in zip(th.hiddenstates(st2)[0], jh.hiddenstates(sj2)[0]):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   rtol=1e-5, atol=1e-6)


def test_get_leaf_matches_jax():
    rng = np.random.default_rng(2)
    cap = 300
    idx = rng.integers(0, cap, 64)
    pri = rng.random(64).astype(np.float32)
    jt = jtree.set_priorities(jtree.init_tree(cap), jnp.asarray(idx),
                              jnp.asarray(pri))
    tt = ttree.set_priorities(ttree.init_tree(cap, "cpu"),
                              torch.from_numpy(idx), torch.from_numpy(pri))
    q = rng.integers(0, cap, 100)
    np.testing.assert_array_equal(
        ttree.get_leaf(tt, torch.from_numpy(q)).numpy(),
        np.asarray(jtree.get_leaf(jt, jnp.asarray(q))))


def test_batch_from_experience_matches_jax():
    rng = np.random.default_rng(3)
    for done in (False, True):
        s = rng.normal(size=(3, 2)).astype(np.float32)
        sp = rng.normal(size=(3, 2)).astype(np.float32)
        a, r = int(rng.integers(0, 4)), float(rng.normal())
        jb = jtr.batch_from_experience(jtr.DQExperience(s, a, r, sp, done))
        tb = ttr.batch_from_experience(ttr.DQExperience(s, a, r, sp, done),
                                       "cpu")
        assert isinstance(tb, dt.TransitionBatch)
        for name in tb._fields:
            t, j = getattr(tb, name), np.asarray(getattr(jb, name))
            assert t.shape == j.shape, name
            np.testing.assert_array_equal(t.numpy(), j, name)
        assert tb.action.dtype == torch.long
        assert tb.reward.dtype == tb.done.dtype == torch.float32


@pytest.mark.parametrize("E,max_size,maxlen,T", [(8, 16, 4, 3), (4, 8, 6, 5)])
def test_episode_size_fn_matches_jax(E, max_size, maxlen, T):
    jb = dq.EpisodeReplayBuffer((3,), max_size, 16, T, maxlen, num_envs=E)
    tb = dt.EpisodeReplayBuffer((3,), max_size, 16, T, maxlen, num_envs=E,
                                device="cpu")
    sizes = []
    for js, ts in _stream(jb, tb, E, 40, seed=E):
        n = tb.size_fn(ts)
        assert n.dtype == torch.int32
        assert int(n) == int(jb.size_fn(js))
        sizes.append(int(n))
    assert sizes[-1] > sizes[0] and sizes[-1] <= E * tb.records_per_env


# --- the names ---------------------------------------------------------
# ROADMAP's "Not to port" list: the one-hot gather, the envs' State
# NamedTuples, the fused Adam layout, the step timer
NOT_TO_PORT = {"ops/lookup.py": {"take0"},
               "learner/train_step.py": {"FusedAdamState"},
               "utils/profiling.py": {"StepTimer"}}
ENV_METHODS = ("reset", "step", "observe")


def _defs(path):
    """Top-level function and class names, and each class's methods."""
    tree = ast.parse(open(path).read())
    names, methods = set(), {}
    for node in tree.body:
        if isinstance(node, (ast.FunctionDef, ast.ClassDef)):
            names.add(node.name)
        if isinstance(node, ast.ClassDef):
            methods[node.name] = {m.name for m in node.body
                                  if isinstance(m, ast.FunctionDef)}
    return names, methods


def test_every_jax_name_has_a_port_counterpart():
    jroot = os.path.join(REPO, "deepqlearning_tpu")
    troot = os.path.join(REPO, "deepqlearning_tpu_torch")
    missing = []
    for d, _, files in os.walk(jroot):
        rel_d = os.path.relpath(d, jroot)
        if rel_d.startswith(os.path.join("ops", "pallas")):
            continue  # the kernels: ops/cuda/ and csrc/
        for f in files:
            if not f.endswith(".py"):
                continue
            rel = os.path.normpath(os.path.join(rel_d, f))
            jn, jm = _defs(os.path.join(jroot, rel))
            tpath = os.path.join(troot, rel)
            tn, tm = _defs(tpath) if os.path.exists(tpath) else (set(), {})
            skip = NOT_TO_PORT.get(rel, set())
            if rel.startswith("envs"):
                skip = {n for n in jn if n.endswith("State")}
            missing += [f"{rel}::{n}" for n in sorted(jn - tn - skip)
                        if not n.startswith("_")]
            if rel.startswith("envs"):
                for cls, ms in jm.items():
                    for m in ENV_METHODS:
                        if (m in ms and cls in tm and m not in tm[cls]
                                and not (cls in ("MDPEnv", "POMDPEnv")
                                         and m == "observe")):
                            missing.append(f"{rel}::{cls}.{m}")
    assert not missing, missing
