"""Port parity: sum tree and prioritized replay against the JAX package.

Priorities, transitions and uniforms are made with numpy from a seed and
fed to both packages.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepqlearning_tpu.ops import sumtree as jst  # noqa: E402
from deepqlearning_tpu.replay.prioritized import (  # noqa: E402
    PrioritizedReplayBuffer as JBuf, ReplayBuffer as JUniform)
from deepqlearning_tpu.replay.transition import (  # noqa: E402
    TransitionBatch as JBatch)
from deepqlearning_tpu_torch.ops import sumtree as tst  # noqa: E402
from deepqlearning_tpu_torch.replay.prioritized import (  # noqa: E402
    PrioritizedReplayBuffer as TBuf, ReplayBuffer as TUniform)
from deepqlearning_tpu_torch.replay.transition import (  # noqa: E402
    TransitionBatch as TBatch)

torch.set_num_threads(2)


def _same_draws(ours, theirs):
    """Sampled indices: >= 99% exact, the rest adjacent (a mass within an
    ulp of a child boundary may pick the neighbour, since the two packages'
    prefix sums add in other orders; tests/test_pallas_kernels.py rule)."""
    ours, theirs = np.asarray(ours), np.asarray(theirs)
    exact = ours == theirs
    assert exact.mean() >= 0.99, exact.mean()
    assert np.abs(ours - theirs).max() <= 1
    return exact


@pytest.mark.parametrize("cap", [1, 2, 64, 100, 4096, 1 << 20])
def test_level_sizes_match(cap):
    assert tst._level_sizes(tst.tree_capacity(cap)) == \
        jst._level_sizes(jst.tree_capacity(cap))


@pytest.mark.parametrize("cap,draws", [(64, 32), (4096, 600), (65536, 512)])
def test_rebuild_and_descend_match(cap, draws):
    rng = np.random.default_rng(cap)
    prios = (rng.random(cap) + 0.01).astype(np.float32)
    jt = jst.set_priorities(jst.init_tree(cap), jnp.arange(cap),
                            jnp.asarray(prios))
    tt = tst.set_priorities(tst.init_tree(cap), torch.arange(cap),
                            torch.from_numpy(prios))
    # level sums: f32 reductions in different orders -> rtol 1e-5
    for a, b in zip(tt, jt):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5)
    u = rng.random(draws).astype(np.float32)
    mass = (np.arange(draws, dtype=np.float32) + u) / draws * \
        np.float32(np.asarray(jt[-1])[0])
    ji, _ = jst.descend(jt, jnp.asarray(mass))
    ti, _ = tst.descend(tt, torch.from_numpy(mass))
    _same_draws(ti.numpy(), ji)


def test_last_write_wins_on_repeated_indices():
    tree = tst.init_tree(64)
    idx = torch.tensor([3, 5, 3, 7, 3])
    tst.set_priorities(tree, idx, torch.tensor([1.0, 2.0, 3.0, 4.0, 5.0]))
    assert float(tree[0][3]) == 5.0 and float(tst.total(tree)) == 11.0


def _batch(rng, n, lib):
    obs = rng.normal(size=(n, 2)).astype(np.float32)
    nobs = rng.normal(size=(n, 2)).astype(np.float32)
    act = rng.integers(0, 4, n).astype(np.int32)
    rew = rng.normal(size=n).astype(np.float32)
    done = (rng.random(n) < 0.1).astype(np.float32)
    if lib == "jax":
        return JBatch(jnp.asarray(obs), jnp.asarray(act), jnp.asarray(rew),
                      jnp.asarray(nobs), jnp.asarray(done))
    return TBatch(torch.from_numpy(obs), torch.from_numpy(act).long(),
                  torch.from_numpy(rew), torch.from_numpy(nobs),
                  torch.from_numpy(done))


def _compare_state(ts, js):
    np.testing.assert_array_equal(ts.rows.numpy(), np.asarray(js.rows))
    # leaves are (|r|+eps)^alpha of the same rewards: f32 pow, rtol 1e-6
    np.testing.assert_allclose(ts.tree[0].numpy(), np.asarray(js.tree[0]),
                               rtol=1e-6)
    assert ts.insert_pos == int(js.insert_pos) and ts.size == int(js.size)


@pytest.mark.parametrize("E", [128, 96])
def test_insert_aligned_and_wrapping(E):
    """E=128 divides the capacity (contiguous writes); E=96 does not (the
    scatter with wraparound)."""
    jb, tb = JBuf((2,), 1024, 32), TBuf((2,), 1024, 32, device="cpu")
    js, ts = jb.init(), tb.init()
    for i in range(12):  # 12*96 > 1024: wraps
        js = jb.insert(js, _batch(np.random.default_rng(i), E, "jax"))
        ts = tb.insert(ts, _batch(np.random.default_rng(i), E, "torch"))
    _compare_state(ts, js)


def _filled(seed=0, n=1024):
    jb, tb = JBuf((2,), n, 32), TBuf((2,), n, 32, device="cpu")
    js = jb.insert(jb.init(), _batch(np.random.default_rng(seed), n, "jax"))
    ts = tb.insert(tb.init(), _batch(np.random.default_rng(seed), n, "torch"))
    return jb, js, tb, ts


@pytest.mark.parametrize("n_batches", [1, 4])
def test_sample_n_u_major_and_is_weights(n_batches):
    jb, js, tb, ts = _filled()
    key = jax.random.PRNGKey(11)
    jbatch, jidx, jw = jb.sample_n(js, key, n_batches)
    u = torch.from_numpy(np.array(
        jax.random.uniform(key, (32 * n_batches,))))
    tbatch, tidx, tw = tb.sample_n(ts, n_batches, u=u)
    exact = _same_draws(tidx.numpy(), jidx)
    # IS weights (N p)^-beta from the same leaves and totals: rtol 1e-5
    np.testing.assert_allclose(tw.numpy()[exact], np.asarray(jw)[exact],
                               rtol=1e-5)
    for a, b in zip(tbatch, jbatch):
        np.testing.assert_array_equal(a.numpy()[exact], np.asarray(b)[exact])
    if n_batches > 1:
        # u-major: sub-batch u holds strata u, n+u, 2n+u, ... -> its draws
        # are increasing within the sub-batch
        sub = tidx.numpy().reshape(n_batches, 32)
        assert (np.diff(sub, axis=1) >= 0).all()


def test_empty_buffer_weights_are_clamped():
    jb, tb = JBuf((2,), 64, 8), TBuf((2,), 64, 8, device="cpu")
    _, _, jw = jb.sample(jb.init(), jax.random.PRNGKey(0))
    _, _, tw = tb.sample(tb.init(), u=torch.rand(8))
    np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
    assert (tw.numpy() == 1.0).all()


def test_update_priorities_matches():
    jb, js, tb, ts = _filled(seed=3)
    rng = np.random.default_rng(4)
    idx = rng.integers(0, 1024, 256).astype(np.int32)  # has repeats
    td = rng.normal(size=256).astype(np.float32)
    js = jb.update_priorities(js, jnp.asarray(idx), jnp.asarray(td))
    ts = tb.update_priorities(ts, torch.from_numpy(idx).long(),
                              torch.from_numpy(td))
    np.testing.assert_allclose(ts.tree[0].numpy(), np.asarray(js.tree[0]),
                               rtol=1e-6)
    np.testing.assert_allclose(float(tst.total(ts.tree)),
                               float(jst.total(js.tree)), rtol=1e-5)


def test_uniform_replay():
    jb, tb = JUniform((2,), 256, 16), TUniform((2,), 256, 16, device="cpu")
    js = jb.insert(jb.init(), _batch(np.random.default_rng(0), 256, "jax"))
    ts = tb.insert(tb.init(), _batch(np.random.default_rng(0), 256, "torch"))
    _compare_state(ts, js)
    _, idx, w = tb.sample(ts, u=torch.rand(16))
    assert (w.numpy() == 1.0).all()
    before = ts.tree[0].clone()
    tb.update_priorities(ts, idx, torch.ones(16))
    assert torch.equal(before, ts.tree[0])


def test_unsupported_storage_raises():
    # 1-, 2- and 4-byte storage dtypes are supported (narrow rows bit-cast
    # their scalars, tests/test_torch_narrow_storage.py); an 8-byte one
    # raises ValueError, as the JAX buffer does
    assert TBuf((2,), 64, 8, obs_dtype=torch.bfloat16,
                device="cpu").ratio == 2
    with pytest.raises(ValueError, match="1/2/4-byte"):
        TBuf((2,), 64, 8, obs_dtype=torch.float64, device="cpu")
    # the mode without replacement is supported; an unknown mode raises
    assert TBuf((2,), 64, 8, sample_mode="without_replacement",
                device="cpu").sample_mode == "without_replacement"
    with pytest.raises(ValueError, match="sample_mode"):
        TBuf((2,), 64, 8, sample_mode="bogus", device="cpu")
