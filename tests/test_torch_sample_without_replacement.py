"""PER without replacement (``ops/sumtree.py::sample_without_replacement``
and ``PrioritizedReplayBuffer(sample_mode="without_replacement")``) against
the JAX package, with the Gumbel noise JAX draws injected into the port,
and the JAX replay tests' invariants (``tests/test_replay.py``) on the
port: distinct and proportional draws, one independent pass per
sub-batch, zero IS weight for unfilled slots, the mode's checks."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepqlearning_tpu.ops import sumtree as jst  # noqa: E402
from deepqlearning_tpu.replay.prioritized import (  # noqa: E402
    PrioritizedReplayBuffer as JBuf)
from deepqlearning_tpu.replay.transition import (  # noqa: E402
    TransitionBatch as JBatch)
from deepqlearning_tpu_torch.ops import sumtree as tst  # noqa: E402
from deepqlearning_tpu_torch.replay.prioritized import (  # noqa: E402
    PrioritizedReplayBuffer as TBuf)
from deepqlearning_tpu_torch.replay.transition import (  # noqa: E402
    TransitionBatch as TBatch)

torch.set_num_threads(2)
WOR = "without_replacement"


def _batches(n, rng):
    obs = rng.normal(size=(n, 3)).astype(np.float32)
    nobs = rng.normal(size=(n, 3)).astype(np.float32)
    act = rng.integers(0, 4, n)
    rew = rng.normal(size=n).astype(np.float32)
    done = (rng.random(n) < 0.1).astype(np.float32)
    j = JBatch(obs=jnp.asarray(obs), action=jnp.asarray(act, jnp.int32),
               reward=jnp.asarray(rew), next_obs=jnp.asarray(nobs),
               done=jnp.asarray(done))
    t = TBatch(obs=torch.tensor(obs), action=torch.tensor(act),
               reward=torch.tensor(rew), next_obs=torch.tensor(nobs),
               done=torch.tensor(done))
    return j, t


@pytest.mark.parametrize("cap,filled,B", [(8, 4, 2), (64, 64, 16),
                                          (4096, 3000, 256)])
def test_gumbel_top_k_matches_jax(cap, filled, B):
    rng = np.random.default_rng(cap)
    prios = np.zeros(cap, np.float32)
    prios[:filled] = rng.random(filled) + 0.01
    jt = jst.set_priorities(jst.init_tree(cap), jnp.arange(cap),
                            jnp.asarray(prios))
    tt = tst.set_priorities(tst.init_tree(cap), torch.arange(cap),
                            torch.from_numpy(prios))
    for seed in range(5):
        key = jax.random.PRNGKey(seed)
        ji, jp = jst.sample_without_replacement(jt, key, B)
        noise = jax.random.gumbel(key, jt[0].shape, jnp.float32)
        ti, tp = tst.sample_without_replacement(
            tt, B, noise=torch.tensor(np.asarray(noise)))
        np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
        np.testing.assert_array_equal(tp.numpy(), np.asarray(jp))
        assert len(set(ti.tolist())) == B


@pytest.mark.parametrize("cap,n,B,U", [(16, 16, 8, 1), (16, 4, 8, 1),
                                       (8, 8, 8, 4), (1024, 700, 64, 3)])
def test_buffer_mode_matches_jax(cap, n, B, U):
    """``sample_n`` draws U independent passes (u-major) with the noise of
    JAX's per-sub-batch keys: the same rows, indices and IS weights
    (weight 0 where a pass ran out of filled slots)."""
    rng = np.random.default_rng(n)
    jb, tb = JBuf((3,), cap, B, sample_mode=WOR), TBuf((3,), cap, B,
                                                      sample_mode=WOR,
                                                      device="cpu")
    jbatch, tbatch = _batches(n, rng)
    js, ts = jb.insert(jb.init(), jbatch), tb.insert(tb.init(), tbatch)
    key = jax.random.PRNGKey(7)
    jbat, jidx, jw = jb.sample_n(js, key, U)
    keys = jax.random.split(key, U)
    noise = np.stack([np.asarray(jax.random.gumbel(k, js.tree[0].shape,
                                                   jnp.float32))
                      for k in keys])
    tbat, tidx, tw = tb.sample_n(ts, U, u=torch.tensor(noise))
    jidx, jw = np.asarray(jidx), np.asarray(jw)
    filled = jidx < n
    # beyond the filled slots, both take zero-priority leaves; which ones
    # is the top-k's tie order, so those draws are compared by weight only
    np.testing.assert_array_equal(tidx.numpy()[filled], jidx[filled])
    np.testing.assert_array_equal(tidx.numpy() < n, filled)
    np.testing.assert_allclose(tw.numpy(), jw, rtol=1e-6)
    assert (tw.numpy()[~filled] == 0.0).all() and (tw.numpy()[filled] > 0).all()
    np.testing.assert_array_equal(tbat.obs.numpy()[filled],
                                  np.asarray(jbat.obs)[filled])
    np.testing.assert_array_equal(tbat.action.numpy()[filled],
                                  np.asarray(jbat.action)[filled])


def test_sampler_distinct_and_proportional():
    """Distinct within a batch, frequencies that track the priorities
    across batches, zero-priority slots never drawn."""
    prio = torch.tensor([4.0, 2.0, 1.0, 1.0, 0.0, 0.0, 0.0, 0.0])
    tree = tst.set_priorities(tst.init_tree(8), torch.arange(8), prio)
    counts = np.zeros(8)
    g = torch.Generator().manual_seed(0)
    for _ in range(400):
        idx, p = tst.sample_without_replacement(tree, 2, generator=g)
        idx = idx.numpy()
        assert len(set(idx.tolist())) == 2
        assert (idx < 4).all()
        np.testing.assert_array_equal(p.numpy(), prio.numpy()[idx])
        counts[idx] += 1
    assert counts[0] > counts[2] * 1.5
    assert counts[4:].sum() == 0


def test_buffer_mode_end_to_end():
    rng = np.random.default_rng(0)
    buf = TBuf((3,), 16, 8, sample_mode=WOR, device="cpu")
    state = buf.insert(buf.init(), _batches(16, rng)[1])
    g = torch.Generator().manual_seed(0)
    batch, idx, w = buf.sample(state, generator=g)
    assert len(set(idx.tolist())) == 8
    assert torch.isfinite(w).all()
    p = state.tree[0][idx] / tst.total(state.tree)
    np.testing.assert_allclose(w.numpy(), ((16 * p) ** (-buf.beta)).numpy(),
                               rtol=1e-5)
    with pytest.raises(ValueError, match="sample_mode"):
        TBuf((3,), 16, 8, sample_mode="bogus", device="cpu")
    with pytest.raises(ValueError, match="batch_size"):
        TBuf((3,), 8, 16, sample_mode=WOR, device="cpu")


def test_grouped_draws_are_per_subbatch():
    """8 filled slots, 8 draws per sub-batch: each of the U sub-batches is
    a permutation of the filled slots (a single shared pass could not
    draw 32 distinct slots from 8)."""
    buf = TBuf((3,), 8, 8, sample_mode=WOR, device="cpu")
    state = buf.insert(buf.init(), _batches(8, np.random.default_rng(1))[1])
    U = 4
    _, idx, w = buf.sample_n(state, U, generator=torch.Generator()
                             .manual_seed(3))
    assert idx.shape == (U * 8,)
    for u in range(U):
        assert sorted(idx[u * 8:(u + 1) * 8].tolist()) == list(range(8))
    assert torch.isfinite(w).all()


def test_unfilled_draws_get_zero_weight():
    buf = TBuf((3,), 16, 8, sample_mode=WOR, device="cpu")
    state = buf.insert(buf.init(), _batches(4, np.random.default_rng(2))[1])
    _, idx, w = buf.sample(state, generator=torch.Generator().manual_seed(0))
    filled = idx < 4
    assert int(filled.sum()) == 4
    assert (w[~filled] == 0.0).all() and (w[filled] > 0.0).all()


def test_loop_trains_without_replacement():
    """The mode through ``build_loop``'s grouped step (the plain grouped
    step on CPU tensors): the sample draws from the loop's generator and
    bypasses the stratified descent (K2)."""
    import deepqlearning_tpu_torch as dt
    from deepqlearning_tpu_torch.learner.loop import build_loop
    from deepqlearning_tpu_torch.utils import profiling

    env = dt.SimpleGridWorld()
    net = dt.create_dueling_network(dt.Chain(
        dt.Flatten(), dt.Dense(2, 16, torch.tanh), dt.Dense(16, 4)))
    cfg = dt.DQNConfig(num_envs=64, train_freq=16, batch_size=16,
                       buffer_size=256, max_episode_length=10,
                       prioritized_sample_mode=WOR)
    buf = TBuf(env.obs_shape, 256, 16, sample_mode=WOR, device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(),
                              env.discount)
    c = dt.init_carry(env, net, buf, cfg, opt, device="cpu")
    cc = pop((c.actor, c.replay, c.params), c.generator)
    c = c._replace(actor=cc[0], replay=cc[1])
    before = profiling.counter("kernels.launches", "dq_tree_sample")
    for _ in range(2):
        c = it(c)
    assert np.isfinite(float(c.loss)) and c.replay.size == 192
    assert profiling.counter("kernels.launches", "dq_tree_sample") == before
