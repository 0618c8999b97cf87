"""Port parity: the episode replay (DRQN) against the JAX package's.

Transitions and episode ends are made with numpy from a seed and streamed
into both buffers; the port's sample takes the JAX sample's own draws
(derived from its key exactly as ``EpisodeReplayBuffer._sample_batch``
splits it). Everything compares exactly: the buffers copy f32 values and
index with the same integers.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.replay.episode import (  # noqa: E402
    EpisodeReplayBuffer as JBuf)
from deepqlearning_tpu.replay.transition import (  # noqa: E402
    TransitionBatch as JBatch)
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.ops import sumtree  # noqa: E402

torch.set_num_threads(2)


def jax_draws(jstate, key, D, M):
    """The draws ``_sample_batch(state, key, D)`` makes, as EpisodeDraws:
    the env draw takes the JAX branch (uniform once every env's record ring
    is full, else the count-tree mass)."""
    E = np.asarray(jstate.rec_count).shape[0]
    k_env, k_rec, k_start = jax.random.split(key, 3)
    t = lambda x: torch.from_numpy(np.array(x)).long()
    big = jnp.asarray(1 << 30)
    if int(jnp.min(jstate.rec_count)) >= M:
        env = dict(env=t(jax.random.randint(k_env, (D,), 0, E)))
    else:
        env = dict(env_u=torch.from_numpy(np.array(
            jax.random.uniform(k_env, (D,)))))
    return dt.EpisodeDraws(rec=t(jax.random.randint(k_rec, (D,), 0, big)),
                           start=t(jax.random.randint(k_start, (D,), 0, big)),
                           **env)


def _stream(jb, tb, E, steps, seed, p_end=0.3, no=3):
    """Stream the same random lockstep transitions into both buffers;
    yields both states after every step."""
    rng = np.random.default_rng(seed)
    js, ts = jb.init(), tb.init()
    jadd = jax.jit(jb.add_step)
    for _ in range(steps):
        obs = rng.normal(size=(E, no)).astype(np.float32)
        nobs = rng.normal(size=(E, no)).astype(np.float32)
        act = rng.integers(0, 4, E).astype(np.int32)
        rew = rng.normal(size=E).astype(np.float32)
        done = (rng.random(E) < p_end / 2).astype(np.float32)
        ended = (done > 0) | (rng.random(E) < p_end / 2)
        js = jadd(js, JBatch(jnp.asarray(obs), jnp.asarray(act),
                                    jnp.asarray(rew), jnp.asarray(nobs),
                                    jnp.asarray(done)), jnp.asarray(ended))
        ts = tb.add_step(ts, dt.TransitionBatch(
            torch.from_numpy(obs), torch.from_numpy(act).long(),
            torch.from_numpy(rew), torch.from_numpy(nobs),
            torch.from_numpy(done)), torch.from_numpy(ended))
        yield js, ts


def _same_state(ts, js):
    ref = convert.episode_replay_from_numpy(
        jax.tree_util.tree_map(np.asarray, js))
    for name in ("data", "ep_start", "ep_len", "rec_count", "cur_len"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      getattr(ref, name).numpy(), name)
    # the step counter: a 0-d int64 tensor on the buffer's device
    assert ts.t.dim() == 0 and ts.t.dtype == torch.int64
    assert ref.t.dim() == 0 and ref.t.dtype == torch.int64
    assert int(ts.t) == int(ref.t) == int(js.t)


def _same_batch(tbatch, jbatch):
    for name in tbatch._fields:
        np.testing.assert_array_equal(getattr(tbatch, name).numpy(),
                                      np.asarray(getattr(jbatch, name)), name)


@pytest.mark.parametrize("E,max_size,maxlen,T,p_end", [
    (8, 16, 4, 3, 0.3), (4, 8, 6, 5, 0.15), (16, 8, 3, 4, 0.35)])
def test_add_step_and_samples_match_jax_exactly(E, max_size, maxlen, T,
                                                p_end):
    """Ring and shadow rows, record commits, and samples (both env-draw
    branches, stale remaps after the ring wrapped) equal JAX's."""
    jb = JBuf((3,), max_size, 16, T, maxlen, num_envs=E)
    tb = dt.EpisodeReplayBuffer((3,), max_size, 16, T, maxlen, num_envs=E,
                                device="cpu")
    assert (tb.ring, tb.records_per_env, tb.F) == (jb.ring, jb.records_per_env,
                                                   jb.F)
    M, R = tb.records_per_env, tb.ring
    jsample = jax.jit(jb.sample_n, static_argnums=2)
    branches, stale_seen = set(), False
    for i, (js, ts) in enumerate(_stream(jb, tb, E, 3 * R + 5, E + T, p_end)):
        _same_state(ts, js)
        if i % 4 == 3:
            key = jax.random.PRNGKey(i)
            d = jax_draws(js, key, 32, M)
            branches.add(d.env is not None)
            _same_batch(tb.sample_n(ts, 2, draws=d), jsample(js, key, 2))
            written = torch.arange(M)[None, :] < ts.rec_count[:, None]
            age = ts.t - ts.ep_start.long()
            stale = age > R - ts.ep_len.long().clamp(min=1)
            stale_seen |= bool((stale & written).any())
    js = jb.reset_in_progress(js)
    ts = tb.reset_in_progress(ts)
    _same_state(ts, js)
    assert stale_seen                 # some records outlived their rows
    assert branches == {True, False}  # both JAX env-draw branches ran


def test_device_counter_over_ring_wraps_matches_jax_exactly():
    """R = 8, T = 4, 4 envs, 3R steps: after every step the ring (shadow
    rows included), the records, the open lengths and ``int(t)`` equal the
    JAX buffer's; the row of step ``t`` is ``t % R`` and its shadow
    ``R + t % R`` while ``t % R < T - 1``; samples of records the ring has
    overwritten are remapped as JAX remaps them. Exact: the buffers copy
    f32 values and index with the same integers."""
    E, T = 4, 4
    jb = JBuf((3,), 8, 16, T, 4, num_envs=E)
    tb = dt.EpisodeReplayBuffer((3,), 8, 16, T, 4, num_envs=E, device="cpu")
    R, M = tb.ring, tb.records_per_env
    assert (R, jb.ring) == (8, 8)
    jsample = jax.jit(jb.sample_n, static_argnums=2)
    stale_sampled = 0
    for i, (js, ts) in enumerate(_stream(jb, tb, E, 3 * R, 7, 0.4)):
        _same_state(ts, js)
        assert int(ts.t) == i + 1
        k = i % R
        if k < T - 1:
            assert torch.equal(ts.data[R + k], ts.data[k])
        key = jax.random.PRNGKey(100 + i)
        d = jax_draws(js, key, 32, M)
        _same_batch(tb.sample_n(ts, 2, draws=d), jsample(js, key, 2))
        # the records the draws took before the remap, and whether stale
        env = (d.env if d.env is not None else
               tb._weighted_env(ts, d.env_u)).long()
        n_rec = ts.rec_count[env].long().clamp(max=M).clamp(min=1)
        rec = d.rec % n_rec
        start = ts.ep_start[env, rec].long()
        length = ts.ep_len[env, rec].long().clamp(min=1)
        stale_sampled += int(((ts.t - start) > (R - length)).sum())
    assert stale_sampled > 0


@pytest.mark.parametrize("E,M", [(1, 3), (7, 2), (64, 4), (100, 3),
                                 (16384, 2)])
def test_weighted_env_equals_the_count_tree_descent(E, M):
    """The env draw (one searchsorted over the prefix sums of the record
    counts) picks the env the count-tree descent picks (``ops/sumtree.py``,
    as the JAX package draws it), exactly: on random counts with zeros, at
    uniforms that put the mass on every prefix boundary, at 0 and at the
    largest f32 below 1, and with no record stored at all."""
    buf = dt.EpisodeReplayBuffer((2,), E * M, 4, 2, 4, num_envs=E,
                                 device="cpu")
    assert buf.records_per_env == M
    rng = np.random.default_rng(E)
    for zeros in (0.0, 0.5, 1.0):
        counts = rng.integers(0, M + 3, E) * (rng.random(E) >= zeros)
        st = buf.init()._replace(
            rec_count=torch.from_numpy(counts.astype(np.int32)))
        clamped = torch.clamp(st.rec_count, max=M).float()
        total = max(float(clamped.sum()), 1.0)
        bounds = torch.cumsum(clamped, 0)[:-1] / total
        u = torch.cat([torch.rand(4096, generator=torch.Generator()
                                  .manual_seed(E)),
                       bounds.float(), torch.tensor([0.0, 1.0 - 2 ** -24])])
        tree = sumtree.init_tree(E)
        tree[0][:E] = clamped
        sumtree.rebuild(tree)
        mass = u * torch.clamp(sumtree.total(tree), min=1.0)
        want = torch.clamp(sumtree.descend(tree, mass)[0], max=E - 1)
        assert torch.equal(buf._weighted_env(st, u), want)


def test_windows_across_the_ring_boundary():
    """Episodes of lengths 3, 3, 4 in a ring of 8: the third spans rows
    6, 7, 0, 1, read through the shadow rows as one contiguous window."""
    T = 4
    buf = dt.EpisodeReplayBuffer((1,), 2, 256, T, 4, num_envs=1, device="cpu")
    assert buf.ring == 8
    st, t = buf.init(), 0
    for L in (3, 3, 4):
        for j in range(L):
            ended = j == L - 1
            st = buf.add_step(st, dt.TransitionBatch(
                torch.tensor([[float(t)]]), torch.tensor([t % 4]),
                torch.tensor([float(t)]), torch.tensor([[t + 0.5]]),
                torch.tensor([float(ended)])), torch.tensor([ended]))
            t += 1
    batch = buf.sample(st, generator=torch.Generator().manual_seed(0))
    obs, rew, mask = batch.obs[..., 0], batch.reward, batch.mask
    starts = obs[:, 0]
    assert ((starts >= 6) & (mask[:, 1] > 0)).any()
    for b in range(obs.shape[0]):
        for j in range(T):
            if mask[b, j]:
                assert obs[b, j] == starts[b] + j == rew[b, j]
                assert batch.next_obs[b, j, 0] == starts[b] + j + 0.5
            else:
                assert obs[b, j] == 0.0 and rew[b, j] == 0.0


def test_draws_are_uniform_over_stored_episodes():
    """env0 commits 1 episode, env1 commits 4: uniform over episodes gives
    env0 1/5 of the draws (uniform over envs would give 1/2)."""
    buf = dt.EpisodeReplayBuffer((1,), 8, 4096, 2, 4, num_envs=2, device="cpu")
    st = buf.init()
    for t in range(4):
        st = buf.add_step(st, dt.TransitionBatch(
            torch.full((2, 1), float(t)), torch.tensor([0, 1]),
            torch.ones(2), torch.full((2, 1), float(t)),
            torch.tensor([float(t == 3), 1.0])), torch.tensor([t == 3, True]))
    assert st.rec_count.tolist() == [1, 4]
    batch = buf.sample(st, generator=torch.Generator().manual_seed(3))
    frac_env0 = float((batch.action[:, 0] == 0).float().mean())
    # binomial std at 4096 draws ~ 0.006
    assert abs(frac_env0 - 0.2) < 0.03, frac_env0


def test_ring_memory_cap_and_storage():
    buf = dt.EpisodeReplayBuffer((84, 84, 4), 1000, 4, 8, 100, num_envs=1,
                                 max_ring_bytes=256 << 20, device="cpu")
    jbuf = JBuf((84, 84, 4), 1000, 4, 8, 100, num_envs=1,
                max_ring_bytes=256 << 20)
    assert buf.ring == jbuf.ring
    assert buf.ring * (2 * 84 * 84 * 4 * 4 + 16) <= 256 << 20
    assert buf.ring >= 2 * buf.max_episode_length
    with pytest.raises(ValueError, match="max_ring_bytes"):
        dt.EpisodeReplayBuffer((84, 84, 4), 1000, 4, 8, 100, num_envs=64,
                               max_ring_bytes=16 << 20, device="cpu")
    # a uint8 ring holds 4x the history under the same cap, as JAX's
    buf8 = dt.EpisodeReplayBuffer((84, 84, 4), 1000, 4, 8, 100, num_envs=1,
                                  obs_dtype=torch.uint8,
                                  max_ring_bytes=256 << 20, device="cpu")
    assert buf8.ring == JBuf((84, 84, 4), 1000, 4, 8, 100, num_envs=1,
                             obs_dtype=np.uint8,
                             max_ring_bytes=256 << 20).ring
    assert buf8.F == 2 * 84 * 84 * 4 + 16 and buf8.ring == 4 * buf.ring
    with pytest.raises(ValueError, match="1/2/4-byte"):
        dt.EpisodeReplayBuffer((2,), 8, 4, 2, 4, obs_dtype=torch.float64,
                               device="cpu")
