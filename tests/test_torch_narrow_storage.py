"""Replay storage in a narrow dtype (uint8, bf16): the JAX package's
storage tests (``tests/test_replay.py::test_per_merged_rows_dtype_
preserving``, ``::test_episode_ring_dtype_preserving_storage``) on the
port, and the port's PER rows and episode ring equal to JAX's bit for bit
after the same inserts (the scalars' lanes in
``jax.lax.bitcast_convert_type``'s order). Inputs from a numpy seed."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402

torch.set_num_threads(2)
DTYPES = [(jnp.uint8, torch.uint8), (jnp.bfloat16, torch.bfloat16)]
IDS = ["uint8", "bf16"]


def _bits(x) -> np.ndarray:
    """The raw bytes of a JAX or torch array, as uint8."""
    if isinstance(x, torch.Tensor):
        return x.contiguous().view(torch.uint8).numpy().reshape(-1)
    return np.ascontiguousarray(np.asarray(x)).view(np.uint8).reshape(-1)


def _transitions(rng, E, obs_shape, scale=10.0):
    """E transitions (non-negative obs, as a uint8 buffer stores them)."""
    obs = (rng.random((E,) + obs_shape) * scale).astype(np.float32)
    nobs = (rng.random((E,) + obs_shape) * scale).astype(np.float32)
    act = rng.integers(0, 4, E).astype(np.int32)
    rew = (rng.normal(size=E) * 50).astype(np.float32)
    done = (rng.random(E) < 0.3).astype(np.float32)
    j = dq.TransitionBatch(jnp.asarray(obs), jnp.asarray(act),
                           jnp.asarray(rew), jnp.asarray(nobs),
                           jnp.asarray(done))
    t = dt.TransitionBatch(torch.tensor(obs), torch.tensor(act).long(),
                           torch.tensor(rew), torch.tensor(nobs),
                           torch.tensor(done))
    return j, t


@pytest.mark.parametrize("jd,td", DTYPES, ids=IDS)
def test_per_merged_rows_dtype_preserving(jd, td):
    """Scalars bit-cast into storage lanes round-trip exactly; obs keep the
    storage dtype (the JAX test, same data)."""
    buf = dt.PrioritizedReplayBuffer((3,), max_size=8, batch_size=4,
                                     obs_dtype=td, device="cpu")
    st = buf.init()
    assert st.rows.dtype == td and st.rows.shape == (8, 2 * 3 + 4 * buf.ratio)
    reward = torch.tensor([0.3, -1.7, 123.456, 0.0, 5.5, -2.25, 7.0, 1e-3])
    b = dt.TransitionBatch(
        obs=torch.arange(24, dtype=torch.float32).reshape(8, 3),
        action=torch.arange(8) % 4, reward=reward,
        next_obs=torch.arange(24, dtype=torch.float32).reshape(8, 3) + 100,
        done=torch.tensor([0, 1, 0, 0, 1, 0, 0, 1], dtype=torch.float32))
    st = buf.insert(st, b)
    batch, idx, w = buf.sample(st, generator=torch.Generator().manual_seed(0))
    assert batch.obs.dtype == td and batch.next_obs.dtype == td
    assert torch.equal(batch.reward, reward[idx])
    assert torch.equal(batch.action, (torch.arange(8) % 4)[idx])
    assert torch.equal(batch.obs.float(), b.obs[idx].to(td).float())
    sc = buf.peek_scalars(st)
    assert sc.dtype == torch.float32 and sc.shape == (8, 4)
    assert torch.equal(sc[:, 1], reward) and torch.equal(sc[:, 2], b.done)


@pytest.mark.parametrize("jd,td", DTYPES + [(jnp.float32, torch.float32)],
                         ids=IDS + ["f32"])
def test_per_rows_equal_jax_bit_for_bit(jd, td):
    """Two inserts (the second wraps around a capacity it does not divide)
    into the port's and JAX's buffers: the rows are the same bytes, the
    sum-tree leaves agree (rtol 1e-6, the same f32 power), and a sample at
    the same uniforms gives the same indices, obs bytes and scalars."""
    rng = np.random.default_rng(5)
    jb = dq.PrioritizedReplayBuffer((2, 3), 12, 4, obs_dtype=jd)
    tb = dt.PrioritizedReplayBuffer((2, 3), 12, 4, obs_dtype=td,
                                    device="cpu")
    js, ts = jb.init(), tb.init()
    for E in (8, 7):
        jt, tt = _transitions(rng, E, (2, 3))
        js, ts = jb.insert(js, jt), tb.insert(ts, tt)
    assert ts.rows.dtype == td
    np.testing.assert_array_equal(_bits(ts.rows), _bits(js.rows))
    np.testing.assert_allclose(ts.tree[0].numpy(), np.asarray(js.tree[0]),
                               rtol=1e-6)
    np.testing.assert_array_equal(tb.peek_scalars(ts).numpy(),
                                  np.asarray(jb.peek_scalars(js)))
    k = jax.random.PRNGKey(1)
    jbatch, jidx, jw = jb.sample_n(js, k, 2)
    u = torch.tensor(np.array(jax.random.uniform(k, (8,))))
    tbatch, tidx, tw = tb.sample_n(ts, 2, u=u)
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))
    assert tbatch.obs.dtype == td
    np.testing.assert_array_equal(_bits(tbatch.obs), _bits(jbatch.obs))
    np.testing.assert_array_equal(_bits(tbatch.next_obs),
                                  _bits(jbatch.next_obs))
    for f in ("action", "reward", "done"):
        np.testing.assert_array_equal(getattr(tbatch, f).numpy(),
                                      np.asarray(getattr(jbatch, f)))
    # the rows cross to the port as raw bits
    back = convert.replay_from_numpy(np.asarray(js.rows), js.tree,
                                     js.insert_pos, js.size)
    assert back.rows.dtype == td and torch.equal(back.rows, ts.rows)


@pytest.mark.parametrize("jd,td", DTYPES, ids=IDS)
def test_episode_ring_dtype_preserving_storage(jd, td):
    """The JAX test: every valid step's reward is exactly an inserted f32,
    actions are in range, masked steps are zero in every field."""
    buf = dt.EpisodeReplayBuffer((2,), max_size=4, batch_size=8,
                                 trace_length=3, max_episode_length=4,
                                 num_envs=1, obs_dtype=td, device="cpu")
    st = buf.init()
    assert st.data.dtype == td
    rewards = [0.3, -1.7, 123.456]
    for t in range(3):
        tr = dt.TransitionBatch(
            obs=torch.full((1, 2), float(10 * t)),
            action=torch.tensor([t]), reward=torch.tensor([rewards[t]]),
            next_obs=torch.full((1, 2), float(10 * t + 1)),
            done=torch.tensor([1.0 if t == 2 else 0.0]))
        st = buf.add_step(st, tr, torch.tensor([t == 2]))
    batch = buf.sample(st, generator=torch.Generator().manual_seed(0))
    assert batch.obs.dtype == td and batch.next_obs.dtype == td
    m, r, a = batch.mask.numpy(), batch.reward.numpy(), batch.action.numpy()
    assert m.sum() > 0 and (m == 0).any()
    assert np.all(np.isin(r[m > 0], np.asarray(rewards, np.float32)))
    assert np.all(np.isin(a[m > 0], [0, 1, 2]))
    np.testing.assert_array_equal(r * (1 - m), 0.0)
    np.testing.assert_array_equal(a * (1 - m), 0)
    np.testing.assert_array_equal(
        batch.obs.float().numpy() * (1 - m[..., None]), 0.0)


@pytest.mark.parametrize("jd,td", DTYPES, ids=IDS)
def test_episode_ring_equal_jax_bit_for_bit(jd, td):
    """Six lockstep steps of 4 envs (episodes ending at random) into both
    rings: the port's ``[R+T-1, E, F]`` ring is the bytes of JAX's grouped
    ``[R+T-1, E/G, G·F]`` ring, the records equal; the ring crosses to the
    port bit for bit."""
    rng = np.random.default_rng(6)
    args = ((3,), 8, 4, 3, 5)
    jb = dq.EpisodeReplayBuffer(*args, num_envs=4, obs_dtype=jd)
    tb = dt.EpisodeReplayBuffer(*args, num_envs=4, obs_dtype=td,
                                device="cpu")
    assert tb.F == jb.F and tb.ring == jb.ring
    js, ts = jb.init(), tb.init()
    for _ in range(6):
        jt, tt = _transitions(rng, 4, (3,))
        ended = rng.random(4) < 0.4
        js = jb.add_step(js, jt, jnp.asarray(ended))
        ts = tb.add_step(ts, tt, torch.tensor(ended))
    np.testing.assert_array_equal(_bits(ts.data), _bits(js.data))
    for f in ("ep_start", "ep_len", "rec_count", "cur_len"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)))
    back = convert.episode_replay_from_numpy(
        jax.tree_util.tree_map(np.asarray, js))
    assert back.data.dtype == td and torch.equal(back.data, ts.data)
