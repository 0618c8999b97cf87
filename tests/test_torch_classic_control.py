"""CartPole, MountainCar and Acrobot (``deepqlearning_tpu_torch/envs``)
against the JAX package's envs.

CartPole and MountainCar: ``step_cols`` / ``reset_cols`` against JAX's on
the same cols and injected uniforms, at each action, with states at and one
ulp either side of every threshold, and at MountainCar's wall and speed
clamps; values at rtol 1e-6 (atol 1e-7 CartPole, 1e-8 MountainCar) and
done exactly, the tolerances of ``tests/test_fused_collect.py``'s cols
checks. Acrobot: ``step_batch`` against JAX's vmapped ``step`` at rtol
1e-5, and ``_wrap_pi`` at ±π. Then the JAX env tests' invariants
(``tests/test_envs.py``) on the port.
"""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.envs import acrobot as jacro  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.envs import acrobot as tacro  # noqa: E402

torch.set_num_threads(2)
f32 = np.float32


def _around(v):
    """``v`` in f32 and its neighbours one ulp below and above, both signs."""
    c = f32(v)
    near = [np.nextafter(c, f32(-np.inf)), c, np.nextafter(c, f32(np.inf))]
    return np.array(near + [-x for x in near], f32)


def _cartpole_states(rng):
    """Random states (many past the thresholds) and states whose next x or
    theta lands at a threshold or one ulp either side (zero velocity keeps
    x + tau * 0 exact)."""
    n = 256
    rand = np.stack([rng.uniform(-2.6, 2.6, n), rng.normal(0, 2, n),
                     rng.uniform(-0.25, 0.25, n), rng.normal(0, 3, n)])
    env = dq.CartPole()
    xs = _around(env.x_threshold)
    ths = _around(env.theta_threshold)
    at_x = np.stack([xs, np.zeros_like(xs), np.full_like(xs, 0.01),
                     np.zeros_like(xs)])
    at_th = np.stack([np.full_like(ths, 0.3), np.zeros_like(ths), ths,
                      np.zeros_like(ths)])
    return np.concatenate([rand, at_x, at_th], axis=1).astype(f32)


def _mountain_car_states(rng):
    """Random states, states at the left wall driving left, at the speed
    clamps, and states whose next position (at the clamped top speed, an
    exact f32 sum) lands on the goal or one ulp either side."""
    n = 256
    rand = np.stack([rng.uniform(-1.2, 0.6, n), rng.uniform(-0.07, 0.07, n)])
    env = dq.MountainCar()
    wall = np.array([[-1.2, -1.19, -1.2, -1.15], [-0.07, -0.07, 0.0, -0.07]])
    speed = np.array([[-0.5, -0.3, 0.0], [0.07, -0.07, 0.0699]])
    top = f32(env.max_speed)
    goal = f32(env.goal_position) - top
    gpos = np.array([np.nextafter(goal, f32(-1)), goal,
                     np.nextafter(goal, f32(1))], f32)
    at_goal = np.stack([gpos, np.full(3, top)])
    return np.concatenate([rand, wall, speed, at_goal], axis=1).astype(f32)


@pytest.mark.parametrize("name", ["cartpole", "mountain_car"])
def test_cols_step_and_reset_match_jax(name):
    rng = np.random.default_rng(0)
    if name == "cartpole":
        jenv, tenv = dq.CartPole(), dt.CartPole()
        cols, atol = _cartpole_states(rng), 1e-7
    else:
        jenv, tenv = dq.MountainCar(), dt.MountainCar()
        cols, atol = _mountain_car_states(rng), 1e-8
    N = cols.shape[1]
    empty = np.zeros((0, N), f32)
    dones = 0
    for a in range(jenv.num_actions):
        act = np.full((1, N), float(a), f32)
        jc, jo, jr, jd = jenv.step_cols(jnp.asarray(cols), jnp.asarray(act),
                                        jnp.asarray(empty))
        for action in (torch.tensor(act[0]), torch.full((N,), a)):
            tc, to, tr, td = tenv.step_cols(torch.tensor(cols.T.copy()),
                                            action, torch.tensor(empty))
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc).T,
                                       rtol=1e-6, atol=atol)
            np.testing.assert_allclose(to.numpy(), np.asarray(jo).T,
                                       rtol=1e-6, atol=atol)
            np.testing.assert_array_equal(tr.numpy(), np.asarray(jr)[0])
            np.testing.assert_array_equal(td.numpy(), np.asarray(jd)[0])
        dones += int(td.sum())
        # the keyed batch step is the cols step
        bs, bo, br, bd = tenv.step_batch(torch.tensor(cols.T.copy()),
                                         torch.full((N,), a), None)
        assert torch.equal(bs, tc) and torch.equal(bd, td)
    assert 0 < dones < N * jenv.num_actions
    u = rng.random((tenv.n_uniform_reset, 512)).astype(f32)
    jc, jo = jenv.reset_cols(jnp.asarray(u))
    tc, to = tenv.reset_cols(torch.tensor(u))
    np.testing.assert_array_equal(tc.numpy(), np.asarray(jc).T)
    np.testing.assert_array_equal(to.numpy(), np.asarray(jo).T)


def test_threshold_states_flip_where_jax_flips():
    """At a threshold exactly the episode goes on (a strict ``>``); one ulp
    past it, it ends: in both packages, for CartPole's x and theta and
    MountainCar's goal (``>=``)."""
    cp = dt.CartPole()
    cols = _cartpole_states(np.random.default_rng(1))[:, 256:]
    _, _, _, d = cp.step_cols(torch.tensor(cols.T.copy()), torch.zeros(12))
    np.testing.assert_array_equal(d.numpy(), [0, 0, 1, 0, 0, 1] * 2)
    mc = dt.MountainCar()
    cols = _mountain_car_states(np.random.default_rng(1))[:, -3:]
    _, _, _, d = mc.step_cols(torch.tensor(cols.T.copy()), torch.full((3,), 2))
    np.testing.assert_array_equal(d.numpy(), [0, 1, 1])


def test_acrobot_step_matches_jax():
    rng = np.random.default_rng(2)
    N = 512
    st = np.stack([rng.uniform(-math.pi, math.pi, N),
                   rng.uniform(-math.pi, math.pi, N),
                   rng.uniform(-4 * math.pi, 4 * math.pi, N),
                   rng.uniform(-9 * math.pi, 9 * math.pi, N)]).astype(f32)
    # states at ±π and the velocity clamps
    st[:, :4] = np.array([[math.pi, -math.pi, math.pi, 0.0],
                          [math.pi, math.pi, -math.pi, 0.0],
                          [12.5, -12.5, 0.0, 0.0],
                          [28.2, -28.2, 0.0, 0.0]], f32)
    jenv, tenv = dq.Acrobot(), dt.Acrobot()
    jst = jacro.AcrobotState(*[jnp.asarray(x) for x in st])
    for a in range(3):
        js, jo, jr, jd = jenv.step_batch(jst, jnp.full((N,), a, jnp.int32),
                                         jax.random.PRNGKey(0))
        ts, to, tr, td = tenv.step_batch(torch.tensor(st.T.copy()),
                                         torch.full((N,), a), None)
        ref = convert.env_state_from_numpy(
            jax.tree_util.tree_map(np.asarray, js)).numpy()
        # angles wrap at ±π: compare them on the circle
        diff = ts.numpy() - ref
        diff[:, :2] = (diff[:, :2] + math.pi) % (2 * math.pi) - math.pi
        np.testing.assert_array_less(np.abs(diff),
                                     1e-5 * np.maximum(1.0, np.abs(ref)))
        np.testing.assert_allclose(to.numpy(), np.asarray(jo), rtol=1e-5,
                                   atol=1e-5)
        np.testing.assert_array_equal(tr.numpy(), np.asarray(jr))
        height = -np.cos(ref[:, 0]) - np.cos(ref[:, 1] + ref[:, 0])
        clear = np.abs(height - 1.0) > 1e-4
        np.testing.assert_array_equal(td.numpy()[clear],
                                      np.asarray(jd, f32)[clear])


def test_wrap_pi_matches_jax_at_pi():
    x = np.array([math.pi, -math.pi, 3 * math.pi, -3 * math.pi, 0.0, 1.0,
                  -1.0, 7.5, -7.5, np.nextafter(f32(math.pi), f32(4))], f32)
    t = tacro._wrap_pi(torch.tensor(x)).numpy()
    j = np.asarray(jacro._wrap_pi(jnp.asarray(x)))
    np.testing.assert_allclose(t, j, rtol=1e-5, atol=1e-6)
    # a floor modulo: negative inputs wrap into [-π, π) like positive ones
    assert (t >= -math.pi - 1e-6).all() and (t < math.pi + 1e-6).all()
    assert t[1] == pytest.approx(-math.pi, abs=1e-6)


def test_env_state_from_numpy_takes_the_cols_rows():
    jenv = dq.CartPole()
    st, _ = jenv.reset_batch(jax.random.PRNGKey(0), 8)
    t = convert.env_state_from_numpy(jax.tree_util.tree_map(np.asarray, st))
    np.testing.assert_array_equal(t.numpy(),
                                  np.asarray(jenv.state_to_cols(st)).T)
    mst, _ = dq.MountainCar().reset_batch(jax.random.PRNGKey(1), 8)
    t = convert.env_state_from_numpy(jax.tree_util.tree_map(np.asarray, mst))
    assert t.shape == (8, 2)


# -- the JAX env tests' invariants (tests/test_envs.py), on the port

def test_cartpole_constant_push_falls_over():
    env = dt.CartPole()
    g = torch.Generator().manual_seed(0)
    st, obs = env.reset_batch(1, g)
    assert obs.shape == (1, 4)
    done_at = None
    for t in range(500):
        st, obs, r, done = env.step_batch(st, torch.zeros(1, dtype=torch.long),
                                          g)
        assert float(r) == 1.0
        if bool(done):
            done_at = t
            break
    assert done_at is not None and done_at < 300
    st, obs = env.reset_batch(32, g)
    assert ((obs >= -0.05) & (obs <= 0.05)).all()


def test_mountain_car_pump_policy_reaches_goal():
    env = dt.MountainCar()
    g = torch.Generator().manual_seed(0)
    st, obs = env.reset_batch(64, g)
    assert obs.shape == (64, 2) and (obs[:, 1] == 0).all()
    assert ((obs[:, 0] >= -0.6) & (obs[:, 0] <= -0.4)).all()
    done_at = torch.full((64,), -1)
    for t in range(250):
        a = torch.where(st[:, 1] >= 0.0, 2, 0)
        st, obs, r, done = env.step_batch(st, a, g)
        assert (r == -1.0).all()
        done_at = torch.where((done > 0) & (done_at < 0), t, done_at)
    assert (done_at >= 0).all() and (done_at < 200).all()


def test_mountain_car_wall_and_speed_clamps():
    env = dt.MountainCar()
    st = torch.tensor([[env.min_position, -env.max_speed]])
    st, _, _, done = env.step_batch(st, torch.tensor([0]), None)
    assert abs(float(st[0, 0]) - env.min_position) < 1e-6
    assert float(st[0, 1]) == 0.0 and not bool(done)
    st = torch.tensor([[-0.5, env.max_speed]])
    st, _, _, _ = env.step_batch(st, torch.tensor([2]), None)
    assert abs(float(st[0, 1])) <= env.max_speed + 1e-9


def test_acrobot_dynamics_invariants():
    env = dt.Acrobot()
    g = torch.Generator().manual_seed(0)
    st, obs = env.reset_batch(16, g)
    assert obs.shape == (16, 6) and (st.abs() <= 0.1).all()
    finished = torch.zeros(16, dtype=torch.bool)
    for t in range(50):
        a = torch.randint(0, 3, (16,), generator=g)
        st, obs, r, done = env.step_batch(st, a, g)
        assert (r == -1.0).all()
        o = obs.numpy()
        np.testing.assert_allclose(o[:, 0] ** 2 + o[:, 1] ** 2, 1.0,
                                   atol=1e-5)
        np.testing.assert_allclose(o[:, 2] ** 2 + o[:, 3] ** 2, 1.0,
                                   atol=1e-5)
        assert (np.abs(o[:, 4]) <= env.MAX_VEL_1 + 1e-6).all()
        assert (np.abs(o[:, 5]) <= env.MAX_VEL_2 + 1e-6).all()
        assert np.isfinite(o).all()
        height = -o[:, 0] - np.cos(np.arctan2(o[:, 1], o[:, 0])
                                   + np.arctan2(o[:, 3], o[:, 2]))
        now = (done > 0) & ~finished
        assert (height[now.numpy()] > 1.0 - 1e-5).all()
        finished |= done > 0


def test_acrobot_has_no_collect_kernel():
    """No cols protocol in the JAX Acrobot, so no collect plan: a loop on
    it takes the plain collect step (and ``fused_collect=True`` raises)."""
    from deepqlearning_tpu_torch.learner.loop import build_loop
    from deepqlearning_tpu_torch.ops.cuda import fused_collect

    env = dt.Acrobot()
    net = dt.Chain(dt.Dense(6, 16, torch.tanh), dt.Dense(16, 3))
    assert fused_collect.collect_plan_for(env, net, None) is None
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 256, 16, device="cpu")
    cfg = dt.DQNConfig(num_envs=32, train_freq=32, batch_size=16,
                       buffer_size=256, max_episode_length=20, dueling=False)
    it, pop, opt = build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(),
                              env.discount)
    c = dt.init_carry(env, net, buf, cfg, opt, device="cpu")
    cc = pop((c.actor, c.replay, c.params), c.generator)
    c = it(c._replace(actor=cc[0], replay=cc[1]))
    assert c.replay.size == 64 and np.isfinite(float(c.loss))
    with pytest.raises(ValueError, match="fused_collect=True"):
        build_loop(env, net, buf, cfg.replace(fused_collect=True),
                   dt.LinearDecaySchedule(), env.discount)
