"""Envs and problems written one instance at a time (``envs/base.py``,
``envs/adapters.py``), batched by ``torch.func.vmap``.

The per-instance StaticArrayMDP (``tests/test_compat.py``'s) and a
table-driven MiniPOMDP, written once for each package, go through
``MDPEnv`` / ``POMDPEnv`` of both and must agree bit for bit; the
per-instance GridWorld that ``chip_smoke.py`` drives on the card equals the
port's built-in batched SimpleGridWorld on the same generator seed, env
step by env step and through ``build_loop``; each built-in env's
per-instance methods are its batched ones at one row. Also: NamedTuple
states through ``auto_reset``, the loop and a resumed ``solve``; the
protocol's errors; ``solve`` of per-instance problems; the policy on raw
per-instance states. CPU only."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.envs.adapters import check_requirements  # noqa: E402
from deepqlearning_tpu_torch.envs.base import auto_reset  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda import fused_collect as fc  # noqa: E402
from deepqlearning_tpu_torch.solver import checkpoint  # noqa: E402
from test_compat import StaticArrayMDP as JStaticArrayMDP  # noqa: E402

GridWorld, StaticArrayMDP, MiniPOMDP = chip_smoke.user_envs()
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def gen(seed):
    return torch.Generator().manual_seed(seed)


def same(t, j):
    """A port tensor equals a JAX array bit for bit (bools as f32)."""
    j = np.asarray(j)
    if j.dtype == bool:
        j = j.astype(np.float32)
    np.testing.assert_array_equal(t.numpy(), j)


# --- per-instance problems against the JAX package --------------------
@pytest.mark.parametrize("E", [8, 64])
def test_static_array_mdp_matches_jax(E):
    je, te = dq.MDPEnv(JStaticArrayMDP()), dt.MDPEnv(StaticArrayMDP())
    assert not te.batched and te.obs_shape == je.obs_shape == (1,)
    js, jo = je.reset_batch(jax.random.PRNGKey(0), E)
    ts, to = te.reset_batch(E, gen(0))
    same(ts, js)
    same(to, jo)
    rng = np.random.default_rng(E)
    for k in range(5):
        a = rng.integers(0, 2, E).astype(np.int32)
        js, jo, jr, jd = je.step_batch(js, jnp.asarray(a),
                                       jax.random.PRNGKey(k))
        ts, to, tr, td = te.step_batch(ts, torch.from_numpy(a).long(),
                                       gen(k))
        for t, j in ((ts, js), (to, jo), (tr, jr), (td, jd)):
            same(t, j)
        assert tr.dtype == td.dtype == torch.float32
    # one instance
    s, o = te.reset(gen(1))
    assert s.shape == (1,) and o.shape == (1,)
    sp, op, r, d = te.step(s, torch.tensor(1), gen(1))
    jsp, jop, jr, jd = je.step(*je.reset(jax.random.PRNGKey(1))[:1],
                               jnp.asarray(1), jax.random.PRNGKey(1))
    for t, j in ((sp, jsp), (op, jop), (r, jr), (d, jd)):
        same(t, j)


class JTablePOMDP:
    """MiniPOMDP whose observation noise is read from a fixed table of
    uniforms at (step, row): the state is ``[bit, row, step]`` int32."""

    num_actions = 2
    discount = 0.9
    action_map = ["stay", "guess"]

    def __init__(self, table):
        self.table = jnp.asarray(table)

    def initial_state(self, key):
        return jnp.zeros(3, jnp.int32)

    def gen(self, s, a, key):
        return jnp.stack([s[0], s[1], s[2] + 1])

    def reward(self, s, a, sp):
        return jnp.where(a == 1, jnp.where(s[0] == 1, 1.0, -1.0), 0.0)

    def isterminal(self, s):
        return s[2] + s[1] % 3 >= 4

    def observation(self, s, a, sp, key):
        correct = self.table[sp[2], sp[1]] < 0.9
        return jnp.where(correct, sp[0], 1 - sp[0])

    def initial_obs(self, s):
        return s[0]

    def convert_o(self, o):
        return jnp.asarray([o], jnp.float32)


class TablePOMDP:
    """:class:`JTablePOMDP` in torch, one instance at a time."""

    num_actions = 2
    discount = 0.9
    action_map = ["stay", "guess"]

    def __init__(self, table):
        self.table = torch.from_numpy(table)

    def initial_state(self, generator):
        return torch.zeros(3, dtype=torch.int32, device=generator.device)

    def gen(self, s, a, generator):
        return torch.stack([s[0], s[1], s[2] + 1])

    def reward(self, s, a, sp):
        return torch.where(a == 1, torch.where(s[0] == 1, 1.0, -1.0), 0.0)

    def isterminal(self, s):
        return s[2] + s[1] % 3 >= 4

    def observation(self, s, a, sp, generator):
        correct = self.table[sp[2], sp[1]] < 0.9
        return torch.where(correct, sp[0], 1 - sp[0])

    def initial_obs(self, s):
        return s[0]

    def convert_o(self, o):
        return o[None].float()


@pytest.mark.parametrize("E", [8, 64])
def test_table_pomdp_matches_jax(E):
    rng = np.random.default_rng(E)
    steps = 5
    table = rng.random((steps + 1, E), np.float32)
    je, te = dq.POMDPEnv(JTablePOMDP(table)), dt.POMDPEnv(TablePOMDP(table))
    assert te.obs_shape == je.obs_shape == (1,)
    (js, jo), _ = je.reset_batch(jax.random.PRNGKey(0), E)
    (ts, to), _ = te.reset_batch(E, gen(0))
    same(ts, js)
    same(to, jo)
    # each row its own hidden bit and its row of the table
    s0 = np.stack([rng.integers(0, 2, E), np.arange(E), np.zeros(E)],
                  axis=1).astype(np.int32)
    o0 = s0[:, :1].astype(np.float32)
    jst = (jnp.asarray(s0), jnp.asarray(o0))
    tst = (torch.from_numpy(s0), torch.from_numpy(o0))
    dones, flips = [], []
    for k in range(steps):
        a = rng.integers(0, 2, E).astype(np.int32)
        jst, jo, jr, jd = je.step_batch(jst, jnp.asarray(a),
                                        jax.random.PRNGKey(k))
        tst, to, tr, td = te.step_batch(tst, torch.from_numpy(a).long(),
                                        gen(k))
        for t, j in ((tst[0], jst[0]), (tst[1], jst[1]), (to, jo), (tr, jr),
                     (td, jd)):
            same(t, j)
        dones.append(td)
        flips.append(to[:, 0] != tst[0][:, 0].float())
    flips = torch.stack(flips)
    assert bool(flips.any()) and not bool(flips.all())  # noisy, not all
    assert 0.0 < float(torch.stack(dones).mean()) < 1.0


# --- the user GridWorld against the built-in batched env --------------
def _grid_state(st):
    return torch.cat([st.pos, st.terminal[:, None]], dim=1)


def test_user_gridworld_matches_builtin_bit_for_bit():
    E = 256
    ue, be = GridWorld(), dt.SimpleGridWorld()
    gu, gb = gen(3), gen(3)
    us, uo = ue.reset_batch(E, gu)
    bs, bo = be.reset_batch(E, gb)
    assert type(us).__name__ == "GridState"
    assert torch.equal(_grid_state(us), bs) and torch.equal(uo, bo)
    rng = np.random.default_rng(0)
    ep = torch.zeros(E)
    for _ in range(30):
        a = torch.from_numpy(rng.integers(0, 4, E))
        us, uo, ur, ud = ue.step_batch(us, a, gu)
        bs, bo, br, bd = be.step_batch(bs, a, gb)
        assert torch.equal(_grid_state(us), bs) and torch.equal(uo, bo)
        assert torch.equal(ur, br) and torch.equal(ud, bd)
        ep = ep + 1
        trunc = ep >= 7
        us, uo, _ = auto_reset(ue, us, uo, ud, trunc, gu)
        bs, bo, be_ = auto_reset(be, bs, bo, bd, trunc, gb)
        assert type(us).__name__ == "GridState"
        assert torch.equal(_grid_state(us), bs) and torch.equal(uo, bo)
        ep = torch.where(be_, 0.0, ep)
    assert ur.abs().sum() > 0  # reward cells were reached


def test_user_gridworld_loop_matches_builtin():
    """The loop at a small shape (512 envs, U = 4, batch 32): the user env
    takes the plain collect step (the collect gate refuses an env without
    cols), the built-in env the same with ``fused_collect=False``; after 3
    iterations everything is equal bit for bit."""
    shape = (512, 4096, 32, 128)
    assert fc.collect_plan_for(GridWorld(), chip_smoke._dueling_net(
        torch, CPU, 8, torch.tanh), dt.PrioritizedReplayBuffer(
            (2,), 64, 4, device="cpu")) is None
    out = []
    for env, kw in ((GridWorld(), {}),
                    (dt.SimpleGridWorld(), dict(fused_collect=False))):
        it, c, cfg, _ = chip_smoke._loop_setup(torch, CPU, *shape, 2,
                                               env=env, **kw)
        assert cfg.updates_per_iter == 4
        for _ in range(3):
            c = it(c)
        out.append(c)
    u, b = out
    assert type(u.actor.env_state).__name__ == "GridState"
    assert torch.equal(_grid_state(u.actor.env_state), b.actor.env_state)
    for name in ("obs", "ep_step", "ep_ret", "ret_ring", "ep_count"):
        assert torch.equal(getattr(u.actor, name), getattr(b.actor, name))
    assert torch.equal(u.replay.rows, b.replay.rows)
    assert torch.equal(u.replay.tree[0], b.replay.tree[0])
    assert all(torch.equal(u.params[k], b.params[k]) for k in b.params)
    assert torch.equal(u.loss, b.loss) and int(b.actor.ep_count) > 0


# --- the built-in envs' per-instance methods ----------------------------
BUILTINS = {
    "SimpleGridWorld": dt.SimpleGridWorld, "TestMDP": lambda: dt.TestMDP(
        (3,), 2, 4), "TigerPOMDP": dt.TigerPOMDP, "CartPole": dt.CartPole,
    "MountainCar": dt.MountainCar, "Acrobot": dt.Acrobot}


@pytest.mark.parametrize("name", sorted(BUILTINS))
def test_builtin_per_instance_is_one_row(name):
    env = BUILTINS[name]()
    for seed in range(3):
        s, o = env.reset(gen(seed))
        S, O = env.reset_batch(1, gen(seed))
        assert torch.equal(s, S[0]) and torch.equal(o, O[0])
        assert tuple(o.shape) == env.obs_shape
        assert torch.equal(env.observe(s), O[0])
        for a in range(env.num_actions):
            out = env.step(s, a, gen(seed + 10))
            ref = env.step_batch(S, torch.tensor([a]), gen(seed + 10))
            for x, y in zip(out, ref):
                assert torch.equal(x, y[0])
            assert torch.equal(env.observe(out[0]), out[1])
    # the per-instance observe vmapped is the batched one
    S, O = env.reset_batch(16, gen(5))
    S, O, _, _ = env.step_batch(S, torch.arange(16) % env.num_actions,
                                gen(6))
    assert torch.equal(dt.Env.observe_batch(env, S), env.observe_batch(S))
    assert torch.equal(env.observe_batch(S), O)


@pytest.mark.parametrize("name", ["TestMDP", "CartPole", "MountainCar",
                                  "Acrobot"])
def test_builtin_per_instance_step_vmaps(name):
    """The deterministic built-ins' per-instance step, vmapped by the base
    class's default, is their batched step."""
    env = BUILTINS[name]()
    S, _ = env.reset_batch(32, gen(0))
    A = torch.arange(32) % env.num_actions
    for x, y in zip(dt.Env.step_batch(env, S, A, gen(1)),
                    env.step_batch(S, A, gen(1))):
        assert torch.equal(x, y)


# --- pytree states ------------------------------------------------------
def test_namedtuple_state_survives_auto_reset_loop_and_resume(tmp_path):
    env = GridWorld()
    g = gen(0)
    s, o = env.reset_batch(8, g)
    ended = torch.tensor([1.0, 0, 1, 0, 0, 0, 0, 1])
    fresh, fo, e = auto_reset(env, s, o, ended, torch.zeros(8), g)
    assert type(fresh) is type(s) and torch.equal(e, ended.bool())
    keep = ~e
    assert torch.equal(fresh.pos[keep], s.pos[keep])
    assert torch.equal(fo[keep], o[keep])
    # a few loop iterations carry the type (the user's step reads .pos)
    net = dt.create_dueling_network(dt.Chain(dt.Dense(2, 8, torch.tanh),
                                             dt.Dense(8, 4)))
    cfg = dt.DQNConfig(num_envs=16, train_freq=16, batch_size=8,
                       buffer_size=128, max_episode_length=5)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, 128, 8, device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg, dt.LinearDecaySchedule(),
                              env.discount)
    c = dt.populate(pop, buf, init_carry(env, net, buf, cfg, opt, "cpu"), 2)
    for _ in range(4):
        c = it(c)
    assert type(c.actor.env_state) is type(s)

    # solve, then resume from the saved train state
    def run(resume):
        return dt.DeepQLearningSolver(
            qnetwork=dt.Chain(dt.Dense(2, 8), dt.Dense(8, 4)), num_envs=8,
            train_freq=8, max_steps=64, train_start=16, batch_size=8,
            buffer_size=128, max_episode_length=10, eval_freq=10_000,
            save_freq=10_000, log_freq=32, logdir=str(tmp_path),
            verbose=False, device="cpu").solve(env, resume=resume)

    run(False)
    run(True)
    raw = torch.load(os.path.join(str(tmp_path), checkpoint.TRAIN_STATE_NAME),
                     weights_only=True)["__fields__"]
    actor = raw["actor"]["__fields__"]
    assert set(actor["env_state"]["__fields__"]) == {"pos", "terminal"}
    assert raw["iters"] == 16 and actor["t"] == 128


# --- errors --------------------------------------------------------------
class Bare(dt.Env):
    num_actions = 2
    obs_shape = (1,)


def test_env_with_neither_form_raises():
    env, g = Bare(), gen(0)
    s = torch.zeros(4, 1)
    for call in (lambda: env.reset(g), lambda: env.reset_batch(4, g),
                 lambda: env.step(s[0], 0, g),
                 lambda: env.step_batch(s, torch.zeros(4, dtype=torch.long),
                                        g),
                 lambda: env.observe(s[0]), lambda: env.observe_batch(s)):
        with pytest.raises(NotImplementedError,
                           match=r"Bare defines neither.*reset\(generator\)"
                                 r".*reset_batch\(num, generator\)"):
            call()


class _Meta:
    """A stand-in generator on another device than the tensors a careless
    per-instance function makes (they land on the CPU)."""

    device = torch.device("meta")


class CarelessEnv(dt.Env):
    num_actions = 2
    obs_shape = (1,)

    def reset(self, generator):
        s = torch.zeros(1)  # no device: the CPU
        return s, s

    def step(self, state, action, generator):
        s = torch.ones(1)
        return s, s, torch.tensor(1.0), torch.tensor(False)

    def observe(self, state):
        return state


def test_tensor_off_the_generator_device_raises():
    env = CarelessEnv()
    with pytest.raises(RuntimeError, match="CarelessEnv.reset returned a "
                       "tensor on cpu.*make tensors on generator.device"):
        env.reset_batch(4, _Meta())
    s = torch.zeros(4, 1, device="meta")
    a = torch.zeros(4, dtype=torch.long, device="meta")
    with pytest.raises(RuntimeError, match="CarelessEnv.step returned.*"
                       "make tensors on generator.device"):
        env.step_batch(s, a, _Meta())
    # on the generator's own device the same env batches
    st, ob = env.reset_batch(4, gen(0))
    st, ob, r, d = env.step_batch(st, torch.zeros(4, dtype=torch.long),
                                  gen(0))
    assert r.dtype == d.dtype == torch.float32 and r.shape == d.shape == (4,)
    st.add_(1.0)  # contiguous, no stride-0 view: writes in place
    assert st.stride() == (1, 1)


class BranchyEnv(CarelessEnv):
    def step(self, state, action, generator):
        if action > 0:  # data-dependent control flow
            state = state + 1
        return state, state, state[0], state[0] > 2


def test_data_dependent_control_flow_names_the_env():
    env = BranchyEnv()
    st, _ = env.reset_batch(4, gen(0))
    with pytest.raises(RuntimeError) as info:
        env.step_batch(st, torch.ones(4, dtype=torch.long), gen(0))
    assert any("BranchyEnv.step" in n and "torch.func.vmap" in n
               for n in info.value.__notes__)


def test_problem_arity():
    class NoArgs(StaticArrayMDP):
        def initial_state(self):
            return torch.ones(1, dtype=torch.int32)

    class Three(StaticArrayMDP):
        def initial_state(self, num, generator, extra):
            return torch.ones(num, 1, dtype=torch.int32)

    class Defaulted(StaticArrayMDP):  # a default does not count
        def initial_state(self, generator, num=None):
            return super().initial_state(generator)

    for bad, n in ((NoArgs, 0), (Three, 3)):
        for call in (lambda: dt.MDPEnv(bad()),
                     lambda: check_requirements(bad()),
                     lambda: dt.DeepQLearningSolver(
                         qnetwork=dt.Chain(dt.Dense(1, 2)), device="cpu",
                         logdir=None, verbose=False).solve(bad())):
            with pytest.raises(TypeError, match=rf"initial_state takes one "
                               rf".*or two.*it takes {n}"):
                call()
    assert not dt.MDPEnv(Defaulted()).batched
    assert not dt.MDPEnv(StaticArrayMDP()).batched


# --- solve and the policy ----------------------------------------------
def test_per_instance_static_array_mdp_solve():
    """``tests/test_compat.py::test_functional_mdp_adapter`` on the port,
    the problem written as the JAX test writes it."""
    solver = dt.DeepQLearningSolver(
        qnetwork=dt.Chain(dt.Dense(1, 32), dt.Dense(32, 2)), max_steps=64,
        learning_rate=0.005, logdir=None, verbose=False, double_q=True,
        dueling=True, prioritized_replay=True, train_start=64,
        buffer_size=256, device="cpu",
        exploration_policy=dt.EpsGreedyPolicy(
            dt.LinearDecaySchedule(1.0, 0.01, 5)))
    policy = solver.solve(StaticArrayMDP())  # auto-wrapped in MDPEnv
    env = policy.problem
    assert isinstance(env, dt.MDPEnv) and not env.batched
    r, _, _ = dt.basic_evaluation(policy.network, policy.params, env, 20,
                                  100, 0)
    assert r > 1.0
    state, obs = env.reset(gen(0))
    assert state.dtype == torch.int32
    assert policy.action(state) == policy.action(obs)


def test_per_instance_pomdp_drqn_solve():
    solver, policy = None, None
    solver = dt.DeepQLearningSolver(
        qnetwork=dt.Chain(dt.LSTM(1, 8), dt.Dense(8, 2)), recurrence=True,
        num_envs=16, train_freq=16, batch_size=8, trace_length=4,
        max_episode_length=8, buffer_size=64, prioritized_replay=False,
        max_steps=160, train_start=16, eval_freq=80, num_ep_eval=8,
        log_freq=80, logdir=None, verbose=False, device="cpu")
    policy = solver.solve(MiniPOMDP())  # auto-wrapped in POMDPEnv
    assert isinstance(policy.problem, dt.POMDPEnv)
    assert len(solver.metrics["eval"]) == 2
    # a raw (hidden state, obs) tuple goes through observe
    state, obs = policy.problem.reset(gen(0))
    policy.reset_state()
    q_raw = policy.actionvalues(state)
    policy.reset_state()
    assert np.array_equal(q_raw, policy.actionvalues(obs))


def test_policy_converts_raw_states():
    """``tests/test_compat.py::test_policy_converts_raw_states`` on the
    port: a per-instance raw TestMDP state goes through ``observe``."""
    mdp = dt.TestMDP((3,), 2, 4)
    net = dt.Chain(dt.Flatten(), dt.Dense(6, mdp.num_actions))
    policy = dt.NNPolicy(mdp, net, net.init(gen(0)), mdp.action_map,
                         len(mdp.obs_shape))
    state, _ = mdp.reset(gen(1))
    assert policy.action(state) in mdp.action_map
