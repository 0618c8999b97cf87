"""The port's solver layer on its own: checkpoints (best-model gating,
``restore_best_model``, the train state with its host ints and generator,
``resume=True``), the problem adapters, the host-env path with custom
strategies, rejections, determinism, the device rule and the collect-kernel
route of the stock ε-greedy strategy. CPU only; every solve passes
``device="cpu"``."""
import math
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch import (  # noqa: E402
    LSTM, Chain, DeepQLearningSolver, Dense, EpsGreedyPolicy, Flatten,
    HostEnv, LinearDecaySchedule, MDPEnv, POMDPEnv, SimpleGridWorld, TestMDP,
    VectorizedStrategy)
from deepqlearning_tpu_torch.envs.adapters import check_requirements  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    build_loop, init_carry)
from deepqlearning_tpu_torch.ops.cuda import fused_collect as fc  # noqa: E402
from deepqlearning_tpu_torch.solver import checkpoint  # noqa: E402
from deepqlearning_tpu_torch.solver import solver as solver_mod  # noqa: E402


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def make(**kw):
    kw.setdefault("device", "cpu")
    kw.setdefault("verbose", False)
    return DeepQLearningSolver(**kw)


def leaves(params):
    return [params[k].detach().clone() for k in sorted(params)]


# --- checkpoints --------------------------------------------------------
def test_save_load_params_roundtrip(tmp_path):
    net = Chain(Dense(3, 8), Dense(8, 2))
    params = {k: v.clone() for k, v in
              net.init(torch.Generator().manual_seed(0)).items()}
    checkpoint.save_params(str(tmp_path), params)
    template = net.init(torch.Generator().manual_seed(1))
    loaded = checkpoint.load_params(str(tmp_path), template)
    assert loaded.keys() == params.keys()
    for k in params:
        assert torch.equal(loaded[k], params[k])
        # filled in place: the dict keeps sharing the module's storage
        assert loaded[k].data_ptr() == template[k].data_ptr()
    with pytest.raises(ValueError, match="shape"):
        checkpoint.load_params(
            str(tmp_path), Chain(Dense(3, 4), Dense(4, 2)).init())


def test_save_model_best_gating(tmp_path):
    params = {"w": torch.ones(3)}
    saved, best = checkpoint.save_model(str(tmp_path), params, 1.0,
                                        -math.inf, False, verbose=False)
    assert saved and best == 1.0
    assert os.path.exists(tmp_path / checkpoint.CKPT_NAME)
    saved2, best2 = checkpoint.save_model(str(tmp_path), {"w": torch.zeros(3)},
                                          0.5, best, saved, verbose=False)
    assert saved2 and best2 == 1.0  # stays saved, best unchanged
    w = checkpoint.load_params(str(tmp_path), {"w": torch.zeros(3)})["w"]
    assert torch.equal(w, torch.ones(3))  # the worse model was not written
    saved3, best3 = checkpoint.save_model(str(tmp_path), params, 1.0, best2,
                                          saved2, verbose=False)
    assert saved3 and best3 == 1.0  # a tie saves
    assert checkpoint.save_model(None, params, 2.0, best3, saved3,
                                 verbose=False) == (True, 2.0)


def test_solver_restore_best_model(tmp_path):
    mdp = TestMDP((3,), 2, 4)
    model = Chain(Flatten(), Dense(6, 8, torch.tanh),
                  Dense(8, mdp.num_actions))
    solver = make(qnetwork=model, max_steps=600, eval_freq=200,
                  save_freq=200, num_ep_eval=10, log_freq=200,
                  train_start=100, logdir=str(tmp_path),
                  exploration_policy=EpsGreedyPolicy())
    policy = solver.solve(mdp)
    assert os.path.exists(os.path.join(solver.logdir, checkpoint.CKPT_NAME))
    assert [t for t, _ in solver.metrics["eval"]] == [200, 400, 600]
    assert solver.metrics["t"] == [200, 400, 600]
    restored = solver.restore_best_model(mdp)
    for a, b in zip(leaves(policy.params), leaves(restored.params)):
        assert torch.equal(a, b)
    restored2 = dt.restore_best_model(solver, mdp)
    for a, b in zip(leaves(policy.params), leaves(restored2.params)):
        assert torch.equal(a, b)
    # the TB events were written with the JAX package's tags
    (events,) = [f for f in os.listdir(tmp_path) if "tfevents" in f]
    data = (tmp_path / events).read_bytes()
    for tag in (b"eval_reward", b"eval_steps", b"eps", b"avg_reward",
                b"loss", b"grad_val", b"env_steps_per_s"):
        assert tag in data


def _small_carry(seed, recurrent=False):
    env = SimpleGridWorld()
    cfg = dt.DQNConfig(num_envs=8, train_freq=8, batch_size=4,
                       buffer_size=64, seed=seed, recurrence=recurrent,
                       trace_length=3, max_episode_length=5)
    if recurrent:
        net = Chain(LSTM(2, 4), Dense(4, 4))
        buf = dt.EpisodeReplayBuffer(env.obs_shape, 64, 4, 3, 5, num_envs=8,
                                     device="cpu")
    else:
        net = dt.create_dueling_network(Chain(Dense(2, 8, torch.tanh),
                                              Dense(8, 4)))
        buf = dt.PrioritizedReplayBuffer(env.obs_shape, 64, 4, device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg, LinearDecaySchedule(),
                              env.discount)
    return env, net, buf, cfg, it, pop, opt


def _flat(x, path="c"):
    """(path, leaf) pairs of a carry: tensors, host ints, generator state."""
    if isinstance(x, torch.Generator):
        yield path, x.get_state()
    elif isinstance(x, torch.Tensor):
        yield path, x
    elif isinstance(x, tuple) and hasattr(x, "_fields"):
        for k, v in x._asdict().items():
            yield from _flat(v, f"{path}.{k}")
    elif isinstance(x, dict):
        for k in sorted(x):
            yield from _flat(x[k], f"{path}.{k}")
    elif isinstance(x, (tuple, list)):
        for i, v in enumerate(x):
            yield from _flat(v, f"{path}[{i}]")
    else:
        yield path, x


@pytest.mark.parametrize("recurrent", [False, True])
def test_train_state_roundtrip_with_host_ints_and_generator(tmp_path,
                                                            recurrent):
    env, net, buf, cfg, it, pop, opt = _small_carry(0, recurrent)
    c = dt.populate(pop, buf, init_carry(env, net, buf, cfg, opt,
                                         device="cpu"), 6)
    for _ in range(3):
        c = it(c)
    assert c.iters == 3 and c.actor.t > 0 and c.sync_acc > 0
    checkpoint.save_train_state(str(tmp_path), c)
    # a fresh template from another seed: every field differs before loading
    env2, net2, buf2, cfg2, it2, pop2, opt2 = _small_carry(5, recurrent)
    tmpl = init_carry(env2, net2, buf2, cfg2, opt2, device="cpu")
    loaded = checkpoint.load_train_state(str(tmp_path), tmpl)
    want, got = dict(_flat(c)), dict(_flat(loaded))
    assert want.keys() == got.keys()
    for k, v in want.items():
        if isinstance(v, torch.Tensor):
            assert torch.equal(got[k], v), k
        else:
            assert got[k] == v, k
    # the generator continues the saved stream
    assert torch.equal(torch.rand(5, generator=loaded.generator),
                       torch.rand(5, generator=c.generator))
    # and the next iteration is the same on both
    a, b = it(c), it2(loaded)
    for (k, x), (_, y) in zip(_flat(a), _flat(b)):
        assert (torch.equal(x, y) if isinstance(x, torch.Tensor)
                else x == y), k


def test_train_state_roundtrip_plain_tree(tmp_path):
    carry = {"params": {"w": torch.arange(4.0)}, "step": 7}
    checkpoint.save_train_state(str(tmp_path), carry)
    loaded = checkpoint.load_train_state(
        str(tmp_path), {"params": {"w": torch.zeros(4)}, "step": 0})
    assert torch.equal(loaded["params"]["w"], torch.arange(4.0))
    assert loaded["step"] == 7


def _saved_counters(logdir):
    raw = torch.load(os.path.join(logdir, checkpoint.TRAIN_STATE_NAME),
                     weights_only=True)["__fields__"]
    actor = raw["actor"]["__fields__"]
    opt = raw["opt_state"]["__fields__"]
    return dict(iters=raw["iters"], t=actor["t"], tick=actor["tick"],
                count=int(opt["count"]), replay=raw["replay"]["__fields__"])


def test_full_train_state_resume_continues_counters(tmp_path):
    mdp = SimpleGridWorld()
    model = Chain(Dense(2, 8), Dense(8, mdp.num_actions))

    def run(resume):
        return make(qnetwork=model, max_steps=300, train_start=100,
                    logdir=str(tmp_path), eval_freq=10_000,
                    save_freq=10_000, log_freq=100,
                    exploration_policy=EpsGreedyPolicy()).solve(
                        mdp, resume=resume)

    p1 = run(False)
    first = _saved_counters(str(tmp_path))
    assert first["iters"] == 75 and first["t"] == 300 and first["count"] == 75
    assert first["replay"]["size"] == 400  # populate 100 + 300
    p2 = run(True)
    second = _saved_counters(str(tmp_path))
    assert second["iters"] == 150 and second["t"] == 600
    assert second["tick"] == 600 % 512 and second["count"] == 150
    assert second["replay"]["size"] == 700
    assert second["replay"]["insert_pos"] == 700 % 1000
    # resumed from the saved optimizer/replay/params and trained further
    assert not torch.equal(leaves(p1.params)[0], leaves(p2.params)[0])
    # the caller's network was left as it was
    assert model.layers[0].w.device.type == "cpu"


def test_full_train_state_resume_recurrent(tmp_path):
    mdp = SimpleGridWorld()

    def run(resume):
        return make(qnetwork=Chain(LSTM(2, 8), Dense(8, mdp.num_actions)),
                    max_steps=400, num_envs=8, train_freq=32, buffer_size=64,
                    train_start=64, trace_length=5, recurrence=True,
                    dueling=False, max_episode_length=20,
                    logdir=str(tmp_path), eval_freq=10_000, save_freq=200,
                    log_freq=200,
                    exploration_policy=EpsGreedyPolicy()).solve(
                        mdp, resume=resume)

    p1 = run(False)
    first = _saved_counters(str(tmp_path))
    p2 = run(True)
    second = _saved_counters(str(tmp_path))
    assert second["iters"] == 2 * first["iters"] == 26
    assert second["replay"]["t"] == 2 * first["replay"]["t"] - 21
    assert not torch.equal(leaves(p1.params)[0], leaves(p2.params)[0])


def test_drqn_resume_continues_the_ring_counter(tmp_path):
    """The episode replay's step counter crosses a save and a resume as the
    device tensor it is: the archive holds a 0-d int64 tensor, loading
    fills the template's counter in place (a carry that a CUDA graph
    replays keeps its buffers), and the resumed iteration writes the ring
    row ``t % R`` that the saved run writes next and moves ``t`` on."""
    env, net, buf, cfg, it, pop, opt = _small_carry(0, recurrent=True)
    c = dt.populate(pop, buf, init_carry(env, net, buf, cfg, opt,
                                         device="cpu"), 6)
    for _ in range(3):
        c = it(c)
    t_saved = int(c.replay.t)
    assert t_saved == 6 + 3 * cfg.steps_per_iter
    checkpoint.save_train_state(str(tmp_path), c)
    raw = torch.load(os.path.join(tmp_path, checkpoint.TRAIN_STATE_NAME),
                     weights_only=True)["__fields__"]["replay"]["__fields__"]
    assert torch.is_tensor(raw["t"]) and raw["t"].dim() == 0
    assert raw["t"].dtype == torch.int64 and int(raw["t"]) == t_saved
    env2, net2, buf2, cfg2, it2, pop2, opt2 = _small_carry(5, recurrent=True)
    tmpl = init_carry(env2, net2, buf2, cfg2, opt2, device="cpu")
    counter = tmpl.replay.t
    loaded = checkpoint.load_train_state(str(tmp_path), tmpl)
    assert loaded.replay.t is counter and int(counter) == t_saved
    k = t_saved % buf.ring
    before = loaded.replay.data[k].clone()
    a, b = it(c), it2(loaded)
    assert int(b.replay.t) == int(a.replay.t) == t_saved + 1
    assert not torch.equal(b.replay.data[k], before)
    assert torch.equal(b.replay.data, a.replay.data)


# --- adapters -----------------------------------------------------------
class StaticArrayMDP:
    """s' = s + a, reward s^2, terminal at s >= 3; batched."""

    num_actions = 2
    discount = 0.95
    action_map = [0, 1]

    def initial_state(self, num, generator):
        return torch.ones(num, 1, dtype=torch.int32,
                          device=generator.device)

    def gen(self, s, a, generator):
        return s + a[:, None].to(torch.int32)

    def reward(self, s, a, sp):
        return (s[:, 0] ** 2).float()

    def isterminal(self, s):
        return s[:, 0] >= 3

    def convert_s(self, s):
        return s.float()


class MiniPOMDP:
    """Hidden bit, observed correctly with probability 0.9; batched."""

    num_actions = 2
    discount = 0.9
    action_map = ["stay", "guess"]

    def initial_state(self, num, generator):
        return (torch.rand(num, generator=generator,
                           device=generator.device) < 0.5).to(torch.int32)

    def gen(self, s, a, generator):
        return s

    def reward(self, s, a, sp):
        return torch.where(a == 1, torch.where(s == 1, 1.0, -1.0), 0.0)

    def isterminal(self, s):
        return torch.zeros_like(s, dtype=torch.bool)

    def observation(self, s, a, sp, generator):
        correct = torch.rand(s.shape[0], generator=generator,
                             device=s.device) < 0.9
        return torch.where(correct, sp, 1 - sp)

    def initial_obs(self, s):
        return s

    def convert_o(self, o):
        return o[:, None].float()


def test_functional_mdp_adapter():
    env = MDPEnv(StaticArrayMDP())
    assert env.obs_shape == (1,) and env.action_map == [0, 1]
    model = Chain(Dense(1, 32), Dense(32, env.num_actions))
    policy = make(qnetwork=model, max_steps=64, learning_rate=0.005,
                  logdir=None, double_q=True, dueling=True,
                  prioritized_replay=True, train_start=64, buffer_size=256,
                  exploration_policy=EpsGreedyPolicy(
                      LinearDecaySchedule(1.0, 0.01, 5))).solve(env)
    r, _, _ = dt.basic_evaluation(policy.network, policy.params, env, 20,
                                  100, 0)
    assert r > 1.0
    # a raw (integer) problem state goes through observe
    state, _ = env.reset(torch.Generator().manual_seed(0))
    assert policy.action(state) == policy.action(np.ones(1, np.float32))


def test_pomdp_adapter():
    env = POMDPEnv(MiniPOMDP())
    assert env.obs_shape == (1,)
    g = torch.Generator().manual_seed(0)
    state, obs = env.reset_batch(8, g)
    assert isinstance(state, tuple) and obs.shape == (8, 1)
    state, obs, r, done = env.step_batch(state, torch.ones(8, dtype=torch.long),
                                         g)
    assert set(r.tolist()) <= {-1.0, 1.0} and obs.shape == (8, 1)
    assert not bool(done.any())
    # the tuple state resets per row
    fresh, fobs, ended = dt.envs.base.auto_reset(
        env, state, obs, torch.tensor([1.0] + [0.0] * 7), torch.zeros(8), g)
    assert torch.equal(fresh[1][1:], obs[1:]) and bool(ended[0])


def test_check_requirements():
    check_requirements(StaticArrayMDP())
    check_requirements(MiniPOMDP(), pomdp=True)

    class Incomplete:
        num_actions = 2

    with pytest.raises(TypeError, match="missing"):
        check_requirements(Incomplete())


def test_solve_auto_wraps_raw_problems():
    policy = make(qnetwork=Chain(Dense(1, 16), Dense(16, 2)), max_steps=32,
                  logdir=None, train_start=32, buffer_size=128,
                  exploration_policy=EpsGreedyPolicy(
                      LinearDecaySchedule(1.0, 0.1, 16))).solve(
                          StaticArrayMDP())
    assert isinstance(policy.problem, MDPEnv)
    assert policy.action(np.asarray([1.0], np.float32)) in [0, 1]
    policy = make(qnetwork=Chain(Dense(1, 16), Dense(16, 2)), max_steps=32,
                  logdir=None, train_start=32, buffer_size=128,
                  max_episode_length=16,
                  exploration_policy=EpsGreedyPolicy(
                      LinearDecaySchedule(1.0, 0.1, 16))).solve(MiniPOMDP())
    assert isinstance(policy.problem, POMDPEnv)
    assert policy.action(np.asarray([1.0], np.float32)) in ["stay", "guess"]


def test_solve_rejects_non_problem_objects():
    solver = make(qnetwork=Chain(Dense(1, 2)), logdir=None)
    with pytest.raises(TypeError, match="FunctionalMDP"):
        solver.solve(object())


def test_functional_path_rejects_function_strategy():
    solver = make(qnetwork=Chain(Dense(2, 4), Dense(4, 4)), logdir=None,
                  exploration_policy=lambda p, e, o, t, r: (0, 0.1))
    with pytest.raises(TypeError, match="schedule-based"):
        solver.solve(SimpleGridWorld())


def test_recurrent_network_needs_recurrence():
    solver = make(qnetwork=Chain(LSTM(2, 4), Dense(4, 4)), logdir=None)
    with pytest.raises(ValueError, match="recurrence is set to false"):
        solver.solve(SimpleGridWorld())


# --- host-env path ------------------------------------------------------
class SimpleEnv(HostEnv):
    """State s in {1, 2, 3}, actions ±1, reward s, terminal at s >= 3."""

    def __init__(self):
        self.s = 1

    def reset(self):
        self.s = 1

    def observe(self):
        return np.asarray([self.s], np.float32)

    def act(self, a):
        r = self.s
        self.s = max(1, self.s + a)
        return r

    def terminated(self):
        return self.s >= 3

    def actions(self):
        return [-1, 1]


def host_evaluate(env, policy, n_ep=20, max_steps=100):
    avg = 0.0
    for _ in range(n_ep):
        env.reset()
        policy.reset_state()
        r, step = 0.0, 0
        while not env.terminated() and step < max_steps:
            r += env.act(policy.action(env.observe()))
            step += 1
        avg += r
    return avg / n_ep


def test_host_env_path():
    env = SimpleEnv()
    solver = make(qnetwork=Chain(Dense(1, 32), Dense(32, 2)), max_steps=10,
                  learning_rate=0.005, logdir=None, double_q=True,
                  dueling=True, prioritized_replay=True,
                  exploration_policy=EpsGreedyPolicy(
                      LinearDecaySchedule(1.0, 0.01, 5)))
    policy = solver.solve(env)
    assert host_evaluate(env, policy) > 1.0


def test_host_env_path_recurrent(tmp_path):
    env = SimpleEnv()
    solver = make(qnetwork=Chain(LSTM(1, 8), Dense(8, 2)), max_steps=40,
                  logdir=str(tmp_path), recurrence=True, trace_length=3,
                  batch_size=4, buffer_size=32, train_start=20,
                  max_episode_length=10, eval_freq=10, save_freq=10,
                  log_freq=10)
    policy = solver.solve(env)
    assert policy.action(env.observe()) in [-1, 1]
    assert os.path.exists(tmp_path / checkpoint.CKPT_NAME)


def test_host_custom_exploration_and_evaluation():
    env = SimpleEnv()
    calls = {"explore": 0, "eval": 0}

    def my_explore(policy, env_, obs, t, rng):
        calls["explore"] += 1
        return env_.actions()[rng.randint(2)], 0.5

    def my_eval(network, params, env_, n_eval, max_len, generator, verbose):
        calls["eval"] += 1
        assert isinstance(generator, torch.Generator)
        return 42.0, 1.0, {"custom": 1.0}

    make(qnetwork=Chain(Dense(1, 16), Dense(16, 2)), max_steps=12,
         train_start=30, eval_freq=4, save_freq=10_000, logdir=None,
         prioritized_replay=False, dueling=False, double_q=False,
         exploration_policy=my_explore, evaluation_policy=my_eval).solve(env)
    assert calls["explore"] == 12
    assert calls["eval"] >= 1


def test_host_path_takes_constant_epsilon():
    # ConstantEpsilon's eps is a float field, not a method
    policy = make(qnetwork=Chain(Dense(1, 8), Dense(8, 2)), max_steps=8,
                  train_start=8, logdir=None,
                  exploration_policy=dt.ConstantEpsilon(0.5)).solve(
                      SimpleEnv())
    assert policy.action(np.ones(1, np.float32)) in [-1, 1]


# --- determinism, device, routes ----------------------------------------
def test_solver_deterministic_given_seed():
    mdp = TestMDP((3,), 2, 4)

    def run(seed):
        model = Chain(Flatten(), Dense(6, 8), Dense(8, mdp.num_actions))
        p = make(qnetwork=model, max_steps=400, train_start=100,
                 logdir=None, seed=seed, eval_freq=10_000,
                 exploration_policy=EpsGreedyPolicy(
                     LinearDecaySchedule(1.0, 0.1, 200))).solve(mdp)
        return p.actionvalues(np.zeros((3, 2), np.float32))

    a, b, c = run(11), run(11), run(12)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_role_generators_differ_per_role():
    gens = solver_mod.role_generators(0, "cpu")
    assert tuple(gens) == solver_mod.ROLES
    draws = [tuple(torch.rand(4, generator=g).tolist())
             for g in gens.values()]
    assert len(set(draws)) == len(draws)
    again = solver_mod.role_generators(0, "cpu")
    assert torch.equal(torch.rand(4, generator=again["init"]),
                       torch.tensor(draws[0]))


def test_solve_runs_on_the_card_unless_asked(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    solver = DeepQLearningSolver(qnetwork=Chain(Dense(2, 4), Dense(4, 4)),
                                 logdir=None, verbose=False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve(SimpleGridWorld())
    with pytest.raises(RuntimeError, match="no CUDA device"):
        solver.solve(SimpleEnv())


def test_forced_collect_kernel_that_cannot_be_honoured_raises():
    solver = make(qnetwork=Chain(Flatten(), Dense(6, 4)), logdir=None,
                  max_steps=8, train_start=8, fused_collect=True)
    with pytest.raises(ValueError, match="fused_collect=True"):
        solver.solve(TestMDP((3,), 2, 4))


def _count_routes(monkeypatch):
    seen = {"select_fn": [], "collect": 0}
    real_build, real_plain = solver_mod.build_loop, fc.fused_collect_plain

    def build(*args, **kw):
        seen["select_fn"].append(kw.get("select_fn"))
        return real_build(*args, **kw)

    def plain(*args, **kw):
        seen["collect"] += 1
        return real_plain(*args, **kw)

    monkeypatch.setattr(solver_mod, "build_loop", build)
    monkeypatch.setattr(fc, "fused_collect_plain", plain)
    return seen


@pytest.mark.parametrize("recurrent", [False, True])
def test_stock_eps_greedy_reaches_the_collect_kernel(monkeypatch, recurrent):
    """The stock EpsGreedyPolicy goes to build_loop as a schedule, so the
    collect step is the kernel route (its plain twin on CPU tensors): the
    JAX solver always passed its select, which never reached its fused
    collect."""
    seen = _count_routes(monkeypatch)
    env = SimpleGridWorld()
    net = (Chain(LSTM(2, 8), Dense(8, 4)) if recurrent
           else Chain(Dense(2, 8, torch.tanh), Dense(8, 4)))
    make(qnetwork=net, max_steps=64, num_envs=8, train_freq=8,
         buffer_size=64, train_start=16, trace_length=3, batch_size=4,
         max_episode_length=10, recurrence=recurrent, logdir=None,
         eval_freq=10_000).solve(env)
    assert seen["select_fn"] == [None]
    n_pop = 11 if recurrent else 2
    assert seen["collect"] == n_pop + 8  # populate + one step per iteration


def test_vectorized_strategy_takes_the_plain_collect(monkeypatch):
    seen = _count_routes(monkeypatch)
    calls = []

    def greedy(q, t, generator):
        calls.append(t)
        return torch.argmax(q, dim=-1), 0.0

    strategy = VectorizedStrategy(greedy)
    make(qnetwork=Chain(Dense(2, 8), Dense(8, 4)), max_steps=64, num_envs=8,
         train_freq=8, buffer_size=64, train_start=16, batch_size=4,
         logdir=None, eval_freq=10_000,
         exploration_policy=strategy).solve(SimpleGridWorld())
    assert seen["select_fn"] == [strategy.select]
    assert seen["collect"] == 0  # a custom select: the plain collect step
    assert calls == [8 * i for i in range(8)]


def test_policy_api_surface():
    env = MDPEnv(StaticArrayMDP())
    model = Chain(Dense(1, 8), Dense(8, 2))
    policy = dt.NNPolicy(env, model, model.init(), env.action_map, 1)
    assert policy.action(np.asarray([1.0], np.float32)) in env.action_map
    assert policy.actionvalues(np.asarray([1.0], np.float32)).shape == (2,)
    assert isinstance(policy.value(np.asarray([1.0], np.float32)), float)
    assert dt.getnetwork(policy) is model
    dt.resetstate(policy)
    with pytest.raises(ValueError, match="NNPolicyError"):
        policy.action(np.zeros((2, 2), np.float32))


def test_eval_deterministic_given_generator_seed():
    env = SimpleGridWorld()
    net = Chain(Dense(2, 8), Dense(8, env.num_actions))
    params = net.init(torch.Generator().manual_seed(0))
    r1 = dt.basic_evaluation(net, params, env, 16, 50, 3)
    r2 = dt.basic_evaluation(net, params, env, 16, 50,
                             torch.Generator().manual_seed(3))
    r3 = dt.basic_evaluation(net, params, env, 16, 50, 4)
    assert r1 == r2 and r1 != r3


def test_profiling_hooks(tmp_path):
    from deepqlearning_tpu_torch.utils import enable_nan_checks, trace

    with trace(str(tmp_path)):
        torch.ones(4).sum()
    assert any(f.endswith(".json") for f in os.listdir(tmp_path))
    enable_nan_checks(True)
    assert torch.is_anomaly_enabled()
    enable_nan_checks(False)
    assert not torch.is_anomaly_enabled()
