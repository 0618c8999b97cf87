"""The compiled segment on the card
(``deepqlearning_tpu_torch/learner/segment.py``).

A CUDA graph replays what the capture recorded, so a user env that keeps a
Python counter would repeat the counter's value at capture on every replay.
``make_segment`` runs one replay after the capture and raises where it
differs from the eager warm-up iteration; the same env without the counter
is captured, in the batched form and in the per-instance form that
``torch.func.vmap`` batches. A DRQN segment (K5, K6 over the episode
replay, whose step counter lives on the device) replays eager iterations
bit for bit, and the populate graph ends by dropping the open episodes.
In a one-rank NCCL world, ``DataParallelRunner``'s graphs (K7 or K8, the
all-reduce and an Adam launch per sub-update; with local SGD on a
``(1, 1)`` mesh, the second graph with the DCN average) replay eager
iterations bit for bit, and its populate graph keeps the open episodes.
``basic_evaluation``'s graphs equal the eager rollout bit for bit, the
caller's generator included, and an env with a Python counter makes them
raise. These tests need an NVIDIA GPU (a CUDA graph has no CPU form) and
skip elsewhere. On a card::

    python -m pytest --noconftest -m card tests/test_torch_segment_card.py
"""
import pytest

torch = pytest.importorskip("torch")

from torch.utils._pytree import tree_flatten, tree_map  # noqa: E402

from deepqlearning_tpu_torch import (  # noqa: E402
    LSTM, Chain, Dense, DQNConfig, EpisodeReplayBuffer, Flatten,
    LinearDecaySchedule, PrioritizedReplayBuffer, SimpleGridWorld,
    create_dueling_network)
from deepqlearning_tpu_torch.envs.base import Env  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    build_loop, init_carry, populate)
from deepqlearning_tpu_torch.learner.segment import (  # noqa: E402
    CompiledSegment, make_collect_graph, make_segment)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU form")
    return torch.device("cuda:0")


class Drift(Env):
    """A user env written batched on ``[0, 1]``; with ``host_counter`` the
    step grows with a Python count of the env's steps."""

    num_actions, obs_shape, discount = 2, (1,), 0.9

    def __init__(self, host_counter):
        self.host_counter = host_counter
        self.steps = 0

    def reset_batch(self, num, generator):
        s = torch.rand(num, generator=generator, device=generator.device)
        return s, s[:, None]

    def observe_batch(self, state):
        return state[:, None]

    def step_batch(self, state, action, generator):
        self.steps += 1
        d = 0.01 * (self.steps if self.host_counter else 1)
        s = (state + torch.where(action == 1, d, -d)).clamp(0.0, 1.0)
        return s, s[:, None], s, (s >= 1.0).float()


class PerInstanceDrift(Env):
    """:class:`Drift` written one instance at a time, batched by vmap."""

    num_actions, obs_shape, discount = 2, (1,), 0.9

    def __init__(self, host_counter):
        self.host_counter = host_counter
        self.steps = 0

    def reset(self, generator):
        s = torch.rand((), generator=generator, device=generator.device)
        return s, s[None]

    def observe(self, state):
        return state[None]

    def step(self, state, action, generator):
        self.steps += 1
        d = 0.01 * (self.steps if self.host_counter else 1)
        s = (state + torch.where(action == 1, d, -d)).clamp(0.0, 1.0)
        return s, s[None], s, s >= 1.0


def _segment(dev, host_counter, per_instance=False):
    env = (PerInstanceDrift if per_instance else Drift)(host_counter)
    net = Chain(Dense(1, 16, torch.tanh, device=dev), Dense(16, 2, device=dev))
    cfg = DQNConfig(num_envs=256, batch_size=32, buffer_size=1 << 12,
                    train_freq=256, max_episode_length=20, double_q=True,
                    prioritized_replay=True)
    buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.05, 10_000),
                              env.discount)
    c = it(populate(pop, buf, init_carry(env, net, buf, cfg, opt, dev), 2))
    return make_segment(it, c, cfg, env, buf, "Drift"), c


@pytest.mark.card
def test_pure_device_env_is_captured(card):
    run, c = _segment(card, host_counter=False)
    assert isinstance(run, CompiledSegment)
    c = run(c, 3)
    assert int(c.iters) == 4 and bool(torch.isfinite(c.loss))


@pytest.mark.card
def test_host_counter_in_env_raises(card):
    with pytest.raises(RuntimeError, match="differs from the eager iteration"):
        _segment(card, host_counter=True)


@pytest.mark.card
def test_per_instance_env_is_captured(card):
    run, c = _segment(card, host_counter=False, per_instance=True)
    assert isinstance(run, CompiledSegment)
    c = run(c, 3)
    assert int(c.iters) == 4 and bool(torch.isfinite(c.loss))


@pytest.mark.card
def test_host_counter_in_per_instance_env_raises(card):
    with pytest.raises(RuntimeError, match="differs from the eager iteration"):
        _segment(card, host_counter=True, per_instance=True)


def _clone(c):
    def one(x):
        if isinstance(x, torch.Generator):
            g = torch.Generator(device=x.device)
            g.set_state(x.get_state())
            return g
        return x.clone()

    return tree_map(one, c)


def _drqn(dev, n_pop):
    """A DRQN loop on the card (K6 and K5 at U = 2), populated through
    its collect graph."""
    env = SimpleGridWorld()
    net = Chain(LSTM(2, 16, device=dev), Dense(16, 4, device=dev))
    cfg = DQNConfig(num_envs=256, batch_size=32, buffer_size=1024,
                    train_freq=128, trace_length=4, max_episode_length=20,
                    recurrence=True, double_q=True)
    buf = EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size, cfg.batch_size,
                              cfg.trace_length, cfg.max_episode_length,
                              num_envs=cfg.num_envs, device=dev)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.05, 10_000),
                              env.discount)
    c = init_carry(env, net, buf, cfg, opt, dev)
    c = make_collect_graph(pop, c, cfg, env, buf, "DRQN populate")(c, n_pop)
    return it, c, cfg, env, buf


@pytest.mark.card
def test_drqn_populate_graph_drops_open_episodes(card):
    n_pop = 21
    _, c, *_ = _drqn(card, n_pop)
    assert not bool(c.replay.cur_len.any())
    assert int(c.replay.t) == n_pop and c.replay.t.is_cuda
    assert int(c.replay.rec_count.min()) > 0


@pytest.mark.card
def test_drqn_segment_replays_equal_eager_iterations(card):
    it, c, cfg, env, buf = _drqn(card, 21)
    e = _clone(c)
    run = make_segment(it, c, cfg, env, buf, "DRQN")
    assert isinstance(run, CompiledSegment)
    c = run(c, 3)
    for _ in range(3):
        e = it(e)
    la, lb = tree_flatten(c)[0], tree_flatten(e)[0]
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert torch.equal(x, y)
    assert int(c.replay.t) == 21 + 3 and int(c.iters) == 3


def _equal(a, b):
    la, lb = tree_flatten(a)[0], tree_flatten(b)[0]
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert torch.equal(x, y)


@pytest.fixture
def nccl_world(card):
    """A one-rank NCCL world on the card."""
    import torch.distributed as dist

    from deepqlearning_tpu_torch.parallel.launch import free_port

    torch.cuda.set_device(card)
    dist.init_process_group("nccl", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    yield card
    dist.destroy_process_group()


def _dp_runner(dev, kind, dcn_sync_every=1):
    """``DataParallelRunner`` on the card: "headline" (dueling 2-16-16-4,
    1024 envs, U = 4: K7) or "drqn" (LSTM(2, 16), 256 envs, U = 2: K8),
    over the 1-D mesh, or the ``(1, 1)`` hybrid mesh for local SGD."""
    from deepqlearning_tpu_torch.parallel.mesh import (
        DataParallelRunner, make_mesh)
    from deepqlearning_tpu_torch.parallel.multihost import hybrid_mesh

    env = SimpleGridWorld()
    if kind == "drqn":
        net = Chain(LSTM(2, 16, device=dev), Dense(16, 4, device=dev))
        cfg = DQNConfig(num_envs=256, batch_size=32, buffer_size=1024,
                        train_freq=128, trace_length=4, max_episode_length=20,
                        recurrence=True, double_q=True)
        buf = EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size,
                                  cfg.batch_size, cfg.trace_length,
                                  cfg.max_episode_length,
                                  num_envs=cfg.num_envs, device=dev)
    else:
        net = create_dueling_network(Chain(
            Flatten(), Dense(2, 16, torch.tanh, device=dev),
            Dense(16, 16, torch.tanh, device=dev), Dense(16, 4, device=dev)))
        cfg = DQNConfig(num_envs=1024, batch_size=64, buffer_size=1 << 14,
                        train_freq=256, max_episode_length=20,
                        target_update_freq=2048, double_q=True, dueling=True,
                        prioritized_replay=True)
        buf = PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                      cfg.batch_size, device=dev)
    mesh = hybrid_mesh() if dcn_sync_every > 1 else make_mesh(1)
    return DataParallelRunner(env, net, buf, cfg,
                              LinearDecaySchedule(1.0, 0.05, 10_000),
                              env.discount, mesh=mesh,
                              dcn_sync_every=dcn_sync_every)


@pytest.mark.card
@pytest.mark.parametrize("kind,k", [("headline", 1), ("drqn", 1),
                                    ("headline", 2)])
def test_dp_graphs_replay_eager_iterations(nccl_world, kind, k):
    from deepqlearning_tpu_torch.learner.segment import CompiledSegment
    from deepqlearning_tpu_torch.utils import profiling

    runner = _dp_runner(nccl_world, kind, k)
    assert runner.graphed
    n_pop = 21 if kind == "drqn" else 2
    c = runner.run_populate(runner.init_carry(0), n_pop)
    c = runner._iteration(c)  # fills the replay past a batch; iters = 1
    e = _clone(c)
    entry = "dq_fused_drqn_grads" if kind == "drqn" else "dq_fused_grads"
    n0 = profiling.counter("kernels.launches", entry)
    c = runner.run_segment(c, 3)
    U = runner.cfg.updates_per_iter
    # warm-up and capture of each graph launch K7 / K8; replays do not
    assert (profiling.counter("kernels.launches", entry) - n0
            == 2 * U * (2 if k > 1 else 1))
    assert all(isinstance(g, CompiledSegment)
               for g in runner._graphs.values())
    for _ in range(3):
        e = runner._iteration(e)
        if k > 1 and int(e.iters) % k == 0:
            runner._average_across_dcn(e)
    _equal(c, e)
    assert int(c.iters) == 4
    with pytest.raises(ValueError, match="injected"):
        runner.run_segment(c, 1, sample_u=[None])


@pytest.mark.card
def test_dp_populate_graph_keeps_open_episodes(nccl_world):
    runner = _dp_runner(nccl_world, "drqn")
    c = runner.run_populate(runner.init_carry(1), 3)
    assert int(c.replay.t) == 3
    assert bool((c.replay.cur_len > 0).any())
    assert torch.equal(c.replay.cur_len.long(), c.actor.ep_step.long())


def _eval_net(dev, recurrent):
    if recurrent:
        return Chain(LSTM(2, 16, device=dev), Dense(16, 4, device=dev))
    return create_dueling_network(Chain(
        Flatten(), Dense(2, 16, torch.tanh, device=dev),
        Dense(16, 4, device=dev)))


@pytest.mark.card
@pytest.mark.parametrize("recurrent", [False, True])
def test_eval_graph_equals_eager_rollout(card, recurrent):
    from deepqlearning_tpu_torch.solver import evaluation as ev

    env, net = SimpleGridWorld(), _eval_net(card, recurrent)
    params = net.init(torch.Generator(device=card).manual_seed(0))
    for seed in (3, 4):
        ours = torch.Generator(device=card).manual_seed(seed)
        ref = torch.Generator(device=card).manual_seed(seed)
        assert ev.graphed(params, env, ours)
        got = ev.basic_evaluation(net, params, env, 64, 30, ours)[:2]
        want = tuple(float(x) for x in ev._eval_rollout(
            env, params, net, 64, 30, ref))
        assert got == want
        assert torch.equal(ours.get_state(), ref.get_state())
    assert len([k for k in ev._GRAPHS if k[0] == id(net)]) == 1


@pytest.mark.card
def test_eval_graph_refuses_a_host_counter(card):
    from deepqlearning_tpu_torch.solver import evaluation as ev

    net = Chain(Dense(1, 8, torch.tanh, device=card), Dense(8, 2, device=card))
    params = net.init(torch.Generator(device=card).manual_seed(0))
    ev.basic_evaluation(net, params, Drift(False), 32, 10, 1)
    with pytest.raises(RuntimeError, match="differs from the eager"):
        ev.basic_evaluation(net, params, Drift(True), 32, 10, 1)
