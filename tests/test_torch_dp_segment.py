"""The data-parallel segment's and the greedy evaluation's preconditions
for their CUDA graphs, on the CPU (``parallel/mesh.py``,
``solver/evaluation.py``, ``learner/segment.py``).

(a) One data-parallel iteration reads nothing back to the host on a gloo
world of one rank: the feed-forward headline's route (K7's twin and
``pmean_flat`` per sub-update), DRQN (K8's twin) and local SGD's
iteration followed by its DCN average on a ``(1, 1)`` ``hybrid_mesh``.
Nor does a greedy evaluation's reset or step: feed-forward, recurrent and
per-instance envs (``torch.func.vmap``). The dispatch mode is
``test_torch_compiled_segment.NoHostRead``.

(b) The local-SGD period counted on the host from the carry's ``iters``,
read once per ``run_segment`` call, averages after exactly the iterations
where the per-iteration device read ``int(carry.iters) % k == 0`` did,
over calls of odd lengths and across a resume, and the carries agree bit
for bit.

(c) ``basic_evaluation`` on the CPU gives what the eager rollout gave
before the graphs were added and advances the caller's generator as it
did; a gloo world stays on the eager route.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.distributed as dist  # noqa: E402
from torch.utils._pytree import tree_flatten  # noqa: E402

import chip_smoke  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.learner.segment import (  # noqa: E402
    collect_body, graph_route, nccl_groups)
from deepqlearning_tpu_torch.parallel.launch import free_port  # noqa: E402
from deepqlearning_tpu_torch.parallel.mesh import (  # noqa: E402
    DataParallelRunner, make_mesh)
from deepqlearning_tpu_torch.parallel.multihost import hybrid_mesh  # noqa: E402
from deepqlearning_tpu_torch.solver import evaluation as ev  # noqa: E402
from deepqlearning_tpu_torch.utils import profiling  # noqa: E402

from test_torch_compiled_segment import NoHostRead  # noqa: E402

torch.set_num_threads(2)
GridWorld, _, MiniPOMDP = chip_smoke.user_envs()


@pytest.fixture
def world_of_one():
    """A one-rank gloo process group in this process."""
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    yield dist.group.WORLD
    dist.destroy_process_group()


def _runner(kind, mesh=None, dcn_sync_every=1, seed=0):
    """A runner on the CPU: "headline" (the headline's dueling 2-16-16-4
    tanh net, U = 4, K7's twin), "drqn" (LSTM(2, 8), U = 2, K8's twin)."""
    env = dt.SimpleGridWorld()
    if kind == "drqn":
        net = dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
        cfg = dt.DQNConfig(num_envs=32, batch_size=8, buffer_size=128,
                           train_freq=16, trace_length=4,
                           max_episode_length=5, recurrence=True,
                           double_q=True, target_update_freq=64,
                           learning_rate=1e-2, fused_updates=True)
        buf = dt.EpisodeReplayBuffer(env.obs_shape, cfg.buffer_size,
                                     cfg.batch_size, cfg.trace_length,
                                     cfg.max_episode_length,
                                     num_envs=cfg.num_envs, device="cpu")
    else:
        net = dt.create_dueling_network(dt.Chain(
            dt.Flatten(), dt.Dense(2, 16, torch.tanh),
            dt.Dense(16, 16, torch.tanh), dt.Dense(16, 4)))
        cfg = dt.DQNConfig(num_envs=64, batch_size=16, buffer_size=512,
                           train_freq=16, max_episode_length=5,
                           target_update_freq=128, learning_rate=1e-2,
                           double_q=True, dueling=True,
                           prioritized_replay=True, fused_updates=True)
        buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                         cfg.batch_size, device="cpu")
    runner = DataParallelRunner(env, net, buf, cfg,
                                dt.LinearDecaySchedule(1.0, 0.05, 500),
                                env.discount,
                                mesh=mesh if mesh is not None else
                                make_mesh(1),
                                dcn_sync_every=dcn_sync_every)
    n_pop = cfg.max_episode_length + 1 if kind == "drqn" else 2
    return runner, runner.run_populate(runner.init_carry(seed), n_pop)


@pytest.mark.parametrize("kind", ["headline", "drqn", "local_sgd"])
def test_no_host_read_in_a_dp_iteration(world_of_one, kind):
    local_sgd = kind == "local_sgd"
    runner, c = _runner("headline" if local_sgd else kind,
                        mesh=hybrid_mesh() if local_sgd else None,
                        dcn_sync_every=2 if local_sgd else 1)
    assert tuple(runner.mesh.shape) == ((1, 1) if local_sgd else (1,))
    c = runner.run_segment(c, 1)  # a warm-up, as the capture's
    U = runner.cfg.updates_per_iter
    iteration = (runner._synced_iteration if local_sgd
                 else runner._iteration)
    n0 = profiling.counter("train.pmean_flat")
    with NoHostRead():
        c = collect_body(runner._populate_step)(c)
        c = iteration(c)
    # U gradient all-reduces, and local SGD's average of params, m and v
    assert profiling.counter("train.pmean_flat") - n0 == U + local_sgd
    assert all(isinstance(x, (torch.Tensor, torch.Generator))
               for x in tree_flatten(c)[0])
    assert int(c.iters) == 2 and bool(torch.isfinite(c.loss))
    assert int(c.opt_state.count) == 2 * U


def _eval_case(name):
    """``(env, network)`` of a greedy evaluation."""
    if name == "feed_forward":
        return dt.SimpleGridWorld(), dt.create_dueling_network(dt.Chain(
            dt.Flatten(), dt.Dense(2, 16, torch.tanh), dt.Dense(16, 4)))
    if name == "recurrent":
        return dt.SimpleGridWorld(), dt.Chain(dt.LSTM(2, 8), dt.Dense(8, 4))
    if name == "per_instance":
        return GridWorld(), dt.Chain(dt.Dense(2, 16, torch.tanh),
                                     dt.Dense(16, 4))
    assert name == "per_instance_recurrent"
    return dt.POMDPEnv(MiniPOMDP()), dt.create_dueling_network(
        dt.Chain(dt.LSTM(1, 8), dt.Dense(8, 2)))


EVALS = ("feed_forward", "recurrent", "per_instance",
         "per_instance_recurrent")


@pytest.mark.parametrize("name", EVALS)
def test_no_host_read_in_a_greedy_evaluation_step(name):
    env, net = _eval_case(name)
    params = net.init(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    step = ev.eval_step(env, net, params)
    c = step(ev.eval_reset(env, net, 16, "cpu", g))  # unguarded warm-up
    with torch.no_grad(), NoHostRead():
        c = ev.eval_reset(env, net, 16, "cpu", c.generator)
        for _ in range(3):
            out = step(c)
            # a graph copies the step's carry back into the reset's
            assert tree_flatten(out)[1] == tree_flatten(c)[1]
            c = out
    assert all(isinstance(x, (torch.Tensor, torch.Generator))
               for x in tree_flatten(c)[0])
    assert c.steps.shape == (16,) and bool((c.steps >= 1).all())
    assert bool((c.steps <= 3).all())


def _old_rollout(env, params, network, n_eval, max_episode_length,
                 generator):
    """The eager rollout as it was written before the graphs: the
    reference for results and generator state."""
    device = next(iter(params.values())).device
    with torch.no_grad():
        env_state, obs = env.reset_batch(n_eval, generator)
        net_state = network.init_state(n_eval, device)
        finished = torch.zeros(n_eval, dtype=torch.bool, device=device)
        ret = torch.zeros(n_eval, dtype=torch.float32, device=device)
        steps = torch.zeros_like(ret)
        for _ in range(max_episode_length + 1):
            q, net_state = network.apply(params, obs, net_state)
            action = torch.argmax(q, dim=-1)
            env_state, obs, r, done = env.step_batch(env_state, action,
                                                     generator)
            active = (~finished).float()
            ret = ret + r * active
            steps = steps + active
            finished = finished | (done > 0.5)
        inv = 1.0 / n_eval
        return float(ret.sum() * inv), float(steps.sum() * inv)


@pytest.mark.parametrize("name", EVALS)
def test_basic_evaluation_on_cpu_is_the_eager_rollout(name):
    env, net = _eval_case(name)
    params = net.init(torch.Generator().manual_seed(2))
    assert not ev.graphed(params, env, torch.Generator())
    for seed, n_eval, max_len in ((3, 24, 6), (4, 5, 0)):
        ours, ref = (torch.Generator().manual_seed(seed) for _ in range(2))
        r, s, info = dt.basic_evaluation(net, params, env, n_eval, max_len,
                                         ours)
        assert (r, s) == _old_rollout(env, params, net, n_eval, max_len,
                                      ref)
        assert info == {}
        # the caller's generator advanced as the eager rollout advances it
        assert torch.equal(ours.get_state(), ref.get_state())
        # an int seed draws from a new generator seeded with it
        assert dt.basic_evaluation(net, params, env, n_eval, max_len,
                                   seed)[:2] == (r, s)


def _record_syncs(runner, seen):
    average = runner._average_across_dcn

    def spy(carry):
        seen.append(int(carry.iters))
        average(carry)

    runner._average_across_dcn = spy


@pytest.mark.parametrize("k", [2, 3])
def test_local_sgd_period_is_counted_on_the_host(world_of_one, k):
    runner, c = _runner("headline", mesh=hybrid_mesh(), dcn_sync_every=k)
    ref_runner, ref = _runner("headline", mesh=hybrid_mesh(),
                              dcn_sync_every=k)
    seen = []
    _record_syncs(runner, seen)
    for n in (1, 4, 3, 0, 5):
        c = runner.run_segment(c, n)
    # a resume: a new runner on a carry that has run 13 iterations
    resumed, _ = _runner("headline", mesh=hybrid_mesh(), dcn_sync_every=k)
    _record_syncs(resumed, seen)
    c = chip_smoke._clone_carry(torch, c)
    for n in (2, 3):
        c = resumed.run_segment(c, n)
    total = 18
    assert int(c.iters) == total
    assert seen == [i for i in range(1, total + 1) if i % k == 0]
    # the per-iteration device read the host count replaces
    for _ in range(total):
        ref = ref_runner._iteration(ref)
        if int(ref.iters) % k == 0:
            ref_runner._average_across_dcn(ref)
    for x, y in zip(tree_flatten(c)[0], tree_flatten(ref)[0]):
        if isinstance(x, torch.Generator):
            assert torch.equal(x.get_state(), y.get_state())
        else:
            assert torch.equal(x, y)


def test_gloo_runner_is_the_eager_route(world_of_one):
    runner, c = _runner("headline")
    assert not runner.graphed
    assert not nccl_groups(world_of_one)
    assert not nccl_groups(())
    assert not graph_route(runner.cfg, runner.env, runner.buffer,
                           world_of_one)
    # the eager route takes injected uniforms
    E, U, B = runner.cfg.num_envs, runner.cfg.updates_per_iter, 16
    rng = np.random.default_rng(0)
    u = lambda *s: torch.from_numpy(rng.random(s, np.float32))
    c = runner.run_segment(c, 2, [[u(6, E)] for _ in range(2)],
                           [[u(U * B)] for _ in range(2)])
    assert int(c.iters) == 2 and bool(torch.isfinite(c.loss))


def test_dp_populate_keeps_open_episodes_open(world_of_one):
    """The JAX runner's ``local_populate`` ends with no
    ``reset_in_progress``: each env's open episode stays in the ring, as
    long as the actor's current episode."""
    runner, _ = _runner("drqn")
    c = runner.run_populate(runner.init_carry(1), 3)
    assert int(c.replay.t) == 3
    assert bool((c.replay.cur_len > 0).any())
    assert torch.equal(c.replay.cur_len.long(), c.actor.ep_step.long())
