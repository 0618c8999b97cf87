"""The port imports neither JAX nor the JAX package.

A subprocess blocks ``jax`` and ``deepqlearning_tpu`` (an import of either
raises), imports every module of ``deepqlearning_tpu_torch`` and runs one
CPU loop iteration through each route (kernel twins and plain paths), for
the feed-forward and the recurrent (DRQN) loop, one data-parallel
iteration of each through ``DataParallelRunner`` in a one-rank gloo world,
a tiny ``DeepQLearningSolver.solve``, the classic-control envs, one
CartPole collect step through the collect kernel's route, and the examples
(``deepqlearning_tpu_torch/examples``; the bf16 conv one runs at tiny
sizes). A second subprocess steps the problems written one instance at a
time (``chip_smoke.user_envs``) and calls the helper names, JAX blocked.
"""
import os
import subprocess
import sys
import textwrap

import pytest

pytest.importorskip("torch")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "deepqlearning_tpu", "optax", "flax"):
        sys.modules[name] = None
    import torch
    torch.set_num_threads(1)
    import deepqlearning_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke  # the chip script imports the port only
    from deepqlearning_tpu_torch import *
    from deepqlearning_tpu_torch.learner.loop import build_loop, init_carry
    env = SimpleGridWorld()
    for fused in (None, False):
        for num_envs, train_freq in ((128, 32), (128, 128)):
            net = create_dueling_network(Chain(
                Flatten(), Dense(2, 8, torch.tanh), Dense(8, 4)))
            cfg = DQNConfig(num_envs=num_envs, train_freq=train_freq,
                            batch_size=16, buffer_size=512,
                            fused_updates=fused, fused_collect=fused)
            buf = PrioritizedReplayBuffer(env.obs_shape, 512, 16, device="cpu")
            it, pop, opt = build_loop(env, net, buf, cfg,
                                      LinearDecaySchedule(), env.discount)
            c = init_carry(env, net, buf, cfg, opt, device="cpu")
            cc = pop((c.actor, c.replay, c.params), c.generator)
            c = it(c._replace(actor=cc[0], replay=cc[1]))
            assert torch.isfinite(c.loss) and c.replay.size == 256
        net = Chain(LSTM(2, 8), Dense(8, 4))
        cfg = DQNConfig(num_envs=128, train_freq=64, batch_size=8,
                        buffer_size=256, trace_length=4, max_episode_length=5,
                        recurrence=True, fused_updates=fused,
                        fused_collect=fused)
        buf = EpisodeReplayBuffer(env.obs_shape, 256, 8, 4, 5, num_envs=128,
                                  device="cpu")
        it, pop, opt = build_loop(env, net, buf, cfg, LinearDecaySchedule(),
                                  env.discount)
        c = populate(pop, buf, init_carry(env, net, buf, cfg, opt,
                                          device="cpu"), 6)
        c = it(c)
        assert torch.isfinite(c.loss) and c.replay.t == 7
    # data parallelism in a one-rank gloo world: the K7 and K8 routes
    import torch.distributed as dist
    from deepqlearning_tpu_torch.parallel.launch import free_port
    dist.init_process_group("gloo", world_size=1, rank=0,
                            init_method=f"tcp://127.0.0.1:{free_port()}")
    mdp = TestMDP((5, 5), 1, 6)
    for rec in (False, True):
        net = (Chain(Flatten(), LSTM(25, 8), Dense(8, 4)) if rec else
               create_dueling_network(Chain(Flatten(), Dense(25, 8, torch.tanh),
                                            Dense(8, 4))))
        cfg = DQNConfig(num_envs=4, train_freq=2, batch_size=4,
                        buffer_size=32, trace_length=3, max_episode_length=6,
                        recurrence=rec, fused_updates=True)
        buf = (EpisodeReplayBuffer(mdp.obs_shape, 32, 4, 3, 6, num_envs=4,
                                   device="cpu")
               if rec else PrioritizedReplayBuffer(mdp.obs_shape, 32, 4,
                                                   device="cpu"))
        runner = DataParallelRunner(mdp, net, buf, cfg, LinearDecaySchedule(),
                                    mdp.discount)
        c = runner.run_segment(runner.run_populate(runner.init_carry(0), 8), 1)
        assert torch.isfinite(c.loss) and int(c.opt_state.count) == 2
    dist.destroy_process_group()
    # the solver's front door: a tiny solve through build_loop
    pol = DeepQLearningSolver(
        qnetwork=Chain(Dense(2, 8), Dense(8, 4)), max_steps=64, num_envs=8,
        train_freq=8, buffer_size=64, train_start=16, batch_size=4,
        eval_freq=32, num_ep_eval=4, logdir=None, verbose=False,
        device="cpu").solve(SimpleGridWorld())
    assert pol.action(torch.zeros(2)) in SimpleGridWorld().action_map
    # the classic-control envs, and one CartPole collect step through the
    # collect kernel's route (its plain twin on CPU tensors)
    from deepqlearning_tpu_torch.learner.actor import (
        init_actor, make_fused_collect_step)
    from deepqlearning_tpu_torch.ops.cuda.fused_collect import (
        collect_plan_for)
    from deepqlearning_tpu_torch.envs import Acrobot, CartPole, MountainCar
    g = torch.Generator().manual_seed(0)
    for e in (Acrobot(), MountainCar()):
        st, ob = e.reset_batch(4, g)
        st, ob, r, d = e.step_batch(st, torch.zeros(4, dtype=torch.long), g)
        assert ob.shape == (4,) + e.obs_shape
    cp = CartPole()
    net = create_dueling_network(Chain(Dense(4, 8, torch.tanh), Dense(8, 2)))
    buf = PrioritizedReplayBuffer(cp.obs_shape, 256, 8, device="cpu")
    plan = collect_plan_for(cp, net, buf)
    assert plan is not None and plan.n_uniforms == 6
    step = make_fused_collect_step(cp, net, 200, lambda t: 0.5,
                                   lambda r, tr, ended: buf.insert(r, tr),
                                   plan)
    a, r, _ = step((init_actor(cp, net, 128, g), buf.init(),
                    net.init(g)), g)
    assert r.size == 128 and a.obs.shape == (128, 4)
    # the examples (imported above with every module): the bf16 conv one
    # runs at tiny sizes, through Conv2D, bf16 replay and the K1/K2 twins
    import contextlib, io
    from deepqlearning_tpu_torch.examples import image_conv_dqn
    with contextlib.redirect_stdout(io.StringIO()):
        sol, pol = image_conv_dqn.main(
            device="cpu", max_steps=32, num_envs=8, train_freq=8,
            batch_size=8, buffer_size=64, train_start=16, num_ep_eval=2,
            eval_freq=16, log_freq=16, logdir=None, verbose=False)
    assert {p.dtype for p in pol.params.values()} == {torch.bfloat16}
    assert "deepqlearning_tpu_torch.examples.cartpole_dqn" in sys.modules
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "jaxlib", "deepqlearning_tpu") and sys.modules[m]]
    assert not bad, bad
    print("OK", len(names))
""")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", SCRIPT], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().startswith("OK")
    assert int(res.stdout.split()[-1]) >= 20  # every module was imported


PER_INSTANCE = textwrap.dedent("""
    import sys
    for name in ("jax", "jaxlib", "deepqlearning_tpu", "optax", "flax"):
        sys.modules[name] = None
    import torch
    from deepqlearning_tpu_torch import MDPEnv, POMDPEnv, batch_trajectories
    from deepqlearning_tpu_torch.ops.helpers import (
        default_discount, hiddenstates, obs_dimensions, sethiddenstates)
    from deepqlearning_tpu_torch.ops.sumtree import get_leaf, init_tree
    from deepqlearning_tpu_torch.replay.episode import EpisodeReplayBuffer
    from deepqlearning_tpu_torch.replay.transition import (
        DQExperience, batch_from_experience)
    import chip_smoke
    GridWorld, StaticArrayMDP, MiniPOMDP = chip_smoke.user_envs()
    g = torch.Generator().manual_seed(0)
    for env in (GridWorld(), MDPEnv(StaticArrayMDP()),
                POMDPEnv(MiniPOMDP())):
        s, o = env.reset_batch(8, g)
        s, o, r, d = env.step_batch(s, torch.ones(8, dtype=torch.long), g)
        assert o.shape == (8,) + obs_dimensions(env)
        assert r.dtype == d.dtype == torch.float32
        assert default_discount(env) == env.discount
    assert batch_trajectories(torch.zeros(2, 3, 4), 3, 2).shape == (3, 2, 4)
    assert get_leaf(init_tree(8), torch.arange(3)).shape == (3,)
    assert batch_from_experience(DQExperience(
        torch.zeros(2), 1, 0.5, torch.ones(2), False)).obs.shape == (1, 2)
    buf = EpisodeReplayBuffer((2,), 8, 4, 2, 4, num_envs=2, device="cpu")
    assert int(buf.size_fn(buf.init())) == 0
    assert hiddenstates(sethiddenstates(((), (1,)), [(2,)])) == [(2,)]
    bad = [m for m in sys.modules if m.split(".")[0] in
           ("jax", "jaxlib", "deepqlearning_tpu") and sys.modules[m]]
    assert not bad, bad
    print("OK")
""")


def test_per_instance_envs_and_new_names_import_no_jax():
    """The per-instance env protocol and the helper names, with JAX
    blocked: one step of each of ``chip_smoke.user_envs``' problems."""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run([sys.executable, "-c", PER_INSTANCE], cwd=REPO,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "OK"
