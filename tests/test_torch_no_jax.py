"""The port imports neither JAX nor the JAX package.

A subprocess blocks ``jax`` and ``deepqlearning_tpu`` (an import of either
raises), imports every module of ``deepqlearning_tpu_torch`` and runs one
CPU loop iteration through each route (kernel twins and plain paths), for
the feed-forward and the recurrent (DRQN) loop.
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
            buf = PrioritizedReplayBuffer(env.obs_shape, 512, 16)
            it, pop, opt = build_loop(env, net, buf, cfg,
                                      LinearDecaySchedule(), env.discount)
            c = init_carry(env, net, buf, cfg, opt)
            cc = pop((c.actor, c.replay, c.params), c.generator)
            c = it(c._replace(actor=cc[0], replay=cc[1]))
            assert torch.isfinite(c.loss) and c.replay.size == 256
        net = Chain(LSTM(2, 8), Dense(8, 4))
        cfg = DQNConfig(num_envs=128, train_freq=64, batch_size=8,
                        buffer_size=256, trace_length=4, max_episode_length=5,
                        recurrence=True, fused_updates=fused,
                        fused_collect=fused)
        buf = EpisodeReplayBuffer(env.obs_shape, 256, 8, 4, 5, num_envs=128)
        it, pop, opt = build_loop(env, net, buf, cfg, LinearDecaySchedule(),
                                  env.discount)
        c = populate(pop, buf, init_carry(env, net, buf, cfg, opt), 6)
        c = it(c)
        assert torch.isfinite(c.loss) and c.replay.t == 7
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
