"""The port's five examples (``deepqlearning_tpu_torch/examples/``): each
``main`` runs on the CPU with tiny overrides of its configuration, and each
configuration is the JAX example's (``examples/*.py``), entry for entry."""
import ast
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from deepqlearning_tpu_torch.examples import (  # noqa: E402
    cartpole_dqn, drqn_tiger, gridworld_dqn, image_conv_dqn, scale_4096_envs)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = dict(logdir=None, verbose=False, max_steps=64, num_ep_eval=4,
            eval_freq=32, log_freq=32, save_freq=1 << 30)
CASES = {
    "gridworld_dqn": (gridworld_dqn, dict(train_start=16, batch_size=8,
                                          buffer_size=128)),
    "cartpole_dqn": (cartpole_dqn, dict(num_envs=8, train_freq=8,
                                        batch_size=8, buffer_size=256,
                                        train_start=16,
                                        max_episode_length=20)),
    "drqn_tiger": (drqn_tiger, dict(batch_size=4, buffer_size=64,
                                    train_start=16, trace_length=4,
                                    max_episode_length=8)),
    "scale_4096_envs": (scale_4096_envs, dict(num_envs=16, train_freq=16,
                                              batch_size=8, buffer_size=256,
                                              train_start=32)),
    "image_conv_dqn": (image_conv_dqn, dict(num_envs=8, train_freq=8,
                                            batch_size=8, buffer_size=64,
                                            train_start=16)),
}


@pytest.fixture(autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_main_runs_on_the_cpu(name, capsys):
    module, tiny = CASES[name]
    solver, policy = module.main(device="cpu", **TINY, **tiny)
    assert solver.config.max_steps == 64
    assert all(torch.isfinite(p.float()).all()
               for p in policy.params.values())
    assert capsys.readouterr().out.strip()  # it printed its result
    if name == "image_conv_dqn":
        assert {p.dtype for p in policy.params.values()} == {torch.bfloat16}
        assert solver.config.dtype == torch.bfloat16


def _jax_solver_kwargs(name):
    """The keyword arguments of the JAX example's ``DeepQLearningSolver``
    call, as source text (a value the example assigns to a name first, such
    as ``max_steps``, substituted)."""
    tree = ast.parse(open(os.path.join(REPO, "examples", name + ".py")).read())
    consts = {t.targets[0].id: ast.unparse(t.value) for t in tree.body
              if isinstance(t, ast.Assign) and len(t.targets) == 1
              and isinstance(t.targets[0], ast.Name)}
    call = next(n for n in ast.walk(tree) if isinstance(n, ast.Call)
                and getattr(n.func, "id", None) == "DeepQLearningSolver")
    out = {}
    for kw in call.keywords:
        if kw.arg in ("qnetwork",):
            continue
        src = ast.unparse(kw.value)
        src = consts.get(src, src)  # a value the example names first
        if "max_steps" in consts:
            src = src.replace("max_steps", consts["max_steps"])
        out[kw.arg] = src
    return out


@pytest.mark.parametrize("name", sorted(CASES))
def test_example_config_is_the_jax_example_s(name):
    """Every number and flag of the JAX example's solver call is in the
    port's configuration with the same value (schedules by their fields;
    ``jnp.bfloat16`` as ``torch.bfloat16``)."""
    module = CASES[name][0]
    cfg = module.config()
    env = {"jnp": type("jnp", (), {"bfloat16": torch.bfloat16}),
           "EpsGreedyPolicy": lambda s: ("eps", s),
           "LinearDecaySchedule": lambda *a, **k: tuple(a) + tuple(
               k[x] for x in ("start", "stop", "steps") if x in k)}
    jax_kwargs = _jax_solver_kwargs(name)
    assert set(jax_kwargs) == set(cfg), (name, set(jax_kwargs) ^ set(cfg))
    for key, src in jax_kwargs.items():
        ref = eval(src, env)
        ours = cfg[key]
        if key == "exploration_policy":
            sch = ours.schedule
            ours = ("eps", (sch.start, sch.stop, sch.steps))
        assert ours == ref, (name, key, ours, ref)


def test_examples_run_as_modules():
    """``python -m deepqlearning_tpu_torch.examples.<name>`` reaches
    ``main`` (checked without running it: the entry guard calls it)."""
    for module, _ in CASES.values():
        src = open(module.__file__).read()
        assert 'if __name__ == "__main__":\n    main()' in src
    assert np.all([callable(m.main) for m, _ in CASES.values()])
