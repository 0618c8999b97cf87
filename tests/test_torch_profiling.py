"""The port's recorder (``deepqlearning_tpu_torch/utils/profiling.py``):
spans with their parents and self time, counters, the bounded rings, the
``enabled`` flag, spans as ranges of a ``torch.profiler`` session, the
spans and counters of an eager segment, populate and ``solve``, and the
benchmark's readers of them (``port_bench/metrics/``) on synthetic
snapshots. CPU, apart from the last test, which needs an NVIDIA GPU: the
node count of a captured graph and a sampled segment's CUDA events. On a
card::

    python -m pytest --noconftest -m card tests/test_torch_profiling.py
"""
import time
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.learner.loop import (  # noqa: E402
    build_loop, init_carry)
from deepqlearning_tpu_torch.learner.segment import (  # noqa: E402
    make_collect_graph, make_segment)
from deepqlearning_tpu_torch.utils import profiling  # noqa: E402


@pytest.fixture(autouse=True)
def fresh():
    profiling.reset()
    yield
    profiling.reset()


def _by_name(snap, name):
    return [s for s in snap["spans"] if s["name"] == name]


def test_nesting_and_self_time():
    with profiling.span("outer", route="r", n=2):
        time.sleep(0.01)
        with profiling.span("inner", route="r"):
            time.sleep(0.02)
        with profiling.span("inner", route="r"):
            with profiling.span("leaf"):
                time.sleep(0.005)
    snap = profiling.snapshot()
    (outer,) = _by_name(snap, "outer")
    inner = _by_name(snap, "inner")
    (leaf,) = _by_name(snap, "leaf")
    assert outer["parent"] is None and outer["route"] == "r"
    assert outer["n"] == 2
    assert [s["parent"] for s in inner] == [outer["id"]] * 2
    assert leaf["parent"] == inner[1]["id"] and leaf["route"] is None
    assert [s["name"] for s in snap["spans"]] == [
        "outer", "inner", "inner", "leaf"]
    t = snap["totals"]
    dur = lambda s: (s["end_ns"] - s["start_ns"]) * 1e-9  # noqa: E731
    assert t["outer"]["r"]["count"] == 1 and t["inner"]["r"]["count"] == 2
    assert t["outer"]["r"]["total_s"] == pytest.approx(dur(outer))
    assert t["outer"]["r"]["self_s"] == pytest.approx(
        dur(outer) - dur(inner[0]) - dur(inner[1]))
    assert t["inner"]["r"]["self_s"] == pytest.approx(
        dur(inner[0]) + dur(inner[1]) - dur(leaf))
    assert t["leaf"][""]["self_s"] == pytest.approx(dur(leaf))
    assert 0.009 < t["outer"]["r"]["self_s"] < t["inner"]["r"]["self_s"]


def test_counters_add_and_set():
    profiling.count("replays", 3, "a")
    profiling.count("replays", 4, "a")
    profiling.count("replays", key="b")
    profiling.count("builds", 0)
    profiling.put("nodes", 17, "a")
    profiling.put("nodes", 12, "a")
    assert profiling.snapshot()["counters"] == {
        "replays": {"a": 7, "b": 1}, "builds": {"": 0}, "nodes": {"a": 12}}


def test_rings_are_bounded_and_totals_keep_counting(monkeypatch):
    monkeypatch.setattr(profiling, "SPANS_PER_NAME", 16)
    profiling.reset()
    with profiling.span("rare"):
        pass
    for i in range(100):
        with profiling.span("often", n=i):
            pass
    snap = profiling.snapshot()
    often = _by_name(snap, "often")
    assert [s["n"] for s in often] == list(range(84, 100))
    assert len(_by_name(snap, "rare")) == 1  # a ring per name
    assert snap["totals"]["often"][""]["count"] == 100
    assert len(profiling.RECORDER.samples) == 0
    assert profiling.RECORDER.samples.maxlen == profiling.SAMPLES


def test_nothing_is_recorded_when_disabled(monkeypatch):
    monkeypatch.setattr(profiling, "enabled", False)
    with profiling.span("segment.run", route="r", n=1):
        profiling.count("segment.replays", 1, "r")
        profiling.put("segment.graph_nodes", 5, "r")
    sampler = profiling.ReplaySampler("r", torch.device("cpu"))
    assert sampler.start(4) is None
    assert profiling.snapshot() == dict(spans=[], totals={}, counters={},
                                        samples=[])


def test_spans_are_ranges_of_a_profiler_session():
    from torch.profiler import ProfilerActivity, profile

    x = torch.ones(64)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with profiling.span("solve.segment"):
            with profiling.span("segment.run", route="r", n=1):
                torch.tanh(x) + 1
    ev = prof.events()
    (run,) = [e for e in ev if e.name == "segment.run"]
    (seg,) = [e for e in ev if e.name == "solve.segment"]
    assert run.cpu_parent is seg
    tanh = [e for e in ev if e.name == "aten::tanh"]
    assert tanh and all(e.cpu_parent is run for e in tanh)
    assert run.time_range.start <= tanh[0].time_range.start
    assert tanh[0].time_range.end <= run.time_range.end
    # outside a session a span opens no range
    with profiling.span("segment.run") as sp:
        pass
    assert sp.range is None
    assert len(_by_name(profiling.snapshot(), "segment.run")) == 2


def _small_loop():
    env = dt.SimpleGridWorld()
    net = dt.create_dueling_network(dt.Chain(
        dt.Dense(2, 16, torch.tanh), dt.Dense(16, 4)))
    cfg = dt.DQNConfig(num_envs=32, batch_size=16, buffer_size=256,
                       train_freq=32, train_start=64, max_episode_length=20,
                       target_update_freq=64, seed=1)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                     cfg.batch_size, device="cpu")
    it, pop, opt = build_loop(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.05, 200),
                              env.discount)
    return env, buf, cfg, it, pop, init_carry(env, net, buf, cfg, opt, "cpu")


def test_eager_segment_and_populate_record_spans_and_replays():
    env, buf, cfg, it, pop, c = _small_loop()
    c = make_collect_graph(pop, c, cfg, env, buf, "tiny populate")(c, 2)
    run = make_segment(it, c, cfg, env, buf, "tiny segment")
    c = run(c, 3)
    c = run(c, 2)
    snap = profiling.snapshot()
    (fill,) = _by_name(snap, "populate")
    assert fill["route"] == "tiny populate" and fill["n"] == 2
    runs = _by_name(snap, "segment.run")
    assert [(s["route"], s["n"]) for s in runs] == [
        ("tiny segment", 3), ("tiny segment", 2)]
    assert snap["counters"]["segment.replays"] == {"tiny segment": 5}
    assert int(c.iters) == 5
    # eager routes capture nothing and sample nothing
    assert "segment.capture" not in snap["totals"] and not snap["samples"]


def _impala_stack(cin, cout, device):
    """An IMPALA stack (Espeholt et al. 2018) as the benchmark builds it
    (``port_bench/layers/ImpalaStack.py``): a 3x3 convolution, a 3x3 max
    pool of stride 2 and two residual blocks of two 3x3 convolutions."""
    from pathlib import Path

    from port_bench.harness.registry import load_module

    part = load_module(Path(__file__).resolve().parents[1] / "port_bench"
                       / "layers" / "ImpalaStack.py")
    return part.program([cin, cout], device)


def _impala_loop(device):
    """The IMPALA dueling net at 12x12x4 frames (stacks of 4, 8, 8) under
    the traffic of the cell ``impala_dqn.learner``: 32 envs, ``train_freq``
    4, so U = 8 grouped plain updates per iteration."""
    env = dt.TestMDP((12, 12), 4, 6)
    net = dt.create_dueling_network(dt.Chain(
        _impala_stack(4, 8, device), _impala_stack(8, 8, device),
        _impala_stack(8, 8, device), dt.Activation(torch.relu),
        dt.Flatten(), dt.Dense(2 * 2 * 8, 16, torch.relu, device=device),
        dt.Dense(16, env.num_actions, device=device)))
    cfg = dt.DQNConfig(num_envs=32, batch_size=8, buffer_size=256,
                       train_freq=4, train_start=64, max_episode_length=6,
                       target_update_freq=64, seed=1)
    buf = dt.PrioritizedReplayBuffer(env.obs_shape, cfg.buffer_size,
                                      cfg.batch_size, device=device)
    it, pop, opt = build_loop(env, net, buf, cfg,
                              dt.LinearDecaySchedule(1.0, 0.05, 200),
                              env.discount)
    c = init_carry(env, net, buf, cfg, opt, device)
    c = make_collect_graph(pop, c, cfg, env, buf, "impala populate")(c, 4)
    return env, buf, cfg, it, c


# one iteration of the IMPALA loop at U = 8: 18 forwards (the collect's,
# the target net's over all U·B rows, and per update the online net's on
# s' and on s), each through 3 stacks of 5 convolutions, 1 pool and 2
# residual blocks
LAYER_CALLS = {"conv2d": 18 * 15, "maxpool2d": 18 * 3, "residual": 18 * 6}


def _layer_calls(route):
    counters = profiling.snapshot()["counters"]
    return {k: counters[f"segment.layer_calls.{k}"][route]
            for k in LAYER_CALLS}


def test_segment_puts_the_layer_calls_of_an_iteration():
    """The eager segment puts ``segment.layer_calls.*`` of its route at
    the counts the iteration's structure gives (270 / 54 / 108 at U = 8),
    the same after more iterations, while the layers' own counters
    (``model.*``) count every call."""
    env, buf, cfg, it, c = _impala_loop("cpu")
    run = make_segment(it, c, cfg, env, buf, "impala segment")
    model = profiling.counter("model.conv2d")
    c = run(c, 1)
    assert _layer_calls("impala segment") == LAYER_CALLS
    assert profiling.counter("model.conv2d") - model == 18 * 15
    c = run(c, 2)
    assert _layer_calls("impala segment") == LAYER_CALLS
    assert profiling.counter("model.conv2d") - model == 3 * 18 * 15
    assert profiling.counter("model.maxpool2d") == 3 * 18 * 3 + 4 * 3


def test_solve_records_segment_evaluation_and_save_in_order(tmp_path):
    mdp = dt.TestMDP((3,), 2, 4)
    solver = dt.DeepQLearningSolver(
        qnetwork=dt.Chain(dt.Flatten(), dt.Dense(6, 8, torch.tanh),
                          dt.Dense(8, mdp.num_actions)),
        max_steps=300, eval_freq=100, save_freq=100, num_ep_eval=4,
        log_freq=100, train_start=50, logdir=str(tmp_path), device="cpu",
        verbose=False, exploration_policy=dt.EpsGreedyPolicy())
    solver.solve(mdp)
    snap = profiling.snapshot()
    names = [s["name"] for s in snap["spans"] if s["name"].startswith(
        ("solve.", "populate"))]
    first = {n: names.index(n) for n in set(names)}
    assert first["populate"] < first["solve.segment"] < first[
        "solve.evaluation"] < first["solve.save"]
    assert names.count("solve.segment") == 3
    assert names.count("solve.evaluation") == 3
    # a save per evaluation, then the train state's at the end
    assert names.count("solve.save") == 4 and names[-1] == "solve.save"
    runs = _by_name(snap, "segment.run")
    segs = _by_name(snap, "solve.segment")
    assert all(r["parent"] == s["id"] for r, s in zip(runs, segs))
    route = segs[0]["route"]
    assert route.startswith("solve on TestMDP")
    assert snap["counters"]["segment.replays"][route] == 300 // 4


# --- the benchmark's readers -------------------------------------------
SEG, POP = "port_bench segment", "port_bench populate"


def _synthetic():
    def sample(call, n, device_ms, gap):
        return dict(route=SEG, call=call, t_ns=call, n=n,
                    device_ms=device_ms, gap_ms=gap)

    totals = {"segment.capture": {SEG: dict(count=1, total_s=1.5,
                                            self_s=0.1),
                                  POP: dict(count=1, total_s=0.5,
                                            self_s=0.1)},
              "populate": {POP: dict(count=1, total_s=0.25, self_s=0.05)}}
    return dict(
        spans=[], totals=totals,
        counters={"segment.graph_nodes": {SEG: 380, POP: 40},
                  "segment.layer_calls.conv2d": {SEG: 270, POP: 15},
                  "segment.layer_calls.maxpool2d": {SEG: 54, POP: 3},
                  "segment.layer_calls.residual": {SEG: 108, POP: 6},
                  "segment.layer_calls.bias_act_kernel": {SEG: 90, POP: 5},
                  "segment.layer_calls.bias_act_plain": {SEG: 30, POP: 0}},
        samples=[sample(0, 1, 9.0, 50.0),   # a checked call: left out
                 sample(5, 2, 2.0, 0.5),
                 sample(9, 2, 3.0, 0.5),
                 sample(13, 4, 4.0, None),  # the next call was traced
                 dict(sample(12, 1, 7.0, 7.0), route=POP)])


# metric: its reading from _synthetic()
READINGS = {
    "segment.graph_nodes": 380,
    "segment.device_ms_per_replay": 1.0,
    "segment.launch_gap_share": 100.0 * 1.0 / 6.0,
    "segment.node_gap_share": 100.0 * (1.0 - 0.8),
    "setup.capture_s": 2.0,
    "setup.populate_s": 0.25,
    "segment.trunk_calls": 432,
    "segment.bias_act_share": 75.0,
}


@pytest.mark.parametrize("name", sorted(READINGS))
def test_recorder_metric_readers(name, monkeypatch):
    from port_bench.harness.registry import Registry

    reader = Registry().metric(name)
    ctx = SimpleNamespace(trace=dict(busy_s=0.008, iterations=10),
                          window=dict(iterations=100, seconds=1.0))
    monkeypatch.setattr(profiling, "snapshot", _synthetic)
    assert reader.read(ctx) == pytest.approx(READINGS[name])
    monkeypatch.setattr(profiling, "snapshot", profiling.RECORDER.snapshot)
    assert reader.read(ctx) is None
    monkeypatch.delattr(profiling, "snapshot")  # a program without it
    assert reader.read(ctx) is None


# --- on the card -------------------------------------------------------
@pytest.mark.card
def test_graph_nodes_and_a_sampled_segment_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU form")
    from test_torch_segment_card import _segment

    dev = torch.device("cuda:0")
    run, c = _segment(dev, host_counter=False)
    first = profiling.snapshot()["counters"]
    _segment(dev, host_counter=False)  # the same route captured again
    again = profiling.snapshot()["counters"]
    nodes = first["segment.graph_nodes"]["Drift"]
    assert nodes == again["segment.graph_nodes"]["Drift"] > 0
    kinds = {k: v["Drift"] for k, v in first.items()
             if k.startswith("segment.graph_nodes.")}
    assert sum(kinds.values()) == nodes and kinds["segment.graph_nodes.kernel"]
    # the first call after a reset is sampled; the next one closes its gap
    profiling.reset()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    c = run(c, 5)
    float(c.loss)
    wall_ms = 1e3 * (time.perf_counter() - t0)
    run(c, 1)
    (s,) = profiling.snapshot()["samples"]
    assert s["route"] == "Drift" and s["call"] == 0 and s["n"] == 5
    assert 0 < s["device_ms"] <= wall_ms and s["gap_ms"] > 0


@pytest.mark.card
def test_a_capture_puts_the_layer_calls_and_replays_leave_them():
    """On the card the IMPALA loop's segment is one CUDA graph: its capture
    puts ``segment.layer_calls.*`` at the eager iteration's counts, the
    guard replay passes (the pool's backward is deterministic), and
    replays run no Python: neither those counters nor ``model.*`` move."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: a CUDA graph has no CPU form")
    env, buf, cfg, it, c = _impala_loop(torch.device("cuda:0"))
    run = make_segment(it, c, cfg, env, buf, "impala segment")
    assert _layer_calls("impala segment") == LAYER_CALLS
    model = {k: profiling.counter(f"model.{k}") for k in LAYER_CALLS}
    c = run(c, 5)
    torch.cuda.synchronize()
    assert _layer_calls("impala segment") == LAYER_CALLS
    assert {k: profiling.counter(f"model.{k}") for k in LAYER_CALLS} == model
    assert profiling.snapshot()["counters"]["segment.replays"][
        "impala segment"] == 5
