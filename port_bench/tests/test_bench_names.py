"""BENCHMARK.json keeps to the format the benchmark is held to: names,
units and texts in their alphabets, every part found by name, and a
configuration, a cell or a metric added by adding a file."""
import json
import re

import pytest

from conftest import FOLDER

BENCH = json.loads((FOLDER.parent / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _text(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_alphabets():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [
        w["name"] for w in BENCH["workloads"]] + [
        m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _text(c["source"]) and _text(c["why"])
        assert all(NAME.match(k) for k in c["reduced"])
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["traffic"]) and _text(w["why"]) and w[
            "chips"] in (1, 4)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in SOURCES
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert _text(m["layer"]) and m["moves"] in e2e


def test_every_part_is_found_by_name():
    from port_bench.harness import work
    from port_bench.harness.registry import Registry

    reg = Registry()
    for c in BENCH["configs"]:
        assert reg.config(c["name"])["name"] == c["name"]
        assert (FOLDER.parent / c["file"]).is_file()
    for w in BENCH["workloads"]:
        cell = reg.cell(w["name"])
        assert cell["config"] == w["config"]
        conf = reg.config(cell["config"])
        work.traffic(conf, cell)
        judged = ({"rows_bad", "hidden_gap"} if "recurrence" in conf
                  else {"prio_gap", "td1_gap", "rows_bad"})
        assert set(cell["limits"]) == {"loss_gap", "grad_gap",
                                       "change_gap"} | judged
    for m in BENCH["per_layer"]:
        assert callable(reg.metric(m["name"]).read)
    for cell in (w["name"] for w in BENCH["workloads"]):
        assert reg.metrics_of(cell, "per_layer")
    for c in BENCH["configs"]:
        conf = reg.config(c["name"])
        env = reg.env(conf["env"]["kind"])
        assert callable(env.program) and env.Reference
        for layer in conf["net"]["layers"]:
            part = reg.layer(layer[0])
            assert callable(part.step if getattr(part, "RECURRENT", False)
                            else part.forward)


def test_added_files_are_picked_up(bench_copy, tmp_path):
    """A new configuration, cell, metric, env kind and layer kind, each a
    file of its own, are found and run with no existing file edited: a
    cell of the grid at other sizes, the grid net at another width, and
    MountainCar (``fixtures/added/envs``) under a net with a standalone
    tanh (``fixtures/added/layers``), which takes the plain collect."""
    import shutil
    import time

    from conftest import FIXTURES
    from port_bench.harness.bench import run_cell
    from port_bench.harness.registry import Registry

    folder = bench_copy.folder
    before = {p: p.read_bytes() for p in folder.rglob("*") if p.is_file()}
    (folder / "metrics" / "added.count.py").write_text(
        "def read(ctx):\n    return float(ctx.window['iterations'])\n")
    for kind in ("envs", "layers"):
        for f in (FIXTURES / "added" / kind).iterdir():
            shutil.copy(f, folder / kind / f.name)
    bench = json.loads(json.dumps(bench_copy.bench))
    cell = json.loads((folder / "workloads" / "tiny_grid.u1.json")
                      .read_text())
    conf = json.loads((folder / "configs" / "tiny_grid.json").read_text())
    conf16 = json.loads(json.dumps(conf))
    conf16["net"]["layers"][1][2] = conf16["net"]["layers"][2][1] = 16
    car = dict(conf, name="tiny_car",
               env={"kind": "MountainCar", "discount": 0.99,
                    "obs_shape": [2]},
               net={"layers": [["Flatten"], ["Tanh"], ["Dense", 2, 32,
                                                        "tanh"],
                               ["Dense", 32, 3, None]], "dueling": True},
               max_episode_length=200,
               exploration={"start": 1.0, "stop": 0.01, "steps": 200})
    added = {"tiny_grid.added": ("tiny_grid", dict(cell, num_envs=128,
                                                   train_freq=64)),
             "tiny_grid16.u1": ("tiny_grid16", dict(cell,
                                                    config="tiny_grid16")),
             "tiny_car.u1": ("tiny_car", dict(cell, config="tiny_car"))}
    for name, c in (("tiny_grid16", conf16), ("tiny_car", car)):
        (folder / "configs" / f"{name}.json").write_text(json.dumps(c))
    for name, (config, c) in added.items():
        (folder / "workloads" / f"{name}.json").write_text(json.dumps(c))
        bench["workloads"].append({"name": name, "config": config,
                                   "traffic": name.split(".")[1],
                                   "chips": 1, "why": "a test"})
    bench["per_layer"].append({"name": "added.count", "unit": "count",
                               "better": "higher", "source": "host_clock",
                               "layer": "learner/segment", "moves":
                               "env_steps_per_s", "workloads":
                               ["tiny_grid.added"]})
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(bench))
    reg = Registry(folder, path)
    assert reg.cell("tiny_grid.added")["num_envs"] == 128
    assert reg.config("tiny_grid16")["net"]["layers"][1][2] == 16
    assert reg.env("MountainCar").RESET_UNIFORMS == 1
    assert [m["name"] for m in reg.metrics_of("tiny_grid.added",
                                              "per_layer")][-1] == \
        "added.count"
    for name in added:
        out = run_cell(name, 5, 0.2, False, "cpu", time.perf_counter(), reg,
                       log=lambda s: None)
        assert out["correct"], (name, out["checks"])
        assert out["metrics"]["env_steps_per_s"]["value"] > 0
    assert out["reference"]["greedy_checked"] > 100  # tiny_car's, ε 0.01
    ctx = type("C", (), {"window": {"iterations": 6}})
    assert reg.metric("added.count").read(ctx) == 6.0
    for p, data in before.items():
        assert p.read_bytes() == data, p


@pytest.mark.parametrize("name", ["segment.host_ms_per_replay",
                                  "device.idle_share", "k2_roofline",
                                  "k5_roofline", "k6_roofline"])
def test_readers_without_a_trace_return_nothing(name):
    from types import SimpleNamespace

    from port_bench.harness import work
    from port_bench.harness.registry import Registry

    reg = Registry()
    ctx = SimpleNamespace(window={"host_ms": []}, trace=None, work=work,
                          registry=reg)
    assert reg.metric(name).read(ctx) is None
