"""Finds the benchmark's parts by name, so that a configuration, a cell, a
per-layer metric or a kernel's work count is added by adding a file:

* ``configs/<config>.json``: a model configuration (its network, env,
  precision and algorithm constants; ``recurrence`` makes it a DRQN over
  an episode replay);
* ``workloads/<cell>.json``: a cell: its configuration's name, its traffic
  (env count, train frequency, batch, replay, target period, replay start,
  iterations per segment) and the limits of its correctness numbers;
* ``metrics/<metric>.py``: a per-layer metric's reader, ``read(ctx)``
  returning a number or None when it finds nothing to read;
* ``kernels/<symbol>.py``: a kernel's work per launch, ``work(ctx)``
  returning ``(flops, bytes)``;
* ``envs/<kind>.py``: an env kind on both sides: ``program(spec)``, the
  port's env, its state width and uniforms per step and reset, and
  ``Reference``, the plain batched env of the check;
* ``layers/<kind>.py``: a network layer kind on both sides:
  ``program(args, device)``, the port's layer, and the plain forward (a
  recurrent kind, ``RECURRENT``: its plain step and zero state), the
  output shape, the multiply-adds and the parameters that the reference and
  the work counts take from it.

``BENCHMARK.json`` at the repository root lists which cells exist and
which metrics each reports.
"""
from __future__ import annotations

import importlib.util
import json
from pathlib import Path

FOLDER = Path(__file__).resolve().parents[1]
ROOT = FOLDER.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path):
    name = f"port_bench_{path.parent.name}_{path.stem}"
    spec = importlib.util.spec_from_file_location(
        name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Registry:
    """The parts under ``folder`` and the benchmark file ``bench``."""

    def __init__(self, folder: Path = FOLDER, bench: Path = None):
        self.folder = Path(folder)
        self.bench = load_json(Path(bench) if bench else
                               self.folder.parent / "BENCHMARK.json")
        self._modules = {}

    def _file(self, kind: str, name: str, ext: str) -> Path:
        path = self.folder / kind / f"{name}{ext}"
        if not path.is_file():
            raise FileNotFoundError(f"no {kind[:-1]} named {name!r}: "
                                    f"{path} is missing")
        return path

    def cell(self, name: str) -> dict:
        if not any(w["name"] == name for w in self.bench["workloads"]):
            raise KeyError(f"BENCHMARK.json has no workload {name!r}")
        return load_json(self._file("workloads", name, ".json"))

    def config(self, name: str) -> dict:
        return load_json(self._file("configs", name, ".json"))

    def _module(self, kind: str, name: str):
        path = self._file(kind, name, ".py")
        if path not in self._modules:
            self._modules[path] = load_module(path)
        return self._modules[path]

    def metric(self, name: str):
        return self._module("metrics", name)

    def kernel(self, symbol: str):
        path = self.folder / "kernels" / f"{symbol}.py"
        return self._module("kernels", symbol) if path.is_file() else None

    def env(self, kind: str):
        return self._module("envs", kind)

    def layer(self, kind: str):
        return self._module("layers", kind)

    def metrics_of(self, cell: str, section: str):
        """The metrics of ``section`` (``end_to_end`` or ``per_layer``)
        that ``cell`` reports."""
        return [m for m in self.bench[section]
                if cell in m.get("workloads", [cell])]
