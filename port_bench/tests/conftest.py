"""The benchmark's own tests (``python -m pytest port_bench/tests``), on
the CPU at tiny sizes; those marked ``card`` need a CUDA device."""
import shutil
import sys
from pathlib import Path

import pytest

FOLDER = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(FOLDER.parent))
FIXTURES = FOLDER / "tests" / "fixtures"


@pytest.fixture
def bench_copy(tmp_path):
    """A copy of the benchmark folder with the tiny test cells added, and
    its registry (``fixtures/BENCHMARK.json`` lists the tiny cells)."""
    from port_bench.harness.registry import Registry

    dst = tmp_path / "port_bench"
    shutil.copytree(FOLDER, dst, ignore=shutil.ignore_patterns(
        "__pycache__", "tests"))
    for kind in ("configs", "workloads"):
        for f in (FIXTURES / kind).iterdir():
            shutil.copy(f, dst / kind / f.name)
    return Registry(dst, FIXTURES / "BENCHMARK.json")
