"""The port's one count of kernel launches: every entry point of the
kernel library that launches work adds 1 per call to the recorder's
``kernels.launches`` under its own name, where ``ops/cuda/build.py::
_bind`` binds it, and the grid-size queries add nothing.

No library is built or loaded: ``_bind`` binds a stand-in object whose
functions record their calls, so the rule holds on the CPU.
"""
import pytest

from deepqlearning_tpu_torch.ops.cuda import build
from deepqlearning_tpu_torch.utils import profiling


class _Function:
    """A ctypes function's stand-in: settable signature, records calls."""

    def __init__(self):
        self.calls = []

    def __call__(self, *args):
        self.calls.append(args)
        return 0


class _Library:
    """Hands out a :class:`_Function` per name, kept as ctypes keeps them;
    ``made`` holds each as it was handed out."""

    def __init__(self):
        self.made = {}

    def __getattr__(self, name):
        if name.startswith("_"):
            raise AttributeError(name)
        fn = self.made[name] = _Function()
        setattr(self, name, fn)
        return fn


def _bound():
    """The stand-in library bound by ``_bind``, and its own functions."""
    lib = build._bind(_Library())
    return lib, lib.made


ENTRIES = [n for n in _bound()[1] if n != "dq_error_string"]
QUERIES = [n for n in ENTRIES if n.endswith("_max_grid")]
LAUNCHES = [n for n in ENTRIES if n not in QUERIES]


@pytest.fixture(autouse=True)
def _recorder():
    profiling.reset()
    yield
    profiling.reset()


def test_the_table_has_the_kernels_and_their_queries():
    assert {"dq_td_loss", "dq_tree_sample", "dq_fused_update",
            "dq_fused_grads", "dq_fused_adam", "dq_fused_collect",
            "dq_fused_collect_rnn", "dq_fused_drqn", "dq_fused_drqn_grads",
            "dq_drqn_adam", "dq_adam_update", "dq_bias_act",
            "dq_bias_act_grad", "dq_drqn_target", "dq_empty"} <= set(LAUNCHES)
    assert set(QUERIES) == {"dq_fused_update_max_grid",
                            "dq_fused_drqn_max_grid"}


@pytest.mark.parametrize("name", LAUNCHES)
def test_a_launch_counts_once_under_its_entry_point(name):
    lib, fns = _bound()
    assert fns[name].argtypes and fns[name].restype is not None
    assert getattr(lib, name)(1, 2) == 0
    assert fns[name].calls == [(1, 2)]  # passed through as it came
    assert profiling.snapshot()["counters"]["kernels.launches"] == {name: 1}
    getattr(lib, name)()
    assert profiling.counter("kernels.launches", name) == 2


@pytest.mark.parametrize("name", QUERIES)
def test_a_query_counts_nothing(name):
    lib, fns = _bound()
    assert getattr(lib, name) is fns[name]
    getattr(lib, name)(None, None)
    assert "kernels.launches" not in profiling.snapshot()["counters"]


def test_the_error_string_counts_nothing():
    lib, fns = _bound()
    assert lib.dq_error_string is fns["dq_error_string"]
    lib.dq_error_string(1)
    assert "kernels.launches" not in profiling.snapshot()["counters"]


def test_the_recorder_switched_off_counts_no_launch(monkeypatch):
    lib, _ = _bound()
    monkeypatch.setattr(profiling, "enabled", False)
    lib.dq_td_loss()
    assert profiling.counter("kernels.launches", "dq_td_loss") == 0
