"""K5 (``ops/cuda/fused_drqn.py``) with max targets (double-Q off): its
plain twin against the JAX Pallas kernel in interpret mode through both
packages' fused DRQN train steps; the double-Q cases and the tolerances are
in test_torch_fused_drqn.py (a file of its own so each stays short)."""
import pytest

pytest.importorskip("torch")

from test_torch_fused_drqn import KINDS, check_fused_step  # noqa: E402


@pytest.mark.parametrize("kind", KINDS)
def test_fused_step_with_max_targets_matches_jax(kind):
    check_fused_step(kind, False)
