"""The plain layer kinds against the port's layers on seeded weights."""
import torch

from conftest import FOLDER


def test_lstm_step_is_the_ports():
    """``layers/LSTM.py``'s plain step equals the port's ``LSTM`` cell, the
    new ``(h, c)`` and the output, bit for bit on the CPU, from a nonzero
    state."""
    from deepqlearning_tpu_torch.models.chain import LSTM
    from port_bench.harness.registry import load_module
    from port_bench.reference.nets import Precision

    part = load_module(FOLDER / "layers" / "LSTM.py")
    g = torch.Generator().manual_seed(7)
    cell = LSTM(3, 16)
    params = {f"base.layers.0.{k}": v
              for k, v in cell.init(g).items()}
    x = torch.randn(5, 3, generator=g)
    state = (torch.randn(5, 16, generator=g), torch.randn(5, 16, generator=g))
    with torch.no_grad():
        y, (h, c) = cell(x, state)
        y2, (h2, c2) = part.step(x, state, params, "base.layers.0", [3, 16],
                                 Precision())
    assert torch.equal(y2, y) and torch.equal(h2, h) and torch.equal(c2, c)
    assert part.n_params([3, 16]) == sum(v.numel() for v in params.values())
    assert part.out_shape((3,), [3, 16]) == (16,)
