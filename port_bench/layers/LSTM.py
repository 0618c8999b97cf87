"""``LSTM(din, H)``: a recurrent cell with the gates in the order i, f, g,
o, ``wi [din, 4H]``, ``wh [H, 4H]``, ``b [4H]`` (forget-gate bias 1 at
init), state ``(h, c)``, zero at an episode's start. One step, as the port
computes it (``models/chain.py::lstm_cell``): ``a = (x·wi + h·wh) + b`` in
f32 on f32 operands, ``c' = σ(f)·c + σ(i)·tanh(g)``, ``h' =
σ(o)·tanh(c')``, both rounded to the input's dtype; ``h'`` is the output.
The published LSTM (Hochreiter & Schmidhuber 1997, with a forget gate) as
DRQN uses it (Hausknecht & Stone 2015), without peepholes."""
import torch

PARAMS = True
# not part of the trailing Dense run: the dueling split keeps it in the base
DENSE = False
RECURRENT = True
# shared memory of one K6 block on sm_90 (csrc/fused_collect.cu's opt-in
# limit less its static part), which the cell's [wi; wh] and bias must fit
K6_MAX_SMEM = 232448 - 1024


def program(args, device):
    from deepqlearning_tpu_torch.models.chain import LSTM

    din, hidden = args
    return LSTM(din, hidden, device=device)


def fused_collect(args):
    """Whether the port's recurrent collect (K6) can hold this cell: its
    parameters within K6's shared memory."""
    din, hidden = args
    return 4 * (din + hidden + 1) * 4 * hidden <= K6_MAX_SMEM


def init_state(n, args, dtype, device):
    z = torch.zeros(n, args[1], dtype=dtype, device=device)
    return (z, z.clone())


def step(x, state, params, prefix, args, prec):
    """``(h', (h', c'))`` from ``x [N, din]`` and ``state = (h, c)``."""
    h, c = state
    a = (prec.operand(x) @ prec.operand(params[prefix + ".wi"])
         + prec.operand(h) @ prec.operand(params[prefix + ".wh"])) + params[
        prefix + ".b"].float()
    i, f, g, o = a.chunk(4, dim=-1)
    c2 = torch.sigmoid(f) * c.float() + torch.sigmoid(i) * torch.tanh(g)
    h2 = (torch.sigmoid(o) * torch.tanh(c2)).to(x.dtype)
    return h2, (h2, c2.to(x.dtype))


def out_shape(shape, args):
    return (args[1],)


def macs(shape, args):
    """Multiply-adds of one step: the gate product over ``[x; h]``."""
    return (args[0] + args[1]) * 4 * args[1]


def obs_macs(shape, args):
    """The part of ``macs`` that reads the layer's input (``x·wi``), whose
    input gradient a first layer never takes; ``h·wh``'s is BPTT's."""
    return args[0] * 4 * args[1]


def n_params(args):
    return (args[0] + args[1] + 1) * 4 * args[1]
