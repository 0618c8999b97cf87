"""``Tanh``: a standalone tanh, the port's ``Activation(torch.tanh)``: a
layer kind that the benchmark's own folder does not hold, added by a test
as a file of its own. K4 does not run it, so the collect is the plain
one."""
import torch

PARAMS = False
DENSE = False


def fused_collect(args):
    return False


def program(args, device):
    from deepqlearning_tpu_torch import Activation

    return Activation(torch.tanh)


def forward(x, params, prefix, args, prec):
    return torch.tanh(x)


def out_shape(shape, args):
    return tuple(shape)


def macs(shape, args):
    return 0


def n_params(args):
    return 0
