"""``ReLU``: ``max(x, 0)`` elementwise, exact in any dtype, the port's
``Activation(torch.relu)``."""
import torch

PARAMS = False
DENSE = False


def fused_collect(args):
    """Whether the port's fused collect (K4) runs this layer."""
    return False


def program(args, device):
    from deepqlearning_tpu_torch import Activation

    return Activation(torch.relu)


def forward(x, params, prefix, args, prec):
    return torch.relu(x)


def out_shape(shape, args):
    return tuple(shape)


def macs(shape, args):
    return 0


def n_params(args):
    return 0
