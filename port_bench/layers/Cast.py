"""``Cast(dtype)``: the input cast to ``dtype`` (``bfloat16``), the port's
``Activation(lambda x: x.to(dtype))``."""
import torch

PARAMS = False
DENSE = False


def fused_collect(args):
    """Whether the port's fused collect (K4) runs this layer."""
    return False


def program(args, device):
    from deepqlearning_tpu_torch import Activation

    dt = getattr(torch, args[0])
    return Activation(lambda x: x.to(dt))


def forward(x, params, prefix, args, prec):
    return x.to(getattr(torch, args[0]))


def out_shape(shape, args):
    return tuple(shape)


def macs(shape, args):
    return 0


def n_params(args):
    return 0
