"""``Dense(din, dout, act)``: an affine layer, ``w [din, dout]``, ``b
[dout]``, activation ``tanh``, ``relu`` or none. The plain forward takes
its product in f32 on f32 operands (a bf16 product is exact there), adds
the bias and applies the activation in f32, and rounds to the input's
dtype."""
import torch

PARAMS = True
# part of the trailing run of Dense layers that the dueling split takes
# into the value and advantage heads
DENSE = True
# K4's widest layer (FC_MAXW of the port's csrc/fused_collect.cu)
K4_MAX_WIDTH = 128
ACT = {"tanh": torch.tanh, "relu": torch.relu, None: lambda x: x}


def program(args, device):
    from deepqlearning_tpu_torch import Dense

    din, dout, act = args
    return Dense(din, dout, None if act is None else getattr(torch, act),
                 device=device)


def fused_collect(args):
    """Whether the port's fused collect (K4) runs this layer: an f32 Dense
    layer within its widths."""
    return max(args[0], args[1]) <= K4_MAX_WIDTH


def value_head(args):
    """The value head's last layer in place of this one: ``Dense(din, 1)``,
    no activation."""
    return [args[0], 1, None]


def forward(x, params, prefix, args, prec):
    y = prec.operand(x) @ prec.operand(params[prefix + ".w"]) + params[
        prefix + ".b"].float()
    return ACT[args[2]](y).to(x.dtype)


def out_shape(shape, args):
    return (args[1],)


def macs(shape, args):
    return args[0] * args[1]


def n_params(args):
    return args[0] * args[1] + args[1]
