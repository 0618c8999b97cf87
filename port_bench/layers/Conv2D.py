"""``Conv2D(cin, cout, k, s, act)``: a VALID ``k x k`` convolution of
stride ``s`` over NHWC frames, ``w [k, k, cin, cout]`` (HWIO), ``b
[cout]``, activation ``relu`` or none. The plain forward takes its
products in f32 on f32 operands, rounds the output to the input's dtype
before the bias (a bf16 convolution keeps a bf16 output, as the JAX
layer), then adds the bias and applies the activation in f32 and rounds
again."""
import torch
import torch.nn.functional as F

PARAMS = True
DENSE = False
ACT = {"relu": torch.relu, None: lambda x: x}


def fused_collect(args):
    """Whether the port's fused collect (K4) runs this layer."""
    return False


def program(args, device):
    from deepqlearning_tpu_torch import Conv2D

    cin, cout, k, s, act = args
    return Conv2D(cin, cout, (k, k), (s, s), "VALID",
                  None if act is None else getattr(torch, act),
                  device=device)


def forward(x, params, prefix, args, prec):
    s = args[3]
    xc = prec.operand(x).permute(0, 3, 1, 2)
    wc = prec.operand(params[prefix + ".w"]).permute(3, 2, 0, 1)
    y = F.conv2d(xc, wc, None, (s, s)).to(x.dtype).permute(0, 2, 3, 1)
    return ACT[args[4]](y.float() + params[prefix + ".b"].float()).to(
        x.dtype)


def out_shape(shape, args):
    cin, cout, k, s, _act = args
    return ((shape[0] - k) // s + 1, (shape[1] - k) // s + 1, cout)


def macs(shape, args):
    cin, cout, k, _s, _act = args
    h, w, _ = out_shape(shape, args)
    return h * w * k * k * cin * cout


def n_params(args):
    cin, cout, k, _s, _act = args
    return k * k * cin * cout + cout
