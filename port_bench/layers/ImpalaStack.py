"""``ImpalaStack(cin, cout)``: one stack of the IMPALA ResNet trunk
(Espeholt et al. 2018, arXiv:1802.01561, Figure 3, right) over NHWC
frames:

    y = Conv3x3(cin -> cout, stride 1, SAME)(x)
    y = MaxPool3x3(stride 2, SAME)(y)
    y = ResBlock_1(y);  y = ResBlock_2(y)
    ResBlock(y) = y + Conv3x3_b(ReLU(Conv3x3_a(ReLU(y))))

Every convolution is ``cout -> cout`` after the first, SAME and with a
bias (``w [3, 3, in, out]``, HWIO). SAME is lax's: a 3x3 convolution of
stride 1 pads one on each side; the pool's pads take no part in the max
(``-inf``) and the odd pad goes high, (0, 1) at 84 and 42, (1, 1) at 21.
Departures from the paper: none inside the stack; the trunk's LSTM and
its other inputs are the configuration's (``configs/*.json``,
``assumed``).

The plain forward, in the configuration's dtype: each convolution takes
its products in f32 on f32 operands with TF32 off and rounds its output
to the input's dtype before the bias (as ``layers/Conv2D.py``), then adds
the bias and applies the ReLU in f32 and rounds again; the max is exact
(taken on the f32 copy); the skip add is rounded to the input's dtype.
Parameters are keyed as the port's ``Chain`` keys them: the first
convolution ``<prefix>.layers.0``, the blocks' ``<prefix>.layers.<2|3>.
inner.layers.<1|2>``.
"""
import math

import torch
import torch.nn.functional as F

PARAMS = True
DENSE = False
K, POOL, STRIDE = 3, 3, 2
# (layer index in the stack's Chain, index in the block's Chain)
CONVS = [(2, 1), (2, 2), (3, 1), (3, 2)]


def fused_collect(args):
    """Whether the port's fused collect (K4) runs this layer."""
    return False


def program(args, device):
    from deepqlearning_tpu_torch import (
        Activation, Chain, Conv2D, MaxPool2D, Residual)

    cin, cout = args

    def conv(c_in, act=None):
        return Conv2D(c_in, cout, (K, K), (1, 1), "SAME", act, device=device)

    def block():
        return Residual(Chain(Activation(torch.relu), conv(cout, torch.relu),
                              conv(cout)))

    return Chain(conv(cin), MaxPool2D((POOL, POOL), (STRIDE, STRIDE),
                                      "SAME"), block(), block())


def _conv(x, params, name, prec, relu):
    xc = prec.operand(x).permute(0, 3, 1, 2)
    wc = prec.operand(params[name + ".w"]).permute(3, 2, 0, 1)
    y = F.conv2d(xc, wc, None, 1, K // 2).to(x.dtype).permute(0, 2, 3, 1)
    y = y.float() + params[name + ".b"].float()
    return (torch.relu(y) if relu else y).to(x.dtype)


def _same(n):
    """lax's SAME pads of the pool along an axis of ``n``: (low, high)."""
    total = max((math.ceil(n / STRIDE) - 1) * STRIDE + POOL - n, 0)
    return total // 2, total - total // 2


def _pool(x):
    (h0, h1), (w0, w1) = _same(x.shape[1]), _same(x.shape[2])
    xc = F.pad(x.float().permute(0, 3, 1, 2), (w0, w1, h0, h1),
               value=-math.inf)
    return F.max_pool2d(xc, POOL, STRIDE).to(x.dtype).permute(0, 2, 3, 1)


def forward(x, params, prefix, args, prec):
    y = _pool(_conv(x, params, prefix + ".layers.0", prec, False))
    for i in (2, 3):
        block = f"{prefix}.layers.{i}.inner.layers."
        h = _conv(torch.relu(y), params, block + "1", prec, True)
        h = _conv(h, params, block + "2", prec, False)
        y = (y.float() + h.float()).to(y.dtype)
    return y


def out_shape(shape, args):
    return (math.ceil(shape[0] / STRIDE), math.ceil(shape[1] / STRIDE),
            args[1])


def obs_macs(shape, args):
    """Multiply-adds of the first convolution, the one that reads the
    stack's input (the observation's, whose gradient is never taken, in
    the trunk's first stack)."""
    return shape[0] * shape[1] * K * K * args[0] * args[1]


def macs(shape, args):
    h, w, cout = out_shape(shape, args)
    return obs_macs(shape, args) + len(CONVS) * h * w * K * K * cout * cout


def n_params(args):
    cin, cout = args
    return K * K * cin * cout + cout + len(CONVS) * (K * K * cout * cout
                                                     + cout)
