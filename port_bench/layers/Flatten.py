"""``Flatten``: every axis but the batch's into one (NHWC order)."""
PARAMS = False
DENSE = False


def fused_collect(args):
    """Whether the port's fused collect (K4) runs this layer."""
    return True


def program(args, device):
    from deepqlearning_tpu_torch import Flatten

    return Flatten()


def forward(x, params, prefix, args, prec):
    return x.reshape(x.shape[0], -1)


def out_shape(shape, args):
    n = 1
    for s in shape:
        n *= s
    return (n,)


def macs(shape, args):
    return 0


def n_params(args):
    return 0
