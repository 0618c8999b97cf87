"""``SoftMoE(d, experts, slots_per_expert, hidden)``: a Soft MoE layer
(Puigcerver et al. 2023, arXiv:2308.00951) in place of a value network's
penultimate layer, as Obando-Ceron et al. 2024 (arXiv:2402.08609) put it
after a conv trunk, one token per position of the map ("PerConv").

Per sample, the map ``[h, w, d]`` is read as ``m = h·w`` tokens ``X [m,
d]``; with ``n`` experts of ``p`` slots each and ``Φ [d, n·p]``:

    L = X·Φ                                    [m, n·p]
    D = softmax of L over the tokens (each column over its m rows)
    C = softmax of L over the slots (each row over its n·p columns)
    X̃ = Dᵀ·X                                   [n·p, d]
    Ỹ_s = ReLU(X̃_s·W_e + b_e), expert e = ⌊s/p⌋  [n·p, hidden]
    Y = C·Ỹ                                    [m, hidden]

and the layer's output is ``Y`` (``[m, hidden]``; the configuration
flattens it into the final layer). Parameters are keyed as the port's
``SoftMoE`` keys them: ``<prefix>.phi [d, n·p]``, ``<prefix>.w [n, d,
hidden]`` and ``<prefix>.b [n·hidden]``, expert ``e``'s bias at ``e·hidden``.

Departures from the papers: Φ and X are not l2-normalised and there is no
learned scale (Puigcerver et al. add both for large ``d``; ``d`` is 32
here); each expert is one Dense layer with a ReLU; the parameters start
Glorot-uniform with zero biases, as the port's other layers do (the
papers' initialisers are not followed); the configuration's ``assumed``
gives the rest.

The plain forward, in the configuration's dtype ``t``: each of the four
products is taken in f32 on f32 copies of its operands with TF32 off; L
stays f32 and both softmaxes are taken in f32, then D and C are rounded to
``t``; X̃ is rounded to ``t``; each expert adds its bias and applies the
ReLU in f32 and rounds to ``t``; Y is rounded to ``t``. The experts are
taken one at a time on their own slots.
"""
import torch

PARAMS = True
DENSE = False


def fused_collect(args):
    """Whether the port's fused collect (K4) runs this layer."""
    return False


def program(args, device):
    from deepqlearning_tpu_torch import SoftMoE

    return SoftMoE(*args, device=device)


def forward(x, params, prefix, args, prec):
    d, n, p, hidden = args
    t = x.dtype
    X = x.reshape(x.shape[0], -1, d)
    L = prec.operand(X) @ prec.operand(params[prefix + ".phi"])
    D = torch.softmax(L, dim=1).to(t)
    C = torch.softmax(L, dim=2).to(t)
    Xt = (prec.operand(D).transpose(1, 2) @ prec.operand(X)).to(t)
    w, b = params[prefix + ".w"], params[prefix + ".b"]
    Yt = []
    for e in range(n):
        y = prec.operand(Xt[:, e * p:(e + 1) * p]) @ prec.operand(w[e])
        y = y + b[e * hidden:(e + 1) * hidden].float()
        Yt.append(torch.relu(y).to(t))
    Yt = torch.cat(Yt, dim=1)
    return (prec.operand(C) @ prec.operand(Yt)).to(t)


def out_shape(shape, args):
    return (shape[0] * shape[1], args[3])


def macs(shape, args):
    """Multiply-adds per sample: the logits, the dispatch, the experts and
    the combine."""
    d, n, p, hidden = args
    m = shape[0] * shape[1]
    return m * d * n * p + n * p * m * d + n * p * d * hidden + (
        m * n * p * hidden)


def n_params(args):
    d, n, p, hidden = args
    return d * n * p + n * d * hidden + n * hidden
