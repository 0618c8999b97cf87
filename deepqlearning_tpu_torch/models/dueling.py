"""Dueling Q-network: Q(s,a) = V(s) + A(s,a) - mean_a A(s,a).

Counterpart of ``deepqlearning_tpu.models.dueling``: the trailing run of
Dense layers becomes the advantage head, a copy of it with the last layer
replaced by ``Dense(n, 1)`` the value head, and everything before the
shared base. A recurrent base (e.g. an LSTM) carries the network's state.
"""
from __future__ import annotations

import copy

from .chain import Chain, Dense, _Functional


class DuelingNetwork(_Functional):
    def __init__(self, base: Chain, val: Chain, adv: Chain):
        super().__init__()
        self.base, self.val, self.adv = base, val, adv

    def forward(self, x, state=None, sequence: bool = False):
        new_state = ()
        if state is None:
            x = self.base(x)
        else:
            x, new_state = self.base(x, state, sequence)
        v = self.val(x)
        a = self.adv(x)
        q = v + a - a.mean(dim=-1, keepdim=True)
        return q if state is None else (q, new_state)

    def init_state(self, batch_size: int, device=None) -> tuple:
        return self.base.init_state(batch_size, device)

    @property
    def recurrent(self) -> bool:
        return self.base.recurrent

    @property
    def out_dim(self):
        return self.adv.out_dim


def create_dueling_network(network: Chain) -> DuelingNetwork:
    """Split a Chain into a DuelingNetwork; raises if it has no trailing
    Dense run. The value head's hidden layers are copies, so the two heads
    never share parameters."""
    if isinstance(network, DuelingNetwork):
        return network
    if not isinstance(network, Chain):
        raise TypeError("create_dueling_network expects a Chain")
    layers = list(network.layers)
    split = len(layers)
    while split > 0 and isinstance(layers[split - 1], Dense):
        split -= 1
    trailing = layers[split:]
    if not trailing:
        raise ValueError(
            "DeepQLearningError: the qnetwork provided is incompatible with dueling"
        )
    last = trailing[-1]
    val = [copy.deepcopy(l) for l in trailing[:-1]]
    val.append(Dense(last.in_dim, 1, device=last.w.device,
                     dtype=last.w.dtype))
    return DuelingNetwork(base=Chain(layers[:split]), val=Chain(val),
                          adv=Chain(trailing))
