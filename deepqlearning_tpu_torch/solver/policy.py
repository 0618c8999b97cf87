"""Greedy NN policy, the artifact ``solve`` returns
(``deepqlearning_tpu.solver.policy``).

``NNPolicy`` wraps the Q-network, its parameters and the action map:
``action`` is the greedy argmax over a batch of one, ``actionvalues`` the
Q-vector (numpy), ``value`` its max. A recurrent network's state is carried
from call to call on the parameters' device; ``reset_state`` zeroes it.

An input is an observation (array-like, floating point) or a raw problem
state, which goes through the env's per-instance ``observe``: anything
``torch.as_tensor`` cannot convert (a tuple or NamedTuple of tensors, as the
adapters' states are), or a tensor that is not floating point (TestMDP's
integer states). A raw state is one instance's state, as ``env.reset(
generator)`` returns it. An observation of the wrong rank raises
``ValueError`` ("NNPolicyError").
"""
from __future__ import annotations

import numpy as np
import torch


class AbstractNNPolicy:
    pass


def _raw_state(o, observe) -> bool:
    if isinstance(o, tuple) and any(torch.is_tensor(x) for x in o):
        return True
    try:
        x = torch.as_tensor(o)
    except (TypeError, ValueError, RuntimeError):
        return True
    return callable(observe) and not x.is_floating_point()


class NNPolicy(AbstractNNPolicy):
    def __init__(self, problem, network, params, action_map,
                 n_input_dims: int):
        self.problem = problem
        self.network = network
        self.params = params
        self.action_map = list(action_map)
        self.n_input_dims = int(n_input_dims)
        self.reset_state()

    @property
    def device(self) -> torch.device:
        return next(iter(self.params.values())).device

    def getnetwork(self):
        return self.network

    def reset_state(self):
        self._state = self.network.init_state(1, self.device)

    def actionmap(self):
        return self.action_map

    def _check(self, o) -> torch.Tensor:
        # raw states exist only for an Env (a HostEnv's observe() reads the
        # env itself)
        observe = (getattr(self.problem, "observe", None)
                   if hasattr(self.problem, "reset_batch") else None)
        if _raw_state(o, observe):
            if not callable(observe):
                raise TypeError(
                    f"{type(self.problem).__name__} has no observe(state): "
                    f"cannot convert a raw state of type {type(o).__name__}")
            x = torch.as_tensor(observe(o))
        else:
            x = torch.as_tensor(o)
        x = x.to(device=self.device, dtype=torch.float32)
        if x.dim() != self.n_input_dims:
            raise ValueError(
                f"NNPolicyError: was expecting an array with "
                f"{self.n_input_dims} dimensions, got {x.dim()}")
        return x[None]

    def _forward(self, o) -> torch.Tensor:
        with torch.no_grad():
            q, self._state = self.network.apply(self.params, self._check(o),
                                                self._state)
        return q[0]

    def action(self, o):
        """Greedy action (the first of tied maxima)."""
        return self.action_map[int(torch.argmax(self._forward(o)))]

    def actionvalues(self, o) -> np.ndarray:
        """Q(s, ·) as a numpy vector."""
        return self._forward(o).cpu().numpy()

    def value(self, o) -> float:
        """max_a Q(s, a)."""
        return float(torch.max(self._forward(o)))


def getnetwork(policy):
    return policy.getnetwork()


def resetstate(policy):
    policy.reset_state()


resetstate_ = resetstate
