"""Small numeric helpers (``deepqlearning_tpu.ops.helpers``), batch-first."""
from __future__ import annotations

import torch


def flattenbatch(x: torch.Tensor) -> torch.Tensor:
    """Flatten all but the leading (batch) axis."""
    return x.reshape(x.shape[0], -1)


def huber_loss(x: torch.Tensor) -> torch.Tensor:
    """Elementwise Huber loss with delta=1: ``0.5*q^2 + (|x|-q)``,
    ``q = min(|x|, 1)``."""
    abserror = x.abs()
    quadratic = torch.clamp(abserror, max=1.0)
    linear = abserror - quadratic
    return 0.5 * quadratic * quadratic + linear


def action_mask(q: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``[..., A]`` booleans, true at each row's taken action. An action
    outside ``[0, A)`` is true nowhere: it selects nothing, so Q(s, a) is 0
    and no gradient flows, on every route of the port (its kernels test
    the same range). The JAX package's routes disagree there (its plain
    ``take_along_axis`` wraps -1 and gives NaN at A; its fused DRQN kernel
    reads a padded head row), so the port holds to this rule instead."""
    return torch.arange(q.shape[-1], device=q.device) == action[..., None]


def select_action(q: torch.Tensor, action: torch.Tensor) -> torch.Tensor:
    """``Q(s, a)`` of each row of ``q [..., A]`` at ``action [...]``, 0
    where the action lies outside ``[0, A)`` (:func:`action_mask`); exact
    for actions in range."""
    return torch.where(action_mask(q, action), q, 0.0).sum(dim=-1)


def globalnorm(grads) -> torch.Tensor:
    """Max absolute entry over all gradient tensors (the reference's
    ``globalnorm`` is a max-abs, not a norm), as an f32 scalar (exact for
    bf16 gradients)."""
    grads = list(grads.values()) if isinstance(grads, dict) else list(grads)
    if not grads:
        return torch.zeros((), dtype=torch.float32)
    return torch.stack([g.abs().max().float() for g in grads]).max()


def flatten(tensors, names) -> torch.Tensor:
    """The tensors ``tensors[n]`` for ``n`` in ``names`` as one flat f32
    vector, in that order."""
    return torch.cat([tensors[n].reshape(-1).float() for n in names])


def unflatten(flat: torch.Tensor, like, names):
    """Pieces of ``flat`` shaped like ``like[n]`` and in its dtype, keyed by
    ``names`` in order (the inverse of :func:`flatten`): views where the
    dtype is ``flat``'s, cast copies otherwise (a bf16 gradient comes back
    bf16, as the JAX ``pmean_flat`` gives each leaf back)."""
    out, off = {}, 0
    for n in names:
        k = like[n].numel()
        out[n] = flat[off:off + k].view(like[n].shape).to(like[n].dtype)
        off += k
    return out


def obs_dimensions(env) -> tuple:
    """Observation shape of an env."""
    return tuple(env.obs_shape)


def default_discount(env) -> float:
    """Discount of an env: its ``discount``, else 1.0 (a raw env)."""
    return float(getattr(env, "discount", 1.0))


def hiddenstates(net_state) -> list:
    """The recurrent entries of a network state (``Chain.init_state``'s
    tuple, where a layer without state holds ``()``)."""
    return [s for s in net_state if s != ()]


def sethiddenstates(net_state, hs) -> tuple:
    """Inverse of :func:`hiddenstates`: the per-layer state tuple of
    ``net_state``'s layout with its recurrent entries taken from ``hs``."""
    it = iter(hs)
    return tuple(next(it) if s != () else () for s in net_state)


def batch_trajectories(x: torch.Tensor, traj_length: int,
                       batch_size: int) -> torch.Tensor:
    """``[batch, traj, features...]`` -> time-major ``[traj, batch, F]``,
    the features flattened."""
    if x.shape[0] != batch_size or x.shape[1] != traj_length:
        raise ValueError(
            f"batch_trajectories: expected [{batch_size}, {traj_length}, "
            f"...], got {list(x.shape)}")
    return x.reshape(batch_size, traj_length, -1).transpose(0, 1)
