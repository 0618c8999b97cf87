"""Actions outside [0, A) select nothing on every route of the port.

The port's rule (``ops/helpers.py::action_mask``): an action outside
``[0, A)`` gives Q(s, a) = 0 and no gradient. The kernels K1, K3/K7 and
K5/K8 test that range; their twins and the plain train steps select with
the same mask. The JAX package's routes disagree with each other there, so
these tests hold the port's routes to one another, not to JAX. The
actions tried are -1, A and A_p - 1, where A_p = 8 is A rounded up to the
JAX fused kernels' padded head width.

Tolerances: loss and td rtol 1e-5, gradients rtol 1e-5 / atol 1e-7 (the
same f32 math, summed in another order by autograd and by the twins'
hand-written backward); the selected Q of an out-of-range action is 0
exactly.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.learner.train_step import (  # noqa: E402
    _make_batch_update, _make_drqn_update)
from deepqlearning_tpu_torch.ops.cuda import (  # noqa: E402
    fused_drqn, fused_update, td_kernel)
from deepqlearning_tpu_torch.ops.helpers import flatten  # noqa: E402

from test_torch_drqn_train_step import nets  # noqa: E402

torch.set_num_threads(2)
A, A_P = 4, 8
OUT_OF_RANGE = [-1, A, A_P - 1]
GAMMA = 0.9


class _Recorder:
    """An optimizer that keeps the gradients it is handed."""

    def update(self, grads, state, params):
        self.grads = {k: g.detach().clone() for k, g in grads.items()}
        return state, None  # Adam.update's (state, gradient max-abs)


def _close(a, b, rtol=1e-5, atol=1e-7):
    np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=rtol,
                               atol=atol)


def _ff_net(dueling):
    chain = dt.Chain(dt.Flatten(), dt.Dense(5, 16, torch.tanh),
                     dt.Dense(16, 16, torch.relu), dt.Dense(16, A))
    return dt.create_dueling_network(chain) if dueling else chain


@pytest.mark.parametrize("double_q", [True, False])
@pytest.mark.parametrize("dueling", [True, False])
@pytest.mark.parametrize("bad", OUT_OF_RANGE)
def test_feed_forward_routes_agree_outside_the_action_range(bad, dueling,
                                                            double_q):
    """The plain step (autograd), the step through K1's twin and K3/K7's
    twin (``fused_grads_plain``) give the same loss, td and gradient when
    some actions lie outside [0, A)."""
    net = _ff_net(dueling)
    params = net.init(torch.Generator().manual_seed(1))
    target = net.init(torch.Generator().manual_seed(2))
    rng = np.random.default_rng(3)
    B = 16
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    action = torch.from_numpy(rng.integers(0, A, B))
    action[::3] = bad
    batch = dt.TransitionBatch(f(B, 5), action, f(B), f(B, 5),
                               torch.from_numpy((rng.random(B) < 0.2)
                                                .astype(np.float32)))
    weights = torch.from_numpy(rng.random(B).astype(np.float32) + 0.5)
    buf = dt.PrioritizedReplayBuffer((5,), 64, B, device="cpu")
    with torch.no_grad():
        q_sp_tgt = net.apply(target, batch.next_obs)[0]
        q_sp_onl = net.apply(params, batch.next_obs)[0]
        q_s = net.apply(params, batch.obs)[0]
    out = {}
    for kernel in (False, True):
        rec = _Recorder()
        update = _make_batch_update(net, buf, GAMMA, double_q, rec, kernel)
        p = {k: v.clone() for k, v in params.items()}
        _, _, td, _, loss, _ = update(p, target, None, batch, weights,
                                      q_sp_tgt)
        out[kernel] = (loss, td, rec.grads)
    plan = fused_update.plan_for(net)
    flat, td3, _, loss3, _ = fused_update.fused_grads_plain(
        plan, params, batch.obs, batch.next_obs, batch.action, batch.reward,
        batch.done, weights, q_sp_tgt, gamma=GAMMA, double_q=double_q,
        alpha=buf.alpha, eps=buf.eps)
    (loss0, td0, g0), (loss1, td1, g1) = out[False], out[True]
    for loss, td in ((loss1, td1), (loss3, td3)):
        _close(loss, loss0, atol=0)
        _close(td, td0, atol=1e-6)
    for k in g0:
        _close(g1[k], g0[k])
    _close(flat, flatten(g0, plan.names))
    # an out-of-range action's Q(s, a) is 0: td is minus the target
    _, _, _, grad = td_kernel.td_loss_plain(
        q_s, q_sp_onl, q_sp_tgt, batch.action, batch.reward, batch.done,
        weights, GAMMA, buf.alpha, buf.eps, double_q)
    out_rows = batch.action == bad
    if double_q:
        q_max = q_sp_tgt.gather(1, q_sp_onl.argmax(1, keepdim=True))[:, 0]
    else:
        q_max = q_sp_tgt.max(1).values
    tgt = batch.reward + (1 - batch.done) * GAMMA * q_max
    assert torch.equal(td0[out_rows], -tgt[out_rows])
    assert float(grad[out_rows].abs().max()) == 0.0
    assert float(grad[~out_rows].abs().max()) > 0.0


@pytest.mark.parametrize("kind", ["plain", "deep", "dueling", "gru",
                                  "gru_dueling"])
@pytest.mark.parametrize("bad", OUT_OF_RANGE)
def test_drqn_routes_agree_outside_the_action_range(bad, kind):
    """The plain DRQN step (autograd through ``apply_sequence``) and K5/K8's
    twins (``fused_drqn_grads_plain`` and the tile-order
    ``fused_drqn_grads_tiled``) give the same loss and gradient when some
    window steps take actions outside [0, A)."""
    _, net = nets(kind)
    params = net.init(torch.Generator().manual_seed(4))
    target = net.init(torch.Generator().manual_seed(5))
    rng = np.random.default_rng(6)
    B, T, OBS = 10, 5, 3
    f = lambda *s: torch.from_numpy(rng.normal(size=s).astype(np.float32))
    action = torch.from_numpy(rng.integers(0, A, (B, T)))
    action.view(-1)[::3] = bad
    lens = torch.from_numpy(rng.integers(1, T + 1, B))
    batch = dt.EpisodeBatch(
        f(B, T, OBS), action, f(B, T), f(B, T, OBS),
        torch.from_numpy((rng.random((B, T)) < 0.2).astype(np.float32)),
        (torch.arange(T)[None] < lens[:, None]).float())
    rec = _Recorder()
    update = _make_drqn_update(net, GAMMA, True, rec)
    p = {k: v.clone() for k, v in params.items()}
    loss, _ = update(p, target, None, batch)
    with torch.no_grad():
        nobs_t = batch.next_obs.transpose(0, 1)
        q_sp_tgt = net.apply_sequence(target, nobs_t, net.init_state(
            B, nobs_t.device))[0].transpose(0, 1)
    plan = fused_drqn.drqn_plan_for(net, T, B, True)
    assert plan is not None
    for fn in (fused_drqn.fused_drqn_grads_plain,
               fused_drqn.fused_drqn_grads_tiled):
        flat, tloss, _ = fn(plan, params, batch.obs, batch.next_obs,
                            batch.action, batch.reward, batch.done,
                            batch.mask, q_sp_tgt, gamma=GAMMA, double_q=True)
        _close(tloss, loss, atol=0)
        _close(flat, flatten(rec.grads, plan.names))
