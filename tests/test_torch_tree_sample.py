"""K2 (``ops/cuda/tree_sample.py``): its plain twin against the JAX
``sumtree.descend`` and the Pallas ``sample_pallas`` in interpret mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepqlearning_tpu.ops import sumtree as jst  # noqa: E402
from deepqlearning_tpu.ops.pallas.tree_sample import sample_pallas  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu_torch.ops import sumtree as tst  # noqa: E402
from deepqlearning_tpu_torch.ops.cuda import tree_sample  # noqa: E402

torch.set_num_threads(2)


def _trees(cap, seed):
    prios = np.asarray(jax.random.uniform(jax.random.PRNGKey(seed), (cap,))
                       + 0.01, np.float32)
    jt = jst.set_priorities(jst.init_tree(cap), jnp.arange(cap),
                            jnp.asarray(prios))
    tt = tst.set_priorities(tst.init_tree(cap), torch.arange(cap),
                            torch.tensor(prios))
    return prios, jt, tt


def _check_draws(idx, ref_idx, prio, prios):
    """>= 99% exact and the rest adjacent (prefix sums in other orders may
    flip a mass within an ulp of a boundary; tests/test_pallas_kernels.py
    rule); the priority is the returned leaf's value, exactly."""
    idx, ref_idx = np.asarray(idx), np.asarray(ref_idx)
    exact = idx == ref_idx
    assert exact.mean() >= 0.99, exact.mean()
    assert np.abs(idx - ref_idx).max() <= 1
    np.testing.assert_array_equal(np.asarray(prio), prios[idx])


@pytest.mark.parametrize("cap,draws", [(64, 32), (4096, 600),
                                       (262144, 512)])
def test_twin_matches_descend_and_pallas(cap, draws):
    prios, jt, tt = _trees(cap, cap)
    key = jax.random.PRNGKey(7)
    # sample_pallas's own uniforms, stratified, as sumtree.sample draws them
    # and the JAX tree's total: the packages' level sums differ by ulps, and
    # at 2^18 leaves an ulp of the total is a few % of one leaf's mass
    u = jax.random.uniform(key, (draws,))
    u = (jnp.arange(draws, dtype=jnp.float32) + u) / draws
    mass = torch.tensor(np.array(u * jst.total(jt)))
    idx, prio = tree_sample.tree_sample(tt, mass)
    assert idx.dtype == torch.int64 and prio.dtype == torch.float32
    jidx, _ = jst.descend(jt, jnp.asarray(mass.numpy()))
    _check_draws(idx.numpy(), jidx, prio.numpy(), prios)
    pidx, pprio = sample_pallas(jt, key, draws, interpret=True)
    _check_draws(idx.numpy(), pidx, prio.numpy(), prios)
    # the kernel's scan order (tree_sample_scan) by the same rule
    sidx, sprio = tree_sample.tree_sample_scan(tt, mass)
    assert sidx.dtype == torch.int64
    for ref in (jidx, pidx):
        _check_draws(sidx.numpy(), ref, sprio.numpy(), prios)


def test_twin_follows_mass_monotonically_and_proportionally():
    cap = 1024
    prios = np.ones(cap, np.float32)
    prios[3] = float(cap)
    tt = tst.set_priorities(tst.init_tree(cap), torch.arange(cap),
                            torch.tensor(prios))
    mass = tst.stratified_mass(tt, torch.rand(2048,
                               generator=torch.Generator().manual_seed(0)))
    idx, _ = tree_sample.tree_sample(tt, mass)
    assert (np.diff(idx.numpy()) >= 0).all()
    assert abs((idx.numpy() == 3).mean() - 0.5) < 0.01


def test_masses_at_the_edges_clamp():
    cap = 256
    prios, jt, tt = _trees(cap, 1)
    tot = float(tst.total(tt))
    mass = torch.tensor([0.0, tot, tot * 2], dtype=torch.float32)
    idx, _ = tree_sample.tree_sample(tt, mass)
    jidx, _ = jst.descend(jt, jnp.asarray(mass.numpy()))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    assert idx.numpy()[0] == 0 and idx.numpy()[2] == cap - 1


# ------------------------------- the kernel's scan order (the redesigned K2)

@pytest.mark.parametrize("cap,draws", [(2, 16), (8, 40), (16, 64),
                                       (128, 100)])
def test_scan_order_reference_on_narrow_roots(cap, draws):
    """``tree_sample_scan`` (the kernel's sum order: 4 children in a lane,
    then a Hillis-Steele scan over 16 lanes) against the JAX
    ``sumtree.descend`` on the same masses, by the rule of
    ``_check_draws``, where the root's branching factor is 2, 8, 16 and a
    2-wide root over 64-wide nodes (lanes past bf read 0; bf = 2 takes the
    kernel's scalar reads)."""
    prios, jt, tt = _trees(cap, cap + 1)
    u = np.random.default_rng(cap).random(draws, dtype=np.float32)
    u = (np.arange(draws, dtype=np.float32) + u) / draws
    mass = torch.tensor(u * np.float32(jst.total(jt)))
    idx, prio = tree_sample.tree_sample_scan(tt, mass)
    jidx, _ = jst.descend(jt, jnp.asarray(mass.numpy()))
    _check_draws(idx.numpy(), jidx, prio.numpy(), prios)


@pytest.mark.parametrize("n_batches", [1, 4])
def test_sample_n_takes_u_major_int64_draws(n_batches):
    """``sample_n`` now takes K2's int64 draws in u-major order as they
    come; they equal the earlier int32 draws reordered after the call
    (``x.reshape(B, n).t().reshape(-1)``, then ``.long()``), and the scan
    reference orders its draws the same way."""
    rng = np.random.default_rng(9)
    B, cap = 8, 64
    buf = dt.PrioritizedReplayBuffer((2,), cap, B, device="cpu")
    st = buf.insert(buf.init(), dt.TransitionBatch(
        torch.tensor(rng.normal(size=(cap, 2)), dtype=torch.float32),
        torch.tensor(rng.integers(0, 4, cap)),
        torch.tensor(rng.normal(size=cap), dtype=torch.float32),
        torch.tensor(rng.normal(size=(cap, 2)), dtype=torch.float32),
        torch.zeros(cap)))
    u = torch.tensor(rng.random(B * n_batches), dtype=torch.float32)
    batch, idx, w = buf.sample_n(st, n_batches, u=u)
    mass = tst.stratified_mass(st.tree, u)
    old, _ = tree_sample.tree_sample_plain(st.tree, mass)
    old = old.to(torch.int32)
    if n_batches > 1:
        old = old.reshape(B, n_batches).t().reshape(-1)
    assert idx.dtype == torch.int64 and torch.equal(idx, old.long())
    assert torch.equal(batch.obs, st.rows[old.long(), :2])
    scan, prio = tree_sample.tree_sample_scan(st.tree, mass, n_batches)
    assert torch.equal(scan, idx) and torch.equal(prio, st.tree[0][idx])
