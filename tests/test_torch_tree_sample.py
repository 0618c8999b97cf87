"""K2 (``ops/cuda/tree_sample.py``): its plain twin against the JAX
``sumtree.descend`` and the Pallas ``sample_pallas`` in interpret mode."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from deepqlearning_tpu.ops import sumtree as jst  # noqa: E402
from deepqlearning_tpu.ops.pallas.tree_sample import sample_pallas  # noqa: E402
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
