"""Conv2D and the bf16 layers of the port against the JAX package's
(``deepqlearning_tpu/models/chain.py``), on the CPU: the same weights
(copied across by ``convert.py``, bf16 bit for bit) and the same inputs,
made from a numpy seed.

Tolerances: f32 outputs rtol 1e-5 / atol 1e-6 (the same f32 products,
summed in another order); bf16 outputs within 2 bf16 ulps (rtol 2^-7,
atol 1e-6: a sum order that differs in f32 can round a bf16 result to its
neighbour, and a layer after it carries that on)."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import deepqlearning_tpu as dq  # noqa: E402
import deepqlearning_tpu_torch as dt  # noqa: E402
from deepqlearning_tpu.models.chain import Activation as JActivation  # noqa: E402
from deepqlearning_tpu.models.chain import Conv2D as JConv2D  # noqa: E402
from deepqlearning_tpu_torch import convert  # noqa: E402
from deepqlearning_tpu_torch.models.chain import Conv2D, same_pads  # noqa: E402

torch.set_num_threads(2)
np_ = lambda t: jax.tree_util.tree_map(np.asarray, t)
DT = {"f32": (jnp.float32, torch.float32), "bf16": (jnp.bfloat16,
                                                   torch.bfloat16)}
TOL = {"f32": dict(rtol=1e-5, atol=1e-6), "bf16": dict(rtol=2 ** -7,
                                                        atol=1e-6)}


def _f32(x):
    """A JAX or torch array as f32 numpy (bf16 widened exactly)."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(jnp.asarray(x).astype(jnp.float32))


def test_same_pads_are_lax_s():
    assert same_pads(20, 3, 2) == (0, 1)
    assert same_pads(10, 3, 2) == (0, 1)
    assert same_pads(20, 3, 1) == (1, 1)
    assert same_pads(9, 3, 2) == (1, 1)
    assert same_pads(5, 3, 2) == (1, 1)
    assert same_pads(2, 5, 3) == (1, 2)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,stride,padding", [
    ((8, 8), 1, "SAME"), ((8, 8), 2, "SAME"), ((8, 8), 1, "VALID"),
    ((8, 8), 2, "VALID"), ((7, 9), 2, "SAME"), ((7, 9), 2, "VALID"),
    ((20, 20), 2, "SAME")])
def test_conv2d_forward_matches_jax(dtype, shape, stride, padding):
    """Conv2D's forward (NHWC, HWIO weights, relu) on a batch of 3: the
    odd 7x9 input at stride 2 and 20x20 at stride 2 take lax's asymmetric
    "SAME" pad."""
    jd, td = DT[dtype]
    rng = np.random.default_rng(1)
    x = rng.normal(size=(3,) + shape + (4,)).astype(np.float32)
    jl = JConv2D(4, 6, (3, 3), (stride, stride), padding, jax.nn.relu)
    tl = Conv2D(4, 6, (3, 3), (stride, stride), padding, torch.relu)
    jp = jl.init(jax.random.PRNGKey(0), jd)
    jp = {"w": jp["w"], "b": jnp.asarray(rng.normal(size=6) * 0.1, jd)}
    tl.init(None, td)
    with torch.no_grad():
        tl.w.copy_(convert.tensor_from_numpy(np.asarray(jp["w"])))
        tl.b.copy_(convert.tensor_from_numpy(np.asarray(jp["b"])))
    y_j = jl.apply(jp, jnp.asarray(x, jd))
    with torch.no_grad():
        y_t = tl(torch.tensor(x).to(td))
    assert y_t.dtype == td and tuple(y_t.shape) == y_j.shape
    np.testing.assert_allclose(_f32(y_t), _f32(y_j), **TOL[dtype])


def _image_nets(bf16_input: bool):
    """A narrow image net on (8, 8, 4) obs, channels 4-8-8, dueling head:
    ``examples/image_conv_dqn.py``'s structure at small widths."""
    def chain(m, conv, act, cast):
        layers = [conv(4, 8, (3, 3), (1, 1), "SAME", act),
                  conv(8, 8, (3, 3), (2, 2), "SAME", act), m.Flatten(),
                  m.Dense(4 * 4 * 8, 16, act), m.Dense(16, 3)]
        if bf16_input:
            layers.insert(0, cast)
        return m.create_dueling_network(m.Chain(*layers))

    return (chain(dq, JConv2D, jax.nn.relu,
                  JActivation(lambda x: x.astype(jnp.bfloat16))),
            chain(dt, Conv2D, torch.relu,
                  dt.Activation(lambda x: x.to(torch.bfloat16))))


@pytest.mark.parametrize("dtype,bf16_input", [("f32", False),
                                              ("bf16", False),
                                              ("bf16", True)])
def test_image_net_apply_and_sequence_match_jax(dtype, bf16_input):
    """The narrow image net's ``apply`` on [5, 8, 8, 4] and
    ``apply_sequence`` on [2, 3, 8, 8, 4] (the Conv2D case of
    ``Chain.apply_sequence``), parameters in ``dtype``, f32 observations
    (a leading cast layer makes them bf16, as in the conv example)."""
    jd, td = DT[dtype]
    jnet, tnet = _image_nets(bf16_input)
    jp = jnet.init(jax.random.PRNGKey(3), jd)
    params = convert.params_from_numpy(tnet, np_(jp))
    assert all(p.dtype == td for p in params.values())
    rng = np.random.default_rng(2)
    x = rng.normal(size=(5, 8, 8, 4)).astype(np.float32)
    xs = rng.normal(size=(2, 3, 8, 8, 4)).astype(np.float32)
    q_j, _ = jnet.apply(jp, jnp.asarray(x))
    qs_j, _ = jnet.apply_sequence(jp, jnp.asarray(xs), jnet.init_state(3))
    with torch.no_grad():
        q_t, _ = tnet.apply(params, torch.tensor(x))
        qs_t, _ = tnet.apply_sequence(params, torch.tensor(xs),
                                      tnet.init_state(3))
    assert q_t.dtype == (torch.bfloat16 if bf16_input else torch.float32)
    assert tuple(qs_t.shape) == (2, 3, 3)
    tol = TOL["bf16" if bf16_input else "f32"]
    if dtype == "bf16" and not bf16_input:
        # f32 activations against bf16 weights: f32 layers, the same
        # products of the same (exactly widened) weights
        tol = TOL["f32"]
    np.testing.assert_allclose(_f32(q_t), _f32(q_j), **tol)
    np.testing.assert_allclose(_f32(qs_t), _f32(qs_j), **tol)


def test_dense_promotes_an_f32_input_against_bf16_weights():
    """An f32 input and bf16 weights compute in f32 and return f32, as
    jnp.dot promotes; a bf16 input returns bf16."""
    jl = dq.Dense(7, 5, jnp.tanh)
    tl = dt.Dense(7, 5, torch.tanh)
    jp = jl.init(jax.random.PRNGKey(4), jnp.bfloat16)
    jp = {"w": jp["w"], "b": jnp.asarray(np.linspace(-1, 1, 5),
                                         jnp.bfloat16)}
    net_j, net_t = dq.Chain(jl), dt.Chain(tl)
    params = convert.params_from_numpy(net_t, np_((jp,)))
    x = np.random.default_rng(3).normal(size=(6, 7)).astype(np.float32)
    for jx, tx, out in ((jnp.asarray(x), torch.tensor(x), torch.float32),
                        (jnp.asarray(x, jnp.bfloat16),
                         torch.tensor(x).bfloat16(), torch.bfloat16)):
        y_j, _ = net_j.apply((jp,), jx)
        with torch.no_grad():
            y_t, _ = net_t.apply(params, tx)
        assert y_t.dtype == out
        tol = TOL["f32"] if out == torch.float32 else TOL["bf16"]
        np.testing.assert_allclose(_f32(y_t), _f32(y_j), **tol)


@pytest.mark.parametrize("cell", ["LSTM", "GRU"])
@pytest.mark.parametrize("state_dtype", ["f32", "bf16"])
def test_bf16_cells_step_and_unroll_match_jax(cell, state_dtype):
    """A bf16 LSTM/GRU (gates in f32, the new state in the state's dtype,
    as the JAX cells): one step on a bf16 input and a 4-step unroll, from
    an f32 state (as the DRQN steps start) and from a bf16 one."""
    sj, st = DT[state_dtype]
    jc, tc = getattr(dq, cell)(5, 6), getattr(dt, cell)(5, 6)
    net_j, net_t = dq.Chain(jc), dt.Chain(tc)
    jp = net_j.init(jax.random.PRNGKey(5), jnp.bfloat16)
    params = convert.params_from_numpy(net_t, np_(jp))
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    xs = rng.normal(size=(4, 3, 5)).astype(np.float32)
    h0 = (rng.normal(size=(3, 6)) * 0.5).astype(np.float32)
    j_state = tuple(jnp.asarray(h0, sj) for _ in jc.init_state(3))
    t_state = tuple(torch.tensor(h0).to(st) for _ in tc.init_state(3))
    y_j, s_j = net_j.apply(jp, jnp.asarray(x, jnp.bfloat16), (j_state,))
    ys_j, ss_j = net_j.apply_sequence(jp, jnp.asarray(xs, jnp.bfloat16),
                                      (j_state,))
    with torch.no_grad():
        y_t, s_t = net_t.apply(params, torch.tensor(x).bfloat16(),
                               (t_state,))
        ys_t, ss_t = net_t.apply_sequence(params, torch.tensor(xs).bfloat16(),
                                          (t_state,))
    assert y_t.dtype == st and all(s.dtype == st for s in s_t[0])
    tol = TOL[state_dtype]
    for a, b in ((y_t, y_j), (ys_t, ys_j), *zip(s_t[0], s_j[0]),
                 *zip(ss_t[0], ss_j[0])):
        np.testing.assert_allclose(_f32(a), _f32(b), **tol)


def test_bf16_params_round_trip_through_numpy_bit_for_bit():
    """JAX bf16 parameters -> numpy (``ml_dtypes.bfloat16``) -> the port
    -> numpy: the same 16-bit patterns, and the port's parameters bf16."""
    jnet, tnet = _image_nets(True)
    jp = np_(jnet.init(jax.random.PRNGKey(6), jnp.bfloat16))
    params = convert.params_from_numpy(tnet, jp)
    assert {p.dtype for p in params.values()} == {torch.bfloat16}
    back = convert.params_to_numpy(tnet, params)
    for a, b in zip(jax.tree_util.tree_leaves(jp),
                    jax.tree_util.tree_leaves(back)):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a.view(np.uint16), b.view(np.uint16))


def test_init_takes_the_dtype_everywhere():
    """``init(generator, dtype)`` gives every parameter the dtype, the
    dueling value head included; the draws are f32's, rounded."""
    _, tnet = _image_nets(False)
    g = lambda: torch.Generator().manual_seed(7)
    p32 = {k: v.clone() for k, v in tnet.init(g()).items()}
    p16 = tnet.init(g(), torch.bfloat16)
    assert any(k.startswith("val.") for k in p16)
    for k, v in p16.items():
        assert v.dtype == torch.bfloat16, k
        torch.testing.assert_close(v, p32[k].bfloat16(), rtol=0, atol=0)
    assert all(p.dtype == torch.float32
               for p in tnet.init(g()).values())


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape,stride", [((7, 9), 2), ((8, 8), 1)])
def test_conv2d_gradients_match_jax(dtype, shape, stride):
    """The gradients of ``sum(conv(x) * c)`` with respect to x, w and b
    (the layer's backward runs through ``_ConvNoTF32``, TF32 off on the
    card), f32 and bf16, the asymmetric pad included."""
    jd, td = DT[dtype]
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2,) + shape + (3,)).astype(np.float32)
    jl = JConv2D(3, 5, (3, 3), (stride, stride), "SAME", jnp.tanh)
    tl = Conv2D(3, 5, (3, 3), (stride, stride), "SAME", torch.tanh)
    jp = jl.init(jax.random.PRNGKey(9), jd)
    jp = {"w": jp["w"], "b": jnp.asarray(rng.normal(size=5) * 0.1, jd)}
    tl.init(None, td)
    with torch.no_grad():
        tl.w.copy_(convert.tensor_from_numpy(np.asarray(jp["w"])))
        tl.b.copy_(convert.tensor_from_numpy(np.asarray(jp["b"])))
    out_shape = jl.apply(jp, jnp.asarray(x, jd)).shape
    c = rng.normal(size=out_shape).astype(np.float32)

    def jloss(p, xx):
        return jnp.sum(jl.apply(p, xx).astype(jnp.float32) * c)

    gp, gx = jax.grad(jloss, argnums=(0, 1))(jp, jnp.asarray(x, jd))
    xt = torch.tensor(x).to(td).requires_grad_()
    loss = (tl(xt).float() * torch.tensor(c)).sum()
    gw, gb, gxt = torch.autograd.grad(loss, [tl.w, tl.b, xt])
    for ours, ref in ((gw, gp["w"]), (gb, gp["b"]), (gxt, gx)):
        assert ours.dtype == td
        np.testing.assert_allclose(_f32(ours), _f32(ref), **TOL[dtype])
