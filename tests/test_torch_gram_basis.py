"""Port parity for the Gram basis (convkan_tpu_torch/basis/poly.py
``gram_basis_cols``), its kernel descriptor (kernels/kan_conv2d.py
``gram_basis``), the ku_5d and beta_weights inits and the GRAMKAN factory
key, against the JAX package.

The basis is held in float64 to 1e-12 of its largest value at degrees
0-4 with a random beta (the recurrence is the same sequence of operations
in both packages) and in float32 to 1e-5 (XLA's and torch's float32 tanh
differ by a few ulp).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis.poly import gram_basis as jax_gram_basis
from convkan_tpu.basis.poly import gram_basis_cols as jax_gram_cols
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.basis.poly import gram_basis, gram_basis_cols
from convkan_tpu_torch.factory.conv_factory import CONV_KAN_FACTORY
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.utils import initializers as init_lib

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _t_beta(dtype, degree, seed):
    """t = tanh of U(-4, 4) with exact 0 and +-1, and beta N(0, 0.5)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-4.0, 4.0, 3000)
    x[:3] = [0.0, 1.0, -1.0]
    return np.tanh(x).astype(dtype), \
        rng.normal(0.0, 0.5, degree + 1).astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("degree", [0, 1, 2, 3, 4])
def test_gram_cols_match_jax(dtype, degree):
    t, beta = _t_beta(dtype, degree, seed=degree)
    got = gram_basis_cols(torch.from_numpy(t), degree, torch.from_numpy(beta))
    want = jax_gram_cols(jnp.asarray(t), degree, jnp.asarray(beta))
    assert len(got) == len(want) == degree + 1
    scale = max(np.abs(np.asarray(w)).max() for w in want)
    for n, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.from_numpy(t).dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL[dtype] * scale, err_msg=f"p_{n}")
    stacked = gram_basis(torch.from_numpy(t), degree, torch.from_numpy(beta))
    np.testing.assert_allclose(
        stacked.numpy(), np.asarray(jax_gram_basis(jnp.asarray(t), degree,
                                                   jnp.asarray(beta))),
        rtol=0, atol=TOL[dtype] * scale)


def test_gram_cols_take_one_beta_row_per_element():
    """beta with a last axis per element of t (the per-(pixel, channel)
    terms of the plain extra partials) gives the same values as the
    shared (degree+1,) beta broadcast."""
    t, beta = _t_beta(np.float64, 3, seed=9)
    tt, bt = torch.from_numpy(t), torch.from_numpy(beta)
    rows = bt.expand(t.shape[0], 4)
    for a, b in zip(gram_basis_cols(tt, 3, rows), gram_basis_cols(tt, 3, bt)):
        assert torch.equal(a, b)


def test_descriptor_rows_operand_and_layout():
    """The kernel descriptor: 4 bases of degree 3 and the base path (R = 5),
    beta as a 4-value operand (no host parameters), poly_w degree-major, and
    degree 3 with SiLU the only Gram basis the build carries."""
    b = kc.gram_basis(3)
    assert (b.K, b.R, b.act, b.n_extra, b.params, b.degree_major) == \
        (4, 5, "silu", 4, (), True)
    assert b.key == ("gram", 3, "silu") and b.key in kc.COMPILED
    assert kc.gram_basis(4).key not in kc.COMPILED
    assert kc.gram_basis(3, "gelu").key not in kc.COMPILED
    cheby = kc.cheby_basis(3)
    assert cheby.n_extra == 0 and not cheby.degree_major
    with pytest.raises(ValueError):
        kc.gram_basis(3, "tanh")
    x = torch.linspace(-3, 3, 11, dtype=torch.float64)[:, None]
    beta = torch.tensor([0.3, -0.2, 0.1, 0.4], dtype=torch.float64)
    E = kc.expand(x, b, beta)
    t = torch.tanh(x)
    p2 = t * t - 2.25 * beta[1]
    want = torch.nn.functional.silu(torch.cat(
        [torch.ones_like(t), t, p2, t * p2 - (100.0 / 3.0) * beta[2] * t, x],
        -1))
    torch.testing.assert_close(E, want, rtol=1e-14, atol=1e-14)


def test_ku_5d_and_beta_init_match_the_jax_distributions():
    """poly_w U(+-sqrt(3 / (O*C*K*k^2))) and beta_weights N(0, 1/(k^2*C*
    (degree+1))), as the JAX module's initializers (the draws differ
    between the packages, the laws do not)."""
    C, O, k = 64, 128, 3
    conv = KanConvND("gram", C, O, k, padding=1, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    jm = JaxKanConvND(family="gram", input_dim=C, output_dim=O,
                      kernel_size=k, padding=1)
    jp = jm.init(jax.random.PRNGKey(0),
                 jnp.zeros((1, 4, 4, C), jnp.float32), train=False)["params"]
    bound = np.sqrt(3.0 / (O * C * 4 * k * k))
    for a in (conv.poly_w.detach().numpy(), np.asarray(jp["poly_w"])):
        assert np.abs(a).max() <= bound
        assert abs(a.std() / (bound / np.sqrt(3.0)) - 1.0) < 0.01
    t = torch.empty(200000)
    init_lib.normal(0.0, 0.5)(t, torch.Generator().manual_seed(1))
    assert abs(t.mean().item()) < 0.005 and abs(t.std().item() - 0.5) < 0.005
    std = 1.0 / (k * k * C * 4)
    big = torch.empty(100000)
    init_lib.normal(0.0, std)(big, torch.Generator().manual_seed(2))
    assert abs(big.std().item() / std - 1.0) < 0.01
    assert conv.beta_weights.shape == jp["beta_weights"].shape == (4,)
    assert np.abs(conv.beta_weights.detach().numpy()).max() < 6 * std
    u = torch.empty(100000)
    init_lib.ku_5d(300)(u, torch.Generator().manual_seed(3))
    assert u.abs().max() <= np.sqrt(3.0 / 300) and \
        abs(u.std().item() / np.sqrt(1.0 / 300) - 1.0) < 0.01


def test_factory_and_module_follow_jax():
    """CONV_KAN_FACTORY["GRAMKAN"] builds the JAX parameter tree (base_w,
    degree-major poly_w, beta_weights; no prelu), 'same' padding, SiLU by
    default, and the reference's unported options raise."""
    jm = JaxKanConvND(family="gram", input_dim=3, output_dim=4,
                      kernel_size=3, padding=1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 3), jnp.float32),
        train=False))
    conv = CONV_KAN_FACTORY["GRAMKAN"](3, 4, 3, device="cpu",
                                       generator=torch.Generator())
    assert {k: tuple(v.shape) for k, v in conv.state_dict().items()} == {
        k: tuple(v.shape) for k, v in shapes["params"].items()} == {
        "base_w": (3, 3, 3, 4), "poly_w": (3, 3, 12, 4),
        "beta_weights": (4,)}
    assert conv.padding == 1 and conv.basis == kc.gram_basis(3)
    assert not hasattr(conv, "prelu")
    assert CONV_KAN_FACTORY["GRAMKAN"](
        3, 4, 3, base_activation="gelu", device="cpu").basis.act == "gelu"
    for kw in (dict(groups=2), dict(stride=2), dict(dilation=2)):
        conv = CONV_KAN_FACTORY["GRAMKAN"](4, 4, 3, device="cpu", **kw)
        assert all(getattr(conv, k) == v for k, v in kw.items())
    with pytest.raises(NotImplementedError):
        CONV_KAN_FACTORY["GRAMKAN"](4, 4, 3, device="cpu", l1_decay=0.1)
