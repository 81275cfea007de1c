"""Port parity for the Chebyshev basis (convkan_tpu_torch/basis/poly.py), its
kernel descriptor (kernels/kan_conv2d.py ``cheby_basis``), the
kaiming_normal init and the ChebyKAN factory key, against the JAX package.

The basis is held in float64 to 1e-12 (the trig and recurrence forms agree
to a few ulp) and in float32 to 1e-5 (XLA's and torch's float32 tanh differ
by a few ulp, and |T_n'| <= n^2 carries that into T_n: 25 x 4 ulp of 1 is
6e-6 at degree 5), on inputs that reach past the clamp of tanh (|x| > 8.3
in float64, > 8.1 in float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis.poly import chebyshev_basis as jax_trig
from convkan_tpu.basis.poly import \
    chebyshev_basis_recurrence_list as jax_recurrence
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.utils.initializers import \
    kaiming_normal as jax_kaiming_normal
from convkan_tpu_torch.basis.poly import (chebyshev_basis,
                                          chebyshev_basis_recurrence_list)
from convkan_tpu_torch.factory.conv_factory import CONV_KAN_FACTORY
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.utils import initializers as init_lib

torch.set_num_threads(1)

TOL = {np.float64: 1e-12, np.float32: 1e-5}


def _x(dtype, n=4000, seed=0):
    """U(-12, 12) with exact 0, +-1 and values around the clamp."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-12.0, 12.0, n)
    x[:8] = [0.0, 1.0, -1.0, 8.0, 8.3, -8.3, 9.0, 12.0]
    return x.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("degree", [1, 3, 5])
def test_recurrence_list_matches_jax(dtype, degree):
    x = _x(dtype, seed=degree)
    got = chebyshev_basis_recurrence_list(torch.from_numpy(x), degree)
    want = jax_recurrence(jnp.asarray(x), degree)
    assert len(got) == len(want) == degree + 1
    for n, (a, b) in enumerate(zip(got, want)):
        assert a.dtype == torch.from_numpy(x).dtype
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0,
                                   atol=TOL[dtype], err_msg=f"T_{n}")


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_trig_form_matches_jax_and_the_recurrence(dtype):
    x = _x(dtype, seed=7)
    got = chebyshev_basis(torch.from_numpy(x), 3).numpy()
    want = np.asarray(jax_trig(jnp.asarray(x), 3))
    assert got.shape == want.shape == x.shape + (4,)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])
    rec = np.stack([t.numpy() for t in chebyshev_basis_recurrence_list(
        torch.from_numpy(x), 3)], -1)
    np.testing.assert_allclose(rec, got, rtol=0, atol=4 * TOL[dtype])


def test_clamp_past_tanh_saturation():
    """Past |x| ~ 8.3 the clamp holds t at +-(1 - eps): T_n is constant and
    its derivative is exactly 0, in both packages."""
    x = np.array([-12.0, -9.0, 9.0, 12.0])
    xt = torch.from_numpy(x).requires_grad_(True)
    cols = chebyshev_basis_recurrence_list(xt, 3)
    np.testing.assert_allclose(cols[1].detach().numpy(),
                               [-1 + 1e-7, -1 + 1e-7, 1 - 1e-7, 1 - 1e-7],
                               rtol=0, atol=1e-15)
    grad = torch.autograd.grad(sum(c.sum() for c in cols), xt)[0]
    jgrad = jax.grad(lambda v: sum(c.sum() for c in jax_recurrence(v, 3)))(
        jnp.asarray(x))
    assert not grad.any() and not np.asarray(jgrad).any()


def test_descriptor_rows_and_clamp_bounds():
    """The kernel descriptor: 4 rows of degree 3, no base path, and the
    float32 clamp bounds that jnp.clip uses on float32 input."""
    b = kc.cheby_basis(3)
    assert (b.K, b.R, b.act, b.key) == (4, 4, None, ("cheby", 3))
    assert b.key in kc.COMPILED and kc.cheby_basis(4).key not in kc.COMPILED
    lo, hi = b.params
    t = jnp.clip(jnp.asarray([-2.0, 2.0], jnp.float32), -1.0 + 1e-7,
                 1.0 - 1e-7)
    assert (lo, hi) == tuple(float(v) for v in np.asarray(t))
    assert np.float32(lo) == -np.float32(hi) and np.float32(hi) < 1.0
    s = kc.bspline_basis(np.linspace(-2.2, 2.2, 12), 3, "silu")
    assert (s.K, s.R, s.key) == (8, 9, ("bspline", 12, 3, "silu"))


def test_kaiming_normal_matches_the_jax_distribution():
    """N(0, sqrt(2) / sqrt(fan_in)) over HWIO fans (cheby_kan_layers.py:
    88-90); the draws differ between the packages, the law does not."""
    t = torch.empty(3, 3, 64, 256)
    init_lib.kaiming_normal("relu", layout="conv_hwio")(
        t, torch.Generator().manual_seed(0))
    j = np.asarray(jax_kaiming_normal("relu", layout="conv_hwio")(
        jax.random.PRNGKey(0), (3, 3, 64, 256), jnp.float32))
    std = np.sqrt(2.0) / np.sqrt(3 * 3 * 64)
    for a in (t.numpy(), j):
        assert abs(a.mean()) < 0.01 * std
        assert abs(a.std() / std - 1.0) < 0.01


def test_factory_and_module_follow_jax():
    """CONV_KAN_FACTORY["ChebyKAN"] builds the JAX parameter tree (poly_w
    only: no base_w, no prelu), 'same' padding, the kaiming_normal init,
    and the reference's unported options raise."""
    jm = JaxKanConvND(family="cheby", input_dim=3, output_dim=4,
                      kernel_size=3, padding=1)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 3), jnp.float32),
        train=False))
    conv = CONV_KAN_FACTORY["ChebyKAN"](3, 4, 3, device="cpu",
                                        generator=torch.Generator())
    assert {k: tuple(v.shape) for k, v in conv.state_dict().items()} == {
        k: tuple(v.shape) for k, v in shapes["params"].items()} == {
        "poly_w": (3, 3, 12, 4)}
    assert conv.padding == 1 and conv.base_w is None
    big = KanConvND("cheby", 64, 256, 3, padding=1, device="cpu",
                    generator=torch.Generator().manual_seed(1))
    std = np.sqrt(2.0) / np.sqrt(3 * 3 * 64 * 4)
    assert abs(big.poly_w.std().item() / std - 1.0) < 0.02
    for kw in (dict(groups=2), dict(stride=2), dict(dilation=2)):
        conv = CONV_KAN_FACTORY["ChebyKAN"](4, 4, 3, device="cpu", **kw)
        assert all(getattr(conv, k) == v for k, v in kw.items())
    with pytest.raises(NotImplementedError):
        CONV_KAN_FACTORY["ChebyKAN"](4, 4, 3, device="cpu", l1_decay=0.1)
