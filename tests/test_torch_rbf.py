"""The port's Gaussian RBF basis (FastKAN) against the JAX package's
``basis/rbf.py``: the float32 linspace centres bit for bit, and the basis
exp(-((x - c) / d)^2) as columns and stacked, in float64 (1e-15 of the
largest value) and float32 (within 1e-6 relative: the same order of
operations, but XLA's exp and torch's differ by an ulp or two, and XLA
flushes subnormal results, below 1.2e-38, to 0)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis import rbf as jrbf
from convkan_tpu_torch.basis import rbf

torch.set_num_threads(1)


@pytest.mark.parametrize("lo,hi,n", [(-2.0, 2.0, 8), (-1.0, 1.0, 5),
                                     (-1.5, 0.7, 3)])
def test_grid_is_jax_float32_linspace(lo, hi, n):
    got = rbf.make_rbf_grid(lo, hi, n)
    want = jrbf.make_rbf_grid(lo, hi, n)
    assert got.dtype == want.dtype == np.float32
    assert np.array_equal(got, want)


@pytest.mark.parametrize("lo,hi,n", [(-2.0, 2.0, 8), (-1.0, 1.0, 5)])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_basis_matches_jax(lo, hi, n, dtype):
    x = np.random.RandomState(n).normal(0.0, 1.5, (3, 4, 5, 2)).astype(dtype)
    grid = rbf.make_rbf_grid(lo, hi, n)
    d = (hi - lo) / (n - 1)
    got = rbf.rbf_basis(torch.from_numpy(x), grid, d).numpy()
    want = np.asarray(jrbf.rbf_basis(jnp.asarray(x), grid, d))
    assert got.shape == want.shape == x.shape + (n,)
    assert got.dtype == want.dtype == dtype
    if dtype == np.float32:
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1.2e-38)
    else:
        assert np.abs(got - want).max() <= 1e-15
    cols = rbf.rbf_cols(torch.from_numpy(x), grid, d)
    assert len(cols) == n and all(
        np.array_equal(c.numpy(), got[..., i]) for i, c in enumerate(cols))


def test_basis_gradient_matches_jax_f64():
    x = np.random.RandomState(1).normal(0.0, 1.5, (2, 3, 3, 4))
    grid, d = rbf.make_rbf_grid(-2.0, 2.0, 8), 4.0 / 7
    w = np.random.RandomState(2).normal(0.0, 1.0, x.shape + (8,))
    want = jax.grad(lambda v: jnp.sum(jrbf.rbf_basis(v, grid, d) * w))(
        jnp.asarray(x))
    xt = torch.from_numpy(x).requires_grad_(True)
    (rbf.rbf_basis(xt, grid, d) * torch.from_numpy(w)).sum().backward()
    assert np.abs(xt.grad.numpy() - np.asarray(want)).max() <= 1e-14
