"""Port parity: convkan_tpu_torch.basis.bspline vs convkan_tpu.basis.bspline
in float64 (max |diff| <= 1e-12), on points on the knots, between knots
and outside the extended grid [-2.2, 2.2]."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis import bspline as jax_bspline
from convkan_tpu_torch.basis import bspline as torch_bspline

torch.set_num_threads(1)


def _points(knots, seed=0):
    rng = np.random.RandomState(seed)
    mids = (knots[:-1] + knots[1:]) / 2.0
    outside = np.array([-5.0, -2.2000001, -2.21, 2.2, 2.2000001, 3.0, 7.5])
    return np.concatenate([knots.astype(np.float64), mids, outside,
                           rng.uniform(-3.0, 3.0, 200)])


@pytest.mark.parametrize("grid_size,order,grid_range", [
    (5, 3, (-1.0, 1.0)),   # the KAN-VGG default
    (3, 2, (-2.0, 2.0)),
    (8, 1, (-1.0, 1.0)),
])
def test_bspline_basis_matches_jax_f64(grid_size, order, grid_range):
    knots = torch_bspline.make_bspline_grid(grid_size, order, grid_range)
    np.testing.assert_array_equal(
        knots, jax_bspline.make_bspline_grid(grid_size, order, grid_range))
    x = _points(knots)
    want = np.stack([np.asarray(b) for b in jax_bspline.
                     bspline_basis_unrolled_list(jnp.asarray(x), tuple(knots),
                                                 order)], -1)
    got = torch.stack(torch_bspline.bspline_basis_unrolled_list(
        torch.from_numpy(x), tuple(knots), order), -1).numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-12


def test_bspline_outside_grid_is_zero_and_knots_half_open():
    knots = torch_bspline.make_bspline_grid(5, 3)
    assert knots[0] == np.float32(-2.2) and knots[-1] == np.float32(2.2)
    x = torch.tensor([-3.0, float(knots[0]) - 1e-6, float(knots[-1]), 4.0],
                     dtype=torch.float64)
    bases = torch.stack(torch_bspline.bspline_basis_unrolled_list(
        x, tuple(knots), 3), -1)
    assert torch.all(bases == 0)
    # on an interior knot the degree-0 indicator picks the interval to its
    # right, so the partition of unity holds there (to 1e-6: the knot
    # deltas are float32-rounded)
    inner = torch.tensor(knots[3:-3], dtype=torch.float64)
    total = torch.stack(torch_bspline.bspline_basis_unrolled_list(
        inner, tuple(knots), 3), -1).sum(-1)
    torch.testing.assert_close(total, torch.ones_like(total), rtol=0,
                               atol=1e-6)
