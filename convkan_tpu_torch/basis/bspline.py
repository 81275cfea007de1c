"""Cox–de Boor B-spline basis, port of ``convkan_tpu/basis/bspline.py``.

A degree-0 half-open indicator ``(x >= k_i) & (x < k_{i+1})`` followed by
``spline_order`` rational blending steps over the uniform extended knot
vector.  Knot deltas are rounded at float32 (the reference keeps its grid
as a float32 tensor) with a zero guard of 1.0, and inputs outside the
extended grid give all-zero bases.
"""

from __future__ import annotations

import numpy as np


def make_bspline_grid(grid_size: int, spline_order: int, grid_range=(-1.0, 1.0)):
    """The extended uniform knot vector as a float32 numpy array of
    ``grid_size + 2*spline_order + 1`` knots."""
    lo, hi = float(grid_range[0]), float(grid_range[1])
    h = (hi - lo) / grid_size
    n = grid_size + 2 * spline_order + 1
    return np.linspace(lo - h * spline_order, hi + h * spline_order, n,
                       dtype=np.float32)


def knot_deltas(knots, spline_order: int):
    """Per-level (dr, dd) knot deltas as python floats, each the float32
    difference of two float32 knots, 0 replaced by 1.0.  Entry ``[k-1][i]``
    is the pair for basis ``i`` at recurrence level ``k``."""
    g32 = np.asarray(knots, np.float32)
    n = len(g32)
    out = []
    for k in range(1, spline_order + 1):
        level = []
        for i in range(n - 1 - k):
            dr = float(g32[i + k] - g32[i]) or 1.0
            dd = float(g32[i + k + 1] - g32[i + 1]) or 1.0
            level.append((dr, dd))
        out.append(level)
    return out


def bspline_basis_unrolled_list(x, knots, spline_order: int):
    """x: tensor of any shape; knots: the knot vector (float32 values).
    Returns a list of ``len(knots) - spline_order - 1`` tensors shaped like
    x, in the dtype of x."""
    g32 = np.asarray(knots, np.float32)
    kn = [float(v) for v in g32]
    n = len(kn)
    bases = [((x >= kn[i]) & (x < kn[i + 1])).to(x.dtype) for i in range(n - 1)]
    for k, level in enumerate(knot_deltas(g32, spline_order), start=1):
        bases = [(x - kn[i]) / dr * bases[i]
                 + (kn[i + k + 1] - x) / dd * bases[i + 1]
                 for i, (dr, dd) in enumerate(level)]
    return bases
