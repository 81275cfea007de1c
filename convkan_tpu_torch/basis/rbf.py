"""Gaussian radial basis functions (FastKAN), port of
``convkan_tpu/basis/rbf.py``: ``num_grids`` centres on a float32 linspace
over [grid_min, grid_max], basis exp(-((x - c) / denominator)^2), in that
order of operations."""

from __future__ import annotations

import numpy as np
import torch


def make_rbf_grid(grid_min: float = -2.0, grid_max: float = 2.0,
                  num_grids: int = 8):
    """The centres, numpy's float32 linspace (as the JAX package's)."""
    return np.linspace(grid_min, grid_max, num_grids, dtype=np.float32)


def rbf_cols(x, grid, denominator: float):
    """[exp(-((x - c) / denominator)^2) for each centre c], each shaped
    like x; the centres as Python floats."""
    return [torch.exp(-torch.square((x - c) / denominator))
            for c in (float(v) for v in np.asarray(grid))]


def rbf_basis(x, grid, denominator: float):
    """The columns of ``rbf_cols`` stacked on a new last axis."""
    return torch.stack(rbf_cols(x, grid, denominator), dim=-1)
