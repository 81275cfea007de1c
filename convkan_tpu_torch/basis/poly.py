"""Chebyshev basis, port of ``chebyshev_basis`` and
``chebyshev_basis_recurrence_list`` of ``convkan_tpu/basis/poly.py``.

The squash is part of the basis: t = clamp(tanh x, -1 + eps, 1 - eps).
``chebyshev_basis`` is the trig form cos(n acos t) that the JAX XLA path
uses; ``chebyshev_basis_recurrence_list`` the three-term recurrence that
its Pallas kernels, and so the port's kernels and their plain versions,
use.  The two agree to a few ulp.
"""

from __future__ import annotations

import torch


def chebyshev_basis(x, degree: int, epsilon: float = 1e-7):
    """T_n(t) = cos(n acos t), n = 0..degree, stacked on a new last axis."""
    theta = torch.acos(torch.clamp(torch.tanh(x), -1.0 + epsilon,
                                   1.0 - epsilon))
    return torch.stack([torch.cos(n * theta) for n in range(degree + 1)],
                       dim=-1)


def chebyshev_basis_recurrence_list(x, degree: int, epsilon: float = 1e-7):
    """[T_0(t) .. T_degree(t)] by T_n = 2t T_{n-1} - T_{n-2}, each shaped
    like x, in the order of operations of the JAX list form."""
    t = torch.clamp(torch.tanh(x), -1.0 + epsilon, 1.0 - epsilon)
    polys = [torch.ones_like(t)]
    if degree >= 1:
        polys.append(t)
        for _ in range(2, degree + 1):
            polys.append(2.0 * t * polys[-1] - polys[-2])
    return polys
