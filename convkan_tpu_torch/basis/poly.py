"""Chebyshev and Gram bases, port of ``chebyshev_basis``,
``chebyshev_basis_recurrence_list``, ``gram_basis_cols`` and ``gram_basis``
of ``convkan_tpu/basis/poly.py``.

Chebyshev's squash is part of the basis: t = clamp(tanh x, -1 + eps, 1 - eps).
``chebyshev_basis`` is the trig form cos(n acos t) that the JAX XLA path
uses; ``chebyshev_basis_recurrence_list`` the three-term recurrence that
its Pallas kernels, and so the port's kernels and their plain versions,
use.  The two agree to a few ulp.  The Gram forms take the squashed input
(the caller applies tanh) and the learnable recurrence coefficients beta.
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


def gram_basis_cols(t, degree: int, beta_weights):
    """[p_0(t) .. p_degree(t)] of the Gram recurrence with a learnable
    coefficient, each shaped like t (the squashed input, tanh x):
    p_0 = 1, p_1 = t, p_i = t p_{i-1} - (c_i beta[i-1]) p_{i-2} with
    c_i = ((m+n)(m-n)n^2) / (m^2/(4n^2-1)), n = i - 1, m = i
    (layers/gram_kan_layers.py:150-170), in the order of operations of the
    JAX list form.  ``beta_weights`` is (degree+1,), or carries one such
    row per element of t on its last axis (``beta_weights[..., n]``)."""
    p0 = torch.ones_like(t)
    if degree == 0:
        return [p0]
    p1 = t
    basis = [p0, p1]
    for i in range(2, degree + 1):
        n, m = i - 1, i
        coef = ((m + n) * (m - n) * n ** 2) / (m ** 2 / (4.0 * n ** 2 - 1.0))
        p2 = t * p1 - (coef * beta_weights[..., n]) * p0
        basis.append(p2)
        p0, p1 = p1, p2
    return basis


def gram_basis(t, degree: int, beta_weights):
    """The Gram polynomials of ``gram_basis_cols`` stacked on a new last
    axis."""
    return torch.stack(gram_basis_cols(t, degree, beta_weights), dim=-1)
