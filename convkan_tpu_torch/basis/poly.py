"""Polynomial and Fourier bases, port of ``convkan_tpu/basis/poly.py``:
Chebyshev, Gram, Legendre, the three-term recurrences on a squashed input
(Jacobi, Bessel, Fibonacci, Gegenbauer, Hermite, Laguerre, Lucas and the
Taylor monomials), the reference's Bernstein sweep and the Fourier
features.

Chebyshev's squash is part of the basis: t = clamp(tanh x, -1 + eps, 1 - eps).
``chebyshev_basis`` is the trig form cos(n acos t) that the JAX XLA path
uses; ``chebyshev_basis_recurrence_list`` the three-term recurrence that
its Pallas kernels, and so the port's kernels and their plain versions,
use.  The two agree to a few ulp.  The Gram forms take the squashed input
(the caller applies tanh) and the learnable recurrence coefficients beta.

The eight three-term recurrences are one function, ``recur3_cols``, over
the coefficients of ``recur3_coefficients``:

    P_0 = c0,  P_1 = (A_1 t + B_1) / D_1,
    P_n = ((A_n t + B_n) P_{n-1} - C_n P_{n-2}) / D_n,

each family's own expression rearranged into this form without changing
one rounded operation (a zero B_n adds +0, a C_n of -1 subtracts -P_{n-2},
a D_n of 1 divides exactly), so float32 and float64 give JAX's list
functions' values bit for bit.  The CUDA kernels' ``Recur3`` policy
(csrc/kan_basis.cuh) runs the same operations on the float32 coefficients.
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


def legendre_basis_list(x, degree: int):
    """[P_0(x) .. P_degree(x)], P_n = ((2n+1) x P_{n-1} - n P_{n-2}) / (n+1)
    (layers/legendre_kan_layers.py:110-124), in the JAX list form's order
    of operations."""
    polys = [torch.ones_like(x)]
    if degree >= 1:
        polys.append(x)
        for n in range(1, degree):
            polys.append(((2.0 * n + 1.0) * x * polys[-1] - n * polys[-2])
                         / (n + 1.0))
    return polys


# the families of recur3_coefficients, with their reference layers
RECUR3_FAMILIES = ("jacobi", "bessel", "fibonacci", "gegenbauer", "hermite",
                   "laguerre", "lucas", "taylor")


def recur3_coefficients(family: str, degree: int, a: float = 1.0,
                        b: float = 1.0, alpha: float = 1.0) -> tuple:
    """(c0, (A_1, B_1, D_1), ((A_n, B_n, C_n, D_n) for n = 2..K-1)) of
    ``family``'s recurrence, K = degree + 1 rows (taylor: K = degree, the
    number of its monomials), as Python floats computed by the JAX list
    function's own expressions (``a``, ``b``: Jacobi's; ``alpha``:
    Gegenbauer's alpha_param or Laguerre's alpha).  An empty middle entry
    for K = 1, and c0 None for K = 0."""
    K = degree if family == "taylor" else degree + 1
    if family not in RECUR3_FAMILIES:
        raise ValueError(f"no three-term recurrence for {family!r}")
    c0 = {"fibonacci": 0.0, "lucas": 2.0}.get(family, 1.0) if K else None
    first = steps = ()
    if K >= 2:
        first = {
            # layers/jacobi_kan_layers.py:117-136: ((a-b) + (a+b+2) t) / 2
            "jacobi": (a + b + 2, a - b, 2),
            # layers/bessel_kan_layers.py:127-156: t + 1
            "bessel": (1, 1.0, 1),
            # layers/fibonacci_kan_layers.py:133-168: 1
            "fibonacci": (0, 1.0, 1),
            # layers/gegenbauer_kan_layers.py:133-156: 2 alpha t
            "gegenbauer": (2.0 * alpha, 0.0, 1),
            # layers/hermite_kan_layers.py:117-148: 2 t
            "hermite": (2.0, 0.0, 1),
            # layers/laguerre_kan_layers.py:132-167: (1 + alpha) - t
            "laguerre": (-1, 1.0 + alpha, 1),
            # layers/lucas_kan_layers.py:146-170: t
            "lucas": (1, 0.0, 1),
            # layers/taylor_kan_layers.py:130-152: t
            "taylor": (1, 0.0, 1),
        }[family]
    out = []
    for i in range(2, K):
        if family == "jacobi":
            theta_k = (2 * i + a + b) * (2 * i + a + b - 1) / (
                2 * i * (i + a + b))
            theta_k1 = (2 * i + a + b - 1) * (a * a - b * b) / (
                2 * i * (i + a + b) * (2 * i + a + b - 2))
            theta_k2 = (i + a - 1) * (i + b - 1) * (2 * i + a + b) / (
                i * (i + a + b) * (2 * i + a + b - 2))
            out.append((theta_k, theta_k1, theta_k2, 1))
        elif family == "bessel":
            out.append((2 * i - 1, 0.0, -1, 1))
        elif family in ("fibonacci", "lucas"):
            out.append((1, 0.0, -1, 1))
        elif family == "gegenbauer":
            n = i - 1
            out.append((2.0 * (n + alpha), 0.0, n + 2.0 * alpha - 1.0, n + 1))
        elif family == "hermite":
            out.append((2.0, 0.0, 2.0 * (i - 1), 1))
        elif family == "laguerre":
            out.append((-1, 2 * (i - 1) + 1 + alpha, i - 1 + alpha, i))
        else:  # taylor
            out.append((1, 0.0, 0.0, 1))
    steps = tuple(out)
    return c0, first, steps


def recur3_cols(t, coefficients) -> list:
    """[P_0(t) .. P_{K-1}(t)] of the recurrence ``coefficients``
    (``recur3_coefficients``), each shaped like t, in its order of
    operations."""
    c0, first, steps = coefficients
    if c0 is None:
        return []
    polys = [torch.full_like(t, c0)]
    if first:
        A, B, D = first
        polys.append((A * t + B) / D)
    for A, B, C, D in steps:
        polys.append(((A * t + B) * polys[-1] - C * polys[-2]) / D)
    return polys


def jacobi_basis_list(x, degree: int, a: float = 1.0, b: float = 1.0):
    """Jacobi P_n^(a,b)(x), n = 0..degree (layers/jacobi_kan_layers.py:
    117-136)."""
    return recur3_cols(x, recur3_coefficients("jacobi", degree, a, b))


def bessel_basis_list(x, degree: int):
    """y_0 = 1, y_1 = x + 1, y_n = (2n-1) x y_{n-1} + y_{n-2}
    (layers/bessel_kan_layers.py:127-156)."""
    return recur3_cols(x, recur3_coefficients("bessel", degree))


def fibonacci_basis_list(x, degree: int):
    """F_0 = 0, F_1 = 1, F_n = x F_{n-1} + F_{n-2}: the first row is all
    zeros, as in the reference (layers/fibonacci_kan_layers.py:133-168)."""
    return recur3_cols(x, recur3_coefficients("fibonacci", degree))


def gegenbauer_basis_list(x, degree: int, alpha: float):
    """C_0 = 1, C_1 = 2 alpha x, C_{n+1} = (2(n+alpha) x C_n - (n+2alpha-1)
    C_{n-1}) / (n+1) (layers/gegenbauer_kan_layers.py:133-156)."""
    return recur3_cols(x, recur3_coefficients("gegenbauer", degree,
                                              alpha=alpha))


def hermite_basis_list(x, degree: int):
    """Physicists' Hermite: H_0 = 1, H_1 = 2x, H_n = 2x H_{n-1} - 2(n-1)
    H_{n-2} (layers/hermite_kan_layers.py:117-148)."""
    return recur3_cols(x, recur3_coefficients("hermite", degree))


def laguerre_basis_list(x, degree: int, alpha: float):
    """Generalized Laguerre: L_0 = 1, L_1 = 1 + alpha - x, k L_k =
    (2k-1+alpha-x) L_{k-1} - (k-1+alpha) L_{k-2}
    (layers/laguerre_kan_layers.py:132-167)."""
    return recur3_cols(x, recur3_coefficients("laguerre", degree,
                                              alpha=alpha))


def lucas_basis_list(x, degree: int):
    """L_0 = 2, L_1 = x, L_n = x L_{n-1} + L_{n-2}
    (layers/lucas_kan_layers.py:146-170)."""
    return recur3_cols(x, recur3_coefficients("lucas", degree))


def taylor_basis_list(x, degree: int):
    """The monomials [1, x, .., x^(degree-1)]: ``degree`` counts the terms
    (layers/taylor_kan_layers.py:130-152; the caller squashes x by tanh)."""
    return recur3_cols(x, recur3_coefficients("taylor", degree))


def bernstein_basis_list(x, degree: int):
    """The reference's de Casteljau sweep from an all-ones buffer
    (layers/bersnstein_kan_layers.py:120-139): sweep j updates the first
    degree + 1 - j slots, so every row stays the constant 1 (exactly, for
    x in [0, 1]: the caller's sigmoid), as the JAX package pins
    (tests/test_math_oracle.py)."""
    cols = [torch.ones_like(x) for _ in range(degree + 1)]
    for j in range(1, degree + 1):
        n = degree + 1 - j
        cols = [cols[i] * (1 - x) + cols[i + 1] * x for i in range(n)] + \
            cols[n:]
    return cols


def fourier_basis_list(x, grid_size: int):
    """[cos(k x) for k = 1..grid_size] then [sin(k x) ...]
    (layers/fourier_kan_layers.py:163-187)."""
    return [torch.cos(float(k) * x) for k in range(1, grid_size + 1)] + \
        [torch.sin(float(k) * x) for k in range(1, grid_size + 1)]
