"""Port parity for the static bases (convkan_tpu_torch/basis/poly.py), the
families' descriptions (nn/kan_conv.py ``FAMILIES``, ``FUSABLE``), the
``normal_full`` init and the conv factory, against the JAX package.

* Every list function (Jacobi, Bernstein, Bessel, Fibonacci, Gegenbauer,
  Hermite, Laguerre, Lucas, Taylor, Fourier, Legendre) against JAX's at
  degrees 0-5 (Fourier: grids 1-5) with default and non-default a, b,
  alpha and alpha_param, in float64 within 1e-12 of the largest value (the
  eight recurrences are ``recur3_cols`` over ``recur3_coefficients``: the
  same rounded operations as JAX's, so they agree bit for bit in float32
  and float64 on the CPU, which the test also checks), and Bernstein's
  rows exactly 1 on [0, 1].
* ``FAMILIES`` carries JAX's fields for every family but ReLU-KAN;
  ``FUSABLE`` is JAX's ``_FUSABLE`` less ReLU-KAN.
* ``normal_full`` draws N(0, 1/(input_dim (degree+1) k^2)) over the full
  input_dim; the module's num_basis per family equals JAX's.
* ``CONV_KAN_FACTORY`` has every JAX key but "ReLUKAN", each with JAX's
  parameters and defaults, and builds its family with them.
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis import poly as jpoly
from convkan_tpu.factory.conv_factory import CONV_KAN_FACTORY as J_FACTORY
from convkan_tpu.nn.kan_conv import FAMILIES as J_FAMILIES
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.basis import poly
from convkan_tpu_torch.factory.conv_factory import CONV_KAN_FACTORY
from convkan_tpu_torch.nn.kan_conv import FAMILIES, FUSABLE, KanConvND
from convkan_tpu_torch.utils import initializers as init_lib

torch.set_num_threads(1)

# (list function name, keyword arguments, input domain)
CASES = [("jacobi", {}, "t"), ("jacobi", dict(a=0.5, b=1.5), "t"),
         ("bessel", {}, "t"), ("fibonacci", {}, "t"),
         ("gegenbauer", dict(alpha=0.0), "t"),
         ("gegenbauer", dict(alpha=0.5), "t"), ("hermite", {}, "t"),
         ("laguerre", dict(alpha=1.0), "t"),
         ("laguerre", dict(alpha=0.5), "t"),
         ("lucas", {}, "t"), ("taylor", {}, "t"), ("legendre", {}, "t"),
         ("bernstein", {}, "s")]


def _inputs(domain, dtype, seed=0):
    """tanh of U(-4, 4) with 0 and +-1 (t), or its sigmoid-like [0, 1] map
    (s), or U(-4, 4) itself (x)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-4.0, 4.0, 2000)
    x[:3] = [0.0, 1.0, -1.0]
    t = {"t": np.tanh(x), "s": (np.tanh(x) + 1) / 2, "x": x}[domain]
    return t.astype(dtype)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("name,kw,domain", CASES,
                         ids=[c[0] + "".join(f"-{k}{v}" for k, v in
                                             c[1].items()) for c in CASES])
def test_list_functions_match_jax(name, kw, domain, dtype):
    t = _inputs(domain, dtype)
    for degree in range(6):
        got = getattr(poly, f"{name}_basis_list")(torch.from_numpy(t),
                                                  degree, **kw)
        want = getattr(jpoly, f"{name}_basis_list")(jnp.asarray(t), degree,
                                                    **kw)
        K = degree if name == "taylor" else degree + 1
        assert len(got) == len(want) == K, (name, degree)
        scale = max([1.0] + [np.abs(np.asarray(w)).max() for w in want])
        for n, (a, b) in enumerate(zip(got, want)):
            b = np.broadcast_to(np.asarray(b), a.shape)
            assert a.dtype == torch.from_numpy(t).dtype
            assert np.abs(a.numpy() - b).max() <= 1e-12 * scale, \
                (name, degree, n)
            # the same rounded operations: equal bit for bit
            assert np.array_equal(a.numpy(), b), (name, degree, n)


@pytest.mark.parametrize("grid", [1, 2, 3, 5])
def test_fourier_list_matches_jax_f64(grid):
    x = _inputs("x", np.float64)
    got = poly.fourier_basis_list(torch.from_numpy(x), grid)
    want = jpoly.fourier_basis_list(jnp.asarray(x), grid)
    assert len(got) == len(want) == 2 * grid
    for a, b in zip(got, want):
        assert np.abs(a.numpy() - np.asarray(b)).max() <= 1e-12


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_bernstein_rows_are_exactly_one(dtype):
    """The reference's sweep from an all-ones buffer keeps every row at 1
    for s in [0, 1] (tests/test_math_oracle.py pins it in JAX), and its
    derivative is exactly 0."""
    s = torch.from_numpy(_inputs("s", dtype)).requires_grad_(True)
    rows = poly.bernstein_basis_list(s, 3)
    assert all(bool((r == 1).all()) for r in rows)
    grad = torch.autograd.grad(sum(r.sum() for r in rows), s)[0]
    assert not grad.any()


def test_recur3_coefficients_reproduce_the_families():
    """The coefficients of the recurrence forms, checked against the
    closed forms at degree 3 (t^3 terms and constants)."""
    t = torch.linspace(-1, 1, 9, dtype=torch.float64)
    h = poly.hermite_basis_list(t, 3)
    assert torch.allclose(h[3], 8 * t ** 3 - 12 * t)
    lg = poly.laguerre_basis_list(t, 2, alpha=0.0)
    assert torch.allclose(lg[2], (t ** 2 - 4 * t + 2) / 2)
    ts = poly.taylor_basis_list(t, 4)
    assert torch.allclose(ts[3], t ** 3)
    c0, first, steps = poly.recur3_coefficients("lucas", 3)
    assert c0 == 2.0 and first == (1, 0.0, 1) and steps == ((1, 0.0, -1, 1),
                                                            (1, 0.0, -1, 1))
    assert poly.recur3_cols(t, poly.recur3_coefficients("taylor", 0)) == []
    with pytest.raises(ValueError):
        poly.recur3_coefficients("legendre", 3)


def test_families_carry_jax_fields():
    assert set(FAMILIES) == set(J_FAMILIES) - {"relukan"}
    for name, fam in FAMILIES.items():
        j = J_FAMILIES[name]
        assert (fam.has_base, fam.base_input, fam.squash, fam.post,
                fam.norm_on, fam.dropout_site, fam.poly_init,
                fam.degree_major, fam.default_act) == (
            j.has_base, j.base_input, j.squash, j.post, j.norm_on,
            j.dropout_site, j.poly_init, j.layout == "degree_major",
            j.default_base_activation), name
    assert FUSABLE == JaxKanConvND._FUSABLE - {"relukan"}


@pytest.mark.parametrize("family",
                         sorted(set(FAMILIES) - {"kan", "fastkan"}))
def test_num_basis_matches_jax(family):
    for kw in (dict(degree=3, grid_size=5), dict(degree=2, grid_size=3)):
        jm = JaxKanConvND(family=family, input_dim=4, output_dim=4,
                          kernel_size=3, **kw)
        tm = KanConvND(family, 4, 4, 3, device="cpu", **kw)
        assert tm.num_basis == jm.num_basis, (family, kw)


def test_normal_full_init():
    """Jacobi's poly_w: N(0, std), std = 1/(input_dim (degree+1) k^2) over
    the full input_dim (groups do not divide it)."""
    conv = KanConvND("jacobi", 16, 64, 3, groups=2, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    std = 1.0 / (16 * 4 * 9)
    w = conv.poly_w.detach()
    assert w.shape == (3, 3, 8 * 4, 64)
    assert abs(w.std().item() / std - 1) < 0.03 and abs(w.mean()) < 3e-4 * 3
    t = torch.empty(2000, 50)
    init_lib.normal_full(16, 3, 9)(t, torch.Generator().manual_seed(1))
    assert abs(t.std().item() / std - 1) < 0.01


def _params(fn):
    return [(n, p.default if not inspect.isclass(p.default)
             else p.default.__name__)
            for n, p in inspect.signature(fn).parameters.items()
            if p.kind not in (p.VAR_KEYWORD, p.KEYWORD_ONLY)]


@pytest.mark.parametrize("key", sorted(CONV_KAN_FACTORY))
def test_factory_keys_and_signatures_match_jax(key):
    assert set(CONV_KAN_FACTORY) == set(J_FACTORY) - {"ReLUKAN"}
    assert _params(CONV_KAN_FACTORY[key]) == _params(J_FACTORY[key])
    conv = CONV_KAN_FACTORY[key](8, 16, 3, device="cpu")
    if key == "conv":
        assert type(conv).__name__ == "StdConvBlock"
        return
    jm = J_FACTORY[key](8, 16, 3)
    jm = getattr(jm, "layer", jm)
    if key == "WavKAN":
        assert type(conv).__name__ == "WavKANConvND"
        return
    assert conv.family == jm.family and conv.padding == jm.padding == 1
    assert conv.num_basis == jm.num_basis


def test_factory_hyperparameters_reach_the_conv():
    """JAX's _poly_conv pops alpha_param, alpha, a, b and grid_size out of
    ``**extra`` into the conv; the rest reaches the norm."""
    x = torch.randn(1, 5, 5, 4, dtype=torch.float64)
    f = CONV_KAN_FACTORY
    a = f["JacobiKAN"](4, 4, 3, a=0.5, b=2.0, device="cpu")
    assert a.basis.coefficients == poly.recur3_coefficients("jacobi", 3,
                                                            0.5, 2.0)
    g = f["GegenbauerKAN"](4, 4, 3, alpha_param=0.5, device="cpu")
    assert g.basis.coefficients == poly.recur3_coefficients(
        "gegenbauer", 3, alpha=0.5)
    fr = f["FourierKAN"](4, 4, 3, device="cpu")
    assert fr.num_basis == 6 and fr.act == "gelu"       # grid 3, GELU
    assert f["BersnsteinKAN"](4, 4, 3, device="cpu").act == "silu"
    assert f["HermiteKAN"](4, 4, 3, device="cpu").act == "gelu"
    le = f["LegendreKAN"](4, 4, 3, norm_layer="BatchNorm2d", momentum=0.5,
                          device="cpu")
    assert le.norm.momentum == 0.5 and le.act == "silu"
    assert torch.isfinite(a.double()(x)).all()
