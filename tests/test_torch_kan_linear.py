"""Port parity for the 17 dense KAN families (``nn/kan_linear.py``) against
the JAX package's, in float64:

* each family (and WavKAN's five wavelets, ReLU-KAN with fixed phases, the
  Gegenbauer/Laguerre/Jacobi parameters) with JAX's variables moved off
  their init: outputs, the input's and every parameter's gradient, in eval
  and train mode (WavKAN's BatchNorm: the batch's statistics and the
  running ones after), within 1e-10 of the largest entry;
* ``KANLinear``'s segment deactivation in train mode, the port's mask
  handed to JAX's ``segment_deactivation_mask``;
* the reference's 21 ``mlp_*`` goldens: their state_dicts through the JAX
  package's ``convert_linear`` into the JAX modules (as
  tests/test_golden_mlp.py builds them), those variables through
  ``from_jax`` into the port (strict=True), the port's eval output against
  the golden's within 1e-9.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_utils import graft, load_golden

from convkan_tpu.nn import kan_linear as jkl
from convkan_tpu.utils import regularization as jreg
from convkan_tpu.utils.torch_compat import convert_linear as T
from convkan_tpu_torch.nn import kan_linear as kl
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-10
F64 = dict(param_dtype=jnp.float64)
T64 = dict(device="cpu", dtype=torch.float64)

# name -> (JAX module, port module) builders for (in, out)
FAMILIES = {
    "KAN": (lambda i, o: jkl.KANLinear(input_dim=i, output_dim=o, **F64),
            lambda i, o: kl.KANLinear(i, o, **T64)),
    "KAN_relu": (lambda i, o: jkl.KANLinear(input_dim=i, output_dim=o,
                                            base_activation="relu",
                                            grid_size=4, **F64),
                 lambda i, o: kl.KANLinear(i, o, base_activation="relu",
                                           grid_size=4, **T64)),
    "FastKAN": (lambda i, o: jkl.FastKANLinear(input_dim=i, output_dim=o,
                                               **F64),
                lambda i, o: kl.FastKANLinear(i, o, **T64)),
    "ChebyKAN": (lambda i, o: jkl.ChebyKANLinear(input_dim=i, output_dim=o,
                                                 degree=4, **F64),
                 lambda i, o: kl.ChebyKANLinear(i, o, degree=4, **T64)),
    "LegendreKAN": (lambda i, o: jkl.LegendreKANLinear(
        input_dim=i, output_dim=o, **F64),
        lambda i, o: kl.LegendreKANLinear(i, o, **T64)),
    "GRAMKAN": (lambda i, o: jkl.GRAMKANLinear(input_dim=i, output_dim=o,
                                               **F64),
                lambda i, o: kl.GRAMKANLinear(i, o, **T64)),
    "JacobiKAN": (lambda i, o: jkl.JacobiKANLinear(
        input_dim=i, output_dim=o, a=1.5, b=0.5, **F64),
        lambda i, o: kl.JacobiKANLinear(i, o, a=1.5, b=0.5, **T64)),
    "BersnsteinKAN": (lambda i, o: jkl.BersnsteinKANLinear(
        input_dim=i, output_dim=o, **F64),
        lambda i, o: kl.BersnsteinKANLinear(i, o, **T64)),
    "BesselKAN": (lambda i, o: jkl.BesselKANLinear(i, o, **F64),
                  lambda i, o: kl.BesselKANLinear(i, o, **T64)),
    "FibonacciKAN": (lambda i, o: jkl.FibonacciKANLinear(i, o, **F64),
                     lambda i, o: kl.FibonacciKANLinear(i, o, **T64)),
    "GegenbauerKAN": (lambda i, o: jkl.GegenbauerKANLinear(
        i, o, alpha_param=0.5, **F64),
        lambda i, o: kl.GegenbauerKANLinear(i, o, alpha_param=0.5, **T64)),
    "HermiteKAN": (lambda i, o: jkl.HermiteKANLinear(i, o, **F64),
                   lambda i, o: kl.HermiteKANLinear(i, o, **T64)),
    "LaguerreKAN": (lambda i, o: jkl.LaguerreKANLinear(i, o, alpha=1.0,
                                                       **F64),
                    lambda i, o: kl.LaguerreKANLinear(i, o, alpha=1.0,
                                                      **T64)),
    "LucasKAN": (lambda i, o: jkl.LucasKANLinear(i, o, degree=4, **F64),
                 lambda i, o: kl.LucasKANLinear(i, o, degree=4, **T64)),
    "FourierKAN": (lambda i, o: jkl.FourierKANLinear(
        input_dim=i, output_dim=o, grid_size=4, **F64),
        lambda i, o: kl.FourierKANLinear(i, o, grid_size=4, **T64)),
    "TaylorKAN": (lambda i, o: jkl.TaylorKANLinear(input_dim=i, output_dim=o,
                                                   **F64),
                  lambda i, o: kl.TaylorKANLinear(i, o, **T64)),
    "ReLUKAN": (lambda i, o: jkl.ReLUKANLinear(input_dim=i, output_dim=o,
                                               g=3, k=2, **F64),
                lambda i, o: kl.ReLUKANLinear(i, o, g=3, k=2, **T64)),
    "ReLUKAN_fixed": (lambda i, o: jkl.ReLUKANLinear(
        input_dim=i, output_dim=o, g=2, k=2, train_ab=False, **F64),
        lambda i, o: kl.ReLUKANLinear(i, o, g=2, k=2, train_ab=False,
                                      **T64)),
    **{f"WavKAN_{wt}": (
        lambda i, o, wt=wt: jkl.WavKANLinear(input_dim=i, output_dim=o,
                                             wavelet_type=wt, **F64),
        lambda i, o, wt=wt: kl.WavKANLinear(i, o, wavelet_type=wt, **T64))
       for wt in ("mexican_hat", "morlet", "dog", "meyer", "shannon")},
}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * max(np.max(np.abs(want)),
                                                   1e-300), what


def _variables(jm, x, rng):
    """JAX's init moved off it: every parameter plus N(0, 0.1) (a scale,
    a norm's weight and a running variance stay positive), the running
    mean N(0, 0.2)."""
    v = jm.init(jax.random.PRNGKey(0), jnp.asarray(x), train=False)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        a = np.asarray(a, np.float64)
        if "'var'" in name:
            return rng.uniform(0.5, 2.0, a.shape)
        if "'mean'" in name:
            return rng.normal(0.0, 0.2, a.shape)
        if "phase" in name:     # ReLU-KAN's windows keep their order
            return a + rng.uniform(-0.05, 0.05, a.shape)
        return a + rng.normal(0.0, 0.1, a.shape)

    return jax.tree_util.tree_map_with_path(draw, v)


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("family", sorted(FAMILIES))
def test_family_matches_jax_f64(family, train):
    jctor, tctor = FAMILIES[family]
    rng = np.random.RandomState(len(family) + 7 * train)
    i, o = 5, 4
    x = rng.normal(0.0, 0.8, (6, i))
    jm = jctor(i, o)
    variables = _variables(jm, x, rng)
    params = variables["params"]
    stats = variables.get("batch_stats")
    g = rng.normal(0.0, 1.0, (6, o))

    def f(xx, p):
        v = {"params": p, **({"batch_stats": stats} if stats else {})}
        if stats:
            y, mut = jm.apply(v, xx, train=train, mutable=["batch_stats"])
            return y, mut["batch_stats"]
        return jm.apply(v, xx, train=train), None

    want, jstats = f(jnp.asarray(x), params)
    jdx, jdp = jax.grad(lambda xx, p: jnp.sum(f(xx, p)[0] * g),
                        argnums=(0, 1))(jnp.asarray(x), params)
    tm = tctor(i, o)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm.train(train)(xt)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y.detach(), want, "y")
    _close(xt.grad, jdx, "dx")
    want_grads = state_dict_from_jax(jdp)
    assert {n for n, _ in tm.named_parameters()} == set(want_grads)
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name], "d " + name)
    if stats:
        for name in ("mean", "var"):
            _close(getattr(tm.norm, name), jstats["BatchNorm_0"][name], name)


def test_kan_linear_segment_deactivation_matches_jax(monkeypatch):
    """Train mode with p_deactivate 0.5: the port's (out, in) mask (U < p
    from its generator) given to JAX; the output and the gradients, and
    some edges on the chord, some on the spline."""
    rng = np.random.RandomState(3)
    i, o = 6, 5
    x = rng.normal(0.0, 0.8, (7, i))
    jm = jkl.KANLinear(input_dim=i, output_dim=o, p_deactivate=0.5, **F64)
    variables = _variables(jm, x, rng)
    tm = kl.KANLinear(i, o, p_deactivate=0.5, **T64)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    u = rng.uniform(0.0, 1.0, (o, i))
    monkeypatch.setattr(kl, "uniform", lambda shape, device, gen=None:
                        torch.from_numpy(u))
    mask = u < 0.5
    assert 0 < mask.sum() < mask.size
    monkeypatch.setattr(jreg, "segment_deactivation_mask",
                        lambda rng_, out_f, in_f, p: jnp.asarray(mask))
    g = rng.normal(0.0, 1.0, (7, o))

    def f(xx, p):
        return jm.apply({"params": p}, xx, train=True,
                        rngs={"dropout": jax.random.PRNGKey(1)})

    want = f(jnp.asarray(x), variables["params"])
    jdx, jdp = jax.grad(lambda xx, p: jnp.sum(f(xx, p) * g),
                        argnums=(0, 1))(jnp.asarray(x), variables["params"])
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm.train()(xt)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y.detach(), want, "y")
    _close(xt.grad, jdx, "dx")
    want_grads = state_dict_from_jax(jdp)
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name], "d " + name)
    plain = tm.eval()(xt).detach()
    assert np.abs(plain.numpy() - np.asarray(want)).max() > 1e-3


def _golden_modules(name, sd):
    """(JAX module, converted reference params, norm scope, port module)
    of a ``mlp_*`` golden, as tests/test_golden_mlp.py converts it."""
    if name == "mlp_kan":
        grid = np.asarray(sd["grid"])
        grid = tuple(grid[0] if grid.ndim == 2 else grid)
        return (jkl.KANLinear(input_dim=12, output_dim=5,
                              grid_override=grid, **F64),
                {"base_w": T(sd["base_weight"]),
                 "spline_w": T(sd["spline_weight"].reshape(5, 12 * 8)),
                 "prelu": np.asarray(sd["prelu.weight"]).reshape(()),
                 "__norm_params__": {"weight": sd["layer_norm.weight"],
                                     "bias": sd["layer_norm.bias"]}},
                "LayerNorm_0", kl.KANLinear(12, 5, grid_override=grid,
                                            **T64))
    if name == "mlp_fastkan":
        grid = tuple(np.asarray(sd["rbf.grid"]).ravel())
        return (jkl.FastKANLinear(input_dim=12, output_dim=5,
                                  grid_override=grid, **F64),
                {"spline_w": T(sd["spline_linear.weight"]),
                 "base_w": T(sd["base_linear.weight"]),
                 "base_b": sd["base_linear.bias"],
                 "__norm_params__": {"weight": sd["layernorm.weight"],
                                     "bias": sd["layernorm.bias"]}},
                "LayerNorm_0", kl.FastKANLinear(12, 5, grid_override=grid,
                                                **T64))
    if name == "mlp_cheby":
        return (jkl.ChebyKANLinear(input_dim=12, output_dim=5, **F64),
                {"coeffs": sd["cheby_coeffs"]}, None,
                kl.ChebyKANLinear(12, 5, **T64))
    if name == "mlp_legendre":
        return (jkl.LegendreKANLinear(input_dim=12, output_dim=5, **F64),
                {"base_w": T(sd["base_weight"]),
                 "poly_w": T(sd["poly_weight"]),
                 "__norm_params__": {"weight": sd["layer_norm.weight"],
                                     "bias": sd["layer_norm.bias"]}},
                "LayerNorm_0", kl.LegendreKANLinear(12, 5, **T64))
    if name == "mlp_gram":
        return (jkl.GRAMKANLinear(input_dim=12, output_dim=5, **F64),
                {"base_w": T(sd["base_weights"]),
                 "coeffs": sd["grams_basis_weights"],
                 "beta_weights": sd["beta_weights"],
                 "__norm_params__": {"weight": sd["norm.weight"],
                                     "bias": sd["norm.bias"]}},
                "LayerNorm_0", kl.GRAMKANLinear(12, 5, **T64))
    if name in ("mlp_jacobi", "mlp_bernstein"):
        fam = name[4:]
        jcls, tcls = {"jacobi": (jkl.JacobiKANLinear, kl.JacobiKANLinear),
                      "bernstein": (jkl.BersnsteinKANLinear,
                                    kl.BersnsteinKANLinear)}[fam]
        return (jcls(input_dim=12, output_dim=5, **F64),
                {"base_w": T(sd["base_weights"]),
                 "coeffs": sd[f"{fam}_coeffs"],
                 "__norm_params__": {"weight": sd["norm.weight"],
                                     "bias": sd["norm.bias"]}},
                "LayerNorm_0", tcls(12, 5, **T64))
    if name in EINSUM:
        fam, key, extra = EINSUM[name]
        return (jkl._EinsumOnlyKanLinear(input_dim=12, output_dim=5,
                                         family=fam, **extra, **F64),
                {"coeffs": sd[key]}, None,
                kl._EinsumOnlyKanLinear(12, 5, family=fam, **extra, **T64))
    if name == "mlp_fourier":
        return (jkl.FourierKANLinear(input_dim=12, output_dim=5,
                                     grid_size=3, **F64),
                {"coeffs": sd["fouriercoeffs"], "bias": sd["bias"]}, None,
                kl.FourierKANLinear(12, 5, grid_size=3, **T64))
    if name == "mlp_taylor":
        return (jkl.TaylorKANLinear(input_dim=12, output_dim=5, **F64),
                {"coeffs": sd["coeffs"], "bias": sd["bias"]}, None,
                kl.TaylorKANLinear(12, 5, **T64))
    if name == "mlp_relukan":
        w = sd["equal_size_conv.weight"]
        return (jkl.ReLUKANLinear(input_dim=12, output_dim=5, g=5, k=3,
                                  **F64),
                {"phase_low": sd["phase_low"],
                 "phase_high": sd["phase_high"],
                 "conv_w": w.reshape(w.shape[0], -1).T,
                 "conv_b": sd["equal_size_conv.bias"]}, None,
                kl.ReLUKANLinear(12, 5, g=5, k=3, **T64))
    wt = "mexican_hat" if name == "mlp_wavkan" else name[len("mlp_wavkan_"):]
    return (jkl.WavKANLinear(input_dim=12, output_dim=5, wavelet_type=wt,
                             **F64),
            {"scale": sd["scale"], "translation": sd["translation"],
             "wavelet_w": sd["wavelet_weights"], "base_w": sd["weight1"],
             "__norm_params__": {"weight": sd["bn.weight"],
                                 "bias": sd["bn.bias"]},
             "__norm_stats__": {"mean": sd["bn.running_mean"],
                                "var": sd["bn.running_var"]}},
            "BatchNorm_0", kl.WavKANLinear(12, 5, wavelet_type=wt, **T64))


EINSUM = {"mlp_bessel": ("bessel", "bessel_coeffs", {}),
          "mlp_fibonacci": ("fibonacci", "fib_coeffs", {}),
          "mlp_gegenbauer": ("gegenbauer", "gegenbauer_coeffs",
                             {"alpha": 0.5}),
          "mlp_hermite": ("hermite", "hermite_coeffs", {}),
          "mlp_laguerre": ("laguerre", "laguerre_coeffs", {"alpha": 1.0}),
          "mlp_lucas": ("lucas", "lucas_coeffs", {})}
GOLDENS = ["mlp_kan", "mlp_fastkan", "mlp_cheby", "mlp_legendre", "mlp_gram",
           "mlp_jacobi", "mlp_bernstein", *EINSUM, "mlp_fourier",
           "mlp_taylor", "mlp_relukan", "mlp_wavkan",
           *(f"mlp_wavkan_{wt}" for wt in ("morlet", "dog", "meyer",
                                           "shannon"))]


@pytest.mark.parametrize("name", GOLDENS)
def test_mlp_golden_through_the_jax_converter(name):
    x, y_ref, sd = load_golden(name)
    jm, converted, scope, tm = _golden_modules(name, sd)
    variables = graft(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                              train=False), converted, norm_scope=scope)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    y = tm.eval()(torch.from_numpy(np.asarray(x)))
    want = np.asarray(y_ref)
    assert np.abs(y.detach().numpy() - want).max() <= \
        1e-9 * max(np.abs(want).max(), 1.0), name


def test_golden_list_is_complete():
    import os

    from golden_utils import GOLDEN_DIR
    assert len(GOLDENS) == 21
    assert sorted(GOLDENS) == sorted(
        f[:-4] for f in os.listdir(GOLDEN_DIR) if f.startswith("mlp_"))
