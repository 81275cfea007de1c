"""Port parity for the static-basis KAN convs (Jacobi, Bernstein, Bessel,
Fibonacci, Fourier, Gegenbauer, Hermite, Laguerre, Lucas, Taylor on the
kernels' route, Legendre on the plain route) against the JAX package.

* The reference goldens ``conv2d_<family>_g1`` (the plain route, which
  float64 takes, and the kernel route forced: on the CPU the kernels'
  plain version; Legendre's plain route only) and ``conv2d_<family>_g2s2``
  (groups 2, stride 2: the plain route) of all eleven families, through
  the JAX package's ``convert_kan_conv`` and the port's ``from_jax``, in
  float64 at the JAX golden tests' 1e-9.
* ``KanConvND`` against the JAX module in float64, in eval and train mode
  with channel dropout 0.25 (JAX's own keep mask, recorded by a flax
  method interceptor, given to the port): at the output (the kernel
  route), on the squashed input before the basis (Bernstein, Legendre:
  "basis_input") and over the expanded rows (Jacobi: "basis"), and with
  groups 2 and stride 2 (the plain route); non-default a, b, alpha and
  alpha_param; outputs and the gradients of x and every parameter within
  1e-10 of the largest entry; where float32 would take the kernel route,
  that route (its plain version) is forced.
* The gate: ``kernel_eligible`` equals the JAX module's choice of its
  Pallas kernels for the new families on a grid of configs.
"""

import itertools

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_utils import assert_close, graft, load_golden, nchw_to_nhwc

from convkan_tpu.kernels.fused_kan_conv import supported
from convkan_tpu.kernels.wide_kan_conv import wide_supported
from convkan_tpu.nn.kan_conv import FAMILIES as JAX_FAMILIES
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.utils.torch_compat import convert_kan_conv
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND, kernel_eligible
from convkan_tpu_torch.ops import dropout as dlib
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-10
FAMILIES = ("jacobi", "bernstein", "bessel", "fibonacci", "fourier",
            "gegenbauer", "hermite", "laguerre", "lucas", "taylor",
            "legendre")
# the JAX golden tests' hyperparameters (tests/test_golden_conv.py)
GOLDEN_KW = {"jacobi": dict(degree=3, a=1.0, b=1.0), "fourier":
             dict(grid_size=3), "gegenbauer": dict(degree=3, alpha_param=0.5),
             "laguerre": dict(degree=3, alpha=1.0)}
# non-default hyperparameters for the module tests
MODULE_KW = {"jacobi": dict(a=0.5, b=1.5), "gegenbauer":
             dict(alpha_param=0.5), "laguerre": dict(alpha=0.5),
             "fourier": dict(grid_size=2)}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("tag", ["g1", "g2s2"])
def test_golden_through_the_jax_converter(family, tag):
    """The reference conv (6 -> 8) in eval mode: its state_dict through
    convert_kan_conv into the JAX module, the JAX variables through
    from_jax into the port's (float64), against the golden y, on the plain
    route and (g1 but Legendre) the kernel route's plain version."""
    x, y_ref, sd = load_golden(f"conv2d_{family}_{tag}")
    kw = dict(kernel_size=3, padding=1, **GOLDEN_KW.get(family,
                                                       dict(degree=3)))
    if tag == "g2s2":
        kw.update(groups=2, stride=2)
    jm = JaxKanConvND(family=family, input_dim=6, output_dim=8, ndim=2,
                      param_dtype=jnp.float64, **kw)
    xh = nchw_to_nhwc(x)
    variables = graft(jm.init(jax.random.PRNGKey(0), xh, train=False),
                      convert_kan_conv(sd, family, kw.get("groups", 1)))
    tm = KanConvND(family, 6, 8, device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    xt = torch.from_numpy(xh.copy())
    kernel = tag == "g1" and family != "legendre"
    assert tm.kernel_route(xt.float()) == kernel
    # float64 takes the plain route; the kernel route's plain version
    # (kan_conv2d on CPU tensors) is forced where float32 would take it
    for forced in (False, True) if kernel else (False,):
        if forced:
            tm.kernel_route = lambda x: True
        kc.reset_launches()
        y = tm.eval()(xt)
        assert kc.plain_calls[kc.PLAIN] == (not forced)
        assert sum(kc.launches.values()) == 0
        assert_close(y.detach().numpy(), nchw_to_nhwc(y_ref),
                     name=f"conv2d_{family}_{tag} kernel route {forced}")


def _intercept_dropout_masks(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            masks.append(np.asarray(out != 0))
        return out
    return interceptor


def _draw(jm, x, rng):
    """The JAX module's tree with N(0, 0.3) weights, PReLU slopes 0.25."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), train=False))
    return jax.tree_util.tree_map_with_path(
        lambda p, s: np.full(s.shape, 0.25) if "prelu" in
        jax.tree_util.keystr(p) else rng.normal(0.0, 0.3, s.shape), shapes)


@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("cfg", ["g1", "g2s2"])
@pytest.mark.parametrize("train", [False, True])
def test_module_matches_jax_f64(family, cfg, train, monkeypatch):
    C, O = 4, 6
    rng = np.random.RandomState(len(family) + 10 * train + len(cfg))
    x = rng.normal(0.0, 1.0, (2, 7, 7, C))
    kw = dict(kernel_size=3, padding=1, dropout=0.25,
              **MODULE_KW.get(family, {}))
    if cfg == "g2s2":
        kw.update(groups=2, stride=2)
    jm = JaxKanConvND(family=family, input_dim=C, output_dim=O,
                      param_dtype=jnp.float64, **kw)
    params = _draw(jm, x, rng)["params"]
    for seed in range(5, 50):     # a dropout key whose mask drops some
        masks = []

        def jf(xx, p):
            return jm.apply({"params": p}, xx, train=train,
                            rngs={"dropout": jax.random.PRNGKey(seed)})

        with fnn.intercept_methods(_intercept_dropout_masks(masks)):
            y, pull = jax.vjp(jf, jnp.asarray(x), params)
        if not masks or 0 < masks[0].sum() < masks[0].size:
            break
    g = rng.normal(0.0, 1.0, y.shape)
    jdx, jdp = pull(jnp.asarray(g))
    tm = KanConvND(family, C, O, device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    if train:
        assert len(masks) == 1
        keep = masks[0][:, :1, :1, :]     # one mask per (image, channel)
        assert (masks[0] == keep).all() and 0 < keep.sum() < keep.size
        site = JAX_FAMILIES[family].dropout_site
        assert keep.shape[-1] == (C * tm.num_basis if site == "basis"
                                  else O if site == "output" else C)
        monkeypatch.setattr(dlib, "uniform", lambda shape, device, gen=None: (
            torch.from_numpy(np.where(keep, 0.0, 0.99))))
    else:
        assert not masks
    tm.train(train)
    # float64 takes the plain route: the kernel route's plain version is
    # forced where float32 would take it
    kernel = tm.kernel_route(torch.from_numpy(x).float())
    assert kernel == (cfg == "g1" and family != "legendre" and not (
        train and tm.spec.dropout_site != "output"))
    if kernel:
        tm.kernel_route = lambda x: True
    kc.reset_launches()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = tm(xt)
    (out * torch.from_numpy(g)).sum().backward()
    assert sum(kc.launches.values()) == 0
    assert kc.plain_calls[kc.PLAIN] == (not kernel)
    _close(out.detach(), y, "y")
    _close(xt.grad, jdx, "dx")
    want = state_dict_from_jax(jdp)
    for name, p in tm.named_parameters():
        _close(p.grad, want[name], "d " + name)


def _jax_gate(family, groups, stride, dilation, k, pad, H, C, O, dtype,
              pre_basis_dropout):
    """The JAX module's choice of its Pallas kernels (_maybe_fused with
    use_pallas=True) for these arguments."""
    if family not in JaxKanConvND._FUSABLE or dtype != torch.float32 or \
            pre_basis_dropout:
        return False
    K = JaxKanConvND(family=family, input_dim=C, output_dim=O,
                     kernel_size=k, grid_size=5).num_basis
    has_base = JAX_FAMILIES[family].has_base
    return bool(supported(2, stride, dilation, groups, k, H, H, C, K, O, pad)
                or wide_supported(2, stride, dilation, groups, k, H, H, C, K,
                                  O, pad, has_base))


@pytest.mark.parametrize("family", FAMILIES)
def test_gate_matches_jax_on_a_grid_of_configs(family):
    n_kernel = n_plain = 0
    for groups, stride, dilation, k, dtype, drop in itertools.product(
            (1, 2), (1, 2), (1, 2), (1, 3, 5, 9),
            (torch.float32, torch.float64), (False, True)):
        pre = drop and JAX_FAMILIES[family].dropout_site != "output"
        for pad in (0, k // 2):
            want = _jax_gate(family, groups, stride, dilation, k, pad, 9, 4,
                             8, dtype, pre)
            got = kernel_eligible(family, stride, dilation, groups, k, pad,
                                  9, 9, dtype, pre)
            assert got == want, (groups, stride, dilation, k, pad, dtype,
                                 drop)
            n_kernel += got
            n_plain += not got
    assert n_plain > 100 and (n_kernel > 5) == (family != "legendre")
