"""Port parity for the convs with a BatchNorm output norm: KanConvND
(``kan``, ``cheby``, ``gram``) and the bare WavKANConvND with its defaults,
against the JAX modules in float64, in train mode (batch statistics, the
running statistics' update) and eval mode (running statistics off their
init): outputs, the running statistics and the gradients of x and every
parameter, within 1e-10 of the largest entry.  Then the reference goldens
``conv2d_kan_bn`` (with its stored knots: ``grid_override``),
``conv2d_kan_g1``, ``conv2d_cheby_g1`` and ``conv2d_wavkan_fast_*`` (every
wavelet), each through the JAX package's converters and the port's
from_jax, at the JAX golden tests' 1e-9."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_utils import assert_close, load_golden, nchw_to_nhwc

from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.nn.wav_conv import WavKANConvND as JaxWavKANConvND
from convkan_tpu.utils.norms import BatchNorm as JaxBatchNorm
from convkan_tpu.utils.torch_compat import (convert_kan_conv,
                                            convert_wavkan_conv)
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.nn.wav_conv import WavKANConv2DLayer, WavKANConvND
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax
from convkan_tpu_torch.utils.norms import BatchNorm

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want)), what


def _draw(jm, x, rng):
    """The JAX module's variables drawn off their init: weights N(0, 0.3),
    scale 1 + 0.3 U, translation 0.5 N, norm weight N(1, 0.3), bias
    N(0, 0.3), running mean N(0, 0.5), running var U(0.5, 2)."""
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), x,
                                            train=False))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        return (1.0 + 0.3 * rng.rand(*s.shape) if "scale" in name else
                0.5 * rng.randn(*s.shape) if "translation" in name else
                rng.normal(1.0, 0.3, s.shape) if "'weight'" in name else
                rng.normal(0.0, 0.5, s.shape) if "'mean'" in name else
                rng.uniform(0.5, 2.0, s.shape) if "'var'" in name else
                rng.normal(0.0, 0.3, s.shape))

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _hold_against_jax(jm, tm, x, rng, train):
    """y, the running statistics and d(x, every parameter) of sum(y * g)
    of the port's module against the JAX module's on the same variables."""
    variables = _draw(jm, jnp.asarray(x), rng)
    assert "BatchNorm_0" in variables["batch_stats"]
    g = rng.normal(0.0, 1.0, x.shape[:-1] + (tm.output_dim,))

    def f(xx, p):
        y, mut = jm.apply({"params": p,
                           "batch_stats": variables["batch_stats"]}, xx,
                          train=train, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (want, jstats)), (jdx, jdp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    tm.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    _close(y.detach().numpy(), want, "y")
    (y * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), jdx, "dx")
    want_grads = state_dict_from_jax(jdp)
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), want_grads[name], "d " + name)
    for name in ("mean", "var"):
        _close(getattr(tm.norm, name).numpy(),
               jstats["BatchNorm_0"][name], name)
    moved = not np.allclose(jstats["BatchNorm_0"]["mean"],
                            variables["batch_stats"]["BatchNorm_0"]["mean"])
    assert moved == train


@pytest.mark.parametrize("family", ["kan", "cheby", "gram"])
@pytest.mark.parametrize("train", [True, False])
def test_kan_conv_with_batchnorm_matches_jax_f64(family, train):
    C, O = 4, 6
    rng = np.random.RandomState(len(family) + 10 * train)
    x = rng.normal(0.0, 1.0, (3, 6, 6, C))
    jm = JaxKanConvND(family=family, input_dim=C, output_dim=O,
                      kernel_size=3, padding=1, norm_layer=JaxBatchNorm,
                      param_dtype=jnp.float64)
    tm = KanConvND(family, C, O, 3, padding=1, norm_layer="BatchNorm2d",
                   device="cpu", dtype=torch.float64)
    assert isinstance(tm.norm, BatchNorm)
    _hold_against_jax(jm, tm, x, rng, train)


@pytest.mark.parametrize("train", [True, False])
def test_bare_wavkan_conv_defaults_match_jax_f64(train):
    """The bare WavKANConvND built with its defaults on both sides: a
    BatchNorm output norm (the JAX class's default), also through
    WavKANConv2DLayer."""
    C, O = 4, 5
    rng = np.random.RandomState(3 + train)
    x = rng.normal(0.0, 1.0, (2, 6, 6, C))
    jm = JaxWavKANConvND(input_dim=C, output_dim=O, kernel_size=3, padding=1,
                         use_pallas=False, param_dtype=jnp.float64)
    tm = WavKANConvND(C, O, 3, padding=1, device="cpu", dtype=torch.float64)
    assert isinstance(tm.norm, BatchNorm)
    assert isinstance(WavKANConv2DLayer(C, O, 3, device="cpu").norm,
                      BatchNorm)
    _hold_against_jax(jm, tm, x, rng, train)


def _golden_variables(converted):
    """{"params", "batch_stats"} of a reference conv with a BatchNorm: the
    converted conv weights, and the norm's parameters and running
    statistics that the converter reserves for the norm's scope under
    flax's scope name."""
    params = dict(converted)
    norm_params = params.pop("__norm_params__")
    norm_stats = params.pop("__norm_stats__")
    return {"params": {**params, "BatchNorm_0": norm_params},
            "batch_stats": {"BatchNorm_0": norm_stats}}


def _knots(sd):
    return tuple(float(v) for v in np.asarray(sd["grid"]).ravel()[:12])


@pytest.mark.parametrize("name", [
    "conv2d_kan_bn", "conv2d_kan_g1", "conv2d_cheby_g1",
    "conv2d_wavkan_fast_mexican_hat",
    "conv2d_wavkan_fast_morlet", "conv2d_wavkan_fast_dog",
    "conv2d_wavkan_fast_meyer", "conv2d_wavkan_fast_shannon"])
def test_golden_through_the_jax_converters(name):
    """The reference conv (6 -> 8, groups 1, pad 1) in eval mode: its
    state_dict through convert_kan_conv / convert_wavkan_conv (the norm's
    weights and running statistics among them), then from_jax into the
    port's module in float64, against the golden y."""
    x, y_ref, sd = load_golden(name)
    if name.startswith("conv2d_kan"):
        converted = convert_kan_conv(sd, "kan", 1)
        bn = name == "conv2d_kan_bn"
        assert ("__norm_stats__" in converted) == bn
        conv = KanConvND("kan", 6, 8, 3, padding=1, grid_override=_knots(sd),
                         norm_layer="BatchNorm2d" if bn else "InstanceNorm2d",
                         device="cpu", dtype=torch.float64)
        assert conv.basis.knots == _knots(sd)
        variables = _golden_variables(converted) if bn else converted
    elif name == "conv2d_cheby_g1":
        variables = convert_kan_conv(sd, "cheby", 1)
        conv = KanConvND("cheby", 6, 8, 3, padding=1, degree=3,
                         device="cpu", dtype=torch.float64)
    else:
        converted = convert_wavkan_conv(sd, groups=1, wav_version="fast")
        conv = WavKANConvND(6, 8, 3, padding=1,
                            wavelet_type=name[len("conv2d_wavkan_fast_"):],
                            device="cpu", dtype=torch.float64)
        variables = _golden_variables(converted)
    conv.load_state_dict(state_dict_from_jax(variables), strict=True)
    y = conv.eval()(torch.from_numpy(nchw_to_nhwc(x).copy()))
    assert y.dtype == torch.float64
    assert_close(y.detach().numpy(), nchw_to_nhwc(y_ref), name=name)


def test_grid_override_replaces_the_uniform_grid():
    """Knots of a non-uniform grid reach the basis: the output differs from
    the uniform grid's, and matches the JAX module with the same knots."""
    knots = (-2.0, -1.5, -1.1, -0.6, -0.2, 0.0, 0.3, 0.7, 1.0, 1.6, 2.1, 2.5)
    rng = np.random.RandomState(0)
    x = rng.normal(0.0, 1.0, (2, 5, 5, 3))
    jm = JaxKanConvND(family="kan", input_dim=3, output_dim=4, kernel_size=3,
                      padding=1, grid_override=knots, param_dtype=jnp.float64)
    variables = _draw(jm, jnp.asarray(x), rng)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    tm = KanConvND("kan", 3, 4, 3, padding=1, grid_override=knots,
                   device="cpu", dtype=torch.float64)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    _close(got, want, "y")
    uniform = KanConvND("kan", 3, 4, 3, padding=1, device="cpu",
                        dtype=torch.float64)
    uniform.load_state_dict(tm.state_dict())
    assert np.abs(uniform.eval()(torch.from_numpy(x)).detach().numpy()
                  - got).max() > 1e-3
