"""The port's FastKAN conv (``KanConvND("fastkan")``: channel dropout of x,
one input norm per group, the Gaussian RBF basis, a base path over act(x),
no output norm) against the JAX module in float64: outputs and the
gradients of x and of every parameter within 1e-10 of the largest entry,
in eval mode and in train mode (with JAX's own dropout mask, and the
input BatchNorms' running statistics moved as JAX moves them), at groups
1 and 2, strides 1 and 2; then the reference goldens ``conv2d_fastkan_g1``,
``_g2_bn`` (running statistics per group), ``_g2_ln`` (the trailing-axis
LayerNorm of the reference) and ``_g2s2`` through the JAX package's
``convert_kan_conv`` and the port's ``from_jax``, at the JAX golden tests'
1e-9.  FastKAN is not in the kernels' families: every call takes the plain
route (counted), on the CPU as on the card."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_utils import assert_close, graft, load_golden, nchw_to_nhwc

from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.utils.norms import resolve_norm as jax_resolve_norm
from convkan_tpu.utils.torch_compat import convert_kan_conv
from convkan_tpu_torch.factory.conv_factory import CONV_KAN_FACTORY
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.ops import dropout as dlib
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax
from convkan_tpu_torch.utils.norms import BatchNorm, LayerNorm

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _intercept_dropout_masks(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            masks.append(np.asarray(out != 0))
        return out
    return interceptor


def _draw(jm, x, rng):
    """Variables off their init: weights N(0, 0.3), a norm's weight
    N(1, 0.3), running mean N(0, 0.5), running var U(0.5, 2)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(x.shape), train=False))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        return (rng.normal(1.0, 0.3, s.shape) if "'weight'" in name else
                rng.normal(0.0, 0.5, s.shape) if "'mean'" in name else
                rng.uniform(0.5, 2.0, s.shape) if "'var'" in name else
                rng.normal(0.0, 0.3, s.shape))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("groups,stride,norm,act", [
    (1, 1, "InstanceNorm2d", "silu"), (2, 1, "BatchNorm2d", "silu"),
    (2, 2, "BatchNorm2d", "hardswish"), (1, 2, "InstanceNorm2d", "gelu")])
@pytest.mark.parametrize("train", [False, True])
def test_fastkan_conv_matches_jax_f64(groups, stride, norm, act, train,
                                      monkeypatch):
    C, O = 4, 6
    rng = np.random.RandomState(groups + 3 * stride + 7 * train)
    x = rng.normal(0.0, 1.5, (3, 7, 7, C))
    kw = dict(kernel_size=3, padding=1, groups=groups, stride=stride,
              grid_size=5, grid_range=(-2.0, 2.0), base_activation=act,
              dropout=0.25)
    jm = JaxKanConvND(family="fastkan", input_dim=C, output_dim=O,
                      norm_layer=jax_resolve_norm(norm),
                      param_dtype=jnp.float64, **kw)
    variables = _draw(jm, x, rng)
    stats = variables.get("batch_stats", {})
    assert ("input_norm_1" in stats) == (groups == 2 and norm[0] == "B")
    g = rng.normal(0.0, 1.0, (3, -(-7 // stride), -(-7 // stride), O))
    masks = []

    def f(xx, p):
        y, mut = jm.apply({"params": p, "batch_stats": stats}, xx,
                          train=train, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(3)})
        return jnp.sum(y * g), (y, mut.get("batch_stats", {}))

    with fnn.intercept_methods(_intercept_dropout_masks(masks)):
        (_, (want, jstats)), (jdx, jdp) = jax.value_and_grad(
            f, argnums=(0, 1), has_aux=True)(jnp.asarray(x),
                                             variables["params"])
    tm = KanConvND("fastkan", C, O, norm_layer=norm, device="cpu",
                   dtype=torch.float64, **kw)
    assert tm.norm is None and tm.basis is None and tm.num_basis == 5
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    if train:
        keep = masks[0][:, :1, :1, :]
        assert len(masks) == 1 and (masks[0] == keep).all()
        assert 0 < keep.sum() < keep.size
        monkeypatch.setattr(dlib, "uniform", lambda shape, device, gen=None: (
            torch.from_numpy(np.where(keep, 0.0, 0.99))))
    else:
        assert not masks
    kc.reset_launches()
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm.train(train)(xt)
    assert kc.plain_calls[kc.PLAIN] == 1
    (y * torch.from_numpy(g)).sum().backward()
    _close(y.detach(), want, "y")
    _close(xt.grad, jdx, "dx")
    want_grads = state_dict_from_jax(jdp)
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name], "d " + name)
    for name, val in state_dict_from_jax({"params": {},
                                          "batch_stats": jstats}).items():
        _close(tm.state_dict()[name], val, name)


def _golden(name, groups, stride, norm):
    x, y_ref, sd = load_golden(name)
    grid = tuple(np.asarray(sd["rbf.grid"]).ravel())
    kw = dict(kernel_size=3, padding=1, groups=groups, stride=stride,
              grid_size=8, grid_range=(-2.0, 2.0), grid_override=grid)
    jm = JaxKanConvND(family="fastkan", input_dim=6, output_dim=8, ndim=2,
                      norm_layer=jax_resolve_norm(norm),
                      param_dtype=jnp.float64, **kw)
    xh = nchw_to_nhwc(x)
    variables = graft(jm.init(jax.random.PRNGKey(0), xh, train=False),
                      convert_kan_conv(sd, "fastkan", groups))
    tm = KanConvND("fastkan", 6, 8, norm_layer=norm, device="cpu",
                   dtype=torch.float64, **kw)
    return tm, variables, xh, nchw_to_nhwc(y_ref)


@pytest.mark.parametrize("name,groups,stride,norm", [
    ("conv2d_fastkan_g1", 1, 1, "InstanceNorm2d"),
    ("conv2d_fastkan_g2_bn", 2, 1, "BatchNorm2d"),
    ("conv2d_fastkan_g2_ln", 2, 1, "LayerNorm"),
    ("conv2d_fastkan_g2s2", 2, 2, "InstanceNorm2d")])
def test_golden_through_the_jax_converter(name, groups, stride, norm):
    """The reference FastKAN conv (6 -> 8, kernel 3, pad 1, grid 8 over
    (-2, 2) with its stored centres) in eval mode, its state_dict through
    convert_kan_conv (the per-group input norms' weights and running
    statistics among them), then from_jax into the port in float64."""
    tm, variables, xh, want = _golden(name, groups, stride, norm)
    if norm == "BatchNorm2d":
        assert set(variables["batch_stats"]) == {"input_norm_0",
                                                 "input_norm_1"}
        assert isinstance(tm.input_norm_1, BatchNorm)
    if norm == "LayerNorm":
        assert isinstance(tm.input_norm_0, LayerNorm)
        assert xh.shape[-2] == 3     # the trailing axis of the reference
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    y = tm.eval()(torch.from_numpy(xh.copy()))
    assert y.dtype == torch.float64
    assert_close(y.detach().numpy(), want, name=name)


def test_trailing_axis_layer_norm_needs_in_g_columns():
    """LayerNorm(in_g) on the reference's NCHW conv input normalizes its
    last axis, which exists only when the width is in_g: other widths
    raise, as the JAX module does."""
    tm = KanConvND("fastkan", 6, 8, 3, padding=1, groups=2,
                   norm_layer="LayerNorm", device="cpu")
    tm(torch.zeros(1, 5, 3, 6))
    with pytest.raises(ValueError, match="trailing spatial axis"):
        tm(torch.zeros(1, 5, 4, 6))


def test_factory_defaults_and_the_plain_route():
    """The factory's FastKAN (grid 8 over (-2, 2), SiLU, InstanceNorm on
    the input) in float32 on the CPU: the plain route, counted, never the
    kernels' wrapper."""
    conv = CONV_KAN_FACTORY["FastKAN"](3, 4, 3, device="cpu",
                                       generator=torch.Generator())
    jm = JaxKanConvND(family="fastkan", input_dim=3, output_dim=4,
                      kernel_size=3, padding=1, grid_size=8,
                      grid_range=(-2.0, 2.0))
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 3), jnp.float32),
        train=False))
    assert {k: tuple(v.shape) for k, v in conv.state_dict().items()} == {
        k: tuple(v.shape) for k, v in state_dict_from_jax(
            jax.tree_util.tree_map(lambda a: np.zeros(a.shape),
                                   shapes)).items()} \
        == {"base_w": (3, 3, 3, 4), "poly_w": (3, 3, 24, 4)}
    assert conv.act == "silu" and conv.padding == 1
    assert conv.centers == tuple(float(v) for v in np.linspace(
        -2, 2, 8, dtype=np.float32))
    kc.reset_launches()
    conv(torch.zeros(2, 5, 5, 3))
    assert kc.plain_calls == {kc.PLAIN: 1}
    assert sum(kc.launches.values()) == 0
