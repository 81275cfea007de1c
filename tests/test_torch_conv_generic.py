"""The plain route of the port's KAN conv (groups, stride and dilation: the
JAX module's XLA path) and the gate that chooses it.

* The reference goldens ``conv2d_{kan,cheby,gram}_g2s2`` and
  ``conv2d_{kan,cheby}_k5d2`` through the JAX package's
  ``convert_kan_conv`` and the port's ``from_jax``, at the JAX golden
  tests' 1e-9.
* ``KanConvND`` ``kan``, ``cheby``, ``gram`` with groups 2, stride 2,
  dilation 2 against the JAX module in float64, in eval and train mode
  (BatchNorm's running statistics, channel dropout with JAX's own mask):
  outputs and the gradients of x and every parameter within 1e-10 of the
  largest entry.
* The gate: ``kernel_eligible`` equals the JAX module's choice of its
  Pallas kernels (a family of ``_FUSABLE``, float32, no channel dropout
  before the basis, and ``supported(...) or wide_supported(...)``) on
  every config of a grid (family, groups, stride, dilation, kernel size,
  padding, dtype, dropout).  JAX's ``supported`` and ``wide_supported``
  also hold a shape to the TPU's VMEM budget, which the port's gate leaves
  to the CUDA kernels' own launch configs: of MobileNetV3-small's 22 1x1
  convs, the two at 56 x 56 fail only that budget (the test shows it), and
  the port runs the kernels on all 22.  A CPU conv that fails the gate
  adds one to the plain-route count and never reaches the kernels'
  wrapper, one that passes it runs the wrapper's plain version.
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
from convkan_tpu.utils.norms import BatchNorm as JaxBatchNorm
from convkan_tpu.utils.torch_compat import convert_kan_conv
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND, kernel_eligible
from convkan_tpu_torch.ops import dropout as dlib
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-10
KW = {"kan": dict(grid_size=5, spline_order=3), "cheby": dict(degree=3),
      "gram": dict(degree=3)}


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


@pytest.mark.parametrize("name,family,kw", [
    ("conv2d_kan_g2s2", "kan", dict(groups=2, stride=2, padding=1)),
    ("conv2d_cheby_g2s2", "cheby", dict(groups=2, stride=2, padding=1)),
    ("conv2d_gram_g2s2", "gram", dict(groups=2, stride=2, padding=1)),
    ("conv2d_kan_k5d2", "kan", dict(kernel_size=5, dilation=2, padding=4)),
    ("conv2d_cheby_k5d2", "cheby",
     dict(kernel_size=5, dilation=2, padding=4))])
def test_golden_through_the_jax_converter(name, family, kw):
    """The reference conv (6 -> 8) in eval mode: its state_dict through
    convert_kan_conv into the JAX module, the JAX variables through
    from_jax into the port's (float64), against the golden y; every call
    takes the plain route."""
    x, y_ref, sd = load_golden(name)
    kw = {"kernel_size": 3, **kw, **KW[family]}
    if family == "kan":
        kw["grid_override"] = tuple(np.asarray(sd["grid"]).ravel()[:12])
    jm = JaxKanConvND(family=family, input_dim=6, output_dim=8, ndim=2,
                      param_dtype=jnp.float64, **kw)
    xh = nchw_to_nhwc(x)
    variables = graft(jm.init(jax.random.PRNGKey(0), xh, train=False),
                      convert_kan_conv(sd, family, kw.get("groups", 1)))
    tm = KanConvND(family, 6, 8, device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    kc.reset_launches()
    y = tm.eval()(torch.from_numpy(xh.copy()))
    assert kc.plain_calls[kc.PLAIN] == 1
    assert_close(y.detach().numpy(), nchw_to_nhwc(y_ref), name=name)


def _intercept_dropout_masks(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            masks.append(np.asarray(out != 0))
        return out
    return interceptor


def _draw(jm, x, rng):
    shapes = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0),
                                            jnp.asarray(x), train=False))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        return (rng.normal(1.0, 0.3, s.shape) if "'weight'" in name else
                rng.normal(0.0, 0.5, s.shape) if "'mean'" in name else
                rng.uniform(0.5, 2.0, s.shape) if "'var'" in name else
                np.full(s.shape, 0.25) if "prelu" in name else
                rng.normal(0.0, 0.3, s.shape))

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("family", ["kan", "cheby", "gram"])
@pytest.mark.parametrize("cfg", [dict(groups=2, stride=2, padding=1),
                                 dict(dilation=2, padding=2),
                                 dict(groups=4, kernel_size=1)])
@pytest.mark.parametrize("train", [False, True])
def test_plain_route_matches_jax_f64(family, cfg, train, monkeypatch):
    C, O = 4, 8
    rng = np.random.RandomState(len(family) + 10 * train + len(cfg))
    x = rng.normal(0.0, 1.0, (3, 7, 7, C))
    kw = {"kernel_size": 3, **cfg, **KW[family], "dropout": 0.25}
    jm = JaxKanConvND(family=family, input_dim=C, output_dim=O,
                      norm_layer=JaxBatchNorm, param_dtype=jnp.float64, **kw)
    variables = _draw(jm, x, rng)
    stats = variables["batch_stats"]
    masks = []

    def f(xx, p):
        y, mut = jm.apply({"params": p, "batch_stats": stats}, xx,
                          train=train, mutable=["batch_stats"],
                          rngs={"dropout": jax.random.PRNGKey(5)})
        return y, mut["batch_stats"]

    want, jstats = f(jnp.asarray(x), variables["params"])
    g = rng.normal(0.0, 1.0, want.shape)
    with fnn.intercept_methods(_intercept_dropout_masks(masks)):
        _, (jdx, jdp) = jax.value_and_grad(
            lambda xx, p: jnp.sum(f(xx, p)[0] * g), argnums=(0, 1))(
            jnp.asarray(x), variables["params"])
    tm = KanConvND(family, C, O, norm_layer="BatchNorm2d", device="cpu",
                   dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    if train:
        assert len(masks) == 1
        keep = masks[0][:, :1, :1, :]
        assert (masks[0] == keep).all() and 0 < keep.sum() < keep.size
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
    for name in ("mean", "var"):
        _close(getattr(tm.norm, name), jstats["BatchNorm_0"][name], name)


def _jax_gate(family, groups, stride, dilation, k, pad, H, C, O, dtype,
              pre_basis_dropout):
    """The JAX module's choice of its Pallas kernels (_maybe_fused with
    use_pallas=True) for these arguments."""
    if family not in JaxKanConvND._FUSABLE or dtype != torch.float32 or \
            pre_basis_dropout:
        return False
    K = {"kan": 8, "cheby": 4, "gram": 4, "fastkan": 5}[family]
    has_base = JAX_FAMILIES[family].has_base
    return bool(supported(2, stride, dilation, groups, k, H, H, C, K, O, pad)
                or wide_supported(2, stride, dilation, groups, k, H, H, C, K,
                                  O, pad, has_base))


# MobileNetV3-small's KAN convs at 224^2, width 1.0, in order: the stem's
# input plane (224, 3, 16), then the 1x1 stride-1 convs (H, C, O)
MNV3_SMALL_CONVS = [
    (224, 3, 16), (56, 16, 16), (56, 16, 72), (28, 72, 24), (28, 24, 88),
    (28, 88, 24), (28, 24, 96), (14, 96, 40), (14, 40, 240), (14, 240, 40),
    (14, 40, 240), (14, 240, 40), (14, 40, 120), (14, 120, 48),
    (14, 48, 144), (14, 144, 48), (14, 48, 288), (7, 288, 96),
    (7, 96, 576), (7, 576, 96), (7, 96, 576), (7, 576, 96), (7, 96, 576)]


def test_gate_matches_jax_on_a_grid_of_configs():
    n_kernel = n_plain = 0
    for family, groups, stride, dilation, k, dtype, drop in itertools.product(
            ("kan", "cheby", "gram", "fastkan"), (1, 2), (1, 2), (1, 2),
            (1, 3, 5, 7, 9), (torch.float32, torch.float64), (False, True)):
        pre = drop and JAX_FAMILIES[family].dropout_site not in ("output",
                                                                 "input")
        for pad in (0, k // 2):
            want = _jax_gate(family, groups, stride, dilation, k, pad, 9, 4,
                             8, dtype, pre)
            got = kernel_eligible(family, stride, dilation, groups, k,
                                  pad, 9, 9, dtype, pre)
            assert got == want, (family, groups, stride, dilation, k, pad,
                                 dtype, drop)
            n_kernel += got
            n_plain += not got
    assert n_kernel > 30 and n_plain > 300


@pytest.mark.parametrize("family", ["kan", "cheby", "fastkan"])
def test_gate_at_mobilenetv3_small_shapes(family):
    """The 22 1x1 convs pass the port's gate for the kernels' families and
    JAX's but for the TPU VMEM budget at 56 x 56 (the same convs at 28 x 28
    pass JAX's); none passes for FastKAN; the strided 3x3 stem passes
    neither gate."""
    shapes = MNV3_SMALL_CONVS[1:]         # the stem's conv is the first entry
    assert len(shapes) == 22 and shapes.count((14, 240, 40)) == 2
    fusable = family != "fastkan"
    for H, C, O in shapes:
        jax_ok = _jax_gate(family, 1, 1, 1, 1, 0, H, C, O, torch.float32,
                           False)
        assert jax_ok == (fusable and H != 56), (H, C, O)
        if H == 56 and fusable:        # VMEM alone: a smaller plane passes
            assert _jax_gate(family, 1, 1, 1, 1, 0, 28, C, O, torch.float32,
                             False)
        assert kernel_eligible(family, 1, 1, 1, 1, 0, H, H,
                               torch.float32) == fusable
    assert not _jax_gate(family, 1, 2, 1, 3, 1, 224, 3, 16, torch.float32,
                         False)
    assert not kernel_eligible(family, 2, 1, 1, 3, 1, 224, 224)


def test_module_routes_and_the_plain_count(monkeypatch):
    """On the CPU a conv that passes the gate runs kan_conv2d's plain
    version (no plain-route count); one that fails it (stride 2, float64,
    gram's dropout in train mode, groups 2) counts once per call and never
    reaches kan_conv2d."""
    calls = []
    real = kc.kan_conv2d_reference
    monkeypatch.setattr(kc, "kan_conv2d_reference",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    gen = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 6, 4, generator=gen)
    cases = [(dict(family="kan"), torch.float32, False, True),
             (dict(family="kan", stride=2), torch.float32, False, False),
             (dict(family="cheby"), torch.float64, False, False),
             (dict(family="gram", dropout=0.5), torch.float32, True, False),
             (dict(family="gram", dropout=0.5), torch.float32, False, True),
             (dict(family="kan", dropout=0.5), torch.float32, True, True),
             (dict(family="cheby", groups=2), torch.float32, False, False)]
    for kw, dtype, train, kernel in cases:
        conv = KanConvND(input_dim=4, output_dim=4, kernel_size=3, padding=1,
                         device="cpu", dtype=dtype, generator=gen, **kw)
        conv.train(train)
        assert conv.kernel_route(x.to(dtype)) == kernel, kw
        calls.clear()
        kc.reset_launches()
        conv(x.to(dtype))
        conv(x.to(dtype))
        assert kc.plain_calls[kc.PLAIN] == (0 if kernel else 2), kw
        assert len(calls) == (2 if kernel else 0), kw
        assert sum(kc.launches.values()) == 0
