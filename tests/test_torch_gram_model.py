"""Port parity for the GRAMKAN slice as a whole: the reference golden of one
Gram conv (``tests/goldens/conv2d_gram_g1.npz``, converted by the JAX
package's ``torch_compat`` and carried over by utils/from_jax.py), the
GRAMKAN VGG16_kansmall (logits, and the (1, 1) head seeing the image) and
one train step against the JAX package in float64 (beta_weights among the
gradients and the updated parameters), plus the serving CLI and the rule
that CPU tensors never reach a kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import torch
from golden_utils import assert_close, load_golden, nchw_to_nhwc

from convkan_tpu.models.vgg import VGGKAN as JaxVGGKAN
from convkan_tpu.models.vgg import vggkan as jax_vggkan
from convkan_tpu.train import data as jdata
from convkan_tpu.train import loop as jloop
from convkan_tpu.train import metrics as jmetrics
from convkan_tpu.train import state as jstate
from convkan_tpu.utils.torch_compat import convert_kan_conv
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.models.vgg import vggkan
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.serve import build_engine, build_parser
from convkan_tpu_torch.train import loop, state
from convkan_tpu_torch.utils.from_jax import vggkan_state_dict_from_jax

torch.set_num_threads(1)

KW = dict(arch="VGG16_kansmall", kan_conv="GRAMKAN",
          classifier_type="Linear")
# sum of C*O over the 13 VGG16_kansmall convs
KANSMALL_CO = 25560


def _close(got, want, what, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def test_golden_gram_conv_through_the_jax_converter():
    """The reference GRAMKAN conv (6 -> 8, groups 1, degree 3, with its
    beta_weights): its state_dict through the JAX package's
    convert_kan_conv, then from_jax with no special case for beta, into the
    port's KanConvND in float64; its output against the golden y at the
    JAX golden test's tolerance (1e-9 of max(1, |y|))."""
    x, y_ref, sd = load_golden("conv2d_gram_g1")
    params = convert_kan_conv(sd, "gram", 1)
    assert set(params) == {"base_w", "poly_w", "beta_weights"}
    conv = KanConvND("gram", 6, 8, 3, padding=1, degree=3, device="cpu",
                     dtype=torch.float64)
    conv.load_state_dict(vggkan_state_dict_from_jax(params), strict=True)
    assert np.abs(conv.beta_weights.detach().numpy()).min() > 0
    y = conv.eval()(torch.from_numpy(nchw_to_nhwc(x).copy()))
    assert y.dtype == torch.float64
    assert_close(y.detach().numpy(), nchw_to_nhwc(y_ref),
                 name="conv2d_gram_g1")


def _jax_params(jm, rng):
    """The JAX model's tree with every leaf N(0, 0.15) (a float64 draw:
    the seeded init of the two packages differs)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        train=False))
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.15, s.shape), shapes)


def test_vgg16_kansmall_gram_logits_match_jax_f64():
    """The GRAMKAN VGG16_kansmall from a JAX tree through the converter
    (13 convs of base_w, poly_w and beta_weights), train.py's (1, 1) head:
    a GRAMKAN conv ends in SiLU after its InstanceNorm, so unlike the
    ChebyKAN and WavKAN trunks its pooled features, and so its logits,
    depend on the image."""
    rng = np.random.RandomState(0)
    jm = jax_vggkan(3, 10, **KW)
    variables = _jax_params(jm, rng)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert sum(a.size for _, a in leaves) == \
        9 * 5 * KANSMALL_CO + 13 * 4 + 650
    names = {jax.tree_util.keystr(p) for p, _ in leaves}
    assert sum("beta_weights" in n for n in names) == 13
    x = rng.normal(0.0, 1.0, (2, 32, 32, 3))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))

    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **KW)
    assert tm.expected_feature_shape == (1, 1)
    assert tm.model_name == jm.model_name == \
        "VGGKAN_Linear_GRAMKAN_VGG16_kansmall"
    tm.load_state_dict(vggkan_state_dict_from_jax(variables), strict=True)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float64
    _close(got, want, "logits")
    assert np.max(np.abs(got[1] - got[0])) > 1e-3
    bias = np.asarray(variables["params"]["Linear_0"]["b"])
    assert np.max(np.abs(got - bias)) > 1e-3


def test_vgg16_small_gram_head_sees_the_image():
    """With seeded init weights (float32, the CPU path) the default (1, 1)
    head's logits differ between two images."""
    m = vggkan(3, 10, arch="VGG16_small", kan_conv="GRAMKAN",
               classifier_type="Linear", device="cpu",
               generator=torch.Generator().manual_seed(0)).eval()
    with torch.no_grad():
        y = m(torch.randn(2, 32, 32, 3, generator=torch.Generator()
                          .manual_seed(1)))
    assert torch.isfinite(y).all() and (y[1] - y[0]).abs().max() > 1e-4


class _JaxVGGKANf64(JaxVGGKAN):
    """The JAX VGGKAN taking its (float32) normalized batch in float64."""

    def __call__(self, x, train: bool = True):
        if not self.is_initializing():
            x = x.astype(jnp.float64)
        return super().__call__(x, train=train)


def test_train_step_matches_jax_f64(monkeypatch):
    """One port train step against one JAX make_train_step step from the
    same float64 weights (GRAMKAN VGG16_kansmall, (1, 1) head; 32x32
    inputs, batch 2, no dropout), with XLA's normalized batch on both sides
    (see tests/test_torch_train.py): the loss to 1e-8, every gradient
    (each conv's beta_weights included, whose entries 0 and 3 get exactly
    0) to 1e-10 of the largest gradient entry, and the parameters after
    the AdamW step (the same weight decay on beta_weights as on the
    weights, the per-epoch ExponentialLR) to 1e-8 of their largest entry
    plus what the gradients' difference moves Adam's first step by (lr /
    eps times it: see tests/test_torch_cheby_model.py)."""
    rng = np.random.RandomState(1)
    kw = dict(KW, dropout_linear=0.0, conv_dropout=0.0)
    jm = _JaxVGGKANf64(input_channels=3, num_classes=10, **kw)
    params = _jax_params(jm, rng)["params"]
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=2)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={}, tx=tx)
    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(vggkan_state_dict_from_jax(js), strict=True)
    ts = state.create_train_state(tm, 1e-3, 1e-3, 0.8, steps_per_epoch=2,
                                  generator=torch.Generator())
    xla_normalize = jax.jit(jdata.normalize_batch, static_argnums=1)
    monkeypatch.setattr(loop, "train_batch", lambda x, ds, aug, **_: (
        torch.from_numpy(np.array(xla_normalize(jnp.asarray(x.numpy()),
                                                ds)))))
    x = rng.randint(0, 256, (2, 32, 32, 3), np.uint8)
    y = rng.randint(0, 10, 2).astype(np.int32)
    xn = xla_normalize(jnp.asarray(x), "CIFAR10")
    jgrad = jax.jit(jax.grad(lambda p: jmetrics.cross_entropy_loss(
        jm.apply({"params": p}, xn), jnp.asarray(y))))(js.params)
    js, jloss = jloop.make_train_step(jm, "CIFAR10", augment=False)(
        js, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    tloss = loop.make_train_step(tm, "CIFAR10", augment=False)(
        ts, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(tloss.item() - float(jloss)) <= 1e-8
    largest = max(np.max(np.abs(a)) for a in jax.tree_util.tree_leaves(jgrad))
    names = [k for k, _ in tm.named_parameters()]
    assert len(names) == 13 * 3 + 2 and not any("prelu" in k for k in names)
    assert sum(k.endswith("beta_weights") for k in names) == 13
    for k, prm in tm.named_parameters():
        m, p = k.split(".")
        assert np.max(np.abs(jgrad[m][p])) > 1e-8 * largest, k
        assert np.max(np.abs(prm.grad.numpy() - jgrad[m][p])) <= \
            1e-10 * largest, k
        if p == "beta_weights":
            assert prm.grad[0] == 0 and prm.grad[3] == 0, k
        want = np.asarray(js.params[m][p])
        slope = 1e-3 / 1e-8 * np.max(np.abs(prm.grad.numpy() - jgrad[m][p]))
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + slope, k + " after the step"


def test_cpu_gram_model_never_reaches_a_kernel_entry(monkeypatch):
    """The CPU path runs the plain versions forward and backward (the first
    conv's beta too); the C entries are never looked up."""
    def refuse(name):
        raise AssertionError(f"kernel entry {name} reached on the CPU")

    monkeypatch.setattr(kc, "_fn", refuse)
    kc.reset_launches()
    m = vggkan(3, 10, device="cpu",
               generator=torch.Generator().manual_seed(0), **KW)
    m(torch.randn(2, 32, 32, 3), torch.Generator().manual_seed(1)) \
        .square().sum().backward()
    assert m.KanConvND_1.poly_w.grad is not None
    assert m.KanConvND_0.beta_weights.grad[1:3].abs().min() > 0
    assert sum(kc.launches.values()) == 0


def test_serve_cli_builds_the_gramkan_model():
    """--kan_conv GRAMKAN with InstanceNorm serves the (1, 1) head of
    train.py: its logits see the image (a fresh BatchNorm's running
    statistics, 0 and 1, do not renormalize the trunk's shrinking signal,
    so there the seeded logits are the bias up to rounding)."""
    args = build_parser().parse_args(
        ["--arch", "VGG16_kansmall", "--kan_conv", "GRAMKAN",
         "--kan_norm_layer", "InstanceNorm2d",
         "--init_random", "--device", "cpu", "--buckets", "1,2"])
    engine, name = build_engine(args)
    try:
        assert name == "VGGKAN_Linear_GRAMKAN_VGG16_kansmall"
        assert engine.model.expected_feature_shape == (1, 1)
        assert engine.model.KanConvND_0.basis == kc.gram_basis(3)
        imgs = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 3),
                                                np.uint8)
        out = engine.predict(imgs)
        assert out.shape == (3, 10) and np.isfinite(out).all()
        assert np.abs(out[1] - out[0]).max() > 1e-5
    finally:
        engine.close()
