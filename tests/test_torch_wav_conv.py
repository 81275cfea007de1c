"""Port parity for the WavKAN slice: convkan_tpu_torch.nn.wav_conv
(WavKANConvND), the WavKAN VGG16_small and a train step, against the JAX
package in float64 (max |diff| <= 1e-10 of the largest entry unless a test
says otherwise), plus the input-site dropout and the rule that CPU tensors
never reach a kernel."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.models.vgg import VGGKAN as JaxVGGKAN
from convkan_tpu.models.vgg import vggkan as jax_vggkan
from convkan_tpu.nn.wav_conv import WavKANConvND as JaxWavKANConvND
from convkan_tpu.train import data as jdata
from convkan_tpu.train import loop as jloop
from convkan_tpu.train import metrics as jmetrics
from convkan_tpu.train import state as jstate
from convkan_tpu.utils.norms import InstanceNorm as JaxInstanceNorm
from convkan_tpu_torch.factory.conv_factory import CONV_KAN_FACTORY
from convkan_tpu_torch.kernels import wav_conv2d as wc
from convkan_tpu_torch.models.vgg import vggkan
from convkan_tpu_torch.nn.wav_conv import WavKANConvND
from convkan_tpu_torch.ops import dropout as dlib
from convkan_tpu_torch.serve import build_engine, build_parser
from convkan_tpu_torch.train import loop, state
from convkan_tpu_torch.utils.from_jax import vggkan_state_dict_from_jax
from convkan_tpu_torch.utils.norms import InstanceNorm

torch.set_num_threads(1)


def _close(got, want, what, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _perturb(path, a, rng):
    """Scale 1 + 0.3 U and translation 0.5 N (off their 1 / 0 init, as
    tests/test_fused_wav.py does), weights N(0, 0.15)."""
    name = jax.tree_util.keystr(path)
    if "scale" in name:
        return 1.0 + 0.3 * rng.rand(*a.shape)
    if "translation" in name:
        return 0.5 * rng.randn(*a.shape)
    return rng.normal(0.0, 0.15, a.shape)


@pytest.mark.parametrize("wavelet_type", ["mexican_hat", "morlet", "dog",
                                          "meyer", "shannon"])
def test_module_matches_jax_f64(wavelet_type):
    """Forward and the gradients w.r.t. x and every parameter of a random
    linear functional of the output."""
    C, O = 4, 5
    rng = np.random.RandomState(len(wavelet_type))
    x = rng.normal(0, 1.0, (2, 6, 6, C))
    g = rng.normal(0, 1.0, (2, 6, 6, O))
    params = {"base_w": (3, 3, C, O), "scale": (1, O, C),
              "translation": (1, O, C), "wavelet_w": (3, 3, C, O),
              "wavelet_out_w": (1, 1, O, O)}
    params = {k: _perturb(((jax.tree_util.DictKey(k)),), np.zeros(v), rng)
              for k, v in params.items()}
    jm = JaxWavKANConvND(input_dim=C, output_dim=O, kernel_size=3, padding=1,
                         wavelet_type=wavelet_type, norm_layer=JaxInstanceNorm,
                         use_pallas=False, param_dtype=jnp.float64)

    def f(xx, p):
        y = jm.apply({"params": p}, xx, train=False)
        return jnp.sum(y * g), y

    (_, want), (jdx, jdp) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x), params)

    tm = WavKANConvND(C, O, 3, padding=1, wavelet_type=wavelet_type,
                      norm_layer=InstanceNorm,
                      device="cpu", dtype=torch.float64)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                       strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    _close(y.detach().numpy(), want, "y")
    (y * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), jdx, "dx")
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), jdp[name], name)


def test_init_and_factory_follow_jax():
    jm = JaxWavKANConvND(input_dim=3, output_dim=4, kernel_size=3, padding=1,
                         norm_layer=JaxInstanceNorm)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 5, 5, 3), jnp.float32),
        train=False))
    conv = CONV_KAN_FACTORY["WavKAN"](3, 4, 3, wav_version="base",
                                      wavelet_type="dog", device="cpu",
                                      generator=torch.Generator())
    assert {k: tuple(v.shape) for k, v in conv.state_dict().items()} == {
        k: tuple(v.shape) for k, v in shapes["params"].items()}
    assert conv.padding == 1 and conv.wavelet_type == "dog"
    assert torch.equal(conv.scale, torch.ones(1, 4, 3))
    assert torch.equal(conv.translation, torch.zeros(1, 4, 3))
    bound = np.sqrt(3.0) / np.sqrt(3 * 9)     # kaiming_uniform('linear')
    assert 0.5 * bound < conv.wavelet_w.abs().max() <= bound
    for bad in (dict(groups=2), dict(stride=2), dict(dilation=2)):
        with pytest.raises(NotImplementedError):
            CONV_KAN_FACTORY["WavKAN"](4, 4, 3, device="cpu", **bad)


def test_input_site_dropout_leaves_base_path_undropped():
    """Dropout drops whole channels of the wavelet path's input only: with
    the mix zeroed, train mode equals eval mode (the base path sees x);
    with the base path zeroed, train mode equals the wavelet path on the
    masked input."""
    conv = WavKANConvND(8, 6, 3, padding=1, dropout=0.5, device="cpu",
                        norm_layer=InstanceNorm,
                        generator=torch.Generator().manual_seed(0))
    x = torch.randn(3, 5, 5, 8, generator=torch.Generator().manual_seed(1))
    gen = lambda: torch.Generator().manual_seed(2)  # noqa: E731
    with torch.no_grad():
        mix = conv.wavelet_out_w.clone()
        conv.wavelet_out_w.zero_()
        torch.testing.assert_close(conv.train()(x, gen()),
                                   conv.eval()(x, gen()), rtol=0, atol=0)
        conv.wavelet_out_w.copy_(mix)
        conv.base_w.zero_()
        xd = dlib.channel_dropout(x, 0.5, gen())
        dropped = (xd == 0).all(dim=(1, 2))
        assert dropped.any() and not dropped.all()
        want = conv.norm(torch.matmul(
            wc.wav_conv2d(xd.contiguous(), conv.wavelet_w,
                          conv.translation[0], conv.scale[0],
                          wavelet_type="mexican_hat", padding=1),
            conv.wavelet_out_w[0, 0]))
        torch.testing.assert_close(conv.train()(x, gen()), want, rtol=0,
                                   atol=0)


@pytest.mark.parametrize("head,n_params", [((1, 1), 2158282),
                                            ((2, 2), 2162122)])
def test_vgg16_small_wavkan_logits_match_jax_f64(head, n_params):
    """The WavKAN VGG16_small from a JAX tree through the converter.  With
    train.py's (1, 1) head the trunk ends in InstanceNorm, whose
    per-channel mean is 0, so the pooled features are 0 and the logits are
    the Linear bias for every image, in JAX and in the port alike; the
    (2, 2) head keeps the last 2x2 map, so the logits see the image."""
    rng = np.random.RandomState(0)
    jm = jax_vggkan(3, 10, arch="VGG16_small", kan_conv="WavKAN",
                    classifier_type="Linear", expected_feature_shape=head)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        train=False))
    variables = jax.tree_util.tree_map_with_path(
        lambda p, s: _perturb(p, s, rng), shapes)
    assert sum(a.size for a in jax.tree_util.tree_leaves(variables)) == \
        n_params
    x = rng.normal(0.0, 1.0, (2, 32, 32, 3))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))

    tm = vggkan(3, 10, arch="VGG16_small", kan_conv="WavKAN",
                classifier_type="Linear", expected_feature_shape=head,
                device="cpu", dtype=torch.float64)
    assert tm.model_name == jm.model_name == \
        "VGGKAN_Linear_WAVKAN_VGG16_small"
    tm.load_state_dict(vggkan_state_dict_from_jax(variables), strict=True)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float64
    _close(got, want, "logits")
    bias = variables["params"]["Linear_0"]["b"]
    if head == (1, 1):
        for logits in (got, want):
            _close(logits, np.broadcast_to(bias, logits.shape), "bias only",
                   tol=1e-12)
    else:
        assert np.max(np.abs(got[1] - got[0])) > 1e-2


class _JaxVGGKANf64(JaxVGGKAN):
    """The JAX VGGKAN taking its (float32) normalized batch in float64."""

    def __call__(self, x, train: bool = True):
        if not self.is_initializing():
            x = x.astype(jnp.float64)
        return super().__call__(x, train=train)


def test_train_step_matches_jax_f64(monkeypatch):
    """One port train step against one JAX make_train_step step from the
    same float64 weights (WavKAN VGG16_kansmall with the (2, 2) head, so
    that the trunk gets a gradient; 32x32 inputs, batch 2, no dropout),
    with XLA's normalized batch on both sides (see
    tests/test_torch_train.py): the loss to 1e-8, every gradient to 1e-10
    of the largest gradient entry, the parameters after the AdamW step to
    1e-8 of their largest entry."""
    rng = np.random.RandomState(0)
    kw = dict(arch="VGG16_kansmall", kan_conv="WavKAN",
              classifier_type="Linear", expected_feature_shape=(2, 2),
              dropout_linear=0.0, conv_dropout=0.0)
    jm = _JaxVGGKANf64(input_channels=3, num_classes=10, **kw)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        train=False))["params"]
    params = jax.tree_util.tree_map_with_path(
        lambda p, s: _perturb(p, s, rng), shapes)
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
    # gradients span orders of magnitude across the trunk: held to the
    # largest gradient entry of the whole model
    largest = max(np.max(np.abs(a)) for a in jax.tree_util.tree_leaves(jgrad))
    for k, prm in tm.named_parameters():
        m, p = k.split(".")
        # every parameter, the first conv's too, sees the loss
        assert np.max(np.abs(jgrad[m][p])) > 1e-6 * largest, k
        assert np.max(np.abs(prm.grad.numpy() - jgrad[m][p])) <= \
            1e-10 * largest, k
        _close(prm.detach().numpy(), js.params[m][p], k + " after the step",
               tol=1e-8)


def test_cpu_wavkan_never_reaches_a_kernel_entry(monkeypatch):
    """The CPU path runs the plain versions forward and backward; the C
    entries are never looked up."""
    def refuse(name):
        raise AssertionError(f"kernel entry {name} reached on the CPU")

    monkeypatch.setattr(wc, "_fn", refuse)
    wc.reset_launches()
    m = vggkan(3, 10, arch="VGG16_kansmall", kan_conv="WavKAN",
               classifier_type="Linear", device="cpu",
               generator=torch.Generator().manual_seed(0))
    m(torch.randn(2, 16, 16, 3)).square().sum().backward()
    assert m.WavKANConvND_1.wavelet_w.grad is not None
    assert sum(wc.launches.values()) == 0


def test_serve_cli_builds_the_wavkan_model():
    args = build_parser().parse_args(
        ["--arch", "VGG16_kansmall", "--kan_conv", "WavKAN", "--init_random",
         "--device", "cpu", "--buckets", "1,2"])
    engine, name = build_engine(args)
    try:
        assert name == "VGGKAN_Linear_WAVKAN_VGG16_kansmall"
        out = engine.predict(np.zeros((3, 32, 32, 3), np.uint8))
        assert out.shape == (3, 10) and np.isfinite(out).all()
    finally:
        engine.close()
