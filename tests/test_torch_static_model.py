"""Port parity for KAN-VGG16_kansmall with each static basis (train.py
--model VGGKAN --kan_conv <key>: base_activation "silu", degree 3, grid 5)
against the JAX package in float64.

* Logits of the eleven families' models (and of the standard "conv"
  block's) from one JAX tree through ``from_jax``, train.py's (1, 1) head
  (PReLU or SiLU follows every norm, so the logits see the image), within
  1e-10 of the largest (Fourier's poly_w drawn at 0.1 of the others');
  the JAX model's parameter names carry over (``base_w``, ``poly_w``,
  ``prelu``; no ``prelu`` where SiLU follows).
* One train step against JAX ``make_train_step`` for Hermite (the
  recurrence with SiLU and PReLU), Jacobi (the identity base path, SiLU
  after the norm, degree-major rows) and Fourier (R = 11): the loss to
  1e-8, every gradient within 1e-10 of the largest, the parameters after
  AdamW as tests/test_torch_gram_model.py holds them.
* The serving CLI builds every key of the factory but "conv" for
  VGG16_kansmall (``--grid_size`` reaching Fourier); the CPU path never
  reaches a kernel entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.models.vgg import VGGKAN as JaxVGGKAN
from convkan_tpu.models.vgg import vggkan as jax_vggkan
from convkan_tpu.train import data as jdata
from convkan_tpu.train import loop as jloop
from convkan_tpu.train import metrics as jmetrics
from convkan_tpu.train import state as jstate
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.models.vgg import vggkan
from convkan_tpu_torch.serve import build_engine, build_parser
from convkan_tpu_torch.train import loop, state
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
KEYS = ("JacobiKAN", "BersnsteinKAN", "BesselKAN", "FibonacciKAN",
        "FourierKAN", "GegenbauerKAN", "HermiteKAN", "LaguerreKAN",
        "LucasKAN", "TaylorKAN", "LegendreKAN")


def _close(got, want, what, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _jax_params(jm, rng, size=32):
    """The JAX model's tree with every leaf N(0, 0.15), PReLU slopes 0.25
    (a float64 draw: the seeded init of the two packages differs); a
    Fourier trunk's poly_w at chip_smoke.STATIC_CURVE (0.1) of that: with
    N(0, 0.15) its 13 convs amplify a relative change of their input about
    1e5 times, as float32's reading at the seeded init shows, so float64
    rounding alone would part the two packages by 1e-10."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32),
        train=False))
    curve = 0.1 if jm.kan_conv == "FourierKAN" else 1.0

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "prelu" in name:
            return np.full(s.shape, 0.25)
        return rng.normal(0.0, 0.15, s.shape) * (curve if "poly_w" in name
                                                 else 1.0)

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.mark.parametrize("key", KEYS + ("conv",))
def test_vgg16_kansmall_logits_match_jax_f64(key):
    rng = np.random.RandomState(len(key))
    kw = dict(arch="VGG16_kansmall", kan_conv=key, classifier_type="Linear")
    jm = jax_vggkan(3, 10, **kw)
    variables = _jax_params(jm, rng)
    x = rng.normal(0.0, 1.0, (2, 32, 32, 3))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))
    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **kw)
    assert tm.model_name == jm.model_name
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    names = [k for k, _ in tm.named_parameters()]
    if key != "conv":
        prelu = sum(k.endswith(".prelu") for k in names)
        silu_post = key in ("JacobiKAN", "BersnsteinKAN", "LegendreKAN")
        assert prelu == (0 if silu_post else 13)
        assert sum(k.endswith((".base_w", ".poly_w")) for k in names) == 26
    kc.reset_launches()
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert sum(kc.launches.values()) == 0
    _close(got, want, key)
    assert np.max(np.abs(got[1] - got[0])) > 1e-5


class _JaxVGGKANf64(JaxVGGKAN):
    """The JAX VGGKAN taking its (float32) normalized batch in float64."""

    def __call__(self, x, train: bool = True):
        if not self.is_initializing():
            x = x.astype(jnp.float64)
        return super().__call__(x, train=train)


@pytest.mark.parametrize("key", ["HermiteKAN", "JacobiKAN", "FourierKAN"])
def test_train_step_matches_jax_f64(key, monkeypatch):
    """One port train step against one JAX make_train_step step from the
    same float64 weights (VGG16_kansmall, (1, 1) head; 32x32 inputs, batch
    2, no dropout), with XLA's normalized batch on both sides (see
    tests/test_torch_train.py)."""
    rng = np.random.RandomState(len(key) + 1)
    kw = dict(arch="VGG16_kansmall", kan_conv=key, classifier_type="Linear",
              dropout_linear=0.0, conv_dropout=0.0)
    jm = _JaxVGGKANf64(input_channels=3, num_classes=10, **kw)
    params = _jax_params(jm, rng)["params"]
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=2)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={}, tx=tx)
    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(js), strict=True)
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
    for k, prm in tm.named_parameters():
        m, p = k.split(".")
        assert np.max(np.abs(jgrad[m][p])) > 1e-8 * largest, k
        assert np.max(np.abs(prm.grad.numpy() - jgrad[m][p])) <= \
            1e-10 * largest, k
        want = np.asarray(js.params[m][p])
        slope = 1e-3 / 1e-8 * np.max(np.abs(prm.grad.numpy() - jgrad[m][p]))
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + slope, k + " after the step"


@pytest.mark.parametrize("key", KEYS)
def test_serve_cli_builds_each_family(key):
    """--kan_conv <key> with InstanceNorm serves train.py's (1, 1) head:
    finite logits that see the image; --grid_size 3 gives Fourier 6
    bases; every conv of a kernel family takes the kernel route."""
    args = build_parser().parse_args(
        ["--arch", "VGG16_kansmall", "--kan_conv", key, "--grid_size", "3",
         "--kan_norm_layer", "InstanceNorm2d", "--init_random", "--device",
         "cpu", "--buckets", "1,2"])
    engine, name = build_engine(args)
    try:
        assert name == f"VGGKAN_Linear_{key.upper()}_VGG16_kansmall"
        conv = engine.model.KanConvND_0
        assert conv.num_basis == (6 if key == "FourierKAN" else
                                  3 if key == "TaylorKAN" else 4)
        kc.reset_launches()
        imgs = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 3),
                                                np.uint8)
        out = engine.predict(imgs)
        assert out.shape == (3, 10) and np.isfinite(out).all()
        assert np.abs(out[1] - out[0]).max() > 1e-5
        plain = kc.plain_calls[kc.PLAIN]      # 13 per device batch
        assert (plain > 0 and plain % 13 == 0) if key == "LegendreKAN" \
            else plain == 0
    finally:
        engine.close()


def test_cpu_models_never_reach_a_kernel_entry(monkeypatch):
    """The CPU path runs the plain versions forward and backward; the C
    entries are never looked up."""
    def refuse(name):
        raise AssertionError(f"kernel entry {name} reached on the CPU")

    monkeypatch.setattr(kc, "_fn", refuse)
    for key in ("FourierKAN", "BersnsteinKAN"):
        kc.reset_launches()
        m = vggkan(3, 10, arch="VGG16_kansmall", kan_conv=key, device="cpu",
                   generator=torch.Generator().manual_seed(0))
        m(torch.randn(2, 32, 32, 3), torch.Generator().manual_seed(1)) \
            .square().sum().backward()
        assert m.KanConvND_1.poly_w.grad.abs().sum() > 0
        assert sum(kc.launches.values()) == 0
