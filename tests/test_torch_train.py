"""Port parity for the training slice: the on-device input pipeline
(crop, flip, normalize), dropout, the loss and metrics, the LR schedule,
and three whole train steps of KAN-VGG16_kansmall, each against the JAX
package.  Random crops and dropout masks cannot come from the same stream
in both frameworks, so the tests pass crop offsets and flips in
explicitly and hold dropout to flax's arithmetic given a mask."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from convkan_tpu.models.vgg import VGGKAN as JaxVGGKAN
from convkan_tpu.train import data as jdata
from convkan_tpu.train import loop as jloop
from convkan_tpu.train import metrics as jmetrics
from convkan_tpu.train import state as jstate
from convkan_tpu_torch.models.vgg import vggkan
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.ops import dropout as dlib
from convkan_tpu_torch.train import data, loop, metrics, state
from convkan_tpu_torch.utils.from_jax import vggkan_state_dict_from_jax

torch.set_num_threads(1)


def _crop_inputs(seed, B=6, H=8, C=3):
    rng = np.random.RandomState(seed)
    x = rng.randint(0, 256, (B, H, H, C), np.uint8)
    offs = rng.randint(0, 9, (B, 2)).astype(np.int32)
    flips = rng.rand(B) < 0.5
    return x, offs, flips


@pytest.mark.parametrize("seed", [0, 1])
def test_batched_crop_matches_jax_bitwise(seed):
    x, offs, flips = _crop_inputs(seed)
    xp = np.pad(x, ((0, 0), (4, 4), (4, 4), (0, 0)))
    for flip in (None, flips):
        want = np.asarray(jdata._batched_crop(
            jnp.asarray(xp), jnp.asarray(offs), 8, 8,
            flip=None if flip is None else jnp.asarray(flip)))
        got = data._batched_crop(
            torch.from_numpy(xp), torch.from_numpy(offs).long(), 8, 8,
            flip=None if flip is None else torch.from_numpy(flip)).numpy()
        assert got.dtype == np.uint8
        np.testing.assert_array_equal(got, want)


def test_augment_and_train_batch_match_jax_bitwise():
    x, offs, flips = _crop_inputs(2, B=4, H=32)
    xt = torch.from_numpy(x)
    kw = dict(offsets=torch.from_numpy(offs), flips=torch.from_numpy(flips))
    xp = jnp.pad(jnp.asarray(x), ((0, 0), (4, 4), (4, 4), (0, 0)))
    crop = jdata._batched_crop(xp, jnp.asarray(offs), 32, 32,
                               flip=jnp.asarray(flips))
    np.testing.assert_array_equal(data.augment_batch(xt, **kw).numpy(),
                                  np.asarray(crop))
    got = data.train_batch(xt, "CIFAR10", True, **kw).numpy()
    want = np.asarray(jdata.normalize_batch(crop, "CIFAR10"))
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    got = data.train_batch(xt, "CIFAR10", False).numpy()
    want = np.asarray(jdata.train_batch(jax.random.PRNGKey(0),
                                        jnp.asarray(x), "CIFAR10", False))
    np.testing.assert_array_equal(got, want)


def test_drawn_crops_are_in_range_and_seeded():
    g = lambda: torch.Generator().manual_seed(5)  # noqa: E731
    offs, flips = data.crop_params(4096, "cpu", g())
    assert offs.min() == 0 and offs.max() == 8 and flips.dtype == torch.bool
    assert 0.45 < flips.float().mean() < 0.55
    again = data.crop_params(4096, "cpu", g())
    assert torch.equal(offs, again[0]) and torch.equal(flips, again[1])
    x = torch.from_numpy(_crop_inputs(0)[0])
    assert torch.equal(data.augment_batch(x, generator=g()),
                       data.augment_batch(x, generator=g()))


def test_synthetic_data_matches_jax():
    for a, b in zip(data._synthetic("CIFAR10", 8, seed=3),
                    jdata._synthetic("CIFAR10", 8, seed=3)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_channel_dropout_arithmetic_matches_flax(dtype):
    """Given flax's mask, the port's select gives flax's values bit for
    bit; the port's own mask drops whole channels at the rate asked."""
    x = np.random.RandomState(0).uniform(0.5, 1.5, (4, 3, 3, 16)) \
        .astype(dtype)
    rate = 0.3
    want = np.asarray(fnn.Dropout(rate=rate, broadcast_dims=(1, 2)).apply(
        {}, jnp.asarray(x), deterministic=False,
        rngs={"dropout": jax.random.PRNGKey(1)}))
    keep = torch.from_numpy(want != 0)
    got = dlib.apply_mask(torch.from_numpy(x), keep, rate).numpy()
    np.testing.assert_array_equal(got, want)

    big = torch.ones(64, 5, 5, 256, dtype=torch.from_numpy(x).dtype)
    y = dlib.channel_dropout(big, rate, torch.Generator().manual_seed(0))
    kept = y[:, :1, :1, :] != 0
    assert torch.equal((y != 0), kept.expand_as(y))       # whole channels
    assert abs(kept.float().mean().item() - (1 - rate)) < 0.02
    assert torch.allclose(y[y != 0], big[y != 0] / (1 - rate))


def test_dropout_only_in_train_mode():
    conv = KanConvND("kan", 3, 8, 3, padding=1, dropout=0.5, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    x = torch.randn(2, 4, 4, 3, generator=torch.Generator().manual_seed(1))
    ref = conv.eval()(x)
    assert torch.equal(conv(x, torch.Generator().manual_seed(2)), ref)
    y = conv.train()(x, torch.Generator().manual_seed(2))
    dropped = (y == 0).all(dim=(1, 2))
    assert dropped.any() and not dropped.all()
    torch.testing.assert_close(y[~(y == 0)], 2 * ref[~(y == 0)])

    m = vggkan(3, 10, arch="VGG16_kansmall", classifier_type="Linear",
               classifier_dropout=0.25, device="cpu",
               generator=torch.Generator().manual_seed(0))
    assert m.dropout_linear == 0.25
    assert m.KanConvND_0.dropout == 0.0


@pytest.mark.parametrize("ls", [0.0, 0.1])
def test_cross_entropy_matches_jax(ls):
    rng = np.random.RandomState(0)
    logits = rng.normal(0, 3, (16, 10))
    labels = rng.randint(0, 10, 16).astype(np.int32)
    want = float(jmetrics.cross_entropy_loss(
        jnp.asarray(logits), jnp.asarray(labels), label_smoothing=ls))
    got = metrics.cross_entropy_loss(torch.from_numpy(logits),
                                     torch.from_numpy(labels), ls).item()
    assert abs(got - want) <= 1e-12 * abs(want)


def test_confusion_matrix_and_accuracy_match_jax():
    rng = np.random.RandomState(1)
    preds, labels = rng.randint(0, 10, 50), rng.randint(0, 10, 50)
    w = (rng.rand(50) < 0.8).astype(np.float32)
    for weights in (None, w):
        want = np.asarray(jmetrics.confusion_matrix(
            jnp.asarray(preds), jnp.asarray(labels), 10,
            weights=None if weights is None else jnp.asarray(weights)))
        cm = metrics.confusion_matrix(
            torch.from_numpy(preds), torch.from_numpy(labels), 10,
            weights=None if weights is None else torch.from_numpy(weights))
        np.testing.assert_array_equal(cm.numpy(), want)
        assert abs(metrics.accuracy_from_cm(cm).item()
                   - float(jmetrics.accuracy_from_cm(jnp.asarray(want)))) \
            <= 1e-7


@pytest.mark.parametrize("kwargs", [
    dict(scheduler="exponential"),
    dict(scheduler="exponential", warmup_epochs=2),
    dict(scheduler="cosine", total_epochs=6),
    dict(scheduler="cosine", total_epochs=6, warmup_epochs=1),
])
def test_lr_schedule_matches_optax(kwargs):
    """optax evaluates the schedule in float32 (the port in float64):
    relative 2.5e-7 covers a few float32 roundings."""
    want = jstate.make_lr_schedule(1e-3, 0.8, 3, **kwargs)
    got = state.make_lr_schedule(1e-3, 0.8, 3, **kwargs)
    for n in range(25):
        w = float(want(jnp.asarray(n, jnp.int32)))
        assert abs(got(n) - w) <= 2.5e-7 * abs(w) + 1e-15, n


def test_unported_training_options_raise():
    m = vggkan(3, 10, arch="VGG16_kansmall", classifier_type="Linear",
               device="cpu", generator=torch.Generator().manual_seed(0))
    for kw in (dict(grad_accum=2), dict(ema_decay=0.9), dict(l1_decay=1e-4)):
        with pytest.raises(NotImplementedError):
            loop.make_train_step(m, "CIFAR10", True, **kw)
    with pytest.raises(NotImplementedError):
        state.create_train_state(m, ema_decay=0.999)


class _JaxVGGKANf64(JaxVGGKAN):
    """The JAX VGGKAN taking its (float32) normalized batch in float64, so
    that a float64 model can run JAX's own train and eval steps."""

    def __call__(self, x, train: bool = True):
        if not self.is_initializing():
            x = x.astype(jnp.float64)
        return super().__call__(x, train=train)


def test_three_train_steps_match_jax_f64(monkeypatch):
    """Three port train steps against three JAX make_train_step steps from
    the same float64 weights (the JAX init, VGG16_kansmall, 32x32 inputs,
    batch 2, no dropout, steps_per_epoch 2 so the LR staircase turns after
    step 2), then one eval step.  (At 16x16 the last three convs see 1x1
    planes, where InstanceNorm outputs 0 and no conv weight gets a
    gradient.)  Jitted, XLA rounds the fused float32 normalization up to
    2 ulp away from the eager one (which the port matches bit for bit,
    tested above), so here the port's step takes XLA's normalized batch.
    Float64 on both sides.  The first step's gradients agree to 1e-10 and
    the three losses to 1e-8.  Parameters after three steps agree to 1e-5
    (99% of entries to 1e-8): many poly_w gradient entries are near 0
    (bases the data never reaches), where Adam's g / (|g| + eps) scales
    float64 summation-order noise by up to 1/eps = 1e8, and the steps
    compound it; optax's float32 learning rate adds a relative 6e-8.
    The eval step normalizes inside JAX's jit (see above): 1e-6."""
    rng = np.random.RandomState(0)
    kw = dict(arch="VGG16_kansmall", kan_conv="KAN", classifier_type="Linear",
              dropout_linear=0.0)
    jm = _JaxVGGKANf64(input_channels=3, num_classes=10, **kw)
    params = jax.tree_util.tree_map(
        lambda a: np.asarray(a, np.float64),
        jax.jit(lambda: jm.init(jax.random.PRNGKey(0),
                                jnp.zeros((1, 32, 32, 3), jnp.float32),
                                train=False))()["params"])
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=2)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats={}, tx=tx)

    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(vggkan_state_dict_from_jax(js),  # a TrainState
                       strict=True)
    ts = state.create_train_state(tm, 1e-3, 1e-3, 0.8, steps_per_epoch=2,
                                  generator=torch.Generator())
    xla_normalize = jax.jit(jdata.normalize_batch, static_argnums=1)
    monkeypatch.setattr(loop, "train_batch", lambda x, ds, aug, **_: (
        torch.from_numpy(np.array(xla_normalize(jnp.asarray(x.numpy()),
                                                ds)))))
    jstep = jloop.make_train_step(jm, "CIFAR10", augment=False)
    tstep = loop.make_train_step(tm, "CIFAR10", augment=False)
    for i in range(3):
        x = rng.randint(0, 256, (2, 32, 32, 3), np.uint8)
        y = rng.randint(0, 10, 2).astype(np.int32)
        if i == 0:
            xn = xla_normalize(jnp.asarray(x), "CIFAR10")
            jgrad = jax.jit(jax.grad(lambda p: jmetrics.cross_entropy_loss(
                jm.apply({"params": p}, xn), jnp.asarray(y))))(js.params)
        js, jloss = jstep(js, jax.random.PRNGKey(i), jnp.asarray(x),
                          jnp.asarray(y))
        tloss = tstep(ts, torch.from_numpy(x), torch.from_numpy(y))
        assert tloss.dtype == torch.float64
        assert abs(tloss.item() - float(jloss)) <= 1e-8, i
        if i == 0:
            for k, prm in tm.named_parameters():
                m, p = k.split(".")
                assert np.max(np.abs(prm.grad.numpy()
                                     - np.asarray(jgrad[m][p]))) <= 1e-10, k
    assert ts.step == int(js.step) == 3
    want = {f"{m}.{p}": np.asarray(v) for m, ps in js.params.items()
            for p, v in ps.items()}
    got = {k: v.detach().numpy() for k, v in tm.state_dict().items()}
    assert got.keys() == want.keys()
    close = 0
    for k in want:
        m, p = k.split(".")
        assert np.max(np.abs(got[k] - want[k])) <= 1e-5, k
        assert np.max(np.abs(got[k] - params[m][p])) > 1e-4, k  # it moved
        close += np.sum(np.abs(got[k] - want[k]) <= 1e-8)
    assert close >= 0.99 * sum(v.size for v in want.values())

    x = rng.randint(0, 256, (3, 32, 32, 3), np.uint8)
    y = rng.randint(0, 10, 3).astype(np.int32)
    w = np.array([1, 1, 0], np.float32)
    jl, jcm = jloop.make_eval_step(jm, "CIFAR10", 10)(
        js, jnp.asarray(x), jnp.asarray(y), jnp.asarray(w))
    tl, tcm = loop.make_eval_step(tm, "CIFAR10", 10)(
        ts, torch.from_numpy(x), torch.from_numpy(y), torch.from_numpy(w))
    assert abs(tl.item() - float(jl)) <= 1e-6
    np.testing.assert_array_equal(tcm.numpy(), np.asarray(jcm))
