"""Port parity for KAN-MobileNetV3 as a whole, against the JAX package:

* the reference goldens ``model_mnv3_small_cheby`` and
  ``model_mnv3_small_fastkan`` (width 0.25, 4 classes), converted with the
  JAX package's ``convert_mobilenet_v3`` and carried by ``from_jax``, at
  the JAX migration tests' 1e-5 (tests/test_model_migration.py);
* seeded MobileNetV3-small (width 0.25, 64 x 64) with B-spline KAN convs
  (hardswish base path), and the ``conv`` and ``replace_depthwise``
  variants: eval logits, and for the first train-mode logits with the
  running statistics of three train-mode forwards (BatchNorm momentum
  0.01), against JAX in float64, within 1e-10 of the largest entry;
* one train step of that model, and of the FastKAN one (its RBF weights
  at a tenth of their init, where float64 is well conditioned), with
  ``imagenet=True, augment=False`` (224 x 224 after the resize and crop)
  against JAX ``make_train_step`` in float64: the loss to 1e-8, every
  gradient to 1e-10 of the largest, the parameters after the AdamW step
  and the running statistics;
* ``imagenet_batch`` against JAX's, bit for bit in float32;
* the serving CLI's FastKAN MobileNetV3 against the JAX CLI's model:
  JAX's seeded variables load with strict=True and the logits agree
  (1e-4, float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_utils import assert_close, load_golden, nchw_to_nhwc

from convkan_tpu.models.mobilenetv3 import MobileNetV3KAN as JaxMNV3
from convkan_tpu.models.mobilenetv3 import mobilenet_v3_kan as jax_mnv3
from convkan_tpu.train import data as jdata
from convkan_tpu.train import loop as jloop
from convkan_tpu.train import metrics as jmetrics
from convkan_tpu.train import state as jstate
from convkan_tpu.utils.torch_compat import convert_mobilenet_v3
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.models.mobilenetv3 import (MobileNetV3KAN,
                                                  mobilenet_v3_conf,
                                                  mobilenet_v3_kan)
from convkan_tpu_torch.serve import build_engine, build_parser
from convkan_tpu_torch.train import data, loop, state
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


@pytest.mark.parametrize("name,kan_conv", [
    ("model_mnv3_small_cheby", "ChebyKAN"),
    ("model_mnv3_small_fastkan", "FastKAN")])
def test_golden_through_the_jax_converter(name, kan_conv):
    """The reference model's state_dict (stem and last KAN convs, the
    blocks' expansion and projection KAN convs, standard depthwise convs,
    SE blocks, running statistics, the Linear head) through
    convert_mobilenet_v3 and from_jax, eval logits against the golden's."""
    x, y_ref, sd = load_golden(name)
    kw = dict(num_classes=4, width_mult=0.25, kan_conv=kan_conv,
              classifier_type="Linear")
    jm = jax_mnv3("small", **kw)
    xh = nchw_to_nhwc(x)
    variables = convert_mobilenet_v3(sd, jm, jax.jit(
        lambda r, xx: jm.init({"params": r}, xx, train=False))(
            jax.random.PRNGKey(0), xh.astype(np.float32)))
    tm = mobilenet_v3_kan("small", device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    y = tm.eval()(torch.from_numpy(xh.copy())).detach().numpy()
    assert_close(y, y_ref, tol=1e-5, name=name)


class _JaxMNV3f64(JaxMNV3):
    """The JAX MobileNetV3KAN taking its (float32) input in float64."""

    def __call__(self, x, train: bool = True):
        if not self.is_initializing():
            x = x.astype(jnp.float64)
        return super().__call__(x, train=train)


def _draw(path, a, rng):
    """A norm's weight N(1, 0.2), bias N(0, 0.2), running mean N(0, 0.3),
    running var U(0.5, 2); every other variable keeps its init."""
    name = jax.tree_util.keystr(path)
    norm = "norm" in name.lower()
    return (rng.normal(1.0, 0.2, a.shape) if norm and "'weight'" in name else
            rng.normal(0.0, 0.2, a.shape) if norm and "'bias'" in name else
            rng.normal(0.0, 0.3, a.shape) if "'mean'" in name else
            rng.uniform(0.5, 2.0, a.shape) if "'var'" in name else
            np.asarray(a, np.float64))


def _jax_variables(jm, rng, size):
    """The JAX model's seeded init (float32 values in float64) with its
    norms drawn off their init."""
    variables = jm.init(jax.random.PRNGKey(int(rng.randint(1000))),
                        jnp.zeros((1, size, size, 3), jnp.float32),
                        train=False)
    return jax.tree_util.tree_map_with_path(
        lambda p, a: _draw(p, a, rng), variables)


# (model keywords, train-mode steps checked): the B-spline model with its
# hardswish base path through three train-mode forwards; the conv_type
# "conv" and replace_depthwise variants in eval mode (ChebyKAN and
# FastKAN: the goldens above, and tests/test_torch_fastkan_conv.py)
VARIANTS = {
    "KAN": (dict(kan_conv="KAN"), 3),
    "conv": (dict(conv_type="conv"), 0),
    "KAN_rdw": (dict(kan_conv="KAN", replace_depthwise=True), 0),
}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_seeded_logits_and_statistics_match_jax_f64(variant):
    """Eval logits from running statistics off their init (1e-10), then
    (KAN) three train-mode forwards (no dropout): logits and every running
    statistic (eps 1e-3, momentum 0.01) against JAX's.  Train-mode
    BatchNorm over 2 x 2 planes of 4 images amplifies rounding along the
    11 blocks, so a train-mode reading is held within the larger of 1e-10
    and 10 times JAX's own move when its input moves by 1e-15 relative
    (float64 rounding)."""
    rng = np.random.RandomState(len(variant))
    model_kw, train_steps = VARIANTS[variant]
    kw = dict(num_classes=10, width_mult=0.25, dropout=0.0, **model_kw)
    jm = _JaxMNV3f64(arch="small", **kw)
    variables = _jax_variables(jm, rng, 64)
    tm = mobilenet_v3_kan("small", device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert tm.model_name == jm.model_name
    x = rng.normal(0.0, 1.0, (4, 64, 64, 3))
    kc.reset_launches()
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x))
    _close(tm.eval()(torch.from_numpy(x)).detach(), want, "eval logits")
    n_kan = 0 if variant == "conv" else 23 + 11 * (variant == "KAN_rdw")
    assert kc.plain_calls[kc.PLAIN] == n_kan    # float64: the plain route
    params, stats = variables["params"], variables["batch_stats"]

    jax_train = jax.jit(lambda xx, st: jm.apply(
        {"params": params, "batch_stats": st}, xx, train=True,
        mutable=["batch_stats"]))
    tm.train()
    spread = {}
    for step in range(train_steps):
        x = rng.normal(0.0, 1.0, (4, 64, 64, 3))
        want, mut = jax_train(jnp.asarray(x), stats)
        moved, _ = jax_train(jnp.asarray(
            x * (1 + 1e-15 * rng.normal(size=x.shape))), stats)
        spread[step] = np.abs(np.asarray(moved) - np.asarray(want)).max()
        tol = max(TOL, 10 * spread[step] / np.abs(want).max())
        _close(tm(torch.from_numpy(x)).detach(), want, f"logits {step}",
               tol)
        stats = mut["batch_stats"]
    got = tm.state_dict()
    moved = state_dict_from_jax({"params": {}, "batch_stats": stats})
    start = state_dict_from_jax({"params": {},
                                 "batch_stats": variables["batch_stats"]})
    for name, val in moved.items():
        _close(got[name], val, name,
               max([TOL] + [1e3 * v for v in spread.values()]))
        # momentum 0.01 over three steps moves each statistic by about 3%
        # of its distance to the batch's
        assert np.abs(val.numpy() - start[name].numpy()).max() < \
            0.2 * np.abs(start[name].numpy()).max() + 0.2, name


# FastKAN's RBF weights in the train-step test: at their init each FastKAN
# conv magnifies a relative error of its input about 2x, so at 224 x 224
# the seeded float64 step carries rounding of ~1e-9 of its gradients (up
# to 1.2e4) that varies with the XLA CPU's thread partition; at a tenth of
# the init (chip_smoke.py's MNV3_CURVE) the step is well conditioned
FASTKAN_RBF_SCALE = 0.1


@pytest.mark.parametrize("kan_conv", ["KAN", "FastKAN"])
def test_imagenet_train_step_matches_jax_f64(monkeypatch, kan_conv):
    """One port train step of the B-spline (hardswish) or FastKAN model
    (imagenet=True, augment=False: the eval-form resize to 256 and centre
    crop to 224) against one JAX make_train_step
    step from the same float64 weights and running statistics
    (MobileNetV3-small at width 0.25, batch 2, no dropout; FastKAN's
    poly_w at FASTKAN_RBF_SCALE of its init; XLA's
    preprocessed batch on both sides, as tests/test_torch_bn_model.py
    does: a jitted resize rounds differently from an eager one).  The
    backward through 11 blocks of train-mode BatchNorm over 7 x 7 planes
    of 2 images amplifies rounding: each gradient is held within the
    larger of 1e-10 of the largest gradient and 10 times JAX's own move
    when its parameters move by 1e-15 relative (float64 rounding)."""
    rng = np.random.RandomState(7)
    kw = dict(num_classes=10, width_mult=0.25, dropout=0.0,
              kan_conv=kan_conv)
    jm = _JaxMNV3f64(arch="small", **kw)
    variables = _jax_variables(jm, rng, 224)
    params, stats = variables["params"], variables["batch_stats"]
    if kan_conv == "FastKAN":
        params = jax.tree_util.tree_map_with_path(
            lambda p, a: a * FASTKAN_RBF_SCALE
            if "'poly_w'" in jax.tree_util.keystr(p) else a, params)
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=100)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats=stats,
                           tx=tx)
    tm = mobilenet_v3_kan("small", device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(js), strict=True)
    ts = state.create_train_state(tm, 1e-3, 1e-3, 0.8, steps_per_epoch=100,
                                  generator=torch.Generator())
    prep = jax.jit(lambda xx: jdata.imagenet_batch(None, xx, False,
                                                   "CIFAR10"))
    seen = []

    def xla_batch(x, ds, aug, imagenet=False, **_):
        seen.append((ds, aug, imagenet))
        return torch.from_numpy(np.array(prep(jnp.asarray(x.numpy()))))

    monkeypatch.setattr(loop, "train_batch", xla_batch)
    x = rng.randint(0, 256, (2, 32, 32, 3), np.uint8)
    y = rng.randint(0, 10, 2).astype(np.int32)
    xn = prep(jnp.asarray(x))
    assert xn.shape == (2, 224, 224, 3)
    grad_fn = jax.jit(jax.grad(lambda p, xx: jmetrics.cross_entropy_loss(
        jm.apply({"params": p, "batch_stats": stats}, xx, train=True,
                 mutable=["batch_stats"])[0], jnp.asarray(y))))
    jgrad = grad_fn(params, xn)
    moved = state_dict_from_jax(grad_fn(jax.tree_util.tree_map(
        lambda a: a * (1 + 1e-15 * rng.normal(size=a.shape)), params), xn))
    js, jloss = jloop.make_train_step(jm, "CIFAR10", augment=False,
                                      imagenet=True)(
        js, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    tloss = loop.make_train_step(tm, "CIFAR10", augment=False,
                                 imagenet=True)(
        ts, torch.from_numpy(x), torch.from_numpy(y))
    assert seen == [("CIFAR10", False, True)]
    assert abs(tloss.item() - float(jloss)) <= 1e-8
    want_grads = state_dict_from_jax(jgrad)
    largest = max(a.abs().max().item() for a in want_grads.values())
    want_params = state_dict_from_jax(js.params)
    for k, prm in tm.named_parameters():
        g = want_grads[k].numpy()
        spread = np.abs(moved[k].numpy() - g).max()
        assert np.max(np.abs(prm.grad.numpy() - g)) <= max(
            1e-10 * largest, 10 * spread), k
        want = want_params[k].numpy()
        slope = 1e-3 / 1e-8 * np.max(np.abs(prm.grad.numpy() - g))
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + slope, k + " after the step"
    after = state_dict_from_jax({"params": {}, "batch_stats": js.batch_stats})
    for k, want in after.items():
        _close(tm.state_dict()[k], want.numpy(), k)


@pytest.mark.parametrize("dataset,shape", [
    ("CIFAR10", (3, 32, 32, 3)), ("CIFAR10", (2, 224, 224, 3)),
    ("SVHN", (2, 40, 40, 3)), ("MNIST", (2, 28, 28, 1))])
def test_imagenet_batch_matches_jax(dataset, shape):
    """The eval-form ImageNet preprocessing: bilinear resize (short side
    256; MNIST straight to 224 and three channels), centre crop 224,
    ImageNet mean and std; bit for bit against JAX's eager float32."""
    x = np.random.RandomState(shape[1]).randint(0, 256, shape, np.uint8)
    want = np.asarray(jdata.imagenet_batch(None, jnp.asarray(x), False,
                                           dataset))
    got = data.imagenet_batch(torch.from_numpy(x), False, dataset).numpy()
    assert got.shape == want.shape == (shape[0], 224, 224, 3)
    assert got.dtype == np.float32 and np.array_equal(got, want)
    with pytest.raises(NotImplementedError):
        data.imagenet_batch(torch.from_numpy(x), True, dataset)
    m = mobilenet_v3_kan("small", num_classes=10, width_mult=0.25,
                         device="cpu")
    with pytest.raises(NotImplementedError):
        loop.make_train_step(m, dataset, True, imagenet=True)


def test_unported_options_raise_and_the_tables():
    for kw in (dict(remat=True, remat_policy="except_basis"),
               dict(classifier_type="KAN"), dict(kan_conv="ReLUKAN")):
        with pytest.raises(NotImplementedError):
            mobilenet_v3_kan("small", width_mult=0.25, device="cpu", **kw)
    for arch in ("small", "large"):
        for kw in (dict(), dict(width_mult=0.75, reduced_tail=True,
                                dilated=True)):
            from convkan_tpu.models.mobilenetv3 import \
                mobilenet_v3_conf as jconf
            got = mobilenet_v3_conf(arch, **kw)
            want = jconf(arch, **kw)
            assert [tuple(vars(c).values()) for c in got[0]] == \
                [tuple(vars(c).values()) for c in want[0]]
            assert got[1] == want[1]
    assert isinstance(mobilenet_v3_kan("small", width_mult=0.25,
                                       device="cpu"), MobileNetV3KAN)


def test_serve_cli_serves_the_jax_cli_model():
    """The same argv on both CLIs (train.py's vocabulary: FastKAN convs,
    BatchNorm2d, affine off, 224 x 224 inputs with the dataset's
    normalization) builds the same MobileNetV3-small: the JAX CLI's input
    shape and model name, and JAX's seeded variables (running statistics
    drawn off their init) load into the port's engine with strict=True,
    whose logits agree with the JAX model's eval logits (float32, 1e-4)."""
    from convkan_tpu.migrate import _dataset_input_shape, _load_train_module

    argv = ["--model", "MobileNetV3KAN", "--arch", "small",
            "--imagenet_preprocessing", "--width_scale", "0.25",
            "--kan_conv", "FastKAN", "--dataset", "CIFAR10", "--init_random",
            "--seed", "3", "--buckets", "2"]
    train = _load_train_module()
    p = train.build_parser()
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--buckets", default="1,8,64")
    jargs = p.parse_args(argv)
    shape = _dataset_input_shape(jargs)
    jm = train.build_model(jargs, shape, 10)
    engine, name = build_engine(build_parser().parse_args(
        argv + ["--device", "cpu"]))
    try:
        assert name == jm.model_name
        assert engine.input_shape == shape == (224, 224, 3)
        variables = jax.jit(lambda r: jm.init(
            r, jnp.zeros((1,) + shape, jnp.float32), train=False))(
            jax.random.PRNGKey(3))
        rng = np.random.RandomState(4)
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree_util.tree_map_with_path(
                         lambda pth, a: _draw(pth, a, rng).astype(
                             np.float32), variables["batch_stats"])}
        engine.model.load_state_dict(state_dict_from_jax(variables),
                                     strict=True)
        imgs = np.random.RandomState(5).randint(0, 256, (2,) + shape,
                                                np.uint8)
        want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
            variables, jdata.normalize_batch(jnp.asarray(imgs), "CIFAR10"))
        got = engine.predict(imgs)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        assert np.isfinite(got).all()
    finally:
        engine.close()
