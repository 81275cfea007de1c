"""Port parity for the rest of train.py's model zoo and every model's KAN
heads, against the JAX package:

* KAN-AlexNet ``small`` at 32 x 32 (the KAN head and the Linear one,
  train.py's BatchNorm2d), KAN-MobileNetV1 at width 0.25 (ReLU KAN convs;
  ``conv_type="conv"``; the KAN head) and KAN-MobileNetV2 ``kan_small`` at
  width 0.25 (the KAN head; ``conv_type="conv"`` without affine, the conv
  bias quirk): JAX variables drawn from a seed (``_draw``, on JAX's tree)
  through ``from_jax`` (strict=True), eval logits (not the same for every
  image) and a train-mode forward's logits and running statistics against
  JAX in float64, 1e-10 of the largest entry;
* VGG16_kansmall with the KAN, HiddenKAN, VGGKAN, VGG and identity heads
  over several head families (the ``classifier_*`` overrides among them),
  and the MobileNetV3 and EfficientNet KAN and HiddenKAN heads: logits
  (and running statistics) the same way;
* one train step (train.py's step: AdamW, no augmentation, the head's
  dropout masks drawn by the port and handed to JAX by a flax method
  interceptor) of AlexNet small with the KAN head and of VGG16_kansmall
  with the KAN, HiddenKAN and VGGKAN heads against JAX's in float64 (the
  gradient of the train-mode loss, then the optax update of its
  make_train_step): the loss to 1e-8, every gradient to 1e-10 of the
  largest, the parameters after the step and the running statistics;
* the reference goldens ``model_vgg_cheby_kanhead``,
  ``model_mnv2_kansmall_bessel``, ``model_mnv1_conv`` and (``slow``, as
  JAX's) ``model_vgg_kan_linear`` through the JAX package's converters and
  ``from_jax``: the port's logits against JAX's within 1e-9 of the
  largest, and against the golden's at the JAX migration tests' 1e-5
  (the reference's knots differ from numpy's by an ulp:
  tests/test_model_migration.py);
* the serving CLI against the JAX CLI (train.py's parser and
  ``build_model``) for ``--model AlexNetKAN --arch small --classifier_type
  KAN``, ``FlexibleAlexNet --arch small``, ``MobileNetV1KAN``,
  ``MobileNetV2KAN --arch kan_small`` and ``VGGKAN --classifier_type
  VGGKAN --kan_classifier FastKAN``: the model name, JAX's seeded
  variables loading with strict=True and the engines' logits (float32,
  1e-4); train.py's default argv (FlexibleAlexNet, arch default, MNIST at
  28 x 28) fails in the JAX CLI and is refused by the port's before
  anything runs, as is AlexNet default at 32 x 32.
"""

import dataclasses

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_utils import assert_close, load_golden, nchw_to_nhwc

from convkan_tpu.models.alexnet import alexnet_kan as jax_alexnet
from convkan_tpu.models.efficientnetv2 import \
    efficientnetv2_kan_small as jax_effv2_small
from convkan_tpu.models.mobilenet import mobilenet_v1_kan as jax_mnv1
from convkan_tpu.models.mobilenetv2 import mobilenet_v2_kan as jax_mnv2
from convkan_tpu.models.mobilenetv3 import mobilenet_v3_kan as jax_mnv3
from convkan_tpu.models.vgg import vggkan as jax_vggkan
from convkan_tpu.train import data as jdata
from convkan_tpu.train import state as jstate
from convkan_tpu.utils.torch_compat import (convert_mobilenet_v1,
                                            convert_mobilenet_v2,
                                            convert_vggkan)
from convkan_tpu_torch.models.alexnet import alexnet_kan
from convkan_tpu_torch.models.efficientnetv2 import efficientnetv2_kan_small
from convkan_tpu_torch.models.mobilenet import mobilenet_v1_kan
from convkan_tpu_torch.models.mobilenetv2 import mobilenet_v2_kan
from convkan_tpu_torch.models.mobilenetv3 import mobilenet_v3_kan
from convkan_tpu_torch.models.vgg import vggkan
from convkan_tpu_torch.ops import dropout as dlib
from convkan_tpu_torch.serve import build_engine, build_parser
from convkan_tpu_torch.train import loop, state
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-10
T64 = dict(device="cpu", dtype=torch.float64)
BN = dict(norm_layer="BatchNorm2d", kan_norm_layer="BatchNorm2d")


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _draw(path, shape, rng):
    """float64 values for the variable at ``path``: a norm's weight
    N(1, 0.2) and bias N(0, 0.2), a running mean N(0, 0.3) and variance
    U(0.5, 2), a PReLU slope 0.25 and a wavelet scale U(0.5, 1.5); any other
    parameter N(0, 1 / sqrt(n)), n its entries over its largest dimension
    (about its fan-in)."""
    name = jax.tree_util.keystr(path)
    norm = "norm" in name.lower()
    if norm and "'weight'" in name:
        return rng.normal(1.0, 0.2, shape)
    if norm and "'bias'" in name:
        return rng.normal(0.0, 0.2, shape)
    if "'mean'" in name:
        return rng.normal(0.0, 0.3, shape)
    if "'var'" in name:
        return rng.uniform(0.5, 2.0, shape)
    if "prelu" in name:
        return np.full(shape, 0.25)
    if "'scale'" in name:
        return rng.uniform(0.5, 1.5, shape)
    n = max(1, int(np.prod(shape)) // max(shape, default=1))
    return rng.normal(0.0, 1.0 / np.sqrt(n), shape)


def _variables(jm, rng, size):
    """The JAX model's variables drawn by ``_draw`` (JAX's tree from
    eval_shape: no init to compile)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3), jnp.float32),
        train=False))
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(p, s.shape, rng), shapes)


def _logits_and_stats(jm, tm, rng, size, train=True, spread=True):
    """Eval logits of JAX's variables (from_jax into ``tm``) and one
    train-mode forward without dropout: logits and running statistics.
    Train-mode BatchNorm over the small late maps of 3 images amplifies
    float64 rounding, so a train-mode reading is held within the larger
    of 1e-10 and 10 times JAX's own move when its input moves by 1e-15
    relative (as tests/test_torch_mnv3_model.py holds MobileNetV3).  With
    ``spread`` the eval logits must differ between the images."""
    variables = _variables(jm, rng, size)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert tm.model_name == jm.model_name
    x = rng.normal(0.0, 1.0, (3, size, size, 3))
    stats = variables.get("batch_stats", {})

    def both(v, xx):
        y_eval = jm.apply(v, xx, train=False)
        if not train:
            return y_eval, None
        return y_eval, jm.apply({"params": v["params"], "batch_stats": stats},
                                xx, train=True, mutable=["batch_stats"])

    jboth = jax.jit(both)
    want, trained = jboth(variables, jnp.asarray(x))
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    _close(got, want, "eval logits")
    assert not spread or \
        np.abs(got[1:] - got[0]).max() > 1e-3 * np.abs(got).max()
    if not train:
        return
    (want, mut), (nudged, mut2) = trained, jboth(variables, jnp.asarray(
        x * (1 + 1e-15 * rng.normal(size=x.shape))))[1]
    move = np.abs(np.asarray(nudged) - np.asarray(want)).max() / \
        np.abs(np.asarray(want)).max()
    _close(tm.train()(torch.from_numpy(x)).detach(), want, "train logits",
           max(TOL, 10 * move))
    moved = state_dict_from_jax({"params": {},
                                 "batch_stats": mut["batch_stats"]})
    moved2 = state_dict_from_jax({"params": {},
                                  "batch_stats": mut2["batch_stats"]})
    got = tm.state_dict()
    for name, val in moved.items():
        s_move = (moved2[name] - val).abs().max() / val.abs().max()
        _close(got[name], val, name, max(TOL, 10 * float(s_move)))


ZOO = {
    "alexnet_kan": (lambda **kw: jax_alexnet(arch="small", **kw),
                    lambda **kw: alexnet_kan(arch="small", **kw),
                    dict(classifier_type="KAN", kan_classifier="KAN",
                         dropout=0.0, **BN, affine=False)),
    "alexnet_linear": (lambda **kw: jax_alexnet(arch="small", **kw),
                       lambda **kw: alexnet_kan(arch="small", **kw),
                       dict(classifier_type="AlexNetKAN", dropout=0.0,
                            kan_conv="ChebyKAN")),
    "mnv1_kan": (jax_mnv1, mobilenet_v1_kan,
                 dict(width_mult=0.25, classifier_type="KAN",
                      kan_classifier="ChebyKAN", dropout=0.0)),
    "mnv1_conv": (jax_mnv1, mobilenet_v1_kan,
                  dict(width_mult=0.25, conv_type="conv", dropout=0.0)),
    "mnv2_kan": (jax_mnv2, mobilenet_v2_kan,
                 dict(width_mult=0.25, arch="kan_small",
                      classifier_type="KAN", kan_classifier="GRAMKAN",
                      dropout=0.0)),
    "mnv2_conv": (jax_mnv2, mobilenet_v2_kan,
                  dict(width_mult=0.25, arch="kan_small", conv_type="conv",
                       affine=False, dropout=0.0)),
    "mnv3_kan": (lambda **kw: jax_mnv3("small", **kw),
                 lambda **kw: mobilenet_v3_kan("small", **kw),
                 dict(width_mult=0.25, classifier_type="KAN",
                      kan_classifier="FastKAN", dropout=0.0,
                      classifier_grid_size=4)),
    "effv2_kan": (jax_effv2_small, efficientnetv2_kan_small,
                  dict(classifier_type="KAN", kan_classifier="JacobiKAN",
                       remat=False, dropout=0.0)),
    "effv2_hiddenkan": (jax_effv2_small, efficientnetv2_kan_small,
                        dict(classifier_type="HiddenKAN",
                             kan_classifier="TaylorKAN", remat=False,
                             dropout=0.0, head_hidden_dim=16)),
}


@pytest.mark.parametrize("name", sorted(ZOO))
def test_zoo_logits_and_statistics_match_jax_f64(name):
    jb, tb, kw = ZOO[name]
    rng = np.random.RandomState(len(name))
    jm = jb(num_classes=10, **kw)
    tm = tb(num_classes=10, **kw, **T64)
    # MobileNetV1's last map at 32 x 32 is 1 x 1: at 64 x 64, 2 x 2; its
    # standard-conv trunk in eval mode gives every image about the same
    # logits, as JAX's does
    _logits_and_stats(jm, tm, rng, 64 if name.startswith("mnv1") else 32,
                      train=not name.startswith(("effv2", "alexnet_l")),
                      spread=name != "mnv1_conv")


VGG_HEADS = [("KAN", "WavKAN", {}),
             ("HiddenKAN", "FastKAN", {"classifier_grid_size": 6}),
             ("VGGKAN", "KAN", {"classifier_base_activation": "relu",
                                "classifier_spline_order": 2}),
             ("VGG", "KAN", {}), ("Identity", "KAN", {})]


@pytest.mark.parametrize("head,family,ov", VGG_HEADS)
def test_vgg_heads_match_jax_f64(head, family, ov):
    kw = dict(arch="VGG16_kansmall", classifier_type=head,
              kan_classifier=family, kan_norm_layer="BatchNorm2d",
              dropout_linear=0.0, **ov)
    rng = np.random.RandomState(len(head) + len(family))
    jm = jax_vggkan(3, 10, **kw)
    tm = vggkan(3, 10, **kw, **T64)
    _logits_and_stats(jm, tm, rng, 32)


def _f64_model(jm):
    """The JAX model ``jm`` taking its (float32) input in float64."""
    cls = type(jm)

    class F64(cls):
        def __call__(self, x, train: bool = True):
            if not self.is_initializing():
                x = x.astype(jnp.float64)
            return super().__call__(x, train=train)

    F64.__name__ = cls.__name__
    fields = {f.name: getattr(jm, f.name) for f in dataclasses.fields(jm)
              if f.name not in ("parent", "name")}
    return F64(**fields)


def _inject_dropout(masks):
    """A flax method interceptor applying, in place of each train-mode
    nn.Dropout's own draw, the next of the port's keep ``masks`` (in call
    order, again from the first for every trace)."""
    calls = [0]

    def interceptor(next_fun, args, kwargs, context):
        m = context.module
        if not (isinstance(m, fnn.Dropout) and context.method_name ==
                "__call__" and kwargs.get("deterministic") is False and
                m.rate > 0):
            return next_fun(*args, **kwargs)
        keep = masks[calls[0] % len(masks)]
        calls[0] += 1
        x = args[0]
        return jnp.where(jnp.asarray(keep), x / (1.0 - m.rate), 0.0)
    return interceptor


STEPS = {
    "alexnet": (lambda: jax_alexnet(num_classes=10, arch="small",
                                    classifier_type="KAN",
                                    kan_classifier="KAN", **BN,
                                    affine=False),
                lambda: alexnet_kan(num_classes=10, arch="small",
                                    classifier_type="KAN",
                                    kan_classifier="KAN", **BN, affine=False,
                                    **T64)),
    **{f"vgg_{head}": (
        lambda head=head, fam=fam: jax_vggkan(
            3, 10, arch="VGG16_kansmall", classifier_type=head,
            kan_classifier=fam, dropout_linear=0.3),
        lambda head=head, fam=fam: vggkan(
            3, 10, arch="VGG16_kansmall", classifier_type=head,
            kan_classifier=fam, dropout_linear=0.3, **T64))
       for head, fam in (("KAN", "GRAMKAN"), ("HiddenKAN", "ChebyKAN"),
                         ("VGGKAN", "KAN"))},
}


@pytest.mark.parametrize("name", sorted(STEPS))
def test_train_step_matches_jax_f64(monkeypatch, name):
    rng = np.random.RandomState(len(name))
    jb, tb = STEPS[name]
    jm = _f64_model(jb())
    variables = _variables(jm, rng, 32)
    params = variables["params"]
    stats = variables.get("batch_stats", {})
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=100)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats=stats,
                           tx=tx)
    tm = tb()
    tm.load_state_dict(state_dict_from_jax(js), strict=True)
    ts = state.create_train_state(tm, 1e-3, 1e-3, 0.8, steps_per_epoch=100,
                                  generator=torch.Generator().manual_seed(1))
    # XLA's normalized batch on both sides (jitted, it rounds the fused
    # float32 normalization up to 2 ulp away from the eager form)
    prep = jax.jit(lambda xx: jdata.normalize_batch(xx, "CIFAR10"))
    monkeypatch.setattr(loop, "train_batch", lambda x, ds, aug, **_: (
        torch.from_numpy(np.array(prep(jnp.asarray(x.numpy()))))))
    draws = []
    uniform = dlib.uniform
    monkeypatch.setattr(dlib, "uniform", lambda *a, **k: draws.append(
        uniform(*a, **k)) or draws[-1])
    x = rng.randint(0, 256, (2, 32, 32, 3), np.uint8)
    y = rng.randint(0, 10, 2).astype(np.int32)
    tloss = loop.make_train_step(tm, "CIFAR10", augment=False)(
        ts, torch.from_numpy(x), torch.from_numpy(y))
    rate = {"alexnet": 0.5}.get(name, 0.3)
    keep = [(u < 1.0 - rate).numpy() for u in draws]
    assert len(keep) == (1 if name in ("vgg_KAN", "vgg_HiddenKAN") else 2)
    assert any(not k.all() for k in keep)
    xn = prep(jnp.asarray(x))

    def loss_fn(p):
        logits, mut = jm.apply({"params": p, "batch_stats": stats}, xn,
                               train=True, mutable=["batch_stats"])
        return _ce(logits, y), mut.get("batch_stats", {})

    with fnn.intercept_methods(_inject_dropout(keep)):
        (jloss, jstats), jgrad = jax.jit(jax.value_and_grad(
            loss_fn, has_aux=True))(params)
    # the rest of JAX's make_train_step: the optax update
    js = js.apply_gradients(grads=jgrad).replace(batch_stats=jstats)
    assert abs(tloss.item() - float(jloss)) <= 1e-8
    want_grads = state_dict_from_jax(jgrad)
    largest = max(a.abs().max().item() for a in want_grads.values())
    want_params = state_dict_from_jax(js.params)
    for k, prm in tm.named_parameters():
        g = want_grads[k].numpy()
        err = np.max(np.abs(prm.grad.numpy() - g))
        assert err <= 1e-10 * largest, k
        want = want_params[k].numpy()
        # AdamW: g / (|g| + eps) scales a gradient's rounding by up to
        # 1 / eps (tests/test_torch_train.py)
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + 1e-3 / 1e-8 * err, \
            k + " after the step"
    after = state_dict_from_jax({"params": {},
                                 "batch_stats": js.batch_stats or {}})
    for k, want in after.items():
        _close(tm.state_dict()[k], want.numpy(), k)


def _ce(logits, y):
    logp = jax.nn.log_softmax(logits)
    return -jnp.mean(jnp.take_along_axis(logp, jnp.asarray(y)[:, None], 1))


def _golden(name, jm, convert, tm):
    x, y_ref, sd = load_golden(name)
    xh = nchw_to_nhwc(x)
    variables = convert(sd, jm, jax.jit(
        lambda r, xx: jm.init({"params": r}, xx, train=False))(
            jax.random.PRNGKey(0), xh.astype(np.float32)))
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    y = tm.eval()(torch.from_numpy(xh.copy())).detach().numpy()
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(variables, xh)
    _close(y, want, name, tol=1e-9)
    assert_close(y, y_ref, tol=1e-5, name=name)


def test_golden_vgg_cheby_kanhead():
    kw = dict(arch="VGG16_kansmall", kan_conv="ChebyKAN",
              classifier_type="KAN", kan_classifier="KAN")
    _golden("model_vgg_cheby_kanhead", jax_vggkan(3, 10, **kw),
            convert_vggkan, vggkan(3, 10, **kw, **T64))


@pytest.mark.slow
def test_golden_vgg_kan_linear():
    kw = dict(arch="VGG16_kansmall", kan_conv="KAN", classifier_type="Linear")
    _golden("model_vgg_kan_linear", jax_vggkan(3, 10, **kw),
            convert_vggkan, vggkan(3, 10, **kw, **T64))


def test_golden_mnv2_kansmall_bessel():
    kw = dict(num_classes=4, arch="kan_small", width_mult=0.25,
              kan_conv="BesselKAN", degree=3, classifier_type="Linear")
    _golden("model_mnv2_kansmall_bessel", jax_mnv2(**kw),
            convert_mobilenet_v2, mobilenet_v2_kan(**kw, **T64))


def test_golden_mnv1_conv():
    kw = dict(num_classes=4, width_mult=0.25, conv_type="conv",
              classifier_type="Linear")
    _golden("model_mnv1_conv", jax_mnv1(**kw), convert_mobilenet_v1,
            mobilenet_v1_kan(**kw, **T64))


def _jax_cli(argv):
    from convkan_tpu.migrate import _dataset_input_shape, _load_train_module
    train = _load_train_module()
    p = train.build_parser()
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--buckets", default="1,8,64")
    jargs = p.parse_args(argv)
    return train, jargs, _dataset_input_shape(jargs)


CLI = [["--model", "AlexNetKAN", "--arch", "small", "--classifier_type",
        "KAN", "--kan_classifier", "KAN"],
       ["--model", "FlexibleAlexNet", "--arch", "small"],
       ["--model", "MobileNetV1KAN", "--width_scale", "0.25",
        "--classifier_type", "KAN", "--kan_classifier", "ChebyKAN"],
       ["--model", "MobileNetV2KAN", "--arch", "kan_small", "--width_scale",
        "0.25"],
       ["--model", "VGGKAN", "--arch", "VGG16_kansmall", "--classifier_type",
        "VGGKAN", "--kan_classifier", "FastKAN", "--classifier_grid_size",
        "6"]]


@pytest.mark.parametrize("argv", CLI, ids=lambda a: "_".join(a[1:4:2]))
def test_serve_cli_serves_the_jax_cli_model(argv):
    argv = argv + ["--dataset", "CIFAR10", "--init_random", "--seed", "3",
                   "--buckets", "2"]
    train, jargs, shape = _jax_cli(argv)
    jm = train.build_model(jargs, shape, 10)
    engine, name = build_engine(build_parser().parse_args(
        argv + ["--device", "cpu"]))
    try:
        assert name == jm.model_name
        assert engine.input_shape == shape == (32, 32, 3)
        variables = jax.tree_util.tree_map(
            lambda a: a.astype(np.float32),
            _variables(jm, np.random.RandomState(4), shape[0]))
        engine.model.load_state_dict(state_dict_from_jax(variables),
                                     strict=True)
        imgs = np.random.RandomState(5).randint(0, 256, (2,) + shape,
                                                np.uint8)
        want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
            variables, jdata.normalize_batch(jnp.asarray(imgs), "CIFAR10"))
        got = engine.predict(imgs)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        assert np.abs(got[1] - got[0]).max() > 1e-3
    finally:
        engine.close()


@pytest.mark.parametrize("argv", [[], ["--dataset", "CIFAR10"]],
                         ids=["default", "cifar10"])
def test_serve_cli_refuses_what_the_jax_cli_cannot_build(argv):
    """train.py's default argv: JAX's AlexNet (arch default) fails inside
    its max pools at 28 x 28 (and at 32 x 32); the port's CLI refuses the
    argv with the reason before building an engine."""
    from convkan_tpu.serve import build_engine as jax_build_engine

    train, jargs, shape = _jax_cli(argv + ["--init_random"])
    for flag, default in (("fold_bn", False), ("bf16", False),
                          ("kind", "best"), ("ckpt_name", None),
                          ("bn_eps", 1e-5), ("batch_timeout_ms", 2.0)):
        setattr(jargs, flag, default)
    with pytest.raises(TypeError, match="window_dimensions"):
        jax_build_engine(jargs, train)
    args = build_parser().parse_args(argv + ["--init_random", "--device",
                                             "cpu"])
    assert (args.model, args.dataset) == (jargs.model, jargs.dataset)
    with pytest.raises(SystemExit, match="max pool .* needs at least 63x63"):
        build_engine(args)


def test_alexnet_refuses_inputs_its_pools_cannot_take():
    m = alexnet_kan(num_classes=10, arch="small", device="cpu")
    with pytest.raises(ValueError, match="at least 15x15"):
        m(torch.zeros(1, 8, 8, 3))
