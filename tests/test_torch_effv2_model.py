"""Port parity for KAN-EfficientNetV2 (and V1 on its engine) as a whole,
against the JAX package on the CPU:

* the reference golden ``model_effv2_kantiny_gram`` (kan_tiny, GRAMKAN,
  affine BatchNorm, 4 classes), converted with the JAX package's
  ``convert_efficientnetv2`` (flax's ``Checkpoint_EffBlock_i`` names, as
  JAX builds the model with remat) and carried by ``from_jax``, at the
  JAX migration tests' 1e-5;
* seeded ``kan_tiny`` models (32 x 32) with KAN, GRAMKAN and FastKAN
  convs and ``replace_depthwise``, and ``tiny`` (64 x 64) with
  ``conv_type="conv"``: eval logits from running statistics off their
  init, then train-mode forwards (no dropout, no DropPath) with their
  running statistics, against JAX in float64 within 1e-10 of the largest
  entry (a train-mode reading within the larger of 1e-10 and 10 times
  JAX's own move when its input moves by 1e-15 relative);
* ``efficientnet_kan_small`` (V1, b0_small) eval logits, float64, 1e-10;
* one ``imagenet=True`` train step (a four-block table on the engine,
  224 x 224 after the resize, DropPath on in two blocks) against JAX
  ``make_train_step`` with remat in float64, the port with remat on and
  off: the port's DropPath masks given to JAX by a flax method
  interceptor; the loss, every gradient, the parameters after AdamW and
  the running statistics;
* arch ``s``'s parameter tree: names and shapes of the port's state_dict
  against ``jax.eval_shape`` of the JAX builder (KAN: 148,196,314
  parameters), never run, and FastKAN's count (100,136,306);
* the serving CLI's EfficientNetV2 against the JAX CLI's model (the same
  argv): JAX's seeded variables load with strict=True and the logits
  agree (1e-4, float32).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as fnn
from golden_utils import assert_close, load_golden, nchw_to_nhwc

from convkan_tpu.models import efficientnet as jeff1
from convkan_tpu.models import efficientnetv2 as jeff
from convkan_tpu.ops.layers import DropPath as JaxDropPath
from convkan_tpu.train import data as jdata
from convkan_tpu.train import loop as jloop
from convkan_tpu.train import metrics as jmetrics
from convkan_tpu.train import state as jstate
from convkan_tpu.utils.torch_compat import convert_efficientnetv2
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.models.efficientnet import efficientnet_kan_small
from convkan_tpu_torch.models import efficientnetv2 as effv2
from convkan_tpu_torch.models.efficientnetv2 import (efficientnetv2_kan,
                                                     efficientnetv2_kan_small)
from convkan_tpu_torch.ops import layers
from convkan_tpu_torch.serve import build_engine, build_parser
from convkan_tpu_torch.train import loop, state
from convkan_tpu_torch.utils.from_jax import _scope, state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-10


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def test_golden_through_the_jax_converter():
    """The reference model's state_dict (stem and head KAN convs, Fused-
    MBConv and MBConv blocks with SE, running statistics, the Linear head)
    through convert_efficientnetv2 and from_jax, eval logits against the
    golden's; the port (remat on, as JAX) is named as JAX's model."""
    x, y_ref, sd = load_golden("model_effv2_kantiny_gram")
    kw = dict(arch="kan_tiny", num_classes=4, kan_conv="GRAMKAN", degree=3,
              classifier_type="Linear", affine=True)
    jm = jeff.efficientnetv2_kan_small(**kw)
    xh = nchw_to_nhwc(x)
    variables = convert_efficientnetv2(sd, jm, jax.jit(
        lambda r, xx: jm.init({"params": r}, xx, train=False))(
            jax.random.PRNGKey(0), xh.astype(np.float32)))
    assert "Checkpoint_EffBlock_0" in variables["params"]
    tm = efficientnetv2_kan_small(device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert tm.model_name == jm.model_name
    y = tm.eval()(torch.from_numpy(xh.copy())).detach().numpy()
    assert_close(y, y_ref, tol=1e-5, name="model_effv2_kantiny_gram")


class _JaxEffF64(jeff.EfficientNetV2KAN):
    """The JAX engine taking its (float32) input in float64."""

    def __call__(self, x, train: bool = True):
        if not self.is_initializing():
            x = x.astype(jnp.float64)
        return super().__call__(x, train=train)


def _jax_f64(jm):
    """``jm`` rebuilt as _JaxEffF64 (the same fields)."""
    return _JaxEffF64(**{f: getattr(jm, f) for f in
                         jeff.EfficientNetV2KAN.__dataclass_fields__
                         if f not in ("parent", "name")})


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
    variables = jax.jit(lambda r: jm.init(
        r, jnp.zeros((1, size, size, 3), jnp.float32), train=False))(
        jax.random.PRNGKey(int(rng.randint(1000))))
    return jax.tree_util.tree_map_with_path(
        lambda p, a: _draw(p, a, rng), variables)


# (arch, model keywords, train-mode forwards checked): kan_tiny (stem
# stride 1, one block per stage) with each KAN family and the grouped KAN
# depthwise convs, tiny (stem stride 2, residual blocks) with standard convs
VARIANTS = {
    "KAN": ("kan_tiny", dict(kan_conv="KAN"), 2),
    "GRAMKAN": ("kan_tiny", dict(kan_conv="GRAMKAN"), 2),
    "FastKAN": ("kan_tiny", dict(kan_conv="FastKAN"), 2),
    "KAN_rdw": ("kan_tiny", dict(kan_conv="KAN", replace_depthwise=True), 1),
    "conv": ("tiny", dict(conv_type="conv"), 2),
}
SIZES = {"kan_tiny": 32, "tiny": 64}


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_seeded_logits_and_statistics_match_jax_f64(variant):
    """Eval logits from running statistics off their init (1e-10), then
    train-mode forwards (no dropout, no DropPath): logits and every
    running statistic (eps 1e-5, momentum 0.1) against JAX's; the
    plain-route count (float64 runs every KAN conv on the plain version
    of the kernels or on the plain route)."""
    arch, model_kw, train_steps = VARIANTS[variant]
    rng = np.random.RandomState(len(variant) + 10 * len(arch))
    size = SIZES[arch]
    kw = dict(arch=arch, num_classes=10, dropout=0.0,
              stochastic_depth_prob=0.0, **model_kw)
    jm = _jax_f64(jeff.efficientnetv2_kan_small(**kw))
    variables = _jax_variables(jm, rng, size)
    tm = efficientnetv2_kan_small(device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert tm.model_name == jm.model_name
    x = rng.normal(0.0, 1.0, (4, size, size, 3))
    kc.reset_launches()
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x))
    _close(tm.eval()(torch.from_numpy(x)).detach(), want, "eval logits")
    # in float64 every KAN conv takes the plain route
    n_convs = sum(type(m).__name__ == "KanConvND" for m in tm.modules())
    assert (n_convs == 0) == (variant == "conv")
    assert sum(kc.launches.values()) == 0
    assert kc.plain_calls[kc.PLAIN] == n_convs
    params, stats = variables["params"], variables["batch_stats"]
    jax_train = jax.jit(lambda xx, st: jm.apply(
        {"params": params, "batch_stats": st}, xx, train=True,
        mutable=["batch_stats"]))
    tm.train()
    spread = {}
    for step in range(train_steps):
        x = rng.normal(0.0, 1.0, (4, size, size, 3))
        want, mut = jax_train(jnp.asarray(x), stats)
        moved, _ = jax_train(jnp.asarray(
            x * (1 + 1e-15 * rng.normal(size=x.shape))), stats)
        spread[step] = np.abs(np.asarray(moved) - np.asarray(want)).max()
        tol = max(TOL, 10 * spread[step] / np.abs(want).max())
        _close(tm(torch.from_numpy(x)).detach(), want, f"logits {step}",
               tol)
        stats = mut["batch_stats"]
    got = tm.state_dict()
    for name, val in state_dict_from_jax(
            {"params": {}, "batch_stats": stats}).items():
        _close(got[name], val, name,
               max([TOL] + [1e3 * v for v in spread.values()]))


def test_efficientnet_v1_small_logits_match_jax_f64():
    """V1 on the same engine: b0_small (width 0.35, 5x5 and 3x3 depthwise
    convs, SE ratio 0.1) with KAN convs, eval logits in float64."""
    rng = np.random.RandomState(3)
    kw = dict(arch="b0_small", num_classes=10)
    jm = _jax_f64(jeff1.efficientnet_kan_small(**kw))
    variables = _jax_variables(jm, rng, 32)
    tm = efficientnet_kan_small(device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    assert tm.model_name == jm.model_name
    x = rng.normal(0.0, 1.0, (3, 32, 32, 3))
    want = jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x))
    _close(tm.eval()(torch.from_numpy(x)).detach(), want, "V1 logits")


def _inject_drop_path(masks):
    """A flax method interceptor that applies, in place of each DropPath's
    own draw, the keep mask ``masks[i]`` of its block i (the port's)."""
    def interceptor(next_fun, args, kwargs, context):
        m = context.module
        if not (isinstance(m, JaxDropPath) and context.method_name ==
                "__call__" and kwargs.get("train") and m.drop_prob > 0):
            return next_fun(*args, **kwargs)
        x = args[0]
        block = int(m.path[0].rsplit("_", 1)[1])
        keep = 1.0 - m.drop_prob
        return x / keep * jnp.asarray(masks[block], x.dtype)
    return interceptor


# a table of four blocks for the train step: two Fused-MBConv blocks and
# two MBConv blocks with SE, the second of each pair residual (so DropPath
# acts there, with 0.5 * 1/4 and 0.5 * 3/4)
STEP_TABLE = (jeff.MBConfig("fused", 1, 3, 1, 8, 8, 2),
              jeff.MBConfig("mbconv", 4, 3, 2, 8, 16, 2, 0.25))


def _step_model(remat, jax_side):
    kw = dict(inverted_residual_setting=STEP_TABLE, dropout=0.0,
              stochastic_depth_prob=0.5, num_classes=10, last_channel=32,
              kan_conv="FastKAN", remat=remat)
    if jax_side:
        return _JaxEffF64(**kw)
    return effv2.EfficientNetV2KAN(device="cpu", dtype=torch.float64, **kw)


@pytest.mark.parametrize("remat", [True, False])
def test_imagenet_train_step_with_drop_path_matches_jax_f64(monkeypatch,
                                                            remat):
    """One port train step (imagenet=True, augment=False: the resize to 256
    and centre crop to 224; FastKAN convs, bench.py's config-5 family, with
    the identity base path in the projections; stochastic depth 0.5:
    DropPath in
    the two residual blocks) against one JAX make_train_step step with
    remat (``Checkpoint_EffBlock_i``) from the same float64 weights and
    running statistics; the port with remat on and off (batch 4; XLA's
    preprocessed batch on both sides, as tests/test_torch_mnv3_model.py
    does).  The port's DropPath masks (each recompute draws the forward's)
    are recorded and given to JAX by a method interceptor.  The loss to
    1e-8, every gradient within 1e-10 of the largest, the parameters after
    AdamW and the running statistics (moved once)."""
    rng = np.random.RandomState(7)
    jm = _step_model(True, jax_side=True)
    variables = _jax_variables(jm, rng, 224)
    params, stats = variables["params"], variables["batch_stats"]
    assert "Checkpoint_EffBlock_1" in params
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=100)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats=stats,
                           tx=tx)
    tm = _step_model(remat, jax_side=False)
    tm.load_state_dict(state_dict_from_jax(js), strict=True)
    ts = state.create_train_state(tm, 1e-3, 1e-3, 0.8, steps_per_epoch=100,
                                  generator=torch.Generator().manual_seed(1))
    prep = jax.jit(lambda xx: jdata.imagenet_batch(None, xx, False,
                                                   "CIFAR10"))
    monkeypatch.setattr(loop, "train_batch", lambda x, ds, aug, **_: (
        torch.from_numpy(np.array(prep(jnp.asarray(x.numpy()))))))
    masks = {}
    for name, m in tm.named_modules():
        if isinstance(m, layers.DropPath) and m.drop_prob > 0:
            block = int(name.split(".")[0].rsplit("_", 1)[1])
            m.register_forward_hook(
                lambda _m, i, o, b=block: masks.setdefault(b, []).append(
                    (o != 0).flatten(1).any(1).view(-1, 1, 1, 1).numpy()))
    x = rng.randint(0, 256, (4, 32, 32, 3), np.uint8)
    y = rng.randint(0, 10, 4).astype(np.int32)
    tloss = loop.make_train_step(tm, "CIFAR10", augment=False,
                                 imagenet=True)(
        ts, torch.from_numpy(x), torch.from_numpy(y))
    assert sorted(masks) == [1, 3]
    for v in masks.values():    # a recompute replays the forward's mask
        assert 1 <= len(v) <= 1 + remat
        assert all(np.array_equal(v[0], u) for u in v)
    keep = {b: v[0] for b, v in masks.items()}
    assert any(not k.all() for k in keep.values())
    xn = prep(jnp.asarray(x))
    assert xn.shape == (4, 224, 224, 3)
    with fnn.intercept_methods(_inject_drop_path(keep)):
        jgrad = jax.jit(jax.grad(lambda p, xx: jmetrics.cross_entropy_loss(
            jm.apply({"params": p, "batch_stats": stats}, xx, train=True,
                     mutable=["batch_stats"])[0], jnp.asarray(y))))(
            params, xn)
        js, jloss = jloop.make_train_step(jm, "CIFAR10", augment=False,
                                          imagenet=True)(
            js, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    assert abs(tloss.item() - float(jloss)) <= 1e-8
    want_grads = state_dict_from_jax(jgrad)
    largest = max(a.abs().max().item() for a in want_grads.values())
    want_params = state_dict_from_jax(js.params)
    for k, prm in tm.named_parameters():
        g = want_grads[k].numpy()
        err = np.max(np.abs(prm.grad.numpy() - g))
        assert err <= 1e-10 * largest, k
        want = want_params[k].numpy()
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + 1e-3 / 1e-8 * err, \
            k + " after the step"
    after = state_dict_from_jax({"params": {}, "batch_stats": js.batch_stats})
    for k, want in after.items():
        _close(tm.state_dict()[k], want.numpy(), k)


def test_arch_s_parameter_tree_matches_jax():
    """Arch s (10 classes, remat, as bench.py builds it with FastKAN): every
    JAX variable (jax.eval_shape of the builder at 224 x 224, never run) is
    a state_dict entry of the port's model (built on the meta device) of
    the same shape, and nothing else is; 148,196,314 parameters with
    B-spline convs."""
    jm = jeff.efficientnetv2_kan(arch="s", num_classes=10, kan_conv="KAN")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 224, 224, 3), jnp.float32),
        train=False))
    leaves = jax.tree_util.tree_flatten_with_path(shapes)[0]
    want = {".".join(_scope(k.key) for k in path[1:]): tuple(a.shape)
            for path, a in leaves}
    tm = efficientnetv2_kan(arch="s", num_classes=10, kan_conv="KAN",
                            device="meta")
    assert {k: tuple(v.shape) for k, v in tm.state_dict().items()} == want
    n = sum(int(np.prod(a.shape)) for path, a in leaves
            if path[0].key == "params")
    assert n == sum(p.numel() for p in tm.parameters()) == 148196314


def test_arch_s_fastkan_parameter_count():
    """bench.py's config-5 model: FastKAN, 100,136,306 parameters (by
    jax.eval_shape of the JAX builder)."""
    tm = efficientnetv2_kan(arch="s", num_classes=10, kan_conv="FastKAN",
                            device="meta")
    assert sum(p.numel() for p in tm.parameters()) == 100136306
    assert tm.model_name == "EfficientNetV2S-KAN_Linear_FASTKAN"


def test_serve_cli_serves_the_jax_cli_model():
    """The same argv on both CLIs (train.py's vocabulary: EfficientNetV2
    kan_tiny, KAN convs, BatchNorm2d, CIFAR-10 at 32 x 32) builds the same
    model: the JAX CLI's input shape and model name, and JAX's seeded
    variables (running statistics drawn off their init; flax's
    Checkpoint_EffBlock_i names) load into the port's engine with
    strict=True, whose logits agree with the JAX model's eval logits
    (float32, 1e-4); train.py's train-only flags are accepted.  --fold_bn
    is refused for this model."""
    from convkan_tpu.migrate import _dataset_input_shape, _load_train_module

    argv = ["--model", "EfficientNetV2KAN", "--arch", "kan_tiny",
            "--kan_conv", "KAN", "--dataset", "CIFAR10", "--init_random",
            "--seed", "3", "--buckets", "2", "--stochastic_depth_prob", "0.5",
            "--dropout_linear", "0.3"]
    train = _load_train_module()
    p = train.build_parser()
    p.add_argument("--init_random", action="store_true")
    p.add_argument("--buckets", default="1,8,64")
    jargs = p.parse_args(argv)
    shape = _dataset_input_shape(jargs)
    jm = train.build_model(jargs, shape, 10)
    with pytest.raises(SystemExit):
        build_engine(build_parser().parse_args(argv + ["--device", "cpu",
                                                       "--fold_bn"]))
    engine, name = build_engine(build_parser().parse_args(
        argv + ["--device", "cpu"]))
    try:
        assert name == jm.model_name
        assert engine.input_shape == shape == (32, 32, 3)
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
