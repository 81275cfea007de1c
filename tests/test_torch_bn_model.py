"""Port parity for the BatchNorm slice as a whole, against the JAX package
in float64: the B-spline KAN-VGG16_small with train.py's BatchNorm2d
(eval logits from running statistics off their init, and one train step
with its batch_stats), fold_batch_norms (the same folded weights, the eval
logits unchanged, what follows each norm left in place, the eps), the
serving CLI's train.py defaults (the same model as JAX's serving CLI) and
--fold_bn / --bn_eps, and BASELINE config 4's WavKAN stack as bench.py
builds it (one train step at a small batch)."""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.migrate import _load_train_module
from convkan_tpu.models.vgg import VGGKAN as JaxVGGKAN
from convkan_tpu.models.vgg import vggkan as jax_vggkan
from convkan_tpu.nn.wav_conv import WavKANConv2DLayer as JaxWavLayer
from convkan_tpu.ops.layers import Linear as JaxLinear
from convkan_tpu.ops.pooling import adaptive_avg_pool as jax_avg_pool
from convkan_tpu.serve import build_engine as jax_build_engine
from convkan_tpu.train import data as jdata
from convkan_tpu.train import loop as jloop
from convkan_tpu.train import metrics as jmetrics
from convkan_tpu.train import state as jstate
from convkan_tpu.utils.fold_bn import fold_batch_norms as jax_fold
from convkan_tpu_torch.models.vgg import vggkan
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.nn.wav_conv import WavKANConv2DLayer
from convkan_tpu_torch.ops.layers import Linear
from convkan_tpu_torch.ops.pooling import adaptive_avg_pool, max_pool
from convkan_tpu_torch.serve import build_engine, build_parser
from convkan_tpu_torch.train import loop, state
from convkan_tpu_torch.train.metrics import cross_entropy_loss
from convkan_tpu_torch.utils.fold_bn import fold_batch_norms
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax
from convkan_tpu_torch.utils.norms import BatchNorm

torch.set_num_threads(1)
KW = dict(arch="VGG16_small", kan_conv="KAN", classifier_type="Linear",
          kan_norm_layer="BatchNorm2d")


def _close(got, want, what, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _draw(path, s, rng):
    """Weights N(0, 0.15); a BatchNorm's weight N(1, 0.2), bias N(0, 0.2),
    running mean N(0, 0.3), running var U(0.5, 2); PReLU 0.25."""
    name = jax.tree_util.keystr(path)
    return (rng.normal(1.0, 0.2, s.shape) if "'weight'" in name else
            rng.normal(0.0, 0.3, s.shape) if "'mean'" in name else
            rng.uniform(0.5, 2.0, s.shape) if "'var'" in name else
            np.full(s.shape, 0.25) if "prelu" in name else
            rng.normal(0.0, 0.2 if "'bias'" in name else 0.15, s.shape))


def _jax_variables(jm, rng, shape=(1, 32, 32, 3)):
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros(shape, jnp.float32), train=False))
    return jax.tree_util.tree_map_with_path(
        lambda p, s: _draw(p, s, rng), shapes)


def test_vgg16_small_batchnorm_logits_match_jax_f64():
    """13 KAN convs, each with BatchNorm (affine) and its running
    statistics carried over by from_jax; eval logits from those statistics
    against JAX's, and the image moves them."""
    rng = np.random.RandomState(0)
    jm = jax_vggkan(3, 10, **KW)
    variables = _jax_variables(jm, rng)
    assert len(variables["batch_stats"]) == 13
    x = rng.normal(0.0, 1.0, (2, 32, 32, 3))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))
    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **KW)
    assert isinstance(tm.KanConvND_12.norm, BatchNorm)
    assert tm.KanConvND_0.norm.weight is not None   # affine, as in JAX
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    _close(got, want, "logits")
    assert np.max(np.abs(got[1] - got[0])) > 1e-3


class _JaxVGGKANf64(JaxVGGKAN):
    """The JAX VGGKAN taking its (float32) normalized batch in float64."""

    def __call__(self, x, train: bool = True):
        if not self.is_initializing():
            x = x.astype(jnp.float64)
        return super().__call__(x, train=train)


def test_train_step_with_batch_stats_matches_jax_f64(monkeypatch):
    """One port train step against one JAX make_train_step step (its
    ``mutable=["batch_stats"]``) from the same float64 weights and running
    statistics (VGG16_small, batch 2, no dropout; XLA's normalized batch on
    both sides, see tests/test_torch_train.py): the loss to 1e-8, every
    gradient to 1e-10 of the largest, the parameters after the AdamW step
    as in tests/test_torch_gram_model.py, and each conv's running mean and
    var after the step to 1e-10 (moved once, as JAX moves them)."""
    rng = np.random.RandomState(1)
    kw = dict(KW, dropout_linear=0.0, conv_dropout=0.0)
    jm = _JaxVGGKANf64(input_channels=3, num_classes=10, **kw)
    variables = _jax_variables(jm, rng)
    params, stats = variables["params"], variables["batch_stats"]
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=2)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats=stats,
                           tx=tx)
    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **kw)
    tm.load_state_dict(state_dict_from_jax(js), strict=True)
    ts = state.create_train_state(tm, 1e-3, 1e-3, 0.8, steps_per_epoch=2,
                                  generator=torch.Generator())
    # the running statistics are buffers: the optimizer does not see them
    assert sum(len(g["params"]) for g in ts.optimizer.param_groups) == \
        len(list(tm.parameters())) == 13 * 5 + 2
    xla_normalize = jax.jit(jdata.normalize_batch, static_argnums=1)
    monkeypatch.setattr(loop, "train_batch", lambda x, ds, aug, **_: (
        torch.from_numpy(np.array(xla_normalize(jnp.asarray(x.numpy()),
                                                ds)))))
    x = rng.randint(0, 256, (2, 32, 32, 3), np.uint8)
    y = rng.randint(0, 10, 2).astype(np.int32)
    xn = xla_normalize(jnp.asarray(x), "CIFAR10")
    jgrad = jax.jit(jax.grad(lambda p: jmetrics.cross_entropy_loss(
        jm.apply({"params": p, "batch_stats": stats}, xn, train=True,
                 mutable=["batch_stats"])[0], jnp.asarray(y))))(params)
    js, jloss = jloop.make_train_step(jm, "CIFAR10", augment=False)(
        js, jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(y))
    tloss = loop.make_train_step(tm, "CIFAR10", augment=False)(
        ts, torch.from_numpy(x), torch.from_numpy(y))
    assert abs(tloss.item() - float(jloss)) <= 1e-8
    want_grads = state_dict_from_jax(jgrad)
    largest = max(a.abs().max().item() for a in want_grads.values())
    want_params = state_dict_from_jax(js.params)
    for k, prm in tm.named_parameters():
        g = want_grads[k].numpy()
        assert np.max(np.abs(prm.grad.numpy() - g)) <= 1e-10 * largest, k
        want = want_params[k].numpy()
        slope = 1e-3 / 1e-8 * np.max(np.abs(prm.grad.numpy() - g))
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + slope, k + " after the step"
    before = state_dict_from_jax({"params": {}, "batch_stats": stats})
    after = state_dict_from_jax({"params": {}, "batch_stats": js.batch_stats})
    assert len(after) == 26
    for k, want in after.items():
        got = tm.state_dict()[k].numpy()
        _close(got, want.numpy(), k)
        assert np.max(np.abs(got - before[k].numpy())) > 1e-6, k


@pytest.mark.parametrize("kan_conv", ["KAN", "ChebyKAN", "GRAMKAN"])
def test_fold_batch_norms_matches_jax_f64(kan_conv):
    """The port's fold of each conv's BatchNorm (PReLU after it for KAN,
    nothing for ChebyKAN, SiLU for GRAMKAN) against the JAX package's on
    the same variables: poly_w, base_w, the norm's weight and mean to
    1e-12; the folded variance gives var + eps == 1 exactly (in float64
    here; JAX's float32 value does so in float32); the eval logits
    unchanged to 1e-10; every other parameter untouched."""
    kw = dict(KW, arch="VGG16_kansmall", kan_conv=kan_conv)
    rng = np.random.RandomState(2)
    jm = jax_vggkan(3, 10, **kw)
    variables = _jax_variables(jm, rng)
    folded, n = jax_fold(variables, eps=1e-5)
    assert n == 13
    tm = vggkan(3, 10, device="cpu", dtype=torch.float64, **kw).eval()
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    x = torch.from_numpy(rng.normal(0.0, 1.0, (2, 32, 32, 3)))
    with torch.no_grad():
        before = tm(x).numpy()
    assert fold_batch_norms(tm, eps=1e-5) == 13
    want = state_dict_from_jax(folded)
    unit = {k for k in want if k.endswith(".norm.var")}
    assert len(unit) == 13
    for k, t in tm.state_dict().items():
        if k in unit:
            assert bool(((t + 1e-5) == 1.0).all()), k
            assert (np.float32(want[k].numpy()) + np.float32(1e-5) ==
                    np.float32(1.0)).all(), k
            continue
        _close(t.numpy(), want[k].numpy(), k, tol=1e-12)
        if k.endswith(("prelu", "beta_weights", ".norm.bias", ".b", ".w")):
            _close(t.numpy(), state_dict_from_jax(variables)[k].numpy(), k,
                   tol=0.0)
    with torch.no_grad():
        _close(tm(x).numpy(), before, "logits after folding")


def test_fold_uses_the_given_eps_and_leaves_wavkan_alone():
    """Two KAN convs whose BatchNorms take eps 1e-3 (norm_kwargs): folded
    with that eps the eval output is unchanged, with the default 1e-5 it
    is not; a WavKAN model has nothing to fold (as in JAX)."""
    gen = torch.Generator().manual_seed(0)
    convs = torch.nn.Sequential(*[
        KanConvND("kan", c, 4, 3, padding=1, norm_layer="BatchNorm2d",
                  norm_kwargs={"eps": 1e-3}, generator=gen, device="cpu",
                  dtype=torch.float64) for c in (3, 4)])
    with torch.no_grad():
        for conv in convs:
            conv.norm.mean.normal_(0.0, 0.3, generator=gen)
            conv.norm.var.uniform_(0.5, 2.0, generator=gen)
    x = torch.randn(2, 6, 6, 3, generator=gen, dtype=torch.float64)
    with torch.no_grad():
        want = convs.eval()(x)
        right, wrong = (torch.nn.Sequential(*[
            KanConvND("kan", c, 4, 3, padding=1, norm_layer="BatchNorm2d",
                      norm_kwargs={"eps": 1e-3}, device="cpu",
                      dtype=torch.float64) for c in (3, 4)]).eval()
            for _ in range(2))
    right.load_state_dict(convs.state_dict())
    wrong.load_state_dict(convs.state_dict())
    assert fold_batch_norms(right, eps=1e-3) == 2
    assert fold_batch_norms(wrong) == 2
    with torch.no_grad():
        _close(right(x).numpy(), want.numpy(), "folded with eps 1e-3")
        assert (wrong(x) - want).abs().max() > 1e-5
    wav = vggkan(3, 10, arch="VGG16_kansmall", kan_conv="WavKAN",
                 kan_norm_layer="BatchNorm2d", device="cpu",
                 generator=torch.Generator().manual_seed(0))
    sd = {k: v.clone() for k, v in wav.state_dict().items()}
    assert fold_batch_norms(wav) == 0
    assert all(torch.equal(v, wav.state_dict()[k]) for k, v in sd.items())


def _jax_cli_args(argv):
    train = _load_train_module()
    p = train.build_parser()
    for flag in ("--init_random", "--fold_bn", "--bf16"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--kind", default="best")
    p.add_argument("--ckpt_name", default=None)
    p.add_argument("--bn_eps", type=float, default=1e-5)
    p.add_argument("--buckets", default="1,8,64")
    p.add_argument("--batch_timeout_ms", type=float, default=2.0)
    return train, p.parse_args(argv)


def test_serve_cli_serves_the_jax_cli_model():
    """The same serving argv (train.py's vocabulary, its BatchNorm2d
    default) on both CLIs builds the same model: the port's takes the JAX
    CLI's seeded variables with strict=True, its engine's logits match the
    JAX engine's (float32, 1e-4), and, with running statistics off their
    init, the JAX model's eval logits (JAX's train.build_model), which
    those statistics move."""
    argv = ["--model", "VGGKAN", "--arch", "VGG16_kansmall", "--dataset",
            "CIFAR10", "--init_random", "--seed", "42", "--buckets", "2"]
    train, jargs = _jax_cli_args(argv)
    jengine, jname = jax_build_engine(jargs, train)
    engine, name = build_engine(build_parser().parse_args(
        argv + ["--device", "cpu"]))
    try:
        assert name == jname == "VGGKAN_Linear_KAN_VGG16_kansmall"
        assert isinstance(engine.model.KanConvND_0.norm, BatchNorm)
        jm = train.build_model(jargs, (32, 32, 3), 10)
        variables = jm.init(jax.random.PRNGKey(42),
                            jnp.zeros((1, 32, 32, 3), jnp.float32),
                            train=False)
        engine.model.load_state_dict(state_dict_from_jax(variables),
                                     strict=True)
        imgs = np.random.RandomState(0).randint(0, 256, (2, 32, 32, 3),
                                                np.uint8)
        first = engine.predict(imgs)
        np.testing.assert_allclose(first, jengine.predict(imgs), rtol=1e-4,
                                   atol=1e-4)
        rng = np.random.RandomState(1)
        variables = {"params": variables["params"],
                     "batch_stats": jax.tree_util.tree_map_with_path(
                         lambda p, s: _draw(p, s, rng).astype(np.float32),
                         variables["batch_stats"])}
        engine.model.load_state_dict(state_dict_from_jax(variables),
                                     strict=True)
        want = jm.apply(variables, jdata.normalize_batch(
            jnp.asarray(imgs), "CIFAR10"), train=False)
        got = engine.predict(imgs)
        np.testing.assert_allclose(got, np.asarray(want), rtol=1e-4,
                                   atol=1e-4)
        assert np.abs(got - first).max() > 1e-3
    finally:
        engine.close()
        jengine.close()


def test_serve_cli_fold_bn_and_bn_eps():
    """--fold_bn folds the 13 BatchNorms with --bn_eps (their variance then
    gives exactly 1 with that eps) and serves the unfolded engine's
    logits; --kan_norm_layer InstanceNorm2d builds InstanceNorm convs."""
    base = ["--arch", "VGG16_kansmall", "--init_random", "--device", "cpu",
            "--buckets", "2"]
    imgs = np.random.RandomState(3).randint(0, 256, (2, 32, 32, 3),
                                            np.uint8)
    outs = []
    for extra in ([], ["--fold_bn"], ["--fold_bn", "--bn_eps", "0.25"],
                  ["--kan_norm_layer", "InstanceNorm2d"]):
        engine, _ = build_engine(build_parser().parse_args(base + extra))
        try:
            outs.append(engine.predict(imgs))
            norm = engine.model.KanConvND_3.norm
        finally:
            engine.close()
        if "--fold_bn" in extra:
            eps = float(extra[-1]) if "--bn_eps" in extra else 1e-5
            assert torch.equal(norm.var + np.float32(eps),
                               torch.ones_like(norm.var))
            assert torch.equal(norm.weight, torch.ones_like(norm.weight))
        if "InstanceNorm2d" in extra:
            assert not isinstance(norm, BatchNorm)
    np.testing.assert_allclose(outs[1], outs[0], rtol=1e-5, atol=1e-6)
    assert np.abs(outs[2] - outs[0]).max() > 1e-6


# ------------------------------------------------ BASELINE config 4
class _JaxWavNet(fnn.Module):
    """bench.py's config-4 stack (its WavNet) in float64."""

    @fnn.compact
    def __call__(self, x, train: bool = True):
        for c in (32, 64, 128):
            x = JaxWavLayer(x.shape[-1], c, 3, padding=1,
                            wavelet_type="mexican_hat", wav_version="fast",
                            param_dtype=jnp.float64)(x, train=train)
            x = fnn.max_pool(x, (2, 2), strides=(2, 2))
        x = jax_avg_pool(x, (1, 1)).reshape(x.shape[0], -1)
        return JaxLinear(x.shape[-1], 100, param_dtype=jnp.float64)(x)


class _WavNet(torch.nn.Module):
    """The same stack from the port's modules, named as flax names it."""

    def __init__(self, **kw):
        super().__init__()
        for i, (c_in, c) in enumerate(((3, 32), (32, 64), (64, 128))):
            self.add_module(f"WavKANConvND_{i}", WavKANConv2DLayer(
                c_in, c, 3, padding=1, wavelet_type="mexican_hat",
                wav_version="fast", **kw))
        self.Linear_0 = Linear(128, 100, **kw)

    def forward(self, x):
        for i in range(3):
            x = max_pool(getattr(self, f"WavKANConvND_{i}")(x), 2, 2)
        return self.Linear_0(adaptive_avg_pool(x, (1, 1)).flatten(1))


def test_config4_stack_train_step_matches_jax_f64():
    """One train step of config 4's stack as bench.py steps it (uniform
    float inputs, CIFAR-100 labels, CE, AdamW with steps_per_epoch 100)
    at batch 4, from the same float64 variables: the loss to 1e-10, the
    gradients to 1e-10 of the largest, the parameters after the step (as
    in the train-step test above) and the three BatchNorms' running
    statistics to 1e-10."""
    rng = np.random.RandomState(4)
    jm = _JaxWavNet()
    xb = rng.rand(4, 32, 32, 3)
    yb = rng.randint(0, 100, 4).astype(np.int32)
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)), train=False))

    def draw(path, s):
        name = jax.tree_util.keystr(path)
        if "scale" in name:
            return 1.0 + 0.3 * rng.rand(*s.shape)
        if "translation" in name:
            return 0.5 * rng.randn(*s.shape)
        return _draw(path, s, rng)

    variables = jax.tree_util.tree_map_with_path(draw, shapes)
    params, stats = variables["params"], variables["batch_stats"]
    tx = jstate.make_optimizer(1e-3, 1e-3, 0.8, steps_per_epoch=100)
    js = jstate.TrainState(step=jnp.zeros((), jnp.int32), params=params,
                           opt_state=tx.init(params), batch_stats=stats,
                           tx=tx)

    def loss_fn(p):
        out, mut = jm.apply({"params": p, "batch_stats": stats},
                            jnp.asarray(xb), train=True,
                            mutable=["batch_stats"])
        return jmetrics.cross_entropy_loss(out, jnp.asarray(yb)), \
            mut["batch_stats"]

    (jloss, new_stats), jgrad = jax.value_and_grad(
        loss_fn, has_aux=True)(params)
    js = js.apply_gradients(jgrad, new_batch_stats=new_stats)

    tm = _WavNet(device="cpu", dtype=torch.float64)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    ts = state.create_train_state(tm, steps_per_epoch=100,
                                  generator=torch.Generator())
    tm.train()
    loss = cross_entropy_loss(tm(torch.from_numpy(xb)),
                              torch.from_numpy(yb))
    ts.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    ts.apply_gradients()
    assert abs(loss.item() - float(jloss)) <= 1e-10 * abs(float(jloss))
    want_grads = state_dict_from_jax(jgrad)
    largest = max(a.abs().max().item() for a in want_grads.values())
    want_params = state_dict_from_jax(js.params)
    for k, prm in tm.named_parameters():
        g = want_grads[k].numpy()
        assert np.max(np.abs(prm.grad.numpy() - g)) <= 1e-10 * largest, k
        want = want_params[k].numpy()
        slope = 1e-3 / 1e-8 * np.max(np.abs(prm.grad.numpy() - g))
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + slope, k + " after the step"
    after = state_dict_from_jax({"params": {}, "batch_stats": js.batch_stats})
    assert len(after) == 6
    for k, want in after.items():
        _close(tm.state_dict()[k].numpy(), want.numpy(), k)
