"""Port parity for the ChebyKAN slice as a whole: the ChebyKAN VGG16_kansmall
(logits through utils/from_jax.py, the (1, 1) head's degenerate logits) and
one train step, against the JAX package in float64 (the JAX convs run the
XLA path: the trig form of the basis), plus the serving CLI and the rule
that CPU tensors never reach a kernel."""

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
from convkan_tpu_torch.utils.from_jax import vggkan_state_dict_from_jax

torch.set_num_threads(1)

KW = dict(arch="VGG16_kansmall", kan_conv="ChebyKAN",
          classifier_type="Linear")


def _close(got, want, what, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _jax_params(jm, rng):
    """The JAX model's tree with every leaf N(0, 0.15) (a float64 draw:
    the seeded init of the two packages differs)."""
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        train=False))
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.15, s.shape), shapes)


# 13 poly_w of 9 taps x 4 rows x C x O (sum of C*O: 25,560), and the head
@pytest.mark.parametrize("head,n_params", [((1, 1), 920160 + 650),
                                            ((2, 2), 920160 + 2570)])
def test_vgg16_kansmall_cheby_logits_match_jax_f64(head, n_params):
    """The ChebyKAN VGG16_kansmall from a JAX tree through the converter
    (13 convs of poly_w only).  With train.py's (1, 1) head the trunk ends
    in InstanceNorm (no PReLU after a ChebyKAN conv), whose per-channel
    mean is 0, so the pooled features are 0 and the logits are the Linear
    bias for every image, in JAX and in the port alike; the (2, 2) head
    keeps the last 2x2 map, so the logits see the image."""
    rng = np.random.RandomState(0)
    jm = jax_vggkan(3, 10, expected_feature_shape=head, **KW)
    variables = _jax_params(jm, rng)
    leaves = jax.tree_util.tree_leaves_with_path(variables)
    assert sum(a.size for _, a in leaves) == n_params
    convs = {jax.tree_util.keystr(p) for p, _ in leaves if "KanConvND" in
             jax.tree_util.keystr(p)}
    assert len(convs) == 13 and all("poly_w" in p for p in convs)
    x = rng.normal(0.0, 1.0, (2, 32, 32, 3))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))

    tm = vggkan(3, 10, expected_feature_shape=head, device="cpu",
                dtype=torch.float64, **KW)
    assert tm.model_name == jm.model_name == \
        "VGGKAN_Linear_CHEBYKAN_VGG16_kansmall"
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
    same float64 weights (ChebyKAN VGG16_kansmall with the (2, 2) head;
    32x32 inputs, batch 2, no dropout), with XLA's normalized batch on both
    sides (see tests/test_torch_train.py): the loss to 1e-8, every gradient
    to 1e-10 of the largest gradient entry, the parameters after the AdamW
    step (the same weight decay, the per-epoch ExponentialLR) to 1e-8 of
    their largest entry plus what the gradients' difference moves Adam's
    first step by: that step is lr g / (|g| + eps), whose slope in g is up
    to lr / eps = 1e5, and a ChebyKAN conv has gradients near 0 (the
    centre tap's T_0 = 1 row adds a constant per channel, which the
    InstanceNorm after it removes: its gradient is 0 up to rounding)."""
    rng = np.random.RandomState(1)
    kw = dict(KW, expected_feature_shape=(2, 2), dropout_linear=0.0,
              conv_dropout=0.0)
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
    assert len(names) == 13 + 2 and not any("base_w" in k or "prelu" in k
                                            for k in names)
    for k, prm in tm.named_parameters():
        m, p = k.split(".")
        assert np.max(np.abs(jgrad[m][p])) > 1e-6 * largest, k
        assert np.max(np.abs(prm.grad.numpy() - jgrad[m][p])) <= \
            1e-10 * largest, k
        want = np.asarray(js.params[m][p])
        slope = 1e-3 / 1e-8 * np.max(np.abs(prm.grad.numpy() - jgrad[m][p]))
        assert np.max(np.abs(prm.detach().numpy() - want)) <= \
            1e-8 * np.max(np.abs(want)) + slope, k + " after the step"


def test_cpu_cheby_model_never_reaches_a_kernel_entry(monkeypatch):
    """The CPU path runs the plain versions forward and backward; the C
    entries are never looked up."""
    def refuse(name):
        raise AssertionError(f"kernel entry {name} reached on the CPU")

    monkeypatch.setattr(kc, "_fn", refuse)
    kc.reset_launches()
    m = vggkan(3, 10, expected_feature_shape=(2, 2), device="cpu",
               generator=torch.Generator().manual_seed(0), **KW)
    m(torch.randn(2, 32, 32, 3), torch.Generator().manual_seed(1)) \
        .square().sum().backward()
    assert m.KanConvND_1.poly_w.grad is not None
    assert sum(kc.launches.values()) == 0


def test_serve_cli_builds_the_chebykan_model():
    """--kan_conv ChebyKAN with InstanceNorm builds the model of the JAX
    CLI (train.py's build_model: the (1, 1) head, as train.py builds it
    whatever the conv family and norm): JAX's seeded variables load with
    strict=True and the engines' logits agree (float32, 1e-4)."""
    from convkan_tpu.migrate import _load_train_module
    from convkan_tpu.serve import build_engine as jax_build_engine

    argv = ["--model", "VGGKAN", "--dataset", "CIFAR10", "--arch",
            "VGG16_kansmall", "--kan_conv", "ChebyKAN", "--kan_norm_layer",
            "InstanceNorm2d", "--init_random", "--seed", "4", "--buckets",
            "1,2"]
    train = _load_train_module()
    p = train.build_parser()
    for flag in ("--init_random", "--fold_bn", "--bf16"):
        p.add_argument(flag, action="store_true")
    p.add_argument("--kind", default="best")
    p.add_argument("--ckpt_name", default=None)
    p.add_argument("--bn_eps", type=float, default=1e-5)
    p.add_argument("--buckets", default="1,8,64")
    p.add_argument("--batch_timeout_ms", type=float, default=2.0)
    jargs = p.parse_args(argv)
    jengine, jname = jax_build_engine(jargs, train)
    engine, name = build_engine(build_parser().parse_args(
        argv + ["--device", "cpu"]))
    try:
        assert name == jname == "VGGKAN_Linear_CHEBYKAN_VGG16_kansmall"
        assert engine.model.expected_feature_shape == (1, 1)
        assert engine.model.KanConvND_0.basis == kc.cheby_basis(3)
        jm = train.build_model(jargs, (32, 32, 3), 10)
        variables = jm.init(jax.random.PRNGKey(4),
                            jnp.zeros((1, 32, 32, 3), jnp.float32),
                            train=False)
        engine.model.load_state_dict(
            vggkan_state_dict_from_jax(variables), strict=True)
        imgs = np.random.RandomState(0).randint(0, 256, (3, 32, 32, 3),
                                                np.uint8)
        out = engine.predict(imgs)
        assert out.shape == (3, 10) and np.isfinite(out).all()
        np.testing.assert_allclose(out, jengine.predict(imgs), rtol=1e-4,
                                   atol=1e-4)
    finally:
        engine.close()
        jengine.close()
