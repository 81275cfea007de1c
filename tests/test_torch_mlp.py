"""Port parity for the stacked KAN MLPs (``nn/mlp.py``) and
``MLP_KAN_FACTORY`` (``factory/mlp_factory.py``) against the JAX package:

* the factory's 17 keys in the JAX order, each builder's defaults (the
  layer config it builds, with and without keyword overrides, None values
  dropped) and a [5, 4, 3] MLP of each key against JAX's in float64 (eval
  logits, 1e-10), which holds ``_build_layer``'s wiring of every family;
* ``KanMLP``'s dropout placement (before the first layer with
  ``first_dropout``, after every layer but the last) in train mode: JAX's
  masks, recorded by a flax method interceptor, given to the port's draw;
  the output and every gradient, 1e-10;
* the golden ``train_steps_kan_mlp``: the reference's two-layer KAN MLP,
  five AdamW steps (lr 1e-3, weight decay 1e-3) in float64 on the port,
  the losses against the reference's within 1e-9 (as
  tests/test_train_parity.py holds the JAX package);
* BASELINE config 2 (bench.py:228-284): ``MLP_KAN_FACTORY["FastKAN"]([784,
  128, 64, 10])``, one train step (cross-entropy, AdamW) from the same
  float64 weights as JAX's ``create_train_state`` step: the loss to 1e-12,
  the gradients to 1e-10 of their largest entry, the parameters after the
  step to 1e-7 of the learning rate (optax's float32 learning rate);
* ``l1_decay`` > 0 raises.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from golden_utils import load_golden

from convkan_tpu.factory.mlp_factory import MLP_KAN_FACTORY as JAX_FACTORY
from convkan_tpu.nn.mlp import KanMLP as JaxKanMLP
from convkan_tpu.utils.torch_compat import convert_linear as T
from convkan_tpu_torch.factory.mlp_factory import MLP_KAN_FACTORY
from convkan_tpu_torch.nn import kan_linear as kl
from convkan_tpu_torch.nn.mlp import KanMLP
from convkan_tpu_torch.ops import dropout as dlib
from convkan_tpu_torch.train.metrics import cross_entropy_loss
from convkan_tpu_torch.train.state import make_optimizer
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-10
T64 = dict(device="cpu", dtype=torch.float64)


def _close(got, want, what, tol=TOL):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= tol * np.max(np.abs(want)), what


def _f64(variables, rng, noise=0.1):
    """JAX's init in float64, moved off it by N(0, noise) (a running
    variance drawn U(0.5, 2))."""
    def draw(path, a):
        a = np.asarray(a, np.float64)
        if "'var'" in jax.tree_util.keystr(path):
            return rng.uniform(0.5, 2.0, a.shape)
        return a + rng.normal(0.0, noise, a.shape)
    return jax.tree_util.tree_map_with_path(draw, variables)


def test_factory_keys_and_defaults():
    assert list(MLP_KAN_FACTORY) == list(JAX_FACTORY)
    assert len(MLP_KAN_FACTORY) == 17
    for key in MLP_KAN_FACTORY:
        for kw in ({}, {"degree": 4, "grid_size": 6, "base_activation":
                        None, "spline_order": 2, "dropout": 0.25,
                        "first_dropout": False}):
            jm = JAX_FACTORY[key]([5, 4], **kw)
            tm = MLP_KAN_FACTORY[key]([5, 4], device="cpu", **kw)
            assert (tm.family, tm.layers_hidden, tm.dropout,
                    tm.first_dropout) == (jm.family, tuple(jm.layers_hidden),
                                          jm.dropout, jm.first_dropout)
            assert tm.cfg == dict(jm.cfg), key
            assert MLP_KAN_FACTORY[key].__name__ == \
                JAX_FACTORY[key].__name__


@pytest.mark.parametrize("key", list(JAX_FACTORY))
def test_factory_mlp_matches_jax_f64(key):
    rng = np.random.RandomState(len(key))
    x = rng.normal(0.0, 0.8, (6, 5))
    jm = JAX_FACTORY[key]([5, 4, 3])
    variables = _f64(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             train=False), rng)
    tm = MLP_KAN_FACTORY[key]([5, 4, 3], **T64)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    want = jm.apply(variables, jnp.asarray(x), train=False)
    _close(tm.eval()(torch.from_numpy(x)).detach(), want, key)


def _record_dropout_masks(masks):
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, fnn.Dropout) and \
                context.method_name == "__call__":
            masks.append(np.asarray(out != 0))
        return out
    return interceptor


@pytest.mark.parametrize("first_dropout", [True, False])
def test_kan_mlp_dropout_placement_matches_jax(monkeypatch, first_dropout):
    """ChebyKAN [6, 5, 4, 3] (no norms) with dropout 0.3 in train mode, on
    a (4, 2, 3) input that both flatten per sample to (4, 6)."""
    rng = np.random.RandomState(int(first_dropout))
    x = rng.normal(0.0, 0.8, (4, 2, 3))
    sizes = [6, 5, 4, 3]
    jm = JaxKanMLP(family="ChebyKAN", layers_hidden=tuple(sizes),
                   dropout=0.3, first_dropout=first_dropout)
    variables = _f64(jm.init(jax.random.PRNGKey(0), jnp.asarray(x),
                             train=False), rng)
    g = rng.normal(0.0, 1.0, (4, 3))
    masks = []

    def f(xx, p):
        return jm.apply({"params": p}, xx, train=True,
                        rngs={"dropout": jax.random.PRNGKey(3)})

    with fnn.intercept_methods(_record_dropout_masks(masks)):
        want = f(jnp.asarray(x), variables["params"])
    jdx, jdp = jax.grad(lambda xx, p: jnp.sum(f(xx, p) * g),
                        argnums=(0, 1))(jnp.asarray(x), variables["params"])
    assert [m.shape for m in masks] == \
        [(4, 6)] * first_dropout + [(4, 5), (4, 4)]
    draws = [np.where(m, 0.0, 0.99) for m in masks]
    monkeypatch.setattr(dlib, "uniform", lambda shape, device, gen=None:
                        torch.from_numpy(draws.pop(0)))
    tm = KanMLP("ChebyKAN", sizes, dropout=0.3, first_dropout=first_dropout,
                **T64)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm.train()(xt)
    assert not draws
    (y * torch.from_numpy(g)).sum().backward()
    _close(y.detach(), want, "y")
    _close(xt.grad, jdx, "dx")
    want_grads = state_dict_from_jax(jdp)
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name], "d " + name)
    with torch.no_grad():
        assert not torch.equal(tm.eval()(xt), y)


def test_l1_decay_raises():
    with pytest.raises(NotImplementedError, match="l1_decay"):
        MLP_KAN_FACTORY["KAN"]([4, 3], l1_decay=0.1, device="cpu")


class _Stack(torch.nn.Module):
    """The golden's model: two KANLinear layers on their own knots."""

    def __init__(self, g1, g2):
        super().__init__()
        self.KANLinear_0 = kl.KANLinear(12, 8, grid_override=g1, **T64)
        self.KANLinear_1 = kl.KANLinear(8, 4, grid_override=g2, **T64)

    def forward(self, x):
        return self.KANLinear_1(self.KANLinear_0(x))


def test_five_adamw_steps_match_the_reference_golden():
    x, _, sd = load_golden("train_steps_kan_mlp")

    def grid(k):
        g = np.asarray(sd[k])
        return tuple(g[0] if g.ndim == 2 else g)

    def layer(prefix):
        out = sd[f"{prefix}.base_weight"].shape[0]
        return {"base_w": T(sd[f"{prefix}.base_weight"]),
                "spline_w": T(sd[f"{prefix}.spline_weight"].reshape(out, -1)),
                "prelu": np.asarray(sd[f"{prefix}.prelu.weight"]).reshape(()),
                "LayerNorm_0": {"weight": sd[f"{prefix}.layer_norm.weight"],
                                "bias": sd[f"{prefix}.layer_norm.bias"]}}

    model = _Stack(grid("l1.grid"), grid("l2.grid"))
    model.load_state_dict(state_dict_from_jax(
        {"KANLinear_0": layer("l1"), "KANLinear_1": layer("l2")}),
        strict=True)
    opt = make_optimizer(model.parameters(), 1e-3, 1e-3)
    xt = torch.from_numpy(np.asarray(x))
    labels = torch.from_numpy(sd["labels"].astype(np.int64))
    losses = []
    for _ in range(5):
        loss = cross_entropy_loss(model(xt), labels)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        losses.append(loss.item())
    np.testing.assert_allclose(losses, sd["losses"], rtol=1e-9, atol=1e-9)


def test_config2_fastkan_mlp_step_matches_jax_f64():
    """bench.py's config-2 model and step (its train=True apply: the MLP
    has no dropout), one step at batch 32 from JAX's seeded init in
    float64."""
    from convkan_tpu.train.metrics import cross_entropy_loss as jce
    from convkan_tpu.train.state import create_train_state as jcreate
    from convkan_tpu_torch.train.state import create_train_state

    rng = np.random.RandomState(2)
    jm = JAX_FACTORY["FastKAN"]([784, 128, 64, 10])
    x = rng.rand(32, 784)
    y = rng.randint(0, 10, 32)
    state = jcreate(jm, jax.random.PRNGKey(0), jnp.zeros((32, 784)),
                    steps_per_epoch=100)
    params = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.float64),
                                    state.params)
    state = state.replace(params=params, opt_state=state.tx.init(params))
    tm = MLP_KAN_FACTORY["FastKAN"]([784, 128, 64, 10], **T64)
    tm.load_state_dict(state_dict_from_jax(params), strict=True)

    def loss_fn(p):
        return jce(jm.apply({"params": p}, jnp.asarray(x), train=True,
                            rngs={"dropout": jax.random.PRNGKey(1)}),
                   jnp.asarray(y))

    jloss, grads = jax.value_and_grad(loss_fn)(state.params)
    state = state.apply_gradients(grads=grads)
    ts = create_train_state(tm, steps_per_epoch=100)
    loss = cross_entropy_loss(tm.train()(torch.from_numpy(x)),
                              torch.from_numpy(y))
    ts.optimizer.zero_grad(set_to_none=True)
    loss.backward()
    ts.apply_gradients()
    assert abs(loss.item() - float(jloss)) <= 1e-12 * abs(float(jloss))
    want_grads = state_dict_from_jax(grads)
    want = state_dict_from_jax(state.params)
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name], "d " + name)
        # AdamW's first step moves each entry by about the learning rate,
        # which optax holds in float32 (1e-3 rounds 4.7e-11 up)
        assert np.abs(p.detach().numpy() - want[name].numpy()).max() <= \
            1e-7 * 1e-3, name
