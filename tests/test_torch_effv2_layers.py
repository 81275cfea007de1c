"""The layers KAN-EfficientNetV2 adds to the port, against the JAX package
on the CPU:

* ``SqueezeExcitation`` built with its defaults computes JAX's function
  (ReLU, then sigmoid as the scale; float64, 1e-12);
* ``DropPath`` with JAX's keep mask (recorded by a flax method
  interceptor and given to the port's draw): train mode, eval mode and
  drop_prob 0 (float64, exact);
* the activations ``sigmoid``, ``identity`` and "None" against JAX's
  registry, and a KAN conv built with ``base_activation=None`` taking the
  identity base path;
* ``resolve_remat_policy``: the policies that save nothing, the queued
  selective ones, an unknown name;
* a rematerialized block (``ops/remat_policy.py::checkpoint_block``) in a
  model with DropPath (EfficientNetV2 tiny) and with channel dropout
  (MobileNetV3-small) and BatchNorm: the same loss, gradients, masks and
  running statistics as without remat, over two steps from one generator
  (float64, exact or 1e-12); with a plain ``torch.utils.checkpoint``
  wrapper the masks of the recompute differ and the statistics move
  twice, which the same checks catch.
"""

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from convkan_tpu.ops.layers import DropPath as JaxDropPath
from convkan_tpu.ops.layers import SqueezeExcitation as JaxSE
from convkan_tpu.utils.activations import ACTIVATIONS as JAX_ACTIVATIONS
from convkan_tpu_torch.models import efficientnetv2 as effv2
from convkan_tpu_torch.models import mobilenetv3 as mnv3
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.ops import layers
from convkan_tpu_torch.ops.remat_policy import resolve_remat_policy
from convkan_tpu_torch.utils.activations import ACTIVATIONS, \
    resolve_activation
from convkan_tpu_torch.utils.norms import BatchNorm

torch.set_num_threads(1)


def test_squeeze_excitation_defaults_match_jax():
    """JAX's SqueezeExcitation defaults (relu, sigmoid) against the port's
    defaults, from the same weights: the port's scale activation was
    hardsigmoid before, a different function."""
    rng = np.random.RandomState(0)
    x = rng.normal(0.0, 1.0, (3, 5, 5, 16))
    jm = JaxSE(input_channels=16, squeeze_channels=4,
               param_dtype=jnp.float64)
    params = jm.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    params = jax.tree_util.tree_map(
        lambda a: rng.normal(0.0, 1.5, a.shape), params)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    tm = layers.SqueezeExcitation(16, 4, device="cpu", dtype=torch.float64)
    tm.load_state_dict({k: torch.from_numpy(np.asarray(v))
                        for k, v in params.items()}, strict=True)
    got = tm(torch.from_numpy(x)).detach().numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
    # the gate is a sigmoid: outside hardsigmoid's (-3, 3) it does not
    # saturate to exactly 0 or 1
    assert tm.scale_activation is ACTIVATIONS["sigmoid"]


def _intercept_drop_path(masks):
    """A flax method interceptor that records the keep mask of every
    DropPath the JAX module calls."""
    def interceptor(next_fun, args, kwargs, context):
        out = next_fun(*args, **kwargs)
        if isinstance(context.module, JaxDropPath) and \
                context.method_name == "__call__":
            masks.append(np.asarray(out != 0))
        return out
    return interceptor


@pytest.mark.parametrize("drop_prob,train", [(0.4, True), (0.4, False),
                                             (0.0, True)])
def test_drop_path_matches_jax(drop_prob, train, monkeypatch):
    """x / keep * mask with JAX's per-sample mask, in float64, exactly;
    an identity in eval mode and at drop_prob 0 (no draw then)."""
    x = np.random.RandomState(1).normal(0.0, 1.0, (16, 3, 3, 4)) + 5.0
    masks = []
    with fnn.intercept_methods(_intercept_drop_path(masks)):
        want = np.asarray(JaxDropPath(drop_prob=drop_prob).apply(
            {}, jnp.asarray(x), train=train,
            rngs={"dropout": jax.random.PRNGKey(3)}))
    draws = []
    if masks and train and drop_prob > 0:
        keep = masks[0][:, :1, :1, :1]
        assert (masks[0] == keep).all() and 0 < keep.sum() < keep.size

        def draw(shape, device, gen=None):
            draws.append(tuple(shape))
            return torch.from_numpy(np.where(keep, 0.0, 0.99))
        monkeypatch.setattr(layers, "uniform", draw)
    else:
        monkeypatch.setattr(layers, "uniform", lambda *a: draws.append(a))
    m = layers.DropPath(drop_prob).train(train)
    got = m(torch.from_numpy(x), torch.Generator()).numpy()
    assert np.array_equal(got, want)
    assert draws == ([(16, 1, 1, 1)] if train and drop_prob > 0 else [])
    if not (train and drop_prob > 0):
        assert np.array_equal(got, x)


def test_activations_match_jax_registry():
    x = torch.linspace(-6.0, 6.0, 241, dtype=torch.float64)
    for name in ("sigmoid", "identity"):
        want = np.asarray(JAX_ACTIVATIONS[name](jnp.asarray(x.numpy())))
        np.testing.assert_allclose(ACTIVATIONS[name](x).numpy(), want,
                                   rtol=1e-15, atol=1e-15)
    # the CLI's "None": no activation in JAX, the identity in the port
    assert JAX_ACTIVATIONS["None"] is None
    assert resolve_activation("None")(x) is x
    for act in (None, "None", "identity"):
        conv = KanConvND("kan", 4, 6, 1, base_activation=act, device="cpu")
        assert conv.act == "identity" and conv.basis.act == "identity"
        assert conv.basis.R == conv.basis.K + 1     # the base path stays
    assert KanConvND("gram", 4, 6, 1, base_activation=None,
                     device="cpu").basis.key == ("gram", 3, "identity")


def test_resolve_remat_policy():
    for name in (None, "", "full", "nothing"):
        assert resolve_remat_policy(name) is None
    for name in ("except_basis", "dots", "offload_basis"):
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            resolve_remat_policy(name)
        with pytest.raises(NotImplementedError):
            effv2.efficientnetv2_kan_small(remat=True, remat_policy=name,
                                           device="cpu")
    with pytest.raises(ValueError):
        resolve_remat_policy("everything")


def _plain_checkpoint(block, x, generator=None):
    """torch.utils.checkpoint alone, without the masks' replay and the
    running statistics' guard."""
    if not torch.is_grad_enabled():
        return block(x, generator)
    return checkpoint(lambda inp: block(inp, generator), x,
                      use_reentrant=False)


def _models(remat):
    """A model with DropPath (tiny, stochastic depth 0.5) and one with
    channel dropout in its KAN convs (MobileNetV3-small at width 0.25,
    conv_dropout 0.3, B-spline convs on the plain route under dropout),
    both with BatchNorm, float64, from one seed."""
    gen = torch.Generator().manual_seed(0)
    return {
        "effv2": effv2.efficientnetv2_kan_small(
            arch="tiny", width_mult=0.5, stochastic_depth_prob=0.5,
            dropout=0.0,
            remat=remat, generator=gen, device="cpu", dtype=torch.float64),
        "mnv3": mnv3.mobilenet_v3_kan(
            "small", num_classes=10, width_mult=0.25, dropout=0.0,
            conv_dropout=0.3, remat=remat,
            generator=torch.Generator().manual_seed(0), device="cpu",
            dtype=torch.float64)}


def _run(model, size, record):
    """Two train-mode forward/backward passes from one generator: the
    losses, the gradients, the running statistics, and the output of
    every DropPath and conv at each of its calls (the recompute's
    included)."""
    hooks = [m.register_forward_hook(
        lambda mod, i, o, n=n: record.setdefault(n, []).append(
            (o != 0).detach().clone()))
        for n, m in model.named_modules()
        if isinstance(m, layers.DropPath) and m.drop_prob > 0]
    gen = torch.Generator().manual_seed(5)
    x = torch.from_numpy(np.random.RandomState(2).normal(
        0.0, 1.0, (8, size, size, 3)))
    out = []
    for _ in range(2):
        model.zero_grad()
        loss = model.train()(x, gen).square().mean()
        loss.backward()
        out.append((loss.item(), {n: p.grad.clone()
                                  for n, p in model.named_parameters()}))
    for h in hooks:
        h.remove()
    stats = {n: b.clone() for n, b in model.named_buffers()}
    return out, stats, gen.get_state()


@pytest.mark.parametrize("name,size", [("effv2", 32), ("mnv3", 32)])
def test_remat_block_replays_masks_and_moves_statistics_once(
        name, size, monkeypatch):
    """remat=True against remat=False from the same weights and generator:
    equal losses, gradients (1e-12 of the largest), DropPath masks (each
    recompute draws the forward's), running statistics (exactly: moved
    once per step) and the generator's state after the steps.  The same
    comparison with a plain torch.utils.checkpoint wrapper fails."""
    ref_masks, got_masks, plain_masks = {}, {}, {}
    ref, ref_stats, ref_gen = _run(_models(False)[name], size, ref_masks)
    # the whole block runs again (no early stop), so that every DropPath's
    # recompute is recorded
    with set_checkpoint_early_stop(False):
        got, got_stats, got_gen = _run(_models(True)[name], size, got_masks)
    assert any(isinstance(m, BatchNorm) for m in _models(False)[name]
               .modules())

    def same(a, b, a_stats, b_stats):
        grads = all(
            abs(la - lb) <= 1e-12 * abs(lb) and all(
                (ga[k] - gb[k]).abs().max() <= 1e-12 * (gb[k].abs().max()
                                                        + 1e-300)
                for k in gb) for (la, ga), (lb, gb) in zip(a, b))
        stats = all(torch.equal(a_stats[k], b_stats[k]) for k in b_stats)
        return grads, stats

    assert same(got, ref, got_stats, ref_stats) == (True, True)
    assert torch.equal(got_gen, ref_gen)
    if name == "effv2":
        assert ref_masks and all(len(v) == 2 for v in ref_masks.values())
        # each DropPath ran again in the recompute, with the same mask
        for k, v in got_masks.items():
            assert len(v) == 4 and all(torch.equal(v[i], v[i + 1])
                                       for i in (0, 2))
            assert torch.equal(v[0], ref_masks[k][0])
            assert torch.equal(v[2], ref_masks[k][1])
        assert any(not v[0].all() for v in ref_masks.values())
    module = effv2 if name == "effv2" else mnv3
    monkeypatch.setattr(module, "checkpoint_block", _plain_checkpoint)
    plain, plain_stats, _ = _run(_models(True)[name], size, plain_masks)
    grads_ok, stats_ok = same(plain, ref, plain_stats, ref_stats)
    assert not grads_ok and not stats_ok
