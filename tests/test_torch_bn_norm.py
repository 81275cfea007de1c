"""Port parity for convkan_tpu_torch.utils.norms.BatchNorm against the JAX
package's BatchNorm in float64 (max |diff| <= 1e-12 of the largest entry):
train mode (batch statistics, the running statistics' update, gradients)
and eval mode (running statistics), affine on and off, a single value per
channel (n = 1), and the registry."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.utils.norms import BatchNorm as JaxBatchNorm
from convkan_tpu_torch.utils.norms import (BatchNorm, InstanceNorm,
                                           make_norm, resolve_norm)

torch.set_num_threads(1)
TOL = 1e-12


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= TOL * max(np.max(np.abs(want)),
                                                   1.0), what


def _pair(C, affine, track=True, rng=None):
    """The JAX module and its variables (weights and running statistics
    off their init), and the port's module holding the same."""
    rng = rng or np.random.RandomState(C)
    params = {"weight": rng.normal(1.0, 0.3, C),
              "bias": rng.normal(0.0, 0.3, C)} if affine else {}
    stats = {"mean": rng.normal(0.0, 0.5, C),
             "var": rng.uniform(0.5, 2.0, C)}
    jm = JaxBatchNorm(num_features=C, affine=affine,
                      track_running_stats=track, param_dtype=jnp.float64)
    tm = BatchNorm(C, affine=affine, track_running_stats=track).double()
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in
                        {**params, **stats}.items()}, strict=True)
    return jm, {"params": params, "batch_stats": stats}, tm


@pytest.mark.parametrize("affine", [True, False])
@pytest.mark.parametrize("train", [True, False])
def test_batchnorm_matches_jax_f64(affine, train):
    """Output, the gradients of a random linear functional of it (x, and
    weight and bias where affine), and the running statistics after the
    call (moved in train mode, kept in eval mode)."""
    C = 5
    rng = np.random.RandomState(7)
    jm, variables, tm = _pair(C, affine, rng=rng)
    x = rng.normal(0.3, 1.7, (3, 4, 6, C))
    g = rng.normal(0.0, 1.0, x.shape)

    def f(xx, p):
        y, mut = jm.apply({"params": p,
                           "batch_stats": variables["batch_stats"]}, xx,
                          train=train, mutable=["batch_stats"])
        return jnp.sum(y * g), (y, mut["batch_stats"])

    (_, (want, jstats)), (jdx, jdp) = jax.value_and_grad(
        f, argnums=(0, 1), has_aux=True)(jnp.asarray(x), variables["params"])
    tm.train(train)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    _close(y.detach().numpy(), want, "y")
    (y * torch.from_numpy(g)).sum().backward()
    _close(xt.grad.numpy(), jdx, "dx")
    for name, p in tm.named_parameters():
        _close(p.grad.numpy(), jdp[name], "d" + name)
    for name in ("mean", "var"):
        _close(getattr(tm, name).numpy(), jstats[name], name)
    moved = not np.allclose(jstats["var"], variables["batch_stats"]["var"])
    assert moved == train


def test_batchnorm_single_value_per_channel():
    """n = B * H * W = 1: the batch variance is 0, so y is the bias, the
    running mean moves towards x and the running variance towards 0
    (JAX's n / max(n - 1, 1))."""
    C = 4
    rng = np.random.RandomState(3)
    jm, variables, tm = _pair(C, True, rng=rng)
    x = rng.normal(0.0, 1.0, (1, 1, 1, C))
    want, mut = jm.apply(variables, jnp.asarray(x), train=True,
                         mutable=["batch_stats"])
    y = tm.train()(torch.from_numpy(x))
    _close(y.detach().numpy(), want, "y")
    _close(y.detach().numpy()[0, 0, 0], variables["params"]["bias"], "bias")
    for name in ("mean", "var"):
        _close(getattr(tm, name).numpy(), mut["batch_stats"][name], name)
    _close(tm.var.numpy(), 0.9 * variables["batch_stats"]["var"], "var")


def test_batchnorm_without_running_stats_uses_the_batch_in_eval():
    C = 3
    rng = np.random.RandomState(5)
    jm, variables, tm = _pair(C, True, track=False, rng=rng)
    x = rng.normal(0.0, 2.0, (2, 3, 3, C))
    want = jm.apply(variables, jnp.asarray(x), train=False)
    _close(tm.eval()(torch.from_numpy(x)).detach().numpy(), want, "y")
    _close(tm.mean.numpy(), variables["batch_stats"]["mean"], "mean kept")


def test_registry_and_signature_filtering():
    for name in ("BatchNorm1d", "BatchNorm2d", "BatchNorm3d"):
        assert resolve_norm(name) is BatchNorm
    assert resolve_norm("InstanceNorm2d") is InstanceNorm
    for name in ("GroupNorm", "LayerNorm", "RMSNorm"):
        assert resolve_norm(name).__name__ == name
    assert resolve_norm("None") is None
    with pytest.raises(NotImplementedError, match="not ported"):
        resolve_norm("SyncBatchNorm")
    bn = make_norm("BatchNorm2d", 6, affine=False, eps=1e-3, num_groups=2)
    assert isinstance(bn, BatchNorm) and bn.weight is None and bn.eps == 1e-3
    assert {k: tuple(v.shape) for k, v in bn.state_dict().items()} == {
        "mean": (6,), "var": (6,)}
    assert torch.equal(bn.mean, torch.zeros(6)) and \
        torch.equal(bn.var, torch.ones(6))
    inorm = make_norm("InstanceNorm2d", 6, momentum=0.3)
    assert isinstance(inorm, InstanceNorm)
