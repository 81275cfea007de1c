"""The port's LayerNorm, RMSNorm and GroupNorm against the JAX package's
(``utils/norms.py``) in float64, channel-last: outputs and the gradients
of x and of every parameter within 1e-12 of the largest entry, affine on
and off, RMSNorm with its dtype-epsilon default and a given eps, GroupNorm
at 1, 2 and 6 groups; the registry's "None" builds no norm (``Identity``)
and a KAN conv with it has no norm parameters and matches JAX's; the
reference's ``affine`` reaches ``elementwise_affine``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.utils import norms as jnorms
from convkan_tpu_torch.nn.kan_conv import KanConvND
from convkan_tpu_torch.utils import norms
from convkan_tpu_torch.utils.from_jax import state_dict_from_jax

torch.set_num_threads(1)
TOL = 1e-12


def _close(got, want, what):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, what
    assert np.max(np.abs(got - want)) <= TOL * np.max(np.abs(want)), what


def _hold(jcls, tcls, C, kwargs, seed):
    rng = np.random.RandomState(seed)
    x = rng.normal(0.5, 2.0, (2, 3, 4, C))
    g = rng.normal(0.0, 1.0, x.shape)
    jm = jnorms.make_norm(jcls, C, **kwargs)
    variables = jm.init(jax.random.PRNGKey(0), jnp.zeros(x.shape, jnp.float32))
    params = jax.tree_util.tree_map(
        lambda s: rng.normal(1.0, 0.3, s.shape), variables.get("params", {}))

    def f(xx, p):
        y = jm.apply({"params": p}, xx)
        return jnp.sum(y * g), y

    (_, want), (jdx, jdp) = jax.value_and_grad(f, argnums=(0, 1),
                                               has_aux=True)(
        jnp.asarray(x), params)
    tm = norms.make_norm(tcls, C, **kwargs).double()
    assert type(tm) is tcls
    tm.load_state_dict(state_dict_from_jax(params), strict=True)
    xt = torch.from_numpy(x).requires_grad_(True)
    y = tm(xt)
    (y * torch.from_numpy(g)).sum().backward()
    _close(y.detach(), want, "y")
    _close(xt.grad, jdx, "dx")
    want_grads = state_dict_from_jax(jdp)
    assert set(want_grads) == {n for n, _ in tm.named_parameters()}
    for name, p in tm.named_parameters():
        _close(p.grad, want_grads[name], "d " + name)


@pytest.mark.parametrize("affine", [True, False])
def test_layer_norm_matches_jax_f64(affine):
    _hold("LayerNorm", norms.LayerNorm, 6, {"affine": affine}, 1 + affine)


@pytest.mark.parametrize("kwargs", [{}, {"eps": 1e-3},
                                    {"affine": False}])
def test_rms_norm_matches_jax_f64(kwargs):
    _hold("RMSNorm", norms.RMSNorm, 5, kwargs, 3 + len(kwargs))


@pytest.mark.parametrize("groups,affine", [(1, True), (2, True), (6, False)])
def test_group_norm_matches_jax_f64(groups, affine):
    _hold("GroupNorm", norms.GroupNorm, 6,
          {"num_groups": groups, "affine": affine}, groups)


def test_none_builds_no_norm():
    assert norms.resolve_norm("None") is None
    ident = norms.make_norm("None", 4, affine=True, eps=1e-3)
    assert isinstance(ident, norms.Identity) and not ident.state_dict()
    x = torch.randn(2, 3, 3, 4)
    assert ident(x) is x
    with pytest.raises(ValueError):
        norms.GroupNorm(6, num_groups=4)


def test_kan_conv_without_a_norm_matches_jax_f64():
    rng = np.random.RandomState(5)
    x = rng.normal(0.0, 1.0, (2, 5, 5, 3))
    jm = JaxKanConvND(family="kan", input_dim=3, output_dim=4, kernel_size=3,
                      padding=1, norm_layer=jnorms.resolve_norm("None"),
                      param_dtype=jnp.float64)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    assert set(variables["params"]) == {"base_w", "poly_w", "prelu"}
    want = jm.apply(variables, jnp.asarray(x), train=False)
    tm = KanConvND("kan", 3, 4, 3, padding=1, norm_layer="None",
                   device="cpu", dtype=torch.float64)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    _close(tm(torch.from_numpy(x)).detach(), want, "y")


def test_layer_norm_output_norm_of_a_conv_loads_from_jax():
    """A conv's LayerNorm (flax scope LayerNorm_0) is the port's ``norm``."""
    rng = np.random.RandomState(6)
    x = rng.normal(0.0, 1.0, (2, 5, 5, 3))
    jm = JaxKanConvND(family="cheby", input_dim=3, output_dim=4,
                      kernel_size=3, padding=1, norm_layer=jnorms.LayerNorm,
                      param_dtype=jnp.float64)
    variables = jm.init(jax.random.PRNGKey(1), jnp.asarray(x), train=False)
    variables = jax.tree_util.tree_map(
        lambda a: rng.normal(0.5, 0.5, a.shape), variables)
    assert "LayerNorm_0" in variables["params"]
    want = jm.apply(variables, jnp.asarray(x), train=False)
    tm = KanConvND("cheby", 3, 4, 3, padding=1, norm_layer="LayerNorm",
                   device="cpu", dtype=torch.float64)
    tm.load_state_dict(state_dict_from_jax(variables), strict=True)
    _close(tm(torch.from_numpy(x)).detach(), want, "y")
