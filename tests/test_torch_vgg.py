"""Port parity for the slice's model: convkan_tpu_torch VGGKAN
(VGG16_kansmall, KAN convs, Linear head) against the JAX vggkan in
float64, with the weights carried over by vggkan_state_dict_from_jax
(logits max |diff| <= 1e-9)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.models.vgg import vggkan as jax_vggkan
from convkan_tpu_torch.models.vgg import cfgs, vggkan
from convkan_tpu_torch.utils.from_jax import vggkan_state_dict_from_jax

torch.set_num_threads(1)


def _jax_params(model, rng):
    """Random float64 params shaped like the JAX model's (no init compile)."""
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        train=False))
    return jax.tree_util.tree_map(
        lambda s: rng.normal(0.0, 0.15, s.shape), shapes)


def test_vgg16_kansmall_logits_match_jax_f64():
    rng = np.random.RandomState(0)
    jm = jax_vggkan(3, 10, arch="VGG16_kansmall", kan_conv="KAN",
                    classifier_type="Linear")
    variables = _jax_params(jm, rng)
    # PReLU slopes away from the 0.25 default, so their mapping is tested
    variables["params"] = {
        k: ({**v, "prelu": rng.uniform(-0.5, 0.5, (1,))} if "prelu" in v
            else v) for k, v in variables["params"].items()}
    x = rng.normal(0.0, 1.0, (2, 32, 32, 3))
    want = np.asarray(jax.jit(lambda v, xx: jm.apply(v, xx, train=False))(
        variables, jnp.asarray(x)))

    tm = vggkan(3, 10, arch="VGG16_kansmall", kan_conv="KAN",
                classifier_type="Linear", device="cpu", dtype=torch.float64)
    tm.load_state_dict(vggkan_state_dict_from_jax(variables), strict=True)
    got = tm.eval()(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float64 and got.shape == want.shape == (2, 10)
    assert np.max(np.abs(got - want)) <= 1e-9


@pytest.mark.parametrize("arch", sorted(cfgs))
def test_every_arch_builds_with_jax_state_dict_names(arch):
    jm = jax_vggkan(3, 10, arch=arch, kan_conv="KAN", classifier_type="Linear")
    shapes = jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3), jnp.float32),
        train=False))
    want = {f"{m}.{p}": tuple(s.shape)
            for m, ps in shapes["params"].items() for p, s in ps.items()}
    tm = vggkan(3, 10, arch=arch, classifier_type="Linear", device="cpu")
    got = {k: tuple(v.shape) for k, v in tm.state_dict().items()}
    assert got == want


def test_unported_heads_raise():
    with pytest.raises(NotImplementedError):
        vggkan(3, 10, arch="VGG16_kansmall", classifier_type="KAN",
               device="cpu")
