"""Port parity for convkan_tpu_torch.nn.kan_conv.KanConvND (family kan,
SiLU or GELU base path, InstanceNorm, PReLU) against the JAX KanConvND in
float64 (max |diff| <= 1e-10), plus the port's device rule."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu_torch.nn.kan_conv import KanConvND

torch.set_num_threads(1)


@pytest.mark.parametrize("C,O,act,prelu", [
    (3, 8, "silu", 0.25),
    (16, 16, "silu", -0.7),
    (5, 12, "gelu", 0.1),
])
def test_kan_conv_module_matches_jax_f64(C, O, act, prelu):
    rng = np.random.RandomState(C + O)
    x = rng.normal(0, 1.2, (2, 8, 8, C))
    params = {"base_w": rng.normal(0, 0.3, (3, 3, C, O)),
              "poly_w": rng.normal(0, 0.3, (3, 3, C * 8, O)),
              "prelu": np.array([prelu])}
    jm = JaxKanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=3,
                      padding=1, base_activation=act, param_dtype=jnp.float64)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x),
                               train=False))
    tm = KanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=3,
                   padding=1, base_activation=act, device="cpu",
                   dtype=torch.float64)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()},
                       strict=True)
    got = tm(torch.from_numpy(x)).detach().numpy()
    assert got.dtype == np.float64 and got.shape == want.shape
    assert np.max(np.abs(got - want)) <= 1e-10


def test_seeded_init_is_deterministic_with_jax_shapes():
    g = lambda: torch.Generator().manual_seed(3)  # noqa: E731
    a = KanConvND("kan", 4, 6, 3, padding=1, generator=g(), device="cpu")
    b = KanConvND("kan", 4, 6, 3, padding=1, generator=g(), device="cpu")
    for (name, p), q in zip(a.state_dict().items(), b.state_dict().values()):
        assert torch.equal(p, q), name
    assert {k: tuple(v.shape) for k, v in a.state_dict().items()} == {
        "base_w": (3, 3, 4, 6), "poly_w": (3, 3, 32, 6), "prelu": (1,)}
    bound = 3 ** 0.5 / (3 * 3 * 32) ** 0.5   # kaiming_uniform, HWIO fan_in
    assert a.poly_w.abs().max() <= bound


@pytest.mark.parametrize("kwargs", [
    {"family": "legendre", "ndim": 3}, {"family": "relukan"}, {"ndim": 3},
    {"kernel_size": (3, 5)}, {"ndim": 1},
])
def test_unported_configs_raise(kwargs):
    base = dict(family="kan", input_dim=4, output_dim=4, kernel_size=3,
                device="cpu")
    base.update(kwargs)
    with pytest.raises(NotImplementedError):
        KanConvND(**base)


def test_device_rule_without_cuda(monkeypatch):
    """The default device is the GPU: a CUDA-less host raises instead of
    quietly running on the CPU, and CPU tensors never launch the kernel."""
    from convkan_tpu_torch import resolve_device
    from convkan_tpu_torch.kernels import kan_conv2d as kc
    from convkan_tpu_torch.models.vgg import vggkan
    from convkan_tpu_torch.serve import InferenceEngine

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        KanConvND("kan", 3, 4, 3, padding=1)
    model = vggkan(3, 10, arch="VGG16_kansmall", classifier_type="Linear",
                   generator=torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        InferenceEngine(model, "CIFAR10", (32, 32, 3), buckets=(1,))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        resolve_device("cuda")
    conv = KanConvND("kan", 3, 4, 3, padding=1, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    kc.reset_launches()
    conv(torch.zeros(1, 4, 4, 3))
    assert sum(kc.launches.values()) == 0


def test_cheby_degree_without_a_kernel_raises_on_cuda(monkeypatch):
    """A ChebyKAN conv of degree 4 has no compiled kernel: on a CUDA tensor
    it raises NotImplementedError before any launch, never falling back to
    the plain version (the tensors are CPU tensors that report themselves
    as CUDA, so this runs without a card)."""
    from convkan_tpu_torch.kernels import kan_conv2d as kc

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    conv = KanConvND("cheby", 3, 4, 3, padding=1, degree=4, device="cpu",
                     generator=torch.Generator().manual_seed(0))
    assert conv.basis.key not in kc.COMPILED and conv.base_w is None
    x = torch.zeros(1, 4, 4, 3)
    monkeypatch.setattr(torch.Tensor, "device",
                        property(lambda t: torch.device("cuda", 0)))

    def refuse(*a, **k):
        raise AssertionError("a plain version or a kernel was reached")

    monkeypatch.setattr(kc, "kan_conv2d_reference", refuse)
    monkeypatch.setattr(kc, "_fn", refuse)
    kc.reset_launches()
    with pytest.raises(NotImplementedError, match="cheby degree=4"):
        conv(x)
    assert sum(kc.launches.values()) == 0
