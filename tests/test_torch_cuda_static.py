"""The KAN-conv kernels' static-basis instantiations on the card: each of
the ten families as KAN-VGG16_small builds it (``Recur3<4, SiLU>``,
``Recur3<4, identity>``, ``Recur3<3, SiLU>``, ``Bernstein<3>``,
``Fourier<5, SiLU>``), the forward and the three backward kernels through
autograd against float64 (autograd) of the plain version (1e-4 of the
largest entry + 1e-4 relative, as chip_smoke.py holds the backward), at a
VGG16_small shape with channel splits and at a ragged one (C = 13, O = 5,
odd H); and the exact zeros: Bernstein's rows have a derivative of 0, so
zeroing their weights leaves dx bit-identical.

Marked `cuda`: skips on a host without a GPU.  It imports no JAX:

    python -m pytest tests/test_torch_cuda_static.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND

FAMILIES = ("jacobi", "bernstein", "bessel", "fibonacci", "fourier",
            "gegenbauer", "hermite", "laguerre", "lucas", "taylor")


def _basis(family):
    return KanConvND(family, 4, 4, 3, base_activation="silu",
                     device="cpu").basis


def _within(got, want, tol=1e-4):
    err = (got.double() - want).abs()
    return bool((err <= tol * want.abs().max() + tol * want.abs()).all()), \
        err.max().item()


def _needs_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()


@pytest.mark.cuda
@pytest.mark.parametrize("family", FAMILIES)
@pytest.mark.parametrize("B,H,C,O", [(16, 8, 64, 64), (3, 9, 13, 5)])
def test_cuda_static_kernels_match_plain_version(family, B, H, C, O):
    _needs_cuda()
    b = _basis(family)
    rng = np.random.RandomState(B + C + len(family))
    arrays = [rng.uniform(-2, 2, (B, H, H, C)),
              rng.normal(0, 0.2, (3, 3, C, O)),
              rng.normal(0, 0.2, (3, 3, C * b.K, O))]
    g = torch.from_numpy(rng.normal(0, 1, (B, H, H, O))).float()
    leaves = [torch.from_numpy(a).float().cuda().requires_grad_(True)
              for a in arrays]
    kc.reset_launches()
    y = kc.kan_conv2d(*leaves, b, 3, 1)
    got = (y, *torch.autograd.grad(y, leaves, g.cuda()))
    ref = [torch.from_numpy(a).requires_grad_(True) for a in arrays]
    y64 = kc.kan_conv2d_reference(*ref, b, 3, 1)
    want = (y64, *torch.autograd.grad(y64, ref, g.double()))
    for name, a, w in zip(("y", "dx", "dbase_w", "dpoly_w"), got, want):
        ok, err = _within(a.detach().cpu(), w.detach())
        assert ok, f"{family} {name}: max |err| {err:.3e}"
    assert kc.launches_by_basis == {
        ("kan_conv2d_fwd", b.key): 1, ("kan_conv2d_bwd_dx", b.key): 1,
        ("kan_conv2d_bwd_dw", b.key): 1,
        ("kan_conv2d_bwd_dw_reduce", b.key): 1}


@pytest.mark.cuda
def test_cuda_bernstein_rows_have_no_gradient():
    _needs_cuda()
    b = _basis("bernstein")
    gen = torch.Generator().manual_seed(0)
    x = (torch.rand(8, 8, 8, 16, generator=gen) * 6 - 3).cuda()
    w_all = (torch.randn(b.R * 16, 9 * 32, generator=gen) * 0.1).cuda()
    wz = w_all.clone()
    wz[:b.K * 16] = 0
    g = torch.randn(8, 8, 8, 32, generator=gen).cuda()
    assert torch.equal(kc.input_grad(x, w_all, g, b, 3, 1),
                       kc.input_grad(x, wz, g, b, 3, 1))
