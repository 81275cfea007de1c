"""The KAN-conv kernels at MobileNetV3's shapes on the card: the B-spline
with a hardswish base path (``BSpline<12, 3, HardSwish>``, x exactly at
-3 and 3 and at knots among the inputs) and the 1x1 convs at 56 x 56 and
at C = 576 (B-spline with hardswish and Chebyshev), forward against the
plain version (rtol = atol = 1e-4) and the three backward kernels through
autograd against float64 autograd of the plain version (1e-4 of the
largest entry + 1e-4 relative, as chip_smoke.py holds them); and the
seeded KAN-MobileNetV3-small at 224 x 224 on the card against the CPU
(logits within 1e-3), with 22 kernel forwards and one plain-route conv
(the strided stem) per forward.

Marked `cuda`: skips on a host without a GPU.  It imports no JAX:

    python -m pytest tests/test_torch_cuda_mnv3.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.kernels import kan_conv2d as kc

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
BASES = {"hardswish": kc.bspline_basis(KNOTS, 3, "hardswish"),
         "cheby": kc.cheby_basis(3)}


def _within(got, want, tol=1e-4):
    err = (got.double() - want).abs()
    return bool((err <= tol * want.abs().max() + tol * want.abs()).all()), \
        err.max().item()


def _inputs(B, H, C, O, k, basis, seed):
    """x U(-4, 4) with the knots and -3, 3 among its values, base_w (None
    without a base path), poly_w and the output gradient g (pad k // 2)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-4, 4, (B, H, H, C)).astype(np.float32)
    x.reshape(-1)[:len(KNOTS) + 2] = KNOTS + (-3.0, 3.0)
    bw = None if basis.act is None else torch.from_numpy(
        rng.normal(0, 0.2, (k, k, C, O)).astype(np.float32)).cuda()
    pw = rng.normal(0, 0.2, (k, k, C * basis.K, O)).astype(np.float32)
    g = rng.normal(0, 1, (B, H, H, O)).astype(np.float32)
    return torch.from_numpy(x).cuda(), bw, torch.from_numpy(pw).cuda(), \
        torch.from_numpy(g).cuda()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O,k,basis", [
    (4, 8, 16, 24, 3, "hardswish"), (3, 9, 13, 5, 3, "hardswish"),
    (16, 56, 16, 72, 1, "hardswish"), (16, 56, 16, 16, 1, "cheby"),
    (32, 7, 576, 96, 1, "hardswish"), (32, 7, 96, 576, 1, "hardswish"),
    (32, 7, 576, 96, 1, "cheby"), (8, 14, 240, 40, 1, "cheby"),
])
def test_cuda_mobilenetv3_kernels_match_plain_version(B, H, C, O, k, basis):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()
    b = BASES[basis]
    pad = k // 2
    x, bw, pw, g = _inputs(B, H, C, O, k, b, seed=B * 100 + C)
    kc.reset_launches()
    y = kc.kan_conv2d(x, bw, pw, b, k, pad)
    torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_fwd"] == 1
    torch.testing.assert_close(y, kc.kan_conv2d_reference(x, bw, pw, b, k,
                                                          pad),
                               rtol=1e-4, atol=1e-4)
    leaves = {n: t.clone().requires_grad_(True)
              for n, t in (("x", x), ("bw", bw), ("pw", pw)) if t is not None}
    kc.reset_launches()
    got = torch.autograd.grad(kc.kan_conv2d(
        leaves["x"], leaves.get("bw"), leaves["pw"], b, k, pad),
        list(leaves.values()), g)
    torch.cuda.synchronize()
    assert kc.launches == dict.fromkeys(kc.KERNELS, 1)
    ref_leaves = {n: t.double().requires_grad_(True)
                  for n, t in leaves.items()}
    ref = torch.autograd.grad(kc.kan_conv2d_reference(
        ref_leaves["x"], ref_leaves.get("bw"), ref_leaves["pw"], b, k, pad),
        list(ref_leaves.values()), g.double())
    for a, r in zip(got, ref):
        ok, err = _within(a, r)
        assert ok, f"max |diff| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("kan_conv", ["KAN", "ChebyKAN", "FastKAN"])
def test_cuda_mobilenetv3_small_matches_cpu(kan_conv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.models.mobilenetv3 import mobilenet_v3_kan

    kw = dict(num_classes=10, kan_conv=kan_conv)
    cpu = mobilenet_v3_kan("small", device="cpu",
                           generator=torch.Generator().manual_seed(0), **kw)
    gpu = mobilenet_v3_kan("small", **kw)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).normal(
        0.0, 1.0, (2, 224, 224, 3)).astype(np.float32))
    kc.reset_launches()
    with torch.no_grad():
        got = gpu.eval()(x.cuda()).cpu()
    counts = dict(kc.launches, **kc.plain_calls)
    want = {"kan_conv2d_fwd": 22, kc.PLAIN: 1} if kan_conv != "FastKAN" \
        else {"kan_conv2d_fwd": 0, kc.PLAIN: 23}
    assert {k: counts[k] for k in want} == want
    with torch.no_grad():
        ref = cpu.eval()(x)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
