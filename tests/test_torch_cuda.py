"""The CUDA KAN-conv kernel against its plain version, on the card.

Marked `cuda`: skips on a host without a GPU.  It imports no JAX, so it
runs on the GPU machine without the JAX package's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.kernels import kan_conv2d as kc

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O,act", [
    (4, 32, 3, 16, "silu"), (3, 8, 32, 64, "silu"), (5, 2, 128, 128, "silu"),
    (2, 5, 6, 9, "gelu"),      # ragged tile: O not a multiple of 4, odd H
])
def test_cuda_kernel_matches_plain_version(B, H, C, O, act):
    """Float32 sums in another order: rtol = atol = 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()
    rng = np.random.RandomState(B * 1000 + H)
    x = rng.uniform(-3, 3, (B, H, H, C)).astype(np.float32)
    x.reshape(-1)[:len(KNOTS)] = KNOTS          # exact knots occur
    bw = rng.normal(0, 0.2, (3, 3, C, O)).astype(np.float32)
    pw = rng.normal(0, 0.2, (3, 3, C * 8, O)).astype(np.float32)
    x, bw, pw = (torch.from_numpy(a).cuda() for a in (x, bw, pw))
    kc.reset_launches()
    y = kc.kan_conv2d(x, bw, pw, KNOTS, 3, 3, 1, act)
    torch.cuda.synchronize()
    assert kc.launches == 1
    ref = kc.kan_conv2d_reference(x, bw, pw, KNOTS, 3, 3, 1, act)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_refuses_float64_and_unported_spline():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    x = torch.zeros(1, 4, 4, 3, device="cuda")
    bw = torch.zeros(3, 3, 3, 4, device="cuda")
    pw = torch.zeros(3, 3, 24, 4, device="cuda")
    with pytest.raises(TypeError):
        kc.kan_conv2d(x.double(), bw.double(), pw.double(), KNOTS, 3, 3, 1,
                      "silu")
    linear = tuple(float(v) for v in make_bspline_grid(3, 1))  # K = 4
    with pytest.raises(NotImplementedError):
        kc.kan_conv2d(x, bw, pw[:, :, :12].contiguous(), linear, 1, 3, 1,
                      "silu")
