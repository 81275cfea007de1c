"""The KAN-conv kernels' identity-base instantiations and EfficientNetV2-s's
kernel shapes on the card: the B-spline with an identity base path
(``BSpline<12, 3, identity>``) and the Gram basis with the identity on
every row (``Gram<3, identity>``, beta's gradient included), the
forward and the three backward kernels through autograd against float64
(autograd) of the plain version (1e-4 of the largest entry + 1e-4
relative, as chip_smoke.py holds the backward: x in +-3 and weights
N(0, 0.2) give outputs of ~20, whose float32 sums of up to 2160 products
taken in another order can pass 1e-4 absolute), at shapes of
EfficientNetV2-s at 224 x 224 (the 3 x 3 conv at 112 x 112, 1x1 convs
with C or O up to 1536) and with the SiLU instantiations where no
earlier shape reached; and a seeded
EfficientNetV2 kan_tiny on the card against the CPU (logits within 1e-3)
with its launch counts.

Marked `cuda`: skips on a host without a GPU.  It imports no JAX:

    python -m pytest tests/test_torch_cuda_effv2.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.kernels import kan_conv2d as kc

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
BASES = {"identity": kc.bspline_basis(KNOTS, 3, "identity"),
         "gram_identity": kc.gram_basis(3, "identity"),
         "silu": kc.bspline_basis(KNOTS, 3, "silu")}


def _within(got, want, tol=1e-4):
    err = (got.double() - want).abs()
    return bool((err <= tol * want.abs().max() + tol * want.abs()).all()), \
        err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O,k,basis", [
    (4, 112, 24, 24, 3, "identity"), (4, 112, 24, 24, 3, "silu"),
    (4, 112, 24, 24, 3, "gram_identity"), (8, 56, 192, 48, 1, "identity"),
    (8, 56, 48, 192, 3, "gram_identity"), (8, 7, 1536, 256, 1, "identity"),
    (8, 7, 256, 1536, 1, "silu"), (8, 7, 1536, 256, 1, "gram_identity"),
    (8, 14, 768, 160, 1, "identity"), (3, 9, 13, 5, 3, "identity"),
])
def test_cuda_identity_kernels_match_plain_version(B, H, C, O, k, basis):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()
    b = BASES[basis]
    pad = k // 2
    rng = np.random.RandomState(B * 100 + C)
    x = rng.uniform(-3, 3, (B, H, H, C)).astype(np.float32)
    x.reshape(-1)[:len(KNOTS)] = KNOTS
    leaves = {"x": x,
              "bw": rng.normal(0, 0.2, (k, k, C, O)).astype(np.float32),
              "pw": rng.normal(0, 0.2, (k, k, C * b.K, O)).astype(np.float32)}
    if b.n_extra:
        leaves["beta"] = rng.normal(0, 0.3, b.n_extra).astype(np.float32)
    g = torch.from_numpy(rng.normal(0, 1, (B, H, H, O)).astype(np.float32))
    leaves = {n: torch.from_numpy(a).cuda() for n, a in leaves.items()}
    kc.reset_launches()
    y = kc.kan_conv2d(leaves["x"], leaves["bw"], leaves["pw"], b, k, pad,
                      leaves.get("beta"))
    torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_fwd"] == 1
    y64 = kc.kan_conv2d_reference(*(leaves[n].double() for n in
                                    ("x", "bw", "pw")), b, k, pad,
                                  *(() if "beta" not in leaves else
                                    (leaves["beta"].double(),)))
    ok, err = _within(y, y64)
    assert ok, f"forward: max |diff| {err}"
    req = {n: t.clone().requires_grad_(True) for n, t in leaves.items()}
    kc.reset_launches()
    got = torch.autograd.grad(kc.kan_conv2d(
        req["x"], req["bw"], req["pw"], b, k, pad, req.get("beta")),
        list(req.values()), g.cuda())
    torch.cuda.synchronize()
    # a reduction for dW, and one for beta's partials with the Gram basis
    assert kc.launches == {**dict.fromkeys(kc.KERNELS, 1),
                           "kan_conv2d_bwd_dw_reduce": 1 + (b.n_extra > 0)}
    ref_leaves = {n: t.double().requires_grad_(True) for n, t in req.items()}
    ref = torch.autograd.grad(kc.kan_conv2d_reference(
        ref_leaves["x"], ref_leaves["bw"], ref_leaves["pw"], b, k, pad,
        ref_leaves.get("beta")), list(ref_leaves.values()), g.cuda().double())
    for name, a, r in zip(req, got, ref):
        if name == "beta":    # one sum over B*H*W*C terms that cancel
            assert (a.double() - r).abs().max() <= 1e-3 * r.abs().max()
            continue
        ok, err = _within(a, r)
        assert ok, f"{name}: max |diff| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("kan_conv", ["KAN", "GRAMKAN", "FastKAN"])
def test_cuda_efficientnetv2_kan_tiny_matches_cpu(kan_conv):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.models.efficientnetv2 import \
        efficientnetv2_kan_small

    kw = dict(arch="kan_tiny", num_classes=10, kan_conv=kan_conv)
    cpu = efficientnetv2_kan_small(device="cpu",
                                   generator=torch.Generator().manual_seed(0),
                                   **kw)
    gpu = efficientnetv2_kan_small(**kw)
    gpu.load_state_dict(cpu.state_dict())
    x = torch.from_numpy(np.random.RandomState(1).normal(
        0.0, 1.0, (4, 32, 32, 3)).astype(np.float32))
    kc.reset_launches()
    with torch.no_grad():
        got = gpu.eval()(x.cuda()).cpu()
    counts = dict(kc.launches, **kc.plain_calls)
    # kan_tiny: 11 KAN convs, the two strided ones on the plain route
    want = {"kan_conv2d_fwd": 9, kc.PLAIN: 2} if kan_conv != "FastKAN" \
        else {"kan_conv2d_fwd": 0, kc.PLAIN: 11}
    assert {k: counts[k] for k in want} == want
    with torch.no_grad():
        ref = cpu.eval()(x)
    torch.testing.assert_close(got, ref, rtol=1e-3, atol=1e-3)
