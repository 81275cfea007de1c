"""The CUDA KAN-conv (B-spline, Chebyshev and Gram) and WavKAN psi-conv
kernels (forward and backward) against their plain versions, on the card;
BatchNorm on the card against the CPU, and the KAN forward with folded
BatchNorm weights against the unfolded model.

Marked `cuda`: skips on a host without a GPU.  It imports no JAX, so it
runs on the GPU machine without the JAX package's conftest:

    python -m pytest tests/test_torch_cuda.py -q --noconftest
"""

import numpy as np
import pytest
import torch

from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.kernels.wav_conv2d import (
    param_launch_config as wav_param_launch_config)

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
BASIS = kc.bspline_basis(KNOTS, 3, "silu")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O,act", [
    (4, 32, 3, 16, "silu"), (3, 8, 32, 64, "silu"), (5, 2, 128, 128, "silu"),
    (2, 5, 6, 9, "gelu"),      # ragged tile: O not a multiple of 4, odd H
    (1023, 8, 32, 64, "silu"),   # B not a multiple of the image group
    (16, 8, 16, 48, "silu"),     # O not a multiple of the column tile
    (8, 16, 5, 16, "silu"),      # C not a multiple of the chunk
    (70, 1, 16, 32, "silu"),     # 1x1: every tap but the centre skipped
    (19, 3, 6, 9, "gelu"),       # 3x3: a block spans two image groups
    (1024, 2, 128, 128, "silu"),  # the 2x2 layer at the real batch
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
    basis = kc.bspline_basis(KNOTS, 3, act)
    y = kc.kan_conv2d(x, bw, pw, basis, 3, 1)
    torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_fwd"] == 1
    ref = kc.kan_conv2d_reference(x, bw, pw, basis, 3, 1)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)


@pytest.mark.cuda
def test_cuda_forward_with_channel_splits_is_deterministic():
    """The 2x2 layer's channel splits are summed over the cluster in rank
    order (no atomics): two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    assert kc.launch_config(1024, 2, 2, 128, 128, 3, 1, 9)["S"] > 1
    rng = np.random.RandomState(5)
    x = rng.uniform(-3, 3, (1024, 2, 2, 128)).astype(np.float32)
    bw = rng.normal(0, 0.2, (3, 3, 128, 128)).astype(np.float32)
    pw = rng.normal(0, 0.2, (3, 3, 128 * 8, 128)).astype(np.float32)
    x, bw, pw = (torch.from_numpy(a).cuda() for a in (x, bw, pw))
    a = kc.kan_conv2d(x, bw, pw, BASIS, 3, 1)
    b = kc.kan_conv2d(x, bw, pw, BASIS, 3, 1)
    assert torch.equal(a, b)


@pytest.mark.cuda
def test_cuda_refuses_float64_and_unported_spline():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    x = torch.zeros(1, 4, 4, 3, device="cuda")
    bw = torch.zeros(3, 3, 3, 4, device="cuda")
    pw = torch.zeros(3, 3, 24, 4, device="cuda")
    with pytest.raises(TypeError):
        kc.kan_conv2d(x.double(), bw.double(), pw.double(), BASIS, 3, 1)
    linear = tuple(float(v) for v in make_bspline_grid(3, 1))  # K = 4
    with pytest.raises(NotImplementedError):
        kc.kan_conv2d(x, bw, pw[:, :, :12].contiguous(),
                      kc.bspline_basis(linear, 1, "silu"), 3, 1)


def _bwd_inputs(B, H, C, O, seed, k=3, pad=1):
    rng = np.random.RandomState(seed)
    Ho = H + 2 * pad - k + 1
    x = rng.uniform(-3, 3, (B, H, H, C)).astype(np.float32)
    x.reshape(-1)[:len(KNOTS)] = KNOTS          # exact knots occur
    bw = rng.normal(0, 0.2, (k, k, C, O)).astype(np.float32)
    pw = rng.normal(0, 0.2, (k, k, C * 8, O)).astype(np.float32)
    g = rng.normal(0, 1, (B, Ho, Ho, O)).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (x, bw, pw, g))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O,act,k,pad", [
    (4, 32, 3, 16, "silu", 3, 1), (3, 8, 32, 64, "silu", 3, 1),
    (5, 2, 128, 128, "silu", 3, 1),
    (2, 5, 6, 9, "gelu", 3, 1),    # ragged: O not a multiple of 4, odd H
    (3, 7, 13, 5, "silu", 3, 1),   # ragged channel chunks
    (16, 8, 16, 48, "silu", 3, 1),  # 216-column weight-gradient tiles
    (8, 16, 13, 32, "silu", 3, 1),  # C not a multiple of the channel chunk
    # the data-gradient tile's ragged edges: B not a multiple of the image
    # group (pad taps skipped at 4x4 and 3x3), odd H with C % 8 and O = 5,
    # O = 48, kernel 5 with pad 2, pad 0 (Ho < H)
    (37, 4, 16, 32, "silu", 3, 1), (41, 3, 6, 8, "gelu", 3, 1),
    (3, 9, 13, 5, "silu", 3, 1), (5, 8, 8, 48, "silu", 3, 1),
    (2, 8, 6, 16, "silu", 5, 2), (3, 6, 8, 12, "silu", 3, 0),
    # ... and its fallbacks for kernels at the edge of shared memory: 32
    # pixel slots; 64 and 32 slots without the table of g offsets
    (1, 9, 1, 1, "silu", 37, 18), (1, 14, 1, 1, "gelu", 37, 18),
    (1, 22, 1, 1, "silu", 37, 18),
])
def test_cuda_backward_matches_plain_version(B, H, C, O, act, k, pad):
    """dx, d base_w and d poly_w of the CUDA path against autograd of the
    plain version in float64 on the card.  Float32 sums of up to
    B*H*W products per dW entry in another order: rtol = atol = 1e-4."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()
    x, bw, pw, g = _bwd_inputs(B, H, C, O, seed=B * 100 + C, k=k, pad=pad)
    leaves = [t.clone().requires_grad_(True) for t in (x, bw, pw)]
    kc.reset_launches()
    basis = kc.bspline_basis(KNOTS, 3, act)
    y = kc.kan_conv2d(*leaves, basis, k, pad)
    got = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert kc.launches == {"kan_conv2d_fwd": 1, "kan_conv2d_bwd_dx": 1,
                           "kan_conv2d_bwd_dw": 1,
                           "kan_conv2d_bwd_dw_reduce": 1}
    ref_leaves = [t.double().requires_grad_(True) for t in (x, bw, pw)]
    ref = torch.autograd.grad(kc.kan_conv2d_reference(
        *ref_leaves, basis, k, pad), ref_leaves, g.double())
    for name, a, b in zip(("dx", "dbase_w", "dpoly_w"), got, ref):
        torch.testing.assert_close(a, b.float(), rtol=1e-4, atol=1e-4,
                                   msg=lambda m: f"{name}: {m}")


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O", [
    (1023, 8, 32, 64),     # B not a multiple of the split's images
    (1024, 2, 128, 128),   # the 2x2 layer at the real batch
    (1024, 4, 64, 128),    # a 4x4 layer at the real batch (skip tiles)
])
def test_cuda_backward_matches_plain_version_at_full_batch(B, H, C, O):
    """The weight-gradient partials and the autograd path's gradients at
    batch 1023-1024 against float64 autograd of the plain version, and two
    data-gradient calls bit-identical.  A dW
    entry sums up to B*H*W = 65,472 float32 products, so it is held as
    chip_smoke.py's phase 6 holds it (see _within: 1e-4 of the largest
    entry + 1e-4 relative)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()
    x, bw, pw, g = _bwd_inputs(B, H, C, O, seed=B + C)
    spec = (BASIS, 3, 1)
    cfg = kc.dw_launch_config(B, H, H, C, O, 3, 1, 9)
    assert cfg["S"] > 1
    ok, err = _within(kc.weight_partials(x, g, *spec),
                      kc.weight_partials_reference(
                          x.double(), g.double(), *spec, cfg["S"],
                          cfg["ips"]))
    assert ok, f"dW partials: max |diff| {err}"
    leaves = [t.clone().requires_grad_(True) for t in (x, bw, pw)]
    kc.reset_launches()
    got = torch.autograd.grad(kc.kan_conv2d(*leaves, *spec), leaves, g)
    torch.cuda.synchronize()
    assert kc.launches == dict.fromkeys(kc.KERNELS, 1)
    ref_leaves = [t.double().requires_grad_(True) for t in (x, bw, pw)]
    ref = torch.autograd.grad(kc.kan_conv2d_reference(*ref_leaves, *spec),
                              ref_leaves, g.double())
    for name, a, b in zip(("dx", "dbase_w", "dpoly_w"), got, ref):
        ok, err = _within(a, b)
        assert ok, f"{name}: max |diff| {err}"
    # each dx element is summed by one thread in a fixed order
    w_all = kc.pack_w_all(bw, pw, C=C, K=8, k=3, O=O)
    assert torch.equal(kc.input_grad(x, w_all, g, *spec),
                       kc.input_grad(x, w_all, g, *spec))


@pytest.mark.cuda
def test_cuda_result_has_grad_fn_and_skips_unneeded_dx():
    """A CUDA result carries a grad_fn when the weights require grad, and
    the data-gradient kernel runs only when x requires grad."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    x, bw, pw, g = _bwd_inputs(2, 8, 4, 8, seed=1)
    bw.requires_grad_(True)
    pw.requires_grad_(True)
    y = kc.kan_conv2d(x, bw, pw, BASIS, 3, 1)
    assert y.grad_fn is not None
    kc.reset_launches()
    (y * g).sum().backward()
    torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_bwd_dx"] == 0
    assert kc.launches["kan_conv2d_bwd_dw"] == 1
    assert bw.grad is not None and pw.grad is not None
    assert float(pw.grad.abs().sum()) > 0


@pytest.mark.cuda
def test_cuda_weight_grad_is_deterministic():
    """Two backward calls on the same inputs give bit-identical dW (fixed
    batch split, ordered reduction, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    x, bw, pw, g = _bwd_inputs(64, 8, 32, 64, seed=2)
    w_all = kc.pack_w_all(bw, pw, C=32, K=8, k=3, O=64)
    a = kc.weight_grad(x, g, BASIS, 3, 1)
    b = kc.weight_grad(x, g, BASIS, 3, 1)
    assert kc.dw_launch_config(64, 8, 8, 32, 64, 3, 1, 9)["S"] > 1
    assert torch.equal(a, b)
    dx1 = kc.input_grad(x, w_all, g, BASIS, 3, 1)
    dx2 = kc.input_grad(x, w_all, g, BASIS, 3, 1)
    assert torch.equal(dx1, dx2)


@pytest.mark.cuda
def test_cuda_reduce_matches_ordered_sum_bitwise():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    p = torch.randn(7, 45, 99, device="cuda")
    assert torch.equal(kc.reduce_partials(p), kc.reduce_reference(p))


# (S, N) of both reductions at the VGG16_small convs at batch 1024, then
# ragged ones: S = 1, odd N, N < 4, S = 1023, a few columns
_VGG = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32), (8, 32, 64),
        (8, 64, 64), (4, 64, 128), (4, 128, 128), (2, 128, 128)]
REDUCE_PAIRS = [(kc.dw_launch_config(1024, H, H, C, O, 3, 1, 9)["S"],
                 81 * C * O) for H, C, O in _VGG]
REDUCE_PAIRS += [(cfg["S"], cfg["N"]) for cfg in (
    wav_param_launch_config(1024, H, H, C, O, 3, 1) for H, C, O in _VGG)]
REDUCE_PAIRS += [(1, 1000), (7, 45 * 99), (513, 4455), (300, 3), (1023, 37),
                 (40, 1), (9, 4 * 257)]


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1], ids=["aligned", "offset1"])
@pytest.mark.parametrize("S,N", REDUCE_PAIRS)
def test_cuda_reduce_matches_grouped_reference_bitwise(S, N, offset):
    """Both reduction wrappers run the kernel of csrc/ordered_sum.cuh and
    equal reduce_reference (the kernel's order) bit for bit, also on a
    contiguous partial whose data pointer is one float past 16 bytes
    (single-float loads); two calls give the same bits."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    gen = torch.Generator(device="cuda").manual_seed(S * 7 + N)
    buf = torch.randn(S * N + offset, device="cuda", generator=gen)
    p = buf[offset:].view(S, N)
    assert (p.data_ptr() % 16 != 0) == bool(offset)
    want = kc.reduce_reference(p)
    kc.reset_launches()
    wc.reset_launches()
    a = kc.reduce_partials(p)
    b = wc.reduce_partials(p)
    c = kc.reduce_partials(p)
    torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_bwd_dw_reduce"] == 2
    assert wc.launches["wav_conv2d_bwd_reduce"] == 1
    assert torch.equal(a.view(torch.int32), want.view(torch.int32))
    assert torch.equal(b.view(torch.int32), want.view(torch.int32))
    assert torch.equal(a.view(torch.int32), c.view(torch.int32))


# ------------------------------------------------ Chebyshev KAN conv
CHEBY = kc.cheby_basis(3)


def _cheby_inputs(B, H, C, O, seed, scale=1.0):
    """x U(-scale, scale) (scale 10: the clamp of tanh holds many x), poly_w
    N(0, 0.2) of the 4 rows per channel, g N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (B, H, H, C)).astype(np.float32)
    pw = rng.normal(0, 0.2, (3, 3, C * CHEBY.K, O)).astype(np.float32)
    g = rng.normal(0, 1, (B, H, H, O)).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (x, pw, g))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O,scale", [
    (4, 32, 3, 16, 1.0), (3, 16, 16, 32, 1.0), (3, 8, 32, 64, 1.0),
    (5, 4, 64, 128, 1.0), (5, 2, 128, 128, 1.0),
    (2, 5, 6, 9, 10.0),        # ragged tile, |x| past the clamp
    (19, 3, 6, 9, 1.0),        # 3x3: a block spans two image groups
    (70, 1, 16, 32, 1.0),      # 1x1: every tap but the centre on the pad
    (16, 8, 16, 48, 1.0),      # O not a multiple of the column tile
    (8, 16, 5, 16, 10.0),      # C not a multiple of the chunk, clamped x
    (1024, 2, 128, 128, 1.0),  # the 2x2 layer at the real batch
])
def test_cuda_cheby_matches_plain_version(B, H, C, O, scale):
    """The Chebyshev instantiations of the forward, data-gradient and
    weight-gradient kernels: the forward against the plain version (rtol =
    atol = 1e-4: float32 sums in another order, tanhf within 2 ulp of
    torch's tanh), dx and dpoly_w against float64 autograd of the plain
    version (_within), launches per kernel, and two calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()
    x, pw, g = _cheby_inputs(B, H, C, O, seed=B * 10 + C, scale=scale)
    kc.reset_launches()
    y = kc.kan_conv2d(x, None, pw, CHEBY, 3, 1)
    same = torch.equal(y, kc.kan_conv2d(x, None, pw, CHEBY, 3, 1))
    torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_fwd"] == 2 and same
    torch.testing.assert_close(
        y, kc.kan_conv2d_reference(x, None, pw, CHEBY, 3, 1), rtol=1e-4,
        atol=1e-4)
    leaves = [t.clone().requires_grad_(True) for t in (x, pw)]
    kc.reset_launches()
    got = torch.autograd.grad(kc.kan_conv2d(leaves[0], None, leaves[1],
                                            CHEBY, 3, 1), leaves, g)
    torch.cuda.synchronize()
    assert kc.launches == dict.fromkeys(kc.KERNELS, 1)
    ref_leaves = [t.double().requires_grad_(True) for t in (x, pw)]
    ref = torch.autograd.grad(kc.kan_conv2d_reference(
        ref_leaves[0], None, ref_leaves[1], CHEBY, 3, 1), ref_leaves,
        g.double())
    for name, a, b in zip(("dx", "dpoly_w"), got, ref):
        ok, err = _within(a, b)
        assert ok, f"{name}: max |diff| {err}"
    w_all = kc.pack_w_all(None, pw, C=C, K=CHEBY.K, k=3, O=O)
    assert torch.equal(kc.input_grad(x, w_all, g, CHEBY, 3, 1),
                       kc.input_grad(x, w_all, g, CHEBY, 3, 1))
    assert torch.equal(kc.weight_grad(x, g, CHEBY, 3, 1),
                       kc.weight_grad(x, g, CHEBY, 3, 1))
    if scale > 8.5:   # where the clamp holds t, dx is exactly 0
        clamped = x.abs() > 8.5
        assert clamped.any() and not got[0][clamped].any()


@pytest.mark.cuda
def test_cuda_cheby_refuses_uncompiled_degree():
    """Degree 4 has no compiled kernel: NotImplementedError on CUDA, no
    launch and no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    x = torch.zeros(1, 4, 4, 3, device="cuda")
    kc.reset_launches()
    with pytest.raises(NotImplementedError):
        kc.kan_conv2d(x, None, torch.zeros(3, 3, 15, 4, device="cuda"),
                      kc.cheby_basis(4), 3, 1)
    assert sum(kc.launches.values()) == 0


# ------------------------------------------------------ Gram KAN conv
GRAM = kc.gram_basis(3)


def _gram_inputs(B, H, C, O, seed):
    """x U(-2, 2), base_w and poly_w N(0, 0.2) (poly_w degree-major), beta
    N(0, 0.3) (far past its init, so its terms count), g N(0, 1)."""
    rng = np.random.RandomState(seed)
    x = rng.uniform(-2, 2, (B, H, H, C)).astype(np.float32)
    bw = rng.normal(0, 0.2, (3, 3, C, O)).astype(np.float32)
    pw = rng.normal(0, 0.2, (3, 3, C * GRAM.K, O)).astype(np.float32)
    beta = rng.normal(0, 0.3, GRAM.n_extra).astype(np.float32)
    g = rng.normal(0, 1, (B, H, H, O)).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (x, bw, pw, beta, g))


def _dbeta_within(got, x, w_all, g, beta, tol=1e-4):
    """d beta against float64 within tol of the sum of |terms| per entry
    (a sum of up to B*H*W*C terms that can cancel), and entries 0 and 3
    exactly 0."""
    terms = kc.extra_terms_reference(x.double(), w_all.double(), g.double(),
                                     GRAM, 3, 1, beta.double())
    want = terms.sum((0, 1, 2, 3))
    scale = terms.abs().sum((0, 1, 2, 3))
    err = (got.double() - want).abs()
    return bool((err <= tol * scale).all()) and got[0] == 0 and \
        got[3] == 0, err.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,C,O", [
    (4, 32, 3, 16), (3, 16, 16, 32), (3, 8, 32, 64), (5, 4, 64, 128),
    (5, 2, 128, 128),
    (2, 5, 6, 9),           # ragged tile: O not a multiple of 4, odd H
    (19, 3, 6, 9),          # 3x3: a block spans two image groups
    (70, 1, 16, 32),        # 1x1: every tap but the centre on the pad
    (16, 8, 16, 48),        # O not a multiple of the column tile
    (8, 16, 5, 16),         # C not a multiple of the chunk
    (1024, 2, 128, 128),    # the 2x2 layer at the real batch
])
def test_cuda_gram_matches_plain_version(B, H, C, O):
    """The Gram instantiations of the forward, data-gradient (with beta's
    partials) and weight-gradient kernels: the forward against the plain
    version (rtol = atol = 1e-4), dx, d base_w and d poly_w against
    float64 autograd of the plain version (_within), d beta against
    float64 within 1e-4 of the sum of |terms|, launches per kernel (the
    reduction twice: dW and d beta), and two calls bit-identical."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32

    set_full_f32()
    x, bw, pw, beta, g = _gram_inputs(B, H, C, O, seed=B * 10 + C)
    kc.reset_launches()
    y = kc.kan_conv2d(x, bw, pw, GRAM, 3, 1, beta)
    same = torch.equal(y, kc.kan_conv2d(x, bw, pw, GRAM, 3, 1, beta))
    torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_fwd"] == 2 and same
    torch.testing.assert_close(
        y, kc.kan_conv2d_reference(x, bw, pw, GRAM, 3, 1, beta), rtol=1e-4,
        atol=1e-4)
    leaves = [t.clone().requires_grad_(True) for t in (x, bw, pw, beta)]
    kc.reset_launches()
    got = torch.autograd.grad(kc.kan_conv2d(*leaves[:3], GRAM, 3, 1,
                                            leaves[3]), leaves, g)
    torch.cuda.synchronize()
    assert kc.launches == {"kan_conv2d_fwd": 1, "kan_conv2d_bwd_dx": 1,
                           "kan_conv2d_bwd_dw": 1,
                           "kan_conv2d_bwd_dw_reduce": 2}
    ref_leaves = [t.double().requires_grad_(True) for t in (x, bw, pw)]
    ref = torch.autograd.grad(kc.kan_conv2d_reference(
        *ref_leaves, GRAM, 3, 1, beta.double()), ref_leaves, g.double())
    for name, a, b in zip(("dx", "dbase_w", "dpoly_w"), got, ref):
        ok, err = _within(a, b)
        assert ok, f"{name}: max |diff| {err}"
    w_all = kc.pack_w_all(bw, pw, C=C, K=GRAM.K, k=3, O=O, degree_major=True)
    ok, err = _dbeta_within(got[3], x, w_all, g, beta)
    assert ok, f"dbeta: max |diff| {err}"
    dx1, p1 = kc.input_extra_grad(x, w_all, g, GRAM, 3, 1, beta)
    dx2, p2 = kc.input_extra_grad(x, w_all, g, GRAM, 3, 1, beta)
    assert torch.equal(dx1, dx2) and torch.equal(p1, p2)
    assert torch.equal(dx1, got[0])
    assert torch.equal(kc.reduce_partials(p1), got[3])
    assert torch.equal(kc.weight_grad(x, g, GRAM, 3, 1, beta),
                       kc.weight_grad(x, g, GRAM, 3, 1, beta))


@pytest.mark.cuda
def test_cuda_gram_first_conv_gets_its_beta_gradient():
    """The first conv's input is the image: no dx is launched for it, but
    beta's gradient is: the data-gradient kernel runs with dx not stored,
    and its partials equal those of the launch that stores dx, bit for
    bit; the autograd path launches it once and returns d beta and no
    dx."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    x, bw, pw, beta, g = _gram_inputs(8, 32, 3, 16, seed=3)
    w_all = kc.pack_w_all(bw, pw, C=3, K=GRAM.K, k=3, O=16,
                          degree_major=True)
    dx, part = kc.input_extra_grad(x, w_all, g, GRAM, 3, 1, beta,
                                   need_dx=False)
    assert dx is None
    assert torch.equal(part, kc.input_extra_grad(x, w_all, g, GRAM, 3, 1,
                                                 beta)[1])
    ok, err = _dbeta_within(kc.reduce_partials(part), x, w_all, g, beta)
    assert ok, f"dbeta: max |diff| {err}"
    leaves = [t.clone().requires_grad_(True) for t in (bw, pw, beta)]
    kc.reset_launches()
    y = kc.kan_conv2d(x, *leaves[:2], GRAM, 3, 1, leaves[2])
    (y * g).sum().backward()
    torch.cuda.synchronize()
    assert kc.launches == {"kan_conv2d_fwd": 1, "kan_conv2d_bwd_dx": 1,
                           "kan_conv2d_bwd_dw": 1,
                           "kan_conv2d_bwd_dw_reduce": 2}
    assert torch.equal(leaves[2].grad, kc.reduce_partials(part))
    assert leaves[2].grad[1:3].abs().min() > 0


@pytest.mark.cuda
def test_cuda_gram_refuses_uncompiled_basis():
    """Degree 4, or GELU, has no compiled kernel: NotImplementedError on
    CUDA, no launch and no fallback."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    x = torch.zeros(1, 4, 4, 3, device="cuda")
    bw = torch.zeros(3, 3, 3, 4, device="cuda")
    kc.reset_launches()
    for basis in (kc.gram_basis(4), kc.gram_basis(3, "gelu")):
        pw = torch.zeros(3, 3, 3 * basis.K, 4, device="cuda")
        beta = torch.zeros(basis.n_extra, device="cuda")
        with pytest.raises(NotImplementedError):
            kc.kan_conv2d(x, bw, pw, basis, 3, 1, beta)
    assert sum(kc.launches.values()) == 0


# ----------------------------------------------------- WavKAN psi-conv
WAVELETS = ["mexican_hat", "morlet", "dog", "meyer", "shannon"]


def _wav_inputs(B, H, W, C, O, seed, xscale=1.0):
    rng = np.random.RandomState(seed)
    x = (rng.normal(0, 1, (B, H, W, C)) * xscale).astype(np.float32)
    w = rng.normal(0, 0.3, (3, 3, C, O)).astype(np.float32)
    t = (0.5 * rng.randn(O, C)).astype(np.float32)
    s = (1.0 + 0.3 * rng.rand(O, C)).astype(np.float32)
    g = rng.normal(0, 1, (B, H, W, O)).astype(np.float32)
    return (torch.from_numpy(a).cuda() for a in (x, w, t, s, g))


def _within(got, want, tol=1e-4):
    """|got - want| <= tol * max|want| + tol * |want| (float32 sums of up
    to B*H*W products in another order than the float64 reference)."""
    d = (got.double() - want.double()).abs()
    lim = tol * want.abs().max().double() + tol * want.abs().double()
    return bool((d <= lim).all()), d.max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,wavelet_type,pad", [
    (4, 32, 32, 3, 16, "mexican_hat", 1), (3, 8, 8, 32, 64, "mexican_hat", 1),
    (5, 2, 2, 128, 128, "mexican_hat", 1),
    (2, 5, 7, 6, 9, "mexican_hat", 1),  # ragged: odd planes, O not 2^n
    (1, 32, 32, 16, 16, "mexican_hat", 1),   # batch 1
    (2, 11, 13, 5, 9, "shannon", 1),    # the generic strips, odd widths
    (3, 8, 8, 20, 5, "dog", 1),         # C, O not multiples of 16, of 4
    (3, 4, 4, 5, 16, "mexican_hat", 0), (2, 3, 5, 4, 12, "morlet", 2),
    # batch 1024: one band of the whole plane (RB = H), as the train step
    # and predict launch it, on the strips and each compiled width
    (1024, 32, 32, 3, 16, "mexican_hat", 1),
    (1024, 16, 16, 16, 32, "mexican_hat", 1),
    (1024, 8, 8, 32, 64, "mexican_hat", 1),
    (1024, 4, 4, 64, 128, "mexican_hat", 1),
] + [(2, 16, 16, 16, 32, w, 1) for w in WAVELETS]
  # each compiled width (8, 4, 2: pad taps left out) in every wavelet
  + [(3, H, H, C, 24, w, 1) for H, C in ((8, 16), (4, 32), (2, 64))
     for w in WAVELETS])
def test_cuda_wav_forward_matches_plain_version(B, H, W, C, O, wavelet_type,
                                                pad):
    """Float32 sums of up to 9*C products in another order: 1e-4; two
    calls bit-identical (a fixed order of sums, no atomics)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    set_full_f32()
    x, w, t, s, _ = _wav_inputs(B, H, W, C, O, seed=B * 100 + C,
                                xscale=3.0 if O == 9 else 1.0)
    wc.reset_launches()
    y = wc.wav_conv2d(x, w, t, s, wavelet_type=wavelet_type, padding=pad)
    torch.cuda.synchronize()
    assert wc.launches["wav_conv2d_fwd"] == 1
    ref = wc.wav_conv2d_reference(x, w, t, s, wavelet_type=wavelet_type,
                                  padding=pad)
    torch.testing.assert_close(y, ref, rtol=1e-4, atol=1e-4)
    assert torch.equal(y, wc.wav_conv2d(x, w, t, s, wavelet_type=wavelet_type,
                                        padding=pad))


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,wavelet_type", [
    # the parameter kernel's compiled row widths 32, 16, 8, 4, 2 (C = 3:
    # not a multiple of its 4 channels per thread)
    (4, 32, 32, 3, 16, "mexican_hat"), (3, 16, 16, 16, 32, "mexican_hat"),
    (3, 8, 8, 32, 64, "mexican_hat"), (4, 4, 4, 64, 128, "mexican_hat"),
    (5, 2, 2, 128, 128, "mexican_hat"),
    (3, 7, 5, 13, 5, "mexican_hat"),   # ragged: the generic row width
    (5, 5, 7, 5, 16, "mexican_hat"),   # W = 7, C = 5
    (9, 1, 8, 6, 32, "mexican_hat"),   # H = 1: both g rows off the frame
] + [(2, 8, 8, 16, 32, w) for w in WAVELETS])
def test_cuda_wav_backward_matches_plain_version(B, H, W, C, O,
                                                 wavelet_type):
    """dx, dw, dt and ds of the CUDA path against autograd of the plain
    version in float64 on the card (see _within)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    set_full_f32()
    x, w, t, s, g = _wav_inputs(B, H, W, C, O, seed=B * 10 + O)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, t, s)]
    wc.reset_launches()
    y = wc.wav_conv2d(*leaves, wavelet_type=wavelet_type, padding=1)
    got = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert wc.launches == {"wav_conv2d_fwd": 1, "wav_conv2d_bwd_dx": 1,
                           "wav_conv2d_bwd_param": 1,
                           "wav_conv2d_bwd_reduce": 1}
    ref_leaves = [a.double().requires_grad_(True) for a in (x, w, t, s)]
    ref = torch.autograd.grad(wc.wav_conv2d_reference(
        *ref_leaves, wavelet_type=wavelet_type, padding=1), ref_leaves,
        g.double())
    for name, a, b in zip(("dx", "dw", "dt", "ds"), got, ref):
        ok, err = _within(a, b)
        assert ok, f"{name}: max |diff| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,pad", [
    (3, 4, 4, 5, 16, 0), (2, 3, 5, 4, 12, 2), (37, 3, 2, 13, 20, 1)])
def test_cuda_wav_param_kernel_other_pads_and_splits(B, H, W, C, O, pad):
    """The parameter kernel's generic rows at pad 0 and 2 (virtual rows
    between images) and a ragged split of 4-byte copies (O = 20 over lanes
    of 32, C = 13), against float64 autograd per split (see _within)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    set_full_f32()
    x, w, t, s, _ = _wav_inputs(B, H, W, C, O, seed=B + 7 * pad)
    Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
    g = torch.from_numpy(np.random.RandomState(pad).normal(
        0, 1, (B, Ho, Wo, O)).astype(np.float32)).cuda()
    cfg = wc.param_launch_config(B, H, W, C, O, 3, pad)
    part = wc.param_partials(x, w, t, s, g, "dog", pad)
    torch.cuda.synchronize()
    ref = wc.param_partials_reference(
        *(a.double() for a in (x, w, t, s, g)), "dog", pad, cfg["S"],
        cfg["ips"])
    ok, err = _within(part, ref)
    assert ok, f"partials: max |diff| {err}"


@pytest.mark.cuda
@pytest.mark.parametrize("B,H,W,C,O,pad,wavelet_type", [
    # the data gradient's compiled row widths 8 (H = 8, 3), 4 (H = 4, 6) and
    # 2 (two rows: H = 2)
    (6, 8, 8, 32, 64, 1, "mexican_hat"), (5, 3, 8, 16, 20, 1, "mexican_hat"),
    (9, 4, 4, 64, 128, 1, "mexican_hat"), (4, 6, 4, 16, 24, 1, "mexican_hat"),
    (33, 2, 2, 128, 128, 1, "mexican_hat"),
    # the generic segment of 8: widths 32, 16, 5, 7, 11; C = 3, 5, 13 (not
    # a multiple of 4); H = 1 and odd H on a compiled width; pads 0 and 2;
    # O not a multiple of 4 (4-byte copies of g) or of the chunk
    (3, 32, 32, 16, 16, 1, "mexican_hat"), (3, 16, 16, 32, 32, 1, "dog"),
    (3, 7, 5, 13, 5, 1, "mexican_hat"), (5, 5, 7, 5, 16, 1, "morlet"),
    (9, 1, 8, 6, 32, 1, "mexican_hat"), (4, 5, 2, 3, 8, 1, "mexican_hat"),
    (3, 4, 4, 5, 16, 0, "mexican_hat"), (2, 3, 5, 4, 12, 2, "mexican_hat"),
    (3, 5, 11, 12, 13, 0, "shannon"),
] + [(4, 8, 8, 16, 24, 1, w) for w in WAVELETS]
  + [(6, 4, 4, 32, 16, 1, w) for w in WAVELETS[1:]]
  + [(7, 2, 2, 64, 32, 1, w) for w in WAVELETS[1:]])
def test_cuda_wav_dx_kernel_matches_plain_version(B, H, W, C, O, pad,
                                                  wavelet_type):
    """The data-gradient kernel alone, one launch, against float64 autograd
    of the plain version on the card (see _within), and two calls
    bit-identical (each block sums all of O in one fixed order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    set_full_f32()
    x, w, t, s, _ = _wav_inputs(B, H, W, C, O, seed=B * 31 + C + pad)
    Ho, Wo = H + 2 * pad - 2, W + 2 * pad - 2
    g = torch.from_numpy(np.random.RandomState(O).normal(
        0, 1, (B, Ho, Wo, O)).astype(np.float32)).cuda()
    wc.reset_launches()
    dx = wc.input_grad(x, w, t, s, g, wavelet_type, pad)
    again = wc.input_grad(x, w, t, s, g, wavelet_type, pad)
    torch.cuda.synchronize()
    assert wc.launches["wav_conv2d_bwd_dx"] == 2
    assert torch.equal(dx, again)
    ref = wc.input_grad_reference(*(a.double() for a in (x, w, t, s, g)),
                                  wavelet_type, pad)
    ok, err = _within(dx, ref)
    assert ok, f"dx: max |diff| {err}"


@pytest.mark.cuda
def test_cuda_wav_skips_unneeded_dx_and_is_deterministic():
    """No data gradient for an input that needs none; two backward calls
    give bit-identical parameter gradients (fixed split, ordered
    reduction) and data gradients."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    x, w, t, s, g = _wav_inputs(64, 8, 8, 32, 64, seed=2)
    params = [a.clone().requires_grad_(True) for a in (w, t, s)]
    y = wc.wav_conv2d(x, *params, wavelet_type="mexican_hat", padding=1)
    assert y.grad_fn is not None
    wc.reset_launches()
    (y * g).sum().backward()
    torch.cuda.synchronize()
    assert wc.launches["wav_conv2d_bwd_dx"] == 0
    assert wc.launches["wav_conv2d_bwd_param"] == 1
    assert all(float(p.grad.abs().sum()) > 0 for p in params)
    spec = ("mexican_hat", 1)
    assert wc.param_launch_config(64, 8, 8, 32, 64, 3, 1)["S"] > 1
    a = wc.param_grads(x, w, t, s, g, *spec)
    b = wc.param_grads(x, w, t, s, g, *spec)
    assert all(torch.equal(u, v) for u, v in zip(a, b))
    assert torch.equal(wc.input_grad(x, w, t, s, g, *spec),
                       wc.input_grad(x, w, t, s, g, *spec))
    p = torch.randn(7, 45, device="cuda")
    assert torch.equal(wc.reduce_partials(p), wc.reduce_reference(p))


# (H, C, O) of BASELINE config 4's three WavKAN convs (bench.py's stack)
CONFIG4_CONVS = [(32, 3, 32), (16, 32, 64), (8, 64, 128)]


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 2048])
@pytest.mark.parametrize("H,C,O", CONFIG4_CONVS)
def test_cuda_wav_config4_shapes_match_plain_version(B, H, C, O):
    """Config 4's shapes, also at its batch 2048: the forward against the
    plain version (1e-4) and dx, dw, dt, ds of the CUDA path against
    float64 autograd of the plain version (see _within), the references
    taken over chunks of 256 images (the parameter gradients summed over
    the chunks in float64)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.device import set_full_f32
    from convkan_tpu_torch.kernels import wav_conv2d as wc

    set_full_f32()
    x, w, t, s, g = _wav_inputs(B, H, H, C, O, seed=B + C)
    leaves = [a.clone().requires_grad_(True) for a in (x, w, t, s)]
    wc.reset_launches()
    y = wc.wav_conv2d(*leaves, wavelet_type="mexican_hat", padding=1)
    got = torch.autograd.grad(y, leaves, g)
    torch.cuda.synchronize()
    assert wc.launches == dict.fromkeys(wc.KERNELS, 1)
    dx64, params64 = [], 0
    for i in range(0, B, 256):
        sl = slice(i, i + 256)
        with torch.no_grad():
            torch.testing.assert_close(
                y[sl], wc.wav_conv2d_reference(
                    x[sl], w, t, s, wavelet_type="mexican_hat", padding=1),
                rtol=1e-4, atol=1e-4)
        ref = [a.double().requires_grad_(True) for a in (x[sl], w, t, s)]
        d = torch.autograd.grad(wc.wav_conv2d_reference(
            *ref, wavelet_type="mexican_hat", padding=1), ref,
            g[sl].double())
        dx64.append(d[0])
        params64 = [p + q for p, q in zip(params64 or [0] * 3, d[1:])]
    for name, a, b in zip(("dx", "dw", "dt", "ds"), got,
                          [torch.cat(dx64)] + params64):
        ok, err = _within(a, b)
        assert ok, f"{name}: max |diff| {err}"


@pytest.mark.cuda
def test_cuda_batchnorm_matches_cpu():
    """BatchNorm on the card against the CPU, float32, train mode (output,
    gradients, running statistics) and eval mode: within 1e-5 of the
    largest entry (sums of 16,384 values per channel in another order)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.utils.norms import BatchNorm

    gen = torch.Generator().manual_seed(0)
    cpu = BatchNorm(32)
    with torch.no_grad():
        cpu.weight.normal_(1.0, 0.3, generator=gen)
        cpu.bias.normal_(0.0, 0.3, generator=gen)
        cpu.mean.normal_(0.0, 0.5, generator=gen)
        cpu.var.uniform_(0.5, 2.0, generator=gen)
    gpu = BatchNorm(32).cuda()
    gpu.load_state_dict(cpu.state_dict())
    x = torch.randn(16, 32, 32, 32, generator=gen) * 2 + 0.5
    g = torch.randn(x.shape, generator=gen)

    def close(a, b):
        a, b = a.detach().cpu().double(), b.detach().double()
        assert (a - b).abs().max() <= 1e-5 * b.abs().max()

    for train in (True, False):
        outs = []
        for m, dev in ((cpu, "cpu"), (gpu, "cuda")):
            xt = x.to(dev).clone().requires_grad_(True)
            y = m.train(train)(xt)
            (y * g.to(dev)).sum().backward()
            outs.append((y, xt.grad, m.weight.grad, m.bias.grad))
        for a, b in zip(outs[1], outs[0]):
            close(a, b)
        for name in ("mean", "var"):
            close(getattr(gpu, name), getattr(cpu, name))
        for m in (cpu, gpu):
            m.zero_grad(set_to_none=True)


@pytest.mark.cuda
def test_cuda_folded_kan_forward_matches_the_unfolded_model():
    """KAN-VGG16_small with BatchNorm2d on the card, its running statistics
    moved by train-mode forwards: folding every norm into poly_w and base_w
    keeps the eval logits within 1e-3 (float32, 13 layers), and the folded
    forward still launches the kernel once per conv."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (run on the GPU machine)")
    from convkan_tpu_torch.models.vgg import vggkan
    from convkan_tpu_torch.utils.fold_bn import fold_batch_norms

    model = vggkan(3, 10, arch="VGG16_small", classifier_type="Linear",
                   kan_norm_layer="BatchNorm2d",
                   generator=torch.Generator().manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for _ in range(3):
            model.train()(torch.randn(64, 32, 32, 3, generator=gen).cuda())
        x = torch.randn(64, 32, 32, 3, generator=gen).cuda()
        want = model.eval()(x)
        assert fold_batch_norms(model) == 13
        kc.reset_launches()
        got = model(x)
        torch.cuda.synchronize()
    assert kc.launches["kan_conv2d_fwd"] == 13
    assert (got - want).abs().max() <= 1e-3 * (1 + want.abs().max())
