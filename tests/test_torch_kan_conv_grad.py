"""Port parity for the KAN-conv gradient (the training slice's kernels in
convkan_tpu_torch/kernels/kan_conv2d.py, and KanConvND under autograd).

On this CPU host the wrappers run their plain PyTorch versions.  They are
held against
  * the TPU backward kernel they replace, ``bwd_kernel`` of
    ``make_wide_kan_conv_op`` run in Pallas interpret mode as
    tests/test_pallas_kernels.py runs it, in float32 (rtol = atol = 1e-4:
    dW sums B*H*W = 128 products per entry in another order);
  * the JAX package's default (XLA) KanConvND path in float64, gradients
    of a random linear functional of the module output (max |diff| <=
    1e-10).
The CUDA kernels themselves are checked on the card by chip_smoke.py and
tests/test_torch_cuda.py.
"""

import itertools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis.bspline import bspline_basis_unrolled_list
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.nn.kan_conv import KanConvND as JaxKanConvND
from convkan_tpu.utils.activations import silu as jax_silu
from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.basis.bspline import (
    bspline_basis_unrolled_list as port_basis)
from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.nn.kan_conv import KanConvND

torch.set_num_threads(1)

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
K = 8
BASIS = kc.bspline_basis(KNOTS, 3, "silu")
R = K + 1       # rows of E per channel: the K bases and act(x)
# (H, C, O) of the VGG16_small convs (9 distinct shapes)
VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]


def _inputs(B, H, C, O, seed, dtype=np.float32, scale=2.5):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (B, H, H, C))
    x.reshape(-1)[:len(KNOTS)] = KNOTS  # exact knot values occur
    bw = rng.normal(0, 0.2, (3, 3, C, O))
    pw = rng.normal(0, 0.2, (3, 3, C * K, O))
    g = rng.normal(0, 1, (B, H, H, O))
    return tuple(a.astype(dtype) for a in (x, bw, pw, g))


def _port_grads(x, bw, pw, g, act="silu"):
    leaves = [torch.from_numpy(a).requires_grad_(True) for a in (x, bw, pw)]
    y = kc.kan_conv2d(*leaves, kc.bspline_basis(KNOTS, 3, act), 3, 1)
    return [t.numpy() for t in torch.autograd.grad(y, leaves,
                                                   torch.from_numpy(g))]


@pytest.mark.parametrize("C,O", [(3, 8), (16, 16)])
def test_grads_match_pallas_bwd_kernel(C, O):
    x, bw, pw, g = _inputs(2, 8, C, O, seed=C * 10 + O)
    op = make_wide_kan_conv_op(
        basis_list_fn=lambda t: bspline_basis_unrolled_list(t, KNOTS, 3),
        num_basis=K, base_act=jax_silu, kernel_size=3, padding=1,
        degree_major=False, has_base=True, interpret=True)
    y, pull = jax.vjp(op, jnp.asarray(x), jnp.asarray(bw), jnp.asarray(pw))
    assert y.dtype == jnp.float32
    want = [np.asarray(t) for t in pull(jnp.asarray(g))]
    got = _port_grads(x, bw, pw, g)
    for name, a, b in zip(("dx", "dbase_w", "dpoly_w"), got, want):
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, rtol=1e-4, atol=1e-4, err_msg=name)


@pytest.mark.parametrize("C,O,act", [(3, 8, "silu"), (16, 16, "silu"),
                                     (5, 12, "gelu")])
def test_module_grads_match_jax_xla_path_f64(C, O, act):
    x, bw, pw, g = _inputs(2, 8, C, O, seed=C + O, dtype=np.float64,
                           scale=1.5)
    prelu = np.array([-0.3])
    jm = JaxKanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=3,
                      padding=1, base_activation=act,
                      param_dtype=jnp.float64)

    def f(xx, p):
        return jnp.sum(jm.apply({"params": p}, xx, train=False) * g)

    params = {"base_w": bw, "poly_w": pw, "prelu": prelu}
    jdx, jdp = jax.grad(f, argnums=(0, 1))(jnp.asarray(x), params)

    tm = KanConvND(family="kan", input_dim=C, output_dim=O, kernel_size=3,
                   padding=1, base_activation=act, device="cpu",
                   dtype=torch.float64)
    tm.load_state_dict({k: torch.from_numpy(v) for k, v in params.items()})
    xt = torch.from_numpy(x).requires_grad_(True)
    (tm.eval()(xt) * torch.from_numpy(g)).sum().backward()
    assert np.max(np.abs(xt.grad.numpy() - np.asarray(jdx))) <= 1e-10
    for name, p in tm.named_parameters():
        assert np.max(np.abs(p.grad.numpy() - np.asarray(jdp[name]))) <= \
            1e-10, name


def test_plain_kernel_versions_agree_with_autograd():
    """The wrappers' plain versions: input_grad and weight_grad are the
    gradients of kan_conv2d_reference, and the per-split partials reduced
    in order give weight_grad."""
    x, bw, pw, g = _inputs(5, 4, 6, 8, seed=4, dtype=np.float64)
    xt, bwt, pwt, gt = (torch.from_numpy(a) for a in (x, bw, pw, g))
    w_all = kc.pack_w_all(bwt, pwt, C=6, K=K, k=3, O=8)
    wl = w_all.clone().requires_grad_(True)
    xl = xt.clone().requires_grad_(True)
    y = kc._conv_w_all(kc.expand(xl, BASIS), wl, 3, 1)
    want_dx, want_dw = torch.autograd.grad(y, (xl, wl), gt)
    dx = kc.input_grad(xt, w_all, gt, BASIS, 3, 1)
    dw = kc.weight_grad(xt, gt, BASIS, 3, 1)
    torch.testing.assert_close(dx, want_dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    partial = kc.weight_partials(xt, gt, BASIS, 3, 1)
    cfg = kc.dw_launch_config(5, 4, 4, 6, 8, 3, 1, R)
    assert partial.shape == (cfg["S"], 9 * 6, 9 * 8) and cfg["S"] == 5
    torch.testing.assert_close(kc.reduce_partials(partial), want_dw,
                               rtol=1e-12, atol=1e-12)


def test_cpu_tensors_never_launch_backward_kernels():
    kc.reset_launches()
    _port_grads(*_inputs(1, 4, 3, 4, seed=0))
    assert sum(kc.launches.values()) == 0


def test_backward_launch_configs_tile_vgg16_small():
    """Every VGG16_small conv shape gets data- and weight-gradient tiles
    that fit.  The data gradient: 8 channels x 8 output channels per chunk,
    two chunks in flight, shared memory for two blocks per SM; the pad taps
    skipped on the 4x4 and 2x2 planes (every (pixel, tap) pair it computes
    an interior one at batch 1024), elsewhere NB x TH x W = 256 pixel slots
    with no idle slot; about two blocks per SM at batch 1024.  The weight
    gradient's rows are whole channels (no padded row), its column tiles
    cut 9*O exactly (no padded column), at most DW_THREADS threads in
    whole warps, shared memory for two blocks per SM, at least two blocks
    per SM at batch 1024, and a split count that depends on the shape
    only."""
    for H, C, O in VGG16_SMALL:
        for B in (1, 16, 64, 1024):
            dx = kc.dx_launch_config(B, H, H, C, O, 3, 1, R)
            assert dx["smem"] <= kc.SMEM_TWO_BLOCKS
            assert (dx["OC"], dx["stages"], dx["table"]) == (kc.DX_OC, 2, 1)
            assert dx["CC"] == min(kc.DX_MAX_CC, 1 << (C - 1).bit_length())
            assert dx["skip"] == (H <= 4)
            if not dx["skip"]:
                assert dx["NB"] * dx["TH"] * H == kc.DX_PIXELS
            if B == 1024:
                assert dx["blocks"] >= 256
                if C > 3:   # the first conv has no data gradient
                    interior = B * ((3 * H - 2) ** 2)
                    pairs = _dx_pairs(dx, B, H, H, 3, 1)
                    assert pairs == interior if dx["skip"] else \
                        pairs == B * H * H * 9
            dw = kc.dw_launch_config(B, H, H, C, O, 3, 1, R)
            CC, BN, PW = dw["CC"], dw["BN"], dw["PW"]
            assert CC <= kc.DW_MAX_CC and C % CC == 0          # rows 9*CC
            assert BN % kc.DW_TN == 0 and 9 * O % BN == 0       # columns
            assert dw["tiles"] == C // CC * (9 * O // BN)
            assert PW * CC * BN // kc.DW_TN <= dw["threads"] \
                <= kc.DW_THREADS and dw["threads"] % 32 == 0
            assert dw["threads"] - PW * CC * BN // kc.DW_TN < 32
            assert dw["smem"] == kc.dw_smem(K + 1, CC, BN, PW) \
                <= kc.SMEM_TWO_BLOCKS
            assert dw["S"] * dw["ips"] >= B > (dw["S"] - 1) * dw["ips"]
            assert dw["blocks"] == dw["tiles"] * dw["S"]
            assert dw["S"] == 1 or dw["blocks"] <= kc.DW_TARGET_BLOCKS
            if B == 1024:
                assert dw["blocks"] >= 2 * 132
            assert dw == kc.dw_launch_config(B, H, H, C, O, 3, 1, R)
    # the first conv: 3 channels x 18 column groups, four pixel slices
    first = kc.dw_launch_config(1024, 32, 32, 3, 16, 3, 1, R)
    assert (first["CC"], first["BN"], first["PW"]) == (3, 144, 4)
    with pytest.raises(NotImplementedError):
        kc.dx_launch_config(1, 4, 4096, 3, 16, 3, 1, R)   # row too wide


def test_dw_launch_config_accepts_every_shape_the_parent_did():
    """Coverage never shrinks: the previous weight-gradient tile took every
    shape with at most 64 expanded rows per channel (K + 1 <= 64: its
    4-row x 8-column thread tile at BN = 128), and each still gets a tile
    that the C entry takes (mirrored here)."""
    accepted = 0
    for B, C, O, k, KK in itertools.product(
            (1, 5, 1023, 1024, 4096), (1, 2, 3, 7, 13, 16, 64, 128, 300, 1024),
            (1, 3, 5, 16, 48, 64, 100, 104, 128, 256, 1000), (1, 3, 5, 7),
            (3, 8, 20, 63)):
        assert KK + 1 <= 64                   # the parent's predicate
        cfg = kc.dw_launch_config(B, 8, 8, C, O, k, k // 2, KK + 1)
        accepted += 1
        CC, BN, PW, T = cfg["CC"], cfg["BN"], cfg["PW"], cfg["threads"]
        TO = k * k * O
        assert 1 <= CC <= kc.DW_MAX_CC and BN >= kc.DW_TN and \
            BN % kc.DW_TN == 0 and PW >= 1
        assert PW * CC * BN // kc.DW_TN <= kc.DW_THREADS
        assert T == 32 * -(-PW * CC * BN // kc.DW_TN // 32)
        assert BN // (4 if O % 4 == 0 else 1) <= T          # the gather
        assert cfg["smem"] == kc.dw_smem(KK + 1, CC, BN, PW) <= \
            kc.SMEM_LIMIT
        assert cfg["tiles"] == -(-C // CC) * -(-TO // BN)
        assert cfg["S"] * cfg["ips"] >= B > (cfg["S"] - 1) * cfg["ips"]
        if TO % (kc.DW_TN * -(-TO // BN)) == 0:
            assert TO % BN == 0         # an exact cut is taken when found
    assert accepted == 8800


def test_grad_wrappers_refuse_bad_gradients():
    x, bw, pw, g = (torch.from_numpy(a) for a in _inputs(1, 4, 3, 4, seed=0))
    w_all = kc.pack_w_all(bw, pw, C=3, K=K, k=3, O=4)
    with pytest.raises(ValueError):          # wrong output-gradient shape
        kc.input_grad(x, w_all, g[:, :2], BASIS, 3, 1)
    with pytest.raises(TypeError):           # dtype differs from x
        kc.weight_grad(x, g.double(), BASIS, 3, 1)


def _recurrence_f32(x, knots, order, span_only):
    """float32 emulation of the CUDA basis loops (every operation rounded
    to float32 as __fsub_rn/__fdiv_rn/__fmul_rn/__fadd_rn do): the full
    Cox-de Boor recurrence (every basis at every level), or the
    span-limited one of csrc/kan_basis.cuh (bspline_span, which the
    forward and backward kernels share), for a vector x."""
    f32 = np.float32
    kn = np.asarray(knots, f32)
    nk = len(kn)
    K = nk - order - 1

    def deltas(i, k):
        dr = kn[i + k] - kn[i]
        dd = kn[i + k + 1] - kn[i + 1]
        return np.where(dr == 0, f32(1), dr), np.where(dd == 0, f32(1), dd)

    if not span_only:
        b = [((x >= kn[i]) & (x < kn[i + 1])).astype(f32)
             for i in range(nk - 1)]
        for k in range(1, order + 1):
            for i in range(nk - 1 - k):
                dr, dd = deltas(i, k)
                b[i] = ((x - kn[i]) / dr) * b[i] + \
                    ((kn[i + k + 1] - x) / dd) * b[i + 1]
        return np.stack(b[:K], -1)
    j = np.full(x.shape, -1)
    for i in range(nk - 1):
        j = np.where((x >= kn[i]) & (x < kn[i + 1]), i, j)
    N = [np.ones_like(x)]
    for k in range(1, order + 1):
        nw = []
        for m in range(k + 1):
            i = j - k + m
            ok = (i >= 0) & (i <= nk - 2 - k)
            ic = np.clip(i, 0, nk - 2 - k)
            dr, dd = deltas(ic, k)
            v = np.zeros_like(x)
            if m >= 1:
                v = ((x - kn[ic]) / dr) * N[m - 1]
            if m <= k - 1:
                t2 = ((kn[ic + k + 1] - x) / dd) * N[m]
                v = v + t2 if m >= 1 else t2
            nw.append(np.where(ok, v, f32(0)))
        N = nw
    out = np.zeros(x.shape + (K,), f32)
    for m in range(order + 1):
        kk = j - order + m
        hit = (j >= 0) & (kk >= 0) & (kk < K)
        out[hit, kk[hit]] = N[m][hit]
    return out


def test_span_basis_is_bit_identical_to_full_recurrence():
    """The kernels evaluate only the ORDER+1 bases over x's knot interval;
    every dropped term is an exact 0, so the float32 values are those of
    the full recurrence bit for bit (finite x)."""
    kn = np.asarray(KNOTS, np.float32)
    x = np.concatenate([
        np.random.RandomState(0).uniform(-3, 3, 20000).astype(np.float32),
        kn, np.nextafter(kn, np.float32(9)), np.nextafter(kn, np.float32(-9))])
    with np.errstate(all="ignore"):
        full = _recurrence_f32(x, KNOTS, 3, span_only=False)
        span = _recurrence_f32(x, KNOTS, 3, span_only=True)
    assert full.dtype == span.dtype == np.float32 and full.shape == (20036, K)
    np.testing.assert_array_equal(span, full)
    np.testing.assert_array_equal(   # and both are the port's plain basis
        full, np.stack([b.numpy() for b in port_basis(
            torch.from_numpy(x), KNOTS, 3)], -1))


# ------------------------------------- the weight-gradient kernel's index map
def _emulate_dw(x, g, k, pad, cfg):
    """csrc/kan_conv2d_bwd.cu ``kan_conv2d_bwd_dw_kernel`` in float64 numpy,
    block by block and chunk by chunk: thread -> (pixel slice, channel,
    column group), column tile -> (tap, o), chunk -> (image, row, column),
    split -> images, the gather's thread -> (column, pixels) map, the
    slices' ordered sum and the partials' layout.  Asserts that every
    staged entry is written once per chunk and that the reads stay inside
    what was staged; returns the partials and how often each was
    written."""
    B, H, W, C = x.shape
    O = g.shape[-1]
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    E = kc.expand(torch.from_numpy(x), BASIS).numpy()
    K1 = E.shape[-1] // C
    E = E.reshape(B, H, W, K1, C)
    gpad = np.zeros((B + 1, Ho + 1, Wo + 1, O + 1))   # index -1: a zero
    gpad[:B, :Ho, :Wo, :O] = g
    CC, BN, P, S, ips, PW = (cfg[n] for n in ("CC", "BN", "P", "S", "ips",
                                              "PW"))
    T, TO, TN = cfg["threads"], k * k * O, kc.DW_TN
    CG = CC * (BN // TN)
    tid = np.arange(T)
    slice_, cl, tn = tid // CG, (tid % CG) % CC, (tid % CG) // CC
    active = slice_ < PW
    # a thread's columns: two runs of 4, tn*4 + j and BN/2 + tn*4 + j
    cols = (np.array([0, 0, 0, 0, 1, 1, 1, 1]) * (BN // 2)
            + np.arange(TN) % 4)[None, :] + 4 * tn[:, None]
    assert cols[active].max() < BN
    # the expansion: thread t takes idx = t, t + T, ... < P*CC, pixel
    # idx / CC, channel idx % CC
    idx = np.concatenate([np.arange(t, P * CC, T) for t in range(T)])
    assert np.array_equal(np.sort(idx), np.arange(P * CC))
    ep, el = idx // CC, idx % CC
    # the gather: thread t loads VW columns fq*VW .. fq*VW + VW - 1 (one
    # tap's when VW = 4) of pixels fp0, fp0 + step, ...
    VW = 4 if O % 4 == 0 else 1
    Q = BN // VW
    step = T // Q
    assert step >= 1
    fq, fp0 = tid % Q, np.where(tid < step * Q, tid // Q, P)
    pairs = [(t, p) for t in range(T) for p in range(fp0[t], P, step)]
    zt, zp = (np.array(a) for a in zip(*pairs))
    zc = fq[zt][:, None] * VW + np.arange(VW)[None, :]      # (pairs, VW)
    zcount = np.zeros((P, BN), dtype=int)
    np.add.at(zcount, (np.broadcast_to(zp[:, None], zc.shape), zc), 1)
    assert (zcount == 1).all()
    # the pixels of every (split, chunk): split s sums images [s*ips,
    # s*ips + ips) in chunks of P (-1: past the split's end)
    nch = -(-ips * H * W // P)
    pg = (np.arange(S)[:, None, None] * ips * H * W
          + np.arange(nch)[None, :, None] * P + np.arange(P)[None, None, :])
    hi = np.minimum(B, np.arange(S) * ips + ips)[:, None, None] * H * W
    pb = np.where(pg < hi, pg // (H * W), -1)
    ph, pw = (pg % (H * W)) // W, pg % W
    partial = np.zeros((S, K1 * C, TO))
    written = np.zeros((S, K1 * C, TO), dtype=int)
    for bx, by in itertools.product(range(-(-C // CC)), range(-(-TO // BN))):
        c0, n0 = bx * CC, by * BN
        # the staged chunks, (split, chunk, pixel, ...); NaN: never staged
        Es = np.full((S, nch, P, CC, K1), np.nan)
        Es[:, :, ep, el] = 0.0
        ok = (pb[:, :, ep] >= 0) & (c0 + el < C)
        sp, ch, i = np.nonzero(ok)
        Es[sp, ch, ep[i], el[i]] = E[pb[sp, ch, ep[i]], ph[sp, ch, ep[i]],
                                     pw[sp, ch, ep[i]], :, c0 + el[i]]
        n = n0 + zc
        tap, o = n // O, n % O
        assert VW == 1 or (tap == tap[:, :1]).all() or (n >= TO).any()
        b = pb[:, :, zp][..., None]
        gi = ph[:, :, zp][..., None] + pad - tap // k
        gj = pw[:, :, zp][..., None] + pad - tap % k
        okg = (b >= 0) & (n < TO) & (gi >= 0) & (gi < Ho) & (gj >= 0) \
            & (gj < Wo)
        Zs = np.full((S, nch, P, BN), np.nan)
        Zs[:, :, zp[:, None], zc] = gpad[tuple(
            np.where(okg, a, -1) for a in np.broadcast_arrays(b, gi, gj, o))]
        # the FMA loop: slice s takes pixels s, s + PW, ... of each chunk
        acc = np.zeros((S, T, K1, TN))
        for s in range(PW):
            on = active & (slice_ == s)
            ps = np.arange(s, P, PW)
            if len(ps) == 0:         # more slices than pixels: no work
                continue
            e = Es[:, :, ps][:, :, :, cl[on]]           # (S, ch, p, t, K1)
            z = Zs[:, :, ps][:, :, :, cols[on]]          # (S, ch, p, t, 8)
            assert not np.isnan(e).any() and not np.isnan(z).any()
            e = e.transpose(0, 3, 4, 1, 2).reshape(S, -1, K1, nch * len(ps))
            z = z.transpose(0, 3, 1, 2, 4).reshape(S, -1, nch * len(ps), TN)
            acc[:, on] = e @ z
        for s in range(1, PW):   # slice order, into slice 0
            acc[:, :CG] += acc[:, (slice_ == s) & active][:, :CG]
        t = np.nonzero((slice_ == 0) & (c0 + cl < C))[0]
        rows = np.arange(K1)[None, :, None] * C + (c0 + cl[t])[:, None, None]
        nn = np.broadcast_to((n0 + cols[t])[:, None, :], (len(t), K1, TN))
        keep = nn < TO
        rr = np.broadcast_to(rows, nn.shape)
        partial[:, rr[keep], nn[keep]] = acc[:, t][:, keep]
        np.add.at(written, (slice(None), rr[keep], nn[keep]), 1)
    return partial, written


@pytest.mark.parametrize("B,H,W,C,O,k,pad", [
    (2, H, H, C, O, 3, 1) for H, C, O in VGG16_SMALL] + [
    (5, 7, 7, 13, 5, 3, 1),     # C % 8, O % 4 ragged; chunks span images
    (3, 5, 5, 6, 9, 3, 1),      # odd H, padded columns, three slices
    (2, 8, 8, 16, 48, 3, 1),    # 216-column tiles
    (793, 1, 1, 1, 1, 3, 1),    # B % ips ragged; 128 pixel slices
    (3, 6, 5, 5, 12, 5, 2),     # kernel 5, pad 2, non-square
    (2, 6, 6, 4, 8, 3, 0),      # no pad: Ho < H
])
def test_dw_kernel_index_mapping_emulation(B, H, W, C, O, k, pad):
    """The weight-gradient kernel's tiling, emulated in float64, writes
    every partial entry exactly once and agrees with the plain version's
    partials to 1e-12."""
    rng = np.random.RandomState(B * 100 + H * 10 + C)
    x = rng.uniform(-2.5, 2.5, (B, H, W, C))
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    g = rng.normal(0, 1, (B, Ho, Wo, O))
    cfg = kc.dw_launch_config(B, H, W, C, O, k, pad, R)
    got, written = _emulate_dw(x, g, k, pad, cfg)
    want = kc.weight_partials_reference(
        torch.from_numpy(x), torch.from_numpy(g), BASIS, k, pad,
        cfg["S"], cfg["ips"]).numpy()
    assert (written == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


# ---------------------------------------- the data-gradient kernel's tile
def _dx_pairs(cfg, B, H, W, k, pad):
    """(pixel, tap) pairs the data-gradient kernel computes per channel
    block: dense, every tap of every pixel slot of every block; skip, the
    taps whose g lies on the output plane, for whole image groups."""
    if not cfg["skip"]:
        return cfg["tiles"] * kc.DX_PIXELS * k * k
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    taps = sum(0 <= i + pad - di < Ho and 0 <= j + pad - dj < Wo
               for i, j, di, dj in itertools.product(
                   range(H), range(W), range(k), range(k)))
    return kc.DX_GROUP * -(-B // kc.DX_GROUP) * taps


def _dx_entry_takes(cfg, B, H, W, k, KK):
    """Asserts that the C entry kan_conv2d_bwd_dx takes the tile (its
    checks, mirrored) and that its shared memory is dx_smem's."""
    CC, OC = cfg["CC"], cfg["OC"]
    assert CC in (1, 2, 4, 8) and OC in (4, 8) and cfg["stages"] in (1, 2)
    assert cfg["table"] in (0, 1)
    if cfg["skip"]:
        assert cfg["NG"] >= kc.skip_groups(H * W, -(-B // kc.DX_GROUP))
    else:
        Wv = 1 << (W - 1).bit_length()
        slots = cfg["NB"] * cfg["TH"] * Wv
        assert slots in (32, 64, 128, 256)
        assert cfg["TH"] & (cfg["TH"] - 1) == 0
        assert cfg["NB"] == 1 or cfg["TH"] >= H
    assert (KK + 1) * CC * OC // 4 <= kc.THREADS
    assert cfg["smem"] == kc.dx_smem(
        cfg["tile"], cfg["pitch"], k * k, KK + 1, CC, OC, cfg["stages"],
        cfg["skip"], cfg["table"]) <= kc.SMEM_LIMIT - kc.DX_SMEM_STATIC


def _parent_dx_accepts(B, H, W, C, O, k, KK):
    """The previous data-gradient tile's predicate, written out: at most
    128 pixels of whole rows per block, the haloed g tile and the weight
    rows of all taps for some CC <= 8 channels in shared memory, output
    channels staged 16 at a time and padded to an odd number of float4s."""
    if W > 128:
        return False
    if H * W >= 128:
        TH, NB = min(H, 128 // W), 1
    else:
        TH, NB = H, min(B, 128 // (H * W))
    OC = min(16, -(-O // 4) * 4)
    gs = OC if (OC // 4) % 2 else OC + 4
    tile = NB * (TH + k - 1) * (W + k - 1)
    return any(4 * (gs * (tile + k * k * (KK + 1) * CC) + (KK + 1) * CC)
               <= kc.SMEM_LIMIT for CC in range(min(C, 8), 0, -1))


def test_dx_launch_config_accepts_every_shape_the_parent_did():
    """Coverage never shrinks: every shape of the grid that the previous
    data-gradient tile took gets a tile that the C entry takes (mirrored
    here), for kernels up to 11 x 11 and up to 64 expanded rows per
    channel (larger kernels: the next test)."""
    accepted = 0
    for B, H, W, C, O, k, KK in itertools.product(
            (1, 5, 33, 1024), (1, 2, 3, 4, 5, 8, 13, 32), (1, 2, 3, 4, 7, 16,
                                                           32, 100, 128),
            (1, 3, 8, 13, 128), (1, 4, 5, 16, 48, 128), (1, 3, 5, 7, 11),
            (3, 8, 63)):
        pad = k // 2
        if not _parent_dx_accepts(B, H, W, C, O, k, KK):
            continue
        accepted += 1
        cfg = kc.dx_launch_config(B, H, W, C, O, k, pad, KK + 1)
        _dx_entry_takes(cfg, B, H, W, k, KK)
        if k <= 5 and KK == 8:   # no fallback where VGG-like layers lie
            assert cfg["table"] == 1 and (
                cfg["skip"] or cfg["NB"] * cfg["TH"] *
                (1 << (W - 1).bit_length()) == kc.DX_PIXELS)
    assert accepted == 117795


def test_dx_launch_config_accepts_large_kernels_the_parent_did():
    """... and for kernels of 13 x 13 up to 61 x 61, where the previous
    tile took shapes at the edge of shared memory (output channels staged
    4 at a time): each gets a tile the C entry takes, some only with the
    fallbacks (dense layouts of 128, 64 or 32 pixel slots, no table of g
    offsets), and each fallback is reached."""
    accepted, seen = 0, set()
    for B, H, W, C, O, k, KK in itertools.product(
            (1, 33), (1, 3, 4, 5, 8, 13, 32), (1, 3, 13, 16, 32, 100, 128),
            (1, 13, 128), (1, 4, 5, 48), (13, 17, 25, 37, 49, 61),
            (3, 8, 20, 63)):
        pad = k // 2
        if not _parent_dx_accepts(B, H, W, C, O, k, KK):
            continue
        accepted += 1
        cfg = kc.dx_launch_config(B, H, W, C, O, k, pad, KK + 1)
        _dx_entry_takes(cfg, B, H, W, k, KK)
        if not cfg["skip"]:
            seen.add((cfg["NB"] * cfg["TH"] * (1 << (W - 1).bit_length()),
                      cfg["table"]))
    assert accepted == 8235
    assert seen == {(256, 1), (128, 1), (64, 1), (32, 1), (256, 0),
                    (128, 0), (64, 0)}


def _emulate_dx(x, w_all, g, k, pad, cfg):
    """csrc/kan_conv2d_bwd.cu ``kan_conv2d_bwd_dx_kernel`` in float64
    numpy, block by block: the g tile's offsets (the TilePixel counter of
    the table, or of each staging thread without it),
    the staging of every chunk (thread -> g pixels, thread -> weight
    entry of every tap), the pixel slots (dense: the NB x TH x Wv layout
    and the uniform dq; skip: warp slot -> (image group, position), its
    valid taps), the sums and the writes.  Asserts that every staged entry
    is written once per chunk, that every read lies in the block's shared
    memory and, for a pixel that is written, in what was staged; returns
    dE (B, H, W, (K+1)*C) and how often each entry was written."""
    B, H, W, C = x.shape
    O = g.shape[-1]
    K1 = w_all.shape[0] // C
    T = k * k
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    O4 = -(-O // 4) * 4
    gp = np.zeros((B, Ho, Wo, O4))
    gp[..., :O] = g
    wp = np.zeros((K1 * C, T, O4))
    wp[..., :O] = w_all.reshape(K1 * C, T, O)
    gflat = gp.reshape(-1)
    CC, OC, skip = cfg["CC"], cfg["OC"], cfg["skip"]
    OC4, tileR, tileC = OC // 4, cfg["tileR"], cfg["tileC"]
    tile, pitch, dq = cfg["tile"], cfg["pitch"], np.array(cfg["dq"])
    tid = np.arange(kc.THREADS)
    tn, pm, warp = tid & 7, tid >> 3, tid >> 5
    P = H * W
    dE = np.full((B, H, W, K1 * C), np.nan)
    written = np.zeros((B, H, W, C), dtype=int)
    for bx, by in itertools.product(range(cfg["tiles"]), range(-(-C // CC))):
        c0 = by * CC
        # the pixel slots: b0, i0 and each thread's q = 0 tile pixel
        slot0 = bx * kc.WARPS
        igB = slot0 // P
        if skip:
            b0, i0 = igB * kc.DX_GROUP, 0
            slot = slot0 + (warp ^ (warp >> 2))
            ig, pos = slot // P, slot % P
            iw = np.where(slot < -(-B // kc.DX_GROUP) * P, pos // W + pad, -Ho)
            jw = pos % W + pad
            gbase = (iw * Wo + jw) * tileC + (ig - igB) * kc.DX_GROUP + (pm & 3)
        else:
            Wv = 1 << (W - 1).bit_length()
            lw, lth = Wv.bit_length() - 1, cfg["TH"].bit_length() - 1
            rowChunks = -(-H // cfg["TH"])
            b0 = bx // rowChunks * cfg["NB"]
            i0 = (bx % rowChunks) << lth
            nb, r = pm >> (lw + lth), (pm >> lw) & (cfg["TH"] - 1)
            gbase = (nb * tileR + r + k - 1) * tileC + (pm & (Wv - 1)) + k - 1
        # the g offsets by the kernel's TilePixel counter: with the table,
        # built once per block by threads tid, tid + 256, ...; without it,
        # counted by each staging thread over its pixels tid / OC4,
        # + 256 / OC4, ... (the OC4 threads of a pixel count the same)
        start, step = (tid, kc.THREADS) if cfg["table"] else \
            (tid // OC4, kc.THREADS // OC4)
        gOff = np.full(tile, -7)
        d0, d1 = start % tileC, start // tileC
        d2, d1 = d1 // tileR, d1 % tileR
        s0, s12 = step % tileC, step // tileC
        s2, s1 = s12 // tileR, s12 % tileR
        for p0 in range(0, tile, step):
            p = p0 + start
            assert ((d2 * tileR + d1) * tileC + d0 == p).all()
            on = p < tile
            b = b0 + (d0 if skip else d2)
            oi = d2 if skip else i0 + pad - (k - 1) + d1
            oj = d1 if skip else pad - (k - 1) + d0
            ok = (b < B) & (oi >= 0) & (oi < Ho) & (oj >= 0) & (oj < Wo)
            off = np.where(ok, ((b * Ho + oi) * Wo + oj) * O4, -1)
            assert ((gOff[p[on]] == -7) | (gOff[p[on]] == off[on])).all()
            gOff[p[on]] = off[on]
            d0 = d0 + s0
            d1, d0 = d1 + (d0 >= tileC), np.where(d0 >= tileC, d0 - tileC, d0)
            d1 = d1 + s1
            d2, d1 = d2 + (d1 >= tileR), np.where(d1 >= tileR, d1 - tileR, d1)
            d2 = d2 + s2
        assert (gOff != -7).all()
        acc = np.zeros((kc.THREADS, kc.DX_TM, K1))
        for oc0 in range(0, O4, OC):
            # g: thread tid stages float4 o4 = tid % OC4 of pixels
            # tid // OC4, + 256 // OC4, ...
            Gs = np.full((OC4, pitch, 4), np.nan)
            count = np.zeros((OC4, pitch), dtype=int)
            for t in range(kc.THREADS):
                o4, oo = t % OC4, oc0 + 4 * (t % OC4)
                ps = np.arange(t // OC4, tile, kc.THREADS // OC4)
                off = gOff[ps]
                ok = (off >= 0) & (oo < O4)
                vals = gflat[np.where(ok, off, 0)[:, None] + oo + np.arange(4)]
                Gs[o4, ps] = np.where(ok[:, None], vals, 0.0)
                count[o4, ps] += 1
            assert (count[:, :tile] == 1).all() and (count[:, tile:] == 0).all()
            # W: thread e < K1*CC*OC4, e = (kk*OC4 + o4)*CC + cl, stages its
            # entry of every tap at e + tap*K1*CC*OC4
            E = K1 * CC * OC4
            e = np.arange(E)
            cl, o4, kk = e % CC, (e // CC) % OC4, e // (CC * OC4)
            oo = oc0 + 4 * o4
            ok = (c0 + cl < C) & (oo < O4)
            Ws = np.zeros((T, E, 4))
            rows = kk * C + np.minimum(c0 + cl, C - 1)
            for tap in range(T):
                cols = np.minimum(oo, O4 - 4)[:, None] + np.arange(4)
                Ws[tap] = np.where(ok[:, None], wp[rows[:, None], tap, cols], 0)
            Wflat = Ws.reshape(T * E, 4)
            # the sums: thread (pm, tn), pixel q at tile pixel gbase + dq[q]
            for tap in range(T):
                di, dj = divmod(tap, k)
                if skip:
                    valid = ((iw - di >= 0) & (iw - di < Ho) & (jw - dj >= 0)
                             & (jw - dj < Wo))
                    sh = (di * Wo + dj) * tileC
                else:
                    valid = np.ones(kc.THREADS, dtype=bool)
                    sh = di * tileC + dj
                idx = gbase[:, None] + dq[None, :] - sh      # (thread, q)
                assert ((idx[valid] >= 0) & (idx[valid] < pitch)).all()
                idxc = np.clip(idx, 0, pitch - 1)
                for u in range(OC4):
                    gv = Gs[u][idxc]                          # (t, q, 4)
                    # thread lane tn & (CC - 1)'s float4 of entry (tap, kk,
                    # u): inside the staged slices for every lane
                    widx = ((tap * K1 + np.arange(K1)[:, None]) * OC4 + u) \
                        * CC + (tn & (CC - 1))[None, :]       # (K1, t)
                    assert (widx < T * E).all()
                    wv = Wflat[widx]                          # (K1, t, 4)
                    wv = np.where((tn < CC)[None, :, None], wv, 0.0)
                    acc += np.where(valid[:, None, None],
                                    np.einsum("tqo,kto->tqk", gv, wv), 0.0)
        # the writes
        c = c0 + tn
        for q in range(kc.DX_TM):
            if skip:
                b = ig * kc.DX_GROUP + (pm & 3) + 4 * q
                i, j = pos // W, pos % W
                ok = slot < -(-B // kc.DX_GROUP) * P
            else:
                m = pm + kc.DX_SLOTS * q
                nbq = m >> (lw + lth)
                b = b0 + nbq
                i = i0 + ((m >> lw) & (cfg["TH"] - 1))
                j = m & (Wv - 1)
                ok = (nbq < cfg["planes"]) & (i - i0 < tileR - (k - 1))
            ok = ok & (tn < CC) & (c < C) & (b < B) & (i < H) & (j < W)
            t = np.nonzero(ok)[0]
            assert not np.isnan(acc[t, q]).any()
            for kk in range(K1):
                dE[b[t], i[t], j[t], kk * C + c[t]] = acc[t, q, kk]
            np.add.at(written, (b[t], i[t], j[t], c[t]), 1)
    return dE, written


@pytest.mark.parametrize("B,H,W,C,O,k,pad", [
    (2, H, H, C, O, 3, 1) for H, C, O in VGG16_SMALL[1:]] + [
    (37, 4, 4, 16, 32, 3, 1),   # B % 32: a skip group of 5 images
    (41, 3, 3, 6, 8, 3, 1),     # 3x3 skip tiles: a block spans two groups
    (3, 9, 9, 13, 5, 3, 1),     # odd H, idle rows and columns, C % 8, O % 4
    (5, 8, 8, 8, 48, 3, 1),     # O = 48: six chunks; B % NB
    (2, 6, 5, 6, 16, 5, 2),     # kernel 5, pad 2, non-square, OC = 4
    (3, 6, 6, 8, 12, 3, 0),     # no pad: Ho < H
    (1, 40, 40, 4, 8, 3, 1),    # Wv = 64: four rows per block, row tiles
])
def test_dx_kernel_index_mapping_emulation(B, H, W, C, O, k, pad):
    """The data-gradient kernel's tiling, emulated in float64, writes every
    interior dx element exactly once and agrees with the plain version to
    1e-12."""
    rng = np.random.RandomState(B * 100 + H * 10 + C)
    x = rng.uniform(-2.5, 2.5, (B, H, W, C))
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    g = rng.normal(0, 1, (B, Ho, Wo, O))
    w_all = rng.normal(0, 0.2, (9 * C, k * k * O))
    cfg = kc.dx_launch_config(B, H, W, C, O, k, pad, R)
    dE, written = _emulate_dx(x, w_all, g, k, pad, cfg)
    assert (written == 1).all() and not np.isnan(dE).any()
    xt = torch.from_numpy(x).requires_grad_(True)
    E = kc.expand(xt, BASIS)
    got = torch.autograd.grad(E, xt, torch.from_numpy(dE))[0].numpy()
    want = kc.input_grad_reference(
        torch.from_numpy(x), torch.from_numpy(w_all), torch.from_numpy(g),
        BASIS, k, pad).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)


@pytest.mark.parametrize("B,H,W,C,O,k,pad,table", [
    (1, 9, 9, 1, 1, 37, 18, None),    # kernel 37: 32 pixel slots
    (1, 14, 14, 1, 1, 37, 18, None),  # ... 64 slots, no table of g offsets
    (3, 9, 9, 13, 5, 3, 1, 0),        # dense without the table
    (41, 3, 3, 6, 8, 3, 1, 0),        # skip without the table
])
def test_dx_kernel_index_mapping_emulation_fallback_tiles(B, H, W, C, O, k,
                                                          pad, table):
    """The same for the fallbacks of large kernels: fewer pixel slots
    (idle pixels) and no table of g offsets (each staging thread counts
    its own), as the tile rule picks them or forced on a small shape."""
    cfg = kc.dx_launch_config(B, H, W, C, O, k, pad, R)
    if table is not None:
        cfg["table"] = table
    elif k == 37:
        Wv = 1 << (W - 1).bit_length()
        assert (cfg["NB"] * cfg["TH"] * Wv, cfg["table"]) == \
            ((32, 1) if H == 9 else (64, 0))
    rng = np.random.RandomState(B * 100 + H * 10 + C)
    x = rng.uniform(-2.5, 2.5, (B, H, W, C))
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    g = rng.normal(0, 1, (B, Ho, Wo, O))
    w_all = rng.normal(0, 0.2, (9 * C, k * k * O))
    dE, written = _emulate_dx(x, w_all, g, k, pad, cfg)
    assert (written == 1).all() and not np.isnan(dE).any()
    xt = torch.from_numpy(x).requires_grad_(True)
    E = kc.expand(xt, BASIS)
    got = torch.autograd.grad(E, xt, torch.from_numpy(dE))[0].numpy()
    want = kc.input_grad_reference(
        torch.from_numpy(x), torch.from_numpy(w_all), torch.from_numpy(g),
        BASIS, k, pad).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
