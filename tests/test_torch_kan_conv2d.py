"""Port parity for the KAN-conv kernel module
(convkan_tpu_torch/kernels/kan_conv2d.py).

On this CPU host the wrapper runs the kernel's plain PyTorch version; it is
held against BOTH TPU forward kernels it replaces, run in Pallas interpret
mode as tests/test_pallas_kernels.py runs them: the wide kernel
(make_wide_kan_conv_op) and the per-tap kernel (fused_kan_conv2d).  Float32
(the Pallas out_shape is float32); atol = rtol = 1e-5 covers the different
summation order.  The CUDA kernel itself is checked on the card by
chip_smoke.py and tests/test_torch_cuda.py.
"""

import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from convkan_tpu.basis.bspline import bspline_basis_unrolled_list
from convkan_tpu.kernels.fused_kan_conv import fused_kan_conv2d
from convkan_tpu.kernels.wide_kan_conv import make_wide_kan_conv_op
from convkan_tpu.utils.activations import silu as jax_silu
from convkan_tpu_torch.basis.bspline import make_bspline_grid
from convkan_tpu_torch.kernels import kan_conv2d as kc

torch.set_num_threads(1)

KNOTS = tuple(float(v) for v in make_bspline_grid(5, 3))
K = 8
BASIS = kc.bspline_basis(KNOTS, 3, "silu")
R = K + 1       # rows of E per channel: the K bases and act(x)


def _inputs(B, H, C, O, seed=0, scale=2.5):
    rng = np.random.RandomState(seed)
    x = rng.uniform(-scale, scale, (B, H, H, C)).astype(np.float32)
    x.reshape(-1)[:len(KNOTS)] = KNOTS  # exact knot values occur
    bw = rng.normal(0, 0.2, (3, 3, C, O)).astype(np.float32)
    pw = rng.normal(0, 0.2, (3, 3, C * K, O)).astype(np.float32)
    return x, bw, pw


def _port(x, bw, pw, act="silu"):
    return kc.kan_conv2d(torch.from_numpy(x), torch.from_numpy(bw),
                         torch.from_numpy(pw), kc.bspline_basis(KNOTS, 3, act),
                         3, 1).numpy()


def _basis_fn(xt):
    return bspline_basis_unrolled_list(xt, KNOTS, 3)


@pytest.mark.parametrize("tpu_kernel", ["wide", "fused"])
@pytest.mark.parametrize("C,O", [(3, 8), (3, 16), (16, 8), (16, 16)])
def test_plain_kernel_matches_tpu_kernels(tpu_kernel, C, O):
    x, bw, pw = _inputs(2, 8, C, O, seed=C * 100 + O)
    xj, bwj, pwj = jnp.asarray(x), jnp.asarray(bw), jnp.asarray(pw)
    if tpu_kernel == "wide":
        op = make_wide_kan_conv_op(
            basis_list_fn=_basis_fn, num_basis=K, base_act=jax_silu,
            kernel_size=3, padding=1, degree_major=False, has_base=True,
            interpret=True)
        want = np.asarray(op(xj, bwj, pwj))
    else:
        want = np.asarray(fused_kan_conv2d(
            xj, jax_silu(xj), bwj, pwj, basis_list_fn=_basis_fn, num_basis=K,
            padding=1, kernel_size=3, interpret=True))
    got = _port(x, bw, pw)
    assert want.dtype == np.float32 and got.shape == want.shape == (2, 8, 8, O)
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_pad_is_zero_after_expansion():
    """Padding x with zeros before the expansion would add B-spline(0) != 0
    on the border; the port's pad must contribute nothing."""
    x, bw, pw = _inputs(1, 4, 3, 4, seed=7)
    y = _port(x, bw, pw)
    xt = torch.from_numpy(x)
    wrong = kc.kan_conv2d_reference(
        torch.nn.functional.pad(xt, (0, 0, 1, 1, 1, 1)), torch.from_numpy(bw),
        torch.from_numpy(pw), BASIS, 3, 0).numpy()
    assert np.abs(y - wrong)[:, 0].max() > 1e-3   # border rows differ
    np.testing.assert_allclose(y[:, 1:-1, 1:-1], wrong[:, 1:-1, 1:-1],
                               atol=1e-5, rtol=1e-5)


def test_pack_w_all_matches_jax():
    from convkan_tpu.kernels.wide_kan_conv import pack_w_all as jax_pack

    _, bw, pw = _inputs(1, 4, 5, 6, seed=3)
    want = np.asarray(jax_pack(jnp.asarray(bw), jnp.asarray(pw), C=5, K=K,
                               k=3, O=6, degree_major=False))
    got = kc.pack_w_all(torch.from_numpy(bw), torch.from_numpy(pw), C=5, K=K,
                        k=3, O=6).numpy()
    np.testing.assert_array_equal(got, want)


def test_cpu_tensors_never_touch_the_kernel():
    kc.reset_launches()
    x, bw, pw = _inputs(1, 4, 3, 4)
    _port(x, bw, pw)
    assert sum(kc.launches.values()) == 0


def _args(x, bw, pw):
    return (torch.from_numpy(x), torch.from_numpy(bw), torch.from_numpy(pw),
            BASIS, 3, 1)


def test_wrapper_refuses_bad_inputs():
    x, bw, pw = _inputs(1, 4, 3, 4)
    xt, bwt, pwt = torch.from_numpy(x), torch.from_numpy(bw), \
        torch.from_numpy(pw)
    call = lambda *a: kc.kan_conv2d(*a, BASIS, 3, 1)  # noqa: E731
    with pytest.raises(TypeError):            # half: neither float32 nor float64
        call(xt.half(), bwt.half(), pwt.half())
    with pytest.raises(TypeError):            # mixed dtypes
        call(xt.double(), bwt, pwt)
    with pytest.raises(ValueError):           # non-contiguous
        call(xt.transpose(1, 2), bwt, pwt)
    with pytest.raises(ValueError):           # wrong weight shape
        call(xt, bwt[:, :, :2], pwt)
    with pytest.raises(ValueError):           # not NHWC
        call(xt[0], bwt, pwt)
    # the kernel route (what a CUDA tensor takes) accepts float32 only
    with pytest.raises(TypeError):
        kc.check_inputs(*_args(x.astype(np.float64), bw.astype(np.float64),
                               pw.astype(np.float64)), for_kernel=True)
    with pytest.raises(ValueError):           # CPU tensors are not CUDA
        kc.check_inputs(*_args(x, bw, pw), for_kernel=True)


VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]


def test_launch_config_tiles_vgg16_small():
    """Every VGG16_small conv shape gets a tile that fits two blocks per SM,
    a register tile of 8 pixels x 8 channels (8 x 4 at O = 16), one column
    tile (the basis expanded once per input tile), pad taps skipped on the
    4x4 and 2x2 layers, and at batch 1024 at least two blocks per SM."""
    for H, C, O in VGG16_SMALL:
        for B in (1, 8, 64, 1024):
            cfg = kc.launch_config(B, H, H, C, O, 3, 1, R)
            TN, _, BM, _ = kc.thread_tile(cfg["BN"])
            assert cfg["BN"] == O and kc.TM == 8 and TN == (4 if O == 16
                                                          else 8)
            assert kc.TM * TN / (kc.TM + TN) >= (8 / 3 if O == 16 else 4)
            assert cfg["skip"] == (H * H <= 16)
            if not cfg["skip"]:
                assert cfg["NB"] * cfg["TH"] * cfg["TW"] <= BM
                assert (cfg["TH"], cfg["TW"]) == (H, H) or cfg["NB"] == 1
            assert cfg["smem"] <= kc.SMEM_TWO_BLOCKS
            assert 1 <= cfg["S"] <= kc.MAX_SPLITS
            assert cfg["S"] & (cfg["S"] - 1) == 0          # a power of two
            assert cfg["S"] <= -(-C // cfg["CC"])          # no empty split
            assert cfg["blocks"] == cfg["tiles"] * cfg["S"]
            if B == 1024:
                assert cfg["blocks"] >= 2 * 132
            assert cfg["S"] == 1 or cfg["blocks"] <= kc.TARGET_BLOCKS
    with pytest.raises(NotImplementedError):     # no tile fits at all
        kc.launch_config(1, 8, 8, 3, 16, 71, 35, R)


def _parent_accepts(B, H, W, C, O, k, pad, K):
    """The previous forward tile's predicate, written out: BN = O rounded
    up to a power of two in 4..64, M = 256 / (BN/4) * 4 pixels per block,
    whole output rows, and a tile (with its pad frame) that fits."""
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    BN = 4
    while BN < min(O, 64):
        BN *= 2
    M = 256 // (BN // 4) * 4
    if Wo > M:
        return False
    if Ho * Wo >= M:
        TH, NB = min(Ho, M // Wo), 1
    else:
        TH, NB = Ho, min(B, M // (Ho * Wo))
    tile = NB * (TH + k - 1) * (W + 2 * pad)
    return any(4 * kc.row_stride(K + 1, CC) * (tile + 2 * BN + 2) <= 227 * 1024
               for CC in range(min(C, 8), 0, -1))


def test_launch_config_accepts_every_shape_the_parent_did():
    """Coverage never shrinks: every shape the previous tile accepted still
    gets a tile (and more: rows wider than a block are cut into column
    tiles), and every tile is one the C entry takes."""
    accepted = 0
    for B, H, W, C, O, k, pad in itertools.product(
            (1, 5, 1024), (1, 2, 3, 4, 9, 40), (1, 3, 16, 130, 700, 1100),
            (1, 3, 13, 128), (1, 5, 16, 48, 64, 100, 256), (1, 3, 5),
            (0, 1, 2)):
        Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
        if Ho <= 0 or Wo <= 0:
            continue
        try:
            cfg = kc.launch_config(B, H, W, C, O, k, pad, R)
        except NotImplementedError:
            assert not _parent_accepts(B, H, W, C, O, k, pad, K)
            continue
        accepted += 1
        TN, _, BM, G = kc.thread_tile(cfg["BN"])
        assert cfg["smem"] <= kc.SMEM_LIMIT and 1 <= cfg["CC"] <= 8
        assert cfg["S"] <= min(kc.MAX_SPLITS, -(-C // cfg["CC"]))
        if cfg["skip"]:
            assert Ho * Wo <= kc.SKIP_POSITIONS
            assert cfg["NG"] >= kc.skip_groups(Ho * Wo, -(-B // G))
        else:
            assert cfg["NB"] * cfg["TH"] * cfg["TW"] <= BM
    assert accepted > 1000


# ------------------------------------------------- the kernel's index map
def _warp_slot(w):
    """``warp_slot``: warps w and w + 4 share an SM sub-partition, and the
    second half of the block's slots runs in reverse."""
    return np.where(w < kc.WARPS // 2, w, kc.WARPS + kc.WARPS // 2 - 1 - w)


def _decode(cfg, dims, bx, m):
    """csrc/kan_conv2d_fwd.cu ``decode`` for block bx, block-local pixels m
    (an int array): the y pixel (-1 outside the output) and the tile pixel
    that tap (0, 0) reads (dense: 0 for pixels outside the output)."""
    B, H, W, Ho, Wo, k, pad = dims
    _, _, _, G = kc.thread_tile(cfg["BN"])
    if cfg["skip"]:
        P = Ho * Wo
        w, r = m // G, m % G
        slot = bx * kc.WARPS + _warp_slot(w)
        ig, pos = slot // P, slot % P
        i, j = pos // Wo, pos % Wo
        tix = ((i - pad) * W + (j - pad)) * (cfg["NG"] * G) \
            + (ig - bx * kc.WARPS // P) * G + r
        b = ig * G + r
        ok = (ig < -(-B // G)) & (b < B)
        return np.where(ok, (b * Ho + i) * Wo + j, -1), tix
    TH, TW, NB = cfg["TH"], cfg["TW"], cfg["NB"]
    col_chunks, row_chunks = -(-Wo // TW), -(-Ho // TH)
    jc, t = bx % col_chunks, bx // col_chunks
    ic, bg = t % row_chunks, t // row_chunks
    nb, rem = m // (TH * TW), m % (TH * TW)
    ti, tj = rem // TW, rem % TW
    b, i, j = bg * NB + nb, ic * TH + ti, jc * TW + tj
    ok = (nb < NB) & (b < B) & (i < Ho) & (j < Wo)
    return (np.where(ok, (b * Ho + i) * Wo + j, -1),
            np.where(ok, (nb * (TH + k - 1) + ti) * (TW + k - 1) + tj, 0))


def _tile_pixels(cfg, dims, bx):
    """(b, h, w) of every pixel of block bx's expanded tile, as the kernel's
    fillE lays them out."""
    B, H, W, Ho, Wo, k, pad = dims
    _, _, _, G = kc.thread_tile(cfg["BN"])
    if cfg["skip"]:
        NBt = cfg["NG"] * G
        p = np.arange(NBt * H * W)
        hw = p // NBt
        return bx * kc.WARPS // (Ho * Wo) * G + p % NBt, hw // W, hw % W
    TH, TW, NB = cfg["TH"], cfg["TW"], cfg["NB"]
    tile_h, tile_w = TH + k - 1, TW + k - 1
    col_chunks, row_chunks = -(-Wo // TW), -(-Ho // TH)
    t = bx // col_chunks
    p = np.arange(NB * tile_h * tile_w)
    nb, rem = p // (tile_h * tile_w), p % (tile_h * tile_w)
    return ((t // row_chunks) * NB + nb,
            (t % row_chunks) * TH - pad + rem // tile_w,
            (bx % col_chunks) * TW - pad + rem % tile_w)


def _emulate(x, w_all, knots, k, pad, cfg):
    """The forward kernel's index mapping in float64 numpy, thread by
    thread: the tile from launch_config, the pixel order (dense, or
    (position, image) with pad taps skipped per warp), the chunk range of
    each channel split, the weight slices, and the splits' ordered sum over
    the cluster.  Returns y and how often each output was written; asserts
    that no thread reads outside its expanded tile."""
    B, H, W, C = x.shape
    O = w_all.shape[1] // (k * k)
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    dims = (B, H, W, Ho, Wo, k, pad)
    E = kc.expand(torch.from_numpy(x),
                  kc.bspline_basis(knots, 3, "silu")).numpy()
    K1 = E.shape[-1] // C
    BN, CC, S = cfg["BN"], cfg["CC"], cfg["S"]
    TN, TPW, BM, G = kc.thread_tile(BN)
    tpn, nh = BN // TN, TN // 4
    R, nch = K1 * CC, -(-C // CC)
    tid = np.arange(kc.THREADS)
    lane, warp = tid % 32, tid // 32
    tn, tmw = lane % tpn, lane // tpn
    q = np.arange(kc.TM)
    if cfg["skip"]:
        m = (warp * G + tmw)[:, None] + q[None, :] * TPW
    else:
        m = (warp * TPW + tmw)[:, None] + q[None, :] * (kc.THREADS // tpn)
    # the thread's columns: h * (BN / nh) + tn * 4 + c
    cols = (np.arange(nh)[:, None] * (BN // nh)
            + np.arange(4)[None, :]).reshape(-1)[None, :] + 4 * tn[:, None]
    y = np.zeros((B * Ho * Wo, O))
    written = np.zeros((B * Ho * Wo, O), dtype=int)
    for bx in range(cfg["tiles"]):
        out, tix = _decode(cfg, dims, bx, m)
        b, h, w = _tile_pixels(cfg, dims, bx)
        inside = (b < B) & (h >= 0) & (h < H) & (w >= 0) & (w < W)
        if cfg["skip"]:
            P = Ho * Wo
            slot = bx * kc.WARPS + _warp_slot(warp)
            warp_on = slot < -(-B // G) * P
            pi, pj = (slot % P) // Wo - pad, (slot % P) % Wo - pad
        for by in range(-(-O // BN)):
            o0 = by * BN
            parts = []
            for bz in range(S):
                acc = np.zeros((kc.THREADS, kc.TM, TN))
                for ch in range(bz * nch // S, (bz + 1) * nch // S):
                    c0 = ch * CC
                    rr = np.arange(R)
                    kk, cl = rr // CC, rr % CC
                    ok_c = c0 + cl < C
                    Es = np.zeros((len(b), R))
                    sel = inside[:, None] & ok_c[None, :]
                    pix = np.nonzero(inside)[0]
                    Es[pix] = E[b[pix], h[pix], w[pix]][
                        :, kk * C + np.minimum(c0 + cl, C - 1)]
                    Es[~sel] = 0.0
                    for tap in range(k * k):
                        di, dj = divmod(tap, k)
                        o = o0 + np.arange(BN)
                        Ws = np.zeros((R, BN))
                        rows = kk * C + c0 + cl
                        okw = ok_c[:, None] & (o < O)[None, :]
                        Ws[okw] = w_all[np.minimum(rows, K1 * C - 1)][
                            :, tap * O + np.minimum(o, O - 1)][okw]
                        if cfg["skip"]:
                            on = warp_on & (pi + di >= 0) & (pi + di < H) \
                                & (pj + dj >= 0) & (pj + dj < W)
                            off = (di * W + dj) * cfg["NG"] * G
                        else:
                            on = np.ones(kc.THREADS, bool)
                            off = di * (cfg["TW"] + k - 1) + dj
                        if not on.any():
                            continue
                        src = tix[on] + off
                        assert src.min() >= 0 and src.max() < len(b)
                        acc[on] += np.einsum("tqr,rtn->tqn", Es[src],
                                             Ws[:, cols[on]])
                parts.append(acc)
            if S == 1:
                for t in range(kc.THREADS):
                    for qq in range(kc.TM):
                        if out[t, qq] < 0:
                            continue
                        for n, col in enumerate(cols[t]):
                            if o0 + col < O:
                                y[out[t, qq], o0 + col] = parts[0][t, qq, n]
                                written[out[t, qq], o0 + col] += 1
                continue
            tiles = np.zeros((S, BM, BN))
            for z in range(S):
                tiles[z][m[:, :, None], cols[:, None, :]] = parts[z]
            total = tiles[0].copy()
            for z in range(1, S):   # rank order, as each block sums
                total += tiles[z]
            mm, cc = np.nonzero(np.ones((BM, BN), bool))
            pix_out, _ = _decode(cfg, dims, bx, mm)
            keep = (pix_out >= 0) & (o0 + cc < O)
            y[pix_out[keep], o0 + cc[keep]] = total[mm[keep], cc[keep]]
            np.add.at(written, (pix_out[keep], o0 + cc[keep]), 1)
    return y.reshape(B, Ho, Wo, O), written


@pytest.mark.parametrize("B,H,W,C,O,k,pad", [
    (37, 1, 1, 5, 16, 3, 1),      # H = 1; B < one image group (G = 64)
    (70, 2, 2, 13, 48, 3, 1),     # 2x2; B % 32, O % 64 and C % CC ragged
    (19, 3, 3, 6, 9, 3, 1),       # 9 positions: a block spans two groups
    (3, 2, 7, 3, 20, 3, 1),       # a non-square plane, skipped taps
    (5, 5, 5, 7, 130, 3, 1),      # dense; two column tiles
    (6, 8, 8, 16, 64, 3, 1),      # dense with channel splits
    (2, 3, 130, 2, 65, 3, 1),     # a row wider than a block: column tiles
    (4, 4, 4, 3, 8, 5, 2),        # kernel 5, pad 2, skipped taps
    (3, 6, 6, 2, 8, 3, 0),        # no pad: Ho < H
])
def test_kernel_index_mapping_emulation(B, H, W, C, O, k, pad):
    """The forward kernel's tiling, emulated in float64 on ragged shapes,
    writes every output exactly once and agrees with the plain version to
    1e-12."""
    rng = np.random.RandomState(B * 100 + H * 10 + C)
    x = rng.uniform(-2.5, 2.5, (B, H, W, C))
    bw = rng.normal(0, 0.2, (k, k, C, O))
    pw = rng.normal(0, 0.2, (k, k, C * K, O))
    cfg = kc.launch_config(B, H, W, C, O, k, pad, R)
    w_all = kc.pack_w_all(torch.from_numpy(bw), torch.from_numpy(pw), C=C,
                          K=K, k=k, O=O).numpy()
    got, written = _emulate(x, w_all, KNOTS, k, pad, cfg)
    want = kc.kan_conv2d_reference(
        torch.from_numpy(x), torch.from_numpy(bw), torch.from_numpy(pw),
        BASIS, k, pad).numpy()
    assert (written == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
