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
    y = kc.kan_conv2d(*leaves, KNOTS, 3, 3, 1, act)
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
    y = kc._conv_w_all(kc.expand(xl, KNOTS, 3, "silu"), wl, 3, 1)
    want_dx, want_dw = torch.autograd.grad(y, (xl, wl), gt)
    dx = kc.input_grad(xt, w_all, gt, KNOTS, 3, 3, 1, "silu")
    dw = kc.weight_grad(xt, gt, KNOTS, 3, 3, 1, "silu")
    torch.testing.assert_close(dx, want_dx, rtol=1e-12, atol=1e-12)
    torch.testing.assert_close(dw, want_dw, rtol=1e-12, atol=1e-12)
    partial = kc.weight_partials(xt, gt, KNOTS, 3, 3, 1, "silu")
    cfg = kc.dw_launch_config(5, 4, 4, 6, 8, 3, 1, K)
    assert partial.shape == (cfg["S"], 9 * 6, 9 * 8) and cfg["S"] == 5
    torch.testing.assert_close(kc.reduce_partials(partial), want_dw,
                               rtol=1e-12, atol=1e-12)


def test_cpu_tensors_never_launch_backward_kernels():
    kc.reset_launches()
    _port_grads(*_inputs(1, 4, 3, 4, seed=0))
    assert sum(kc.launches.values()) == 0


def test_backward_launch_configs_tile_vgg16_small():
    """Every VGG16_small conv shape gets data- and weight-gradient tiles
    that fit: the weight gradient's rows are whole channels (no padded
    row), its column tiles cut 9*O exactly (no padded column), at most
    DW_THREADS threads in whole warps, shared memory for two blocks per
    SM, at least two blocks per SM at batch 1024, and a split count that
    depends on the shape only."""
    for H, C, O in VGG16_SMALL:
        for B in (1, 16, 64, 1024):
            dx = kc.dx_launch_config(B, H, H, C, O, 3, 1, K)
            assert dx["NB"] * dx["TH"] * H <= kc.DX_PIXELS
            assert dx["CC"] == min(C, kc.DX_MAX_CC) and dx["OC"] % 4 == 0
            dw = kc.dw_launch_config(B, H, H, C, O, 3, 1, K)
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
            assert dw == kc.dw_launch_config(B, H, H, C, O, 3, 1, K)
    # the first conv: 3 channels x 18 column groups, four pixel slices
    first = kc.dw_launch_config(1024, 32, 32, 3, 16, 3, 1, K)
    assert (first["CC"], first["BN"], first["PW"]) == (3, 144, 4)
    with pytest.raises(NotImplementedError):
        kc.dx_launch_config(1, 4, 4096, 3, 16, 3, 1, K)   # row too wide


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
        cfg = kc.dw_launch_config(B, 8, 8, C, O, k, k // 2, KK)
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
        kc.input_grad(x, w_all, g[:, :2], KNOTS, 3, 3, 1, "silu")
    with pytest.raises(TypeError):           # dtype differs from x
        kc.weight_grad(x, g.double(), KNOTS, 3, 3, 1, "silu")


def _recurrence_f32(x, knots, order, span_only):
    """float32 emulation of the CUDA basis loops (every operation rounded
    to float32 as __fsub_rn/__fdiv_rn/__fmul_rn/__fadd_rn do): the full
    Cox-de Boor recurrence (every basis at every level), or the
    span-limited one of csrc/kan_bspline.cuh (bspline_span, which the
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
    E = kc.expand(torch.from_numpy(x), KNOTS, 3, "silu").numpy()
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
    cfg = kc.dw_launch_config(B, H, W, C, O, k, pad, K)
    got, written = _emulate_dw(x, g, k, pad, cfg)
    want = kc.weight_partials_reference(
        torch.from_numpy(x), torch.from_numpy(g), KNOTS, 3, k, pad, "silu",
        cfg["S"], cfg["ips"]).numpy()
    assert (written == 1).all()
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-12)
