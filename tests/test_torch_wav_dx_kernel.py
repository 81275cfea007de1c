"""CPU replay of the WavKAN data-gradient kernel's index mapping
(``wav_conv2d_bwd_dx_kernel`` in convkan_tpu_torch/csrc/wav_conv2d_bwd.cu)
and of its launch configuration (``dx_launch_config``).

The card is needed to run the kernel; its arithmetic on indices is not.
``DxKernel`` below repeats, step for step, the block and lane mapping, the
staging of each chunk into its buffer (the g rect's row walk, the weights'
and factors' pairs), the tile's row mask and the taps each variant issues,
and the tests hold what it produces against the function's definition:

* every shared-memory read of a thread lies in a float that the chunk it
  computes staged, in the buffer it reads, with the g, weight or factor its
  tap needs (zero-filled where g lies off the frame, which only the
  generic tile reads: the compiled widths issue exactly the taps whose g
  lies on the frame); idle lanes read nothing and no read passes the
  chunk's last output channel;
* the staging writes stay inside the block's shared memory, which the
  launch configuration's ``smem`` counts;
* every dx element is written by exactly one thread;
* the kernel's order of sums, replayed in float64, gives
  ``input_grad_reference``;
* every shape the previous launch configuration took still gets one.

Change the kernel's tiling and this file together.  Pure numpy and torch:
no JAX, no card.
"""

import itertools
import math

import numpy as np
import pytest
import torch

from convkan_tpu_torch.kernels import wav_conv2d as wc

torch.set_num_threads(1)

K = 3
OCH = wc.DX_OCH
GROUP = wc.DX_GROUP
MEX_C = 2.0 / (math.sqrt(3.0) * math.pi ** 0.25)
# (B, H, W, C, O, pad): the compiled widths 8, 4 and 2 (H = 8, 6, 5, 4, 2),
# the generic width (32, 16 at pad 1; 5, 7, 11), C not a multiple of 4
# (3, 5, 13), H = 1, pads 0 and 2, O not a multiple of the chunk or of 4
SHAPES = [(3, 8, 8, 32, 20, 1), (2, 8, 8, 16, 9, 1), (5, 4, 4, 64, 16, 1),
          (6, 6, 4, 3, 8, 1), (4, 5, 4, 16, 9, 1), (17, 2, 2, 24, 12, 1),
          (5, 6, 2, 8, 9, 1),
          (2, 32, 32, 16, 8, 1), (2, 16, 16, 32, 12, 1), (3, 7, 5, 13, 5, 1),
          (5, 5, 7, 5, 16, 1), (9, 1, 8, 6, 11, 1), (3, 4, 4, 5, 16, 0),
          (2, 3, 5, 4, 12, 2), (3, 5, 11, 12, 13, 0)]
VGG16_SMALL = [(32, 16, 16), (16, 16, 32), (16, 32, 32), (8, 32, 64),
               (8, 64, 64), (4, 64, 128), (4, 128, 128), (2, 128, 128)]


class DxKernel:
    """The kernel's index arithmetic for one shape and launch config, in the
    CUDA source's names (C entry, then the kernel)."""

    def __init__(self, B, H, W, C, O, pad, cfg):
        self.B, self.H, self.W, self.C, self.O, self.pad = B, H, W, C, O, pad
        self.Ho, self.Wo = H + 2 * pad - K + 1, W + 2 * pad - K + 1
        self.WT, self.CG, self.NPB = cfg["WT"], cfg["CG"], cfg["NPB"]
        self.P = self.WT or 8
        self.RT = 2 if self.WT == 2 else 1
        assert (self.P, self.RT) == (cfg["P"], cfg["RT"])
        self.lCG = self.CG.bit_length() - 1
        self.lNPB = self.NPB.bit_length() - 1
        self.CTILE = 4 * self.CG
        self.NGC = self.P + K - 1
        self.nSeg = -(-W // self.P)
        self.nRG = -(-H // self.RT)
        self.nRB = -(-self.nRG // self.NPB)
        self.NIB = (32 // self.CG) * (4 // self.NPB)
        self.NGR = self.NPB * self.RT + K - 1
        self.imgStride = self.NGR * self.NGC * OCH + 4
        self.gBuf = self.NIB * self.imgStride
        self.wStride = self.CG * GROUP
        self.bufStride = self.gBuf + OCH * self.wStride
        self.nCh = -(-O // OCH)
        self.nbuf = 2 if self.nCh > 1 else 1
        self.gVec = O % 4 == 0
        self.grid = (-(-B // self.NIB) * self.nSeg * self.nRB,
                     -(-C // self.CTILE))
        self.np = self.CG >> 2
        assert cfg["NIB"] == self.NIB and cfg["NGR"] == self.NGR
        assert cfg["img_stride"] == self.imgStride
        assert tuple(cfg["grid"]) == self.grid

    def thread(self, bx, by, tid):
        warp, lane = tid >> 5, tid & 31
        cg = lane & (self.CG - 1)
        pw = warp & (self.NPB - 1)
        i = ((warp >> self.lNPB) << (5 - self.lCG)) + (lane >> self.lCG)
        rb = bx % self.nRB
        seg = (bx // self.nRB) % self.nSeg
        ib = bx // self.nRB // self.nSeg
        b = ib * self.NIB + i
        rg = rb * self.NPB + pw
        h0, w0 = rg * self.RT, seg * self.P
        c0 = by * self.CTILE + 4 * cg
        vm = sum(1 << a for a in range(self.RT + K - 1)
                 if 0 <= h0 - 1 + a < self.Ho)
        return {"warp": warp, "cg": cg, "pw": pw, "i": i, "ib": ib, "b": b,
                "rg": rg, "h0": h0, "w0": w0, "c0": c0, "vm": vm,
                "active": b < self.B and rg < self.nRG and c0 < self.C,
                "ohR": rb * self.NPB * self.RT + self.pad - (K - 1),
                "ow0": w0 + self.pad - (K - 1),
                "gOff": i * self.imgStride + pw * self.RT * self.NGC * OCH,
                "wOff": self.gBuf + cg * GROUP}

    def stage(self, bx, by, k):
        """{buffer-relative float: source} a chunk's staging writes: ("g",
        b, oh, ow, o), ("w", tap, c, o), ("iv" | "nt" | "kv", o, c), or None
        (zero-filled).  Asserts each float is written once."""
        oc0 = k * OCH
        out = {}

        def put(d, src):
            assert d not in out, f"float {d} written twice"
            assert 0 <= d < self.bufStride
            out[d] = src

        t0 = self.thread(bx, by, 0)
        ib, ohR, ow0 = t0["ib"], t0["ohR"], t0["ow0"]
        for warp in range(wc.DX_THREADS // 32):
            i2, gr = 0, warp
            while gr >= self.NGR:
                gr, i2 = gr - self.NGR, i2 + 1
            while i2 < self.NIB:
                b2, oh = ib * self.NIB + i2, ohR + gr
                row_ok = b2 < self.B and 0 <= oh < self.Ho
                dst = i2 * self.imgStride + gr * self.NGC * OCH
                if self.gVec:
                    for e in range(self.NGC * OCH // 4):
                        col, q = e >> 1, e & 1
                        ow = ow0 + col
                        ok = row_ok and 0 <= ow < self.Wo and \
                            oc0 + 4 * q < self.O
                        assert (dst + 4 * e) % 4 == 0   # 16-byte aligned
                        for f in range(4):
                            put(dst + 4 * e + f, ("g", b2, oh, ow,
                                                  oc0 + 4 * q + f)
                                if ok else None)
                else:
                    for e in range(self.NGC * OCH):
                        col, q = e >> 3, e & (OCH - 1)
                        ow = ow0 + col
                        ok = row_ok and 0 <= ow < self.Wo and oc0 + q < self.O
                        put(dst + e, ("g", b2, oh, ow, oc0 + q) if ok
                            else None)
                gr += wc.DX_THREADS // 32
                while gr >= self.NGR:
                    gr, i2 = gr - self.NGR, i2 + 1
        for tid in range(wc.DX_THREADS):
            for q in range(self.np):
                e = tid + q * wc.DX_THREADS
                cl = e >> 3
                o, c = oc0 + (e & (OCH - 1)), by * self.CTILE + cl
                off = self.gBuf + (e & (OCH - 1)) * self.wStride + \
                    (cl >> 2) * GROUP + (cl & 3)
                ok = c < self.C and o < self.O
                for tap in range(K * K):
                    put(off + 4 * tap, ("w", tap, c, o) if ok else None)
                for n, name in enumerate(("iv", "nt", "kv")):
                    put(off + 4 * K * K + 4 * n, (name, o, c) if ok else None)
        return out

    def taps(self, vm, EL, ER):
        """(rho, j, r, e, a, sc) of every tap a tile issues, in its order:
        rect column sc loads rows a of vm (the halo columns if EL / ER);
        pixel j = sc - 2 of tile row rho then sums r, e."""
        out = []
        NGC = self.NGC
        for sc in range(NGC):
            if sc < K - 1:
                continue
            j = sc - (K - 1)
            for rho in range(self.RT):
                for r in range(K):
                    if not (vm >> (rho + r)) & 1:
                        continue
                    for e in range(K):
                        if (j + e == 0 and not EL) or \
                                (j + e == NGC - 1 and not ER):
                            continue
                        out.append((rho, j, r, e, rho + r, j + e))
        return out

    def variant(self, th):
        if self.WT == 0:
            return (1 << (self.RT + K - 1)) - 1, True, True
        return th["vm"], False, False


def _config(B, H, W, C, O, pad):
    return wc.dx_launch_config(B, H, W, C, O, K, pad)


def _inputs(B, H, W, C, O, pad, seed):
    rng = np.random.RandomState(seed)
    Ho, Wo = H + 2 * pad - K + 1, W + 2 * pad - K + 1
    return (rng.normal(0, 1, (B, H, W, C)), rng.normal(0, 0.3, (K, K, C, O)),
            0.5 * rng.randn(O, C), 1.0 + 0.3 * rng.rand(O, C),
            rng.normal(0, 1, (B, Ho, Wo, O)))


def _replay(B, H, W, C, O, pad, arrays=None):
    """Walks every block, chunk and active thread as the kernel does,
    checking each read against the staged buffers; with ``arrays`` also
    sums dx in the kernel's order in float64 (psi = mexican_hat)."""
    cfg = _config(B, H, W, C, O, pad)
    kp = DxKernel(B, H, W, C, O, pad, cfg)
    assert 4 * kp.nbuf * kp.bufStride == cfg["smem"] <= wc.BLOCK_SMEM_MAX
    written = {}
    dx = None
    if arrays is not None:
        x, w, t, s, g = arrays
        dx = np.full((B, H, W, C), np.nan)
    for bx, by in itertools.product(range(kp.grid[0]), range(kp.grid[1])):
        threads = [kp.thread(bx, by, tid) for tid in range(wc.DX_THREADS)]
        bufs = [None] * kp.nbuf
        bufs[0] = (0, kp.stage(bx, by, 0))
        accs = {tid: np.zeros((kp.RT, kp.P, 4)) for tid, th
                in enumerate(threads) if th["active"]}
        for k in range(kp.nCh):
            if k + 1 < kp.nCh:
                staged_next = (k + 1, kp.stage(bx, by, k + 1))
            chunk, content = bufs[k & 1]
            assert chunk == k, "the buffer holds another chunk"
            no = min(OCH, O - k * OCH)
            for tid, th in enumerate(threads):
                if not th["active"]:
                    continue
                vm, EL, ER = kp.variant(th)
                taps = kp.taps(vm, EL, ER)
                c0, h0, w0, b = th["c0"], th["h0"], th["w0"], th["b"]
                for oo in range(no):
                    o = k * OCH + oo
                    wbase = th["wOff"] + oo * kp.wStride
                    for ch in range(4):
                        c = c0 + ch
                        for tap in range(K * K):
                            want = ("w", tap, c, o) if c < C else None
                            assert content[wbase + 4 * tap + ch] == want
                        for n, name in enumerate(("iv", "nt", "kv")):
                            want = (name, o, c) if c < C else None
                            assert content[wbase + 36 + 4 * n + ch] == want
                    for rho, j, r, e, a, sc in taps:
                        src = content[th["gOff"] + (a * kp.NGC + sc) * OCH
                                      + oo]
                        oh = h0 + rho + pad - (K - 1) + r
                        ow = w0 + j + pad - (K - 1) + e
                        on = 0 <= oh < kp.Ho and 0 <= ow < kp.Wo
                        if on:
                            assert src == ("g", b, oh, ow, o), \
                                "g read from the wrong float"
                        else:
                            assert src is None, "off-frame g not zero"
                            assert kp.WT == 0, "compiled tile issues a pad tap"
                    if arrays is None:
                        continue
                    # the sums of this o, in the kernel's order
                    cs = [min(c0 + ch, C - 1) for ch in range(4)]
                    iv = 1.0 / s[o, cs]
                    nt, kv = -t[o, cs] * iv, MEX_C * iv
                    acc = accs[tid]
                    G = np.zeros((kp.RT, kp.P, 4))
                    for rho, j, r, e, a, sc in taps:
                        oh = h0 + rho + pad - (K - 1) + r
                        ow = w0 + j + pad - (K - 1) + e
                        gv = g[b, oh, ow, o] if (0 <= oh < kp.Ho and
                                                 0 <= ow < kp.Wo) else 0.0
                        G[rho, j] = gv * w[K - 1 - r, K - 1 - e, cs, o] + \
                            G[rho, j]
                    for rho, j in itertools.product(range(kp.RT),
                                                    range(kp.P)):
                        hh, ww = min(h0 + rho, H - 1), min(w0 + j, W - 1)
                        z = x[b, hh, ww, cs] * iv + nt
                        d = kv * z * np.exp(-0.5 * z * z) * (3.0 - z * z)
                        acc[rho, j] = d * G[rho, j] + acc[rho, j]
            if k + 1 < kp.nCh:
                bufs[(k + 1) & 1] = staged_next
        for tid, th in enumerate(threads):
            if not th["active"]:
                continue
            nc = min(4, C - th["c0"])
            for rho, j in itertools.product(range(kp.RT), range(kp.P)):
                h, ww = th["h0"] + rho, th["w0"] + j
                if h >= H or ww >= W:
                    continue
                for ch in range(nc):
                    key = (th["b"], h, ww, th["c0"] + ch)
                    assert key not in written, f"dx {key} written twice"
                    written[key] = (bx, by, tid)
                    if dx is not None:
                        dx[key] = accs[tid][rho, j, ch]
    assert sorted(written) == list(itertools.product(
        range(B), range(H), range(W), range(C))), "dx not covered"
    return cfg, kp, dx


@pytest.mark.parametrize("B,H,W,C,O,pad", SHAPES)
def test_dx_kernel_index_mapping_and_sum_order_f64(B, H, W, C, O, pad):
    """Reads, writes and coverage as the module docstring says, and the
    kernel's sums (per thread: chunks in order, each chunk's o in order,
    each pixel's G over r then e) replayed in float64 with psi =
    mexican_hat match ``input_grad_reference`` to rounding."""
    arrays = _inputs(B, H, W, C, O, pad, seed=B * 100 + H * 10 + C)
    _, _, dx = _replay(B, H, W, C, O, pad, arrays)
    want = wc.input_grad_reference(
        *(torch.from_numpy(a) for a in arrays), "mexican_hat", pad).numpy()
    np.testing.assert_allclose(dx, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("H,C,O", VGG16_SMALL)
def test_dx_launch_at_vgg16_small(H, C, O):
    """At batch 1024 each VGG16_small shape gets whole warps of 4-channel
    groups, a compiled width on the 8x8, 4x4 and 2x2 planes (the generic
    segment of 8 on the others), 3 blocks per SM within shared memory and
    registers, and a grid that puts blocks on every SM; the compiled tiles
    issue exactly the interior taps."""
    cfg = _config(1024, H, H, C, O, 1)
    kp = DxKernel(1024, H, H, C, O, 1, cfg)
    assert cfg["threads"] == wc.DX_THREADS and cfg["threads"] % 32 == 0
    assert 32 % cfg["CG"] == 0 and C % cfg["CT"] == 0
    assert cfg["compiled"] == (H in wc.DX_WIDTHS) and cfg["WT"] == (
        H if H in wc.DX_WIDTHS else 0)
    assert cfg["P"] == min(8, H) if cfg["compiled"] else cfg["P"] == 8
    assert cfg["RT"] == (2 if H == 2 else 1)
    assert cfg["smem"] <= wc.SM_SMEM // 3 - 1024
    assert cfg["blocks_per_sm"] == 3 == wc.SM_REGS // (
        cfg["threads"] * wc.DX_REGS)
    assert cfg["blocks"] >= wc.SMS
    # every lane of every block owns 4 channels of a tile at this batch
    th = [kp.thread(bx, 0, tid) for bx in (0, kp.grid[0] - 1)
          for tid in range(wc.DX_THREADS)]
    assert all(t["active"] for t in th)
    issued = interior = 0
    for h0 in range(0, H, kp.RT):
        vm, EL, ER = kp.variant({"vm": sum(
            1 << a for a in range(kp.RT + 2) if 0 <= h0 - 1 + a < H)})
        for w0 in range(0, H, kp.P):
            issued += len(kp.taps(vm, EL, ER))
    interior = sum(1 for i, j, di, dj in itertools.product(
        range(H), range(H), range(K), range(K))
        if 0 <= i + 1 - di < H and 0 <= j + 1 - dj < H)
    if cfg["compiled"]:
        assert issued == interior
    else:
        assert issued == 9 * H * H


def _parent_dx_config(B, H, W, C, O, k, pad):
    """The launch configuration this kernel's tiling replaced: strips of TW
    pixels x CL lanes, OCH output channels within 96 KB; None where it
    raised."""
    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p
    TW = 2 if W <= 2 else 4 if W <= 4 else 8
    CL = min(32, pow2(C))
    NS = 256 // CL
    for OCH in range(min(O, 32), 0, -1):
        if 4 * (NS * (OCH * k * (TW + k - 1) + 1) + OCH * k * k * CL
                + 2 * OCH * CL) <= 96 * 1024:
            return OCH
    return None


def test_dx_config_covers_every_shape_the_parent_took():
    """Every shape on a grid (widths and heights past the VGG planes,
    C and O from 1 to past a chunk or a block's channels, pads 0-3) that
    the previous configuration accepted gets a launch whose buffers fit
    the block's shared memory and whose grid covers every image, row,
    segment and channel."""
    taken = 0
    for H, W, C, O, pad in itertools.product(
            (1, 2, 3, 4, 7, 8), (1, 2, 3, 4, 5, 8, 9, 16, 32, 100, 3000),
            (1, 3, 5, 13, 16, 17, 64, 300), (1, 5, 8, 33, 128),
            (0, 1, 2, 3)):
        B = 5
        if H + 2 * pad - K + 1 <= 0 or W + 2 * pad - K + 1 <= 0:
            continue
        if _parent_dx_config(B, H, W, C, O, K, pad) is None:
            continue
        taken += 1
        cfg = _config(B, H, W, C, O, pad)
        kp = DxKernel(B, H, W, C, O, pad, cfg)
        assert cfg["smem"] == 4 * kp.nbuf * kp.bufStride <= \
            wc.BLOCK_SMEM_MAX
        assert kp.grid[0] * kp.NIB >= B * kp.nSeg * kp.nRB
        assert kp.nSeg * kp.P >= W and kp.nRB * kp.NPB * kp.RT >= H
        assert kp.grid[1] * kp.CTILE >= C
        if cfg["compiled"]:
            assert pad == 1 and W in wc.DX_WIDTHS
    assert taken > 1000
