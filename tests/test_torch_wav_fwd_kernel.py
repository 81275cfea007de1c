"""CPU replay of the WavKAN forward kernel's index mapping
(``wav_conv2d_fwd_kernel`` in convkan_tpu_torch/csrc/wav_conv2d_fwd.cu)
and of its launch configuration (``fwd_launch_config``).

The card is needed to run the kernel; its arithmetic on indices is not.
``FwdKernel`` below repeats, step for step, the block and lane mapping
(tile slots of (strip, image), bands of rows, o tiles), the walk over
virtual rows and chunks, the staging of each chunk into its buffer (each
slot's x columns, the weights transposed to channels fastest, -t/s and
1/s; the next chunk's, into the other buffer, behind the current one's
FMAs; the weights kept, not restaged, when a row takes one chunk) and the
taps each variant issues, and the tests hold what it produces against the
function's definition:

* every shared-memory read of a thread lies in a float that the chunk it
  computes staged into the buffer it reads, with the x, weight, -t/s or
  1/s its tap needs (zero-filled past C); columns off the image are never
  read, and idle lanes read nothing;
* the staging writes stay inside the buffer the launch configuration's
  ``smem`` counts, each float written once per chunk;
* every y element is written by exactly one thread;
* psi is evaluated once per (pixel, o, channel) on the compiled widths and
  at most 1.19 / 1.125 times on the 32x32 / 16x16 strips (channels in
  whole quads: the first conv's 3 channels take a quad of 4);
* the kernel's order of sums, replayed in float64, gives
  ``psi_conv_reference``;
* every shape the previous launch configuration took still gets one;
* the psi and tap FMAs the replay issues are what ``chip_smoke.py``'s
  ``wav_fwd_issued`` models (its issue counts, rates and shares of the
  VGG16_small shapes come from that model, not from the card).

The staging layout (a slot's and an o's strides, the grid, the shared
memory) is read from the launch configuration, which owns it, as the C
entry does.  Change the kernel's tiling and this file together.  Pure
numpy and torch: no JAX, no card.
"""

import importlib.util
import itertools
import math
from pathlib import Path

import numpy as np
import pytest
import torch

from convkan_tpu_torch.kernels import wav_conv2d as wc

torch.set_num_threads(1)

_spec = importlib.util.spec_from_file_location(
    "chip_smoke", Path(__file__).resolve().parent.parent / "chip_smoke.py")
chip_smoke = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(chip_smoke)

K = 3
THREADS = wc.FWD_THREADS
KCC = wc.FWD_CC
QUAD = wc.FWD_QUAD
TS = 4 * K * K                  # -t/s at +TS, 1/s at +TS + 4 of a quad
MEX_C = 2.0 / (math.sqrt(3.0) * math.pi ** 0.25)
# (B, H, W, C, O, pad): the compiled widths 8, 4 and 2 (H = 8, 5, 4, 3, 2,
# 1), the generic strips (32, 16, 5, 7, 11, 13), C not a multiple of 4 or
# of the chunk (3, 5, 13, 20), pads 0 and 2, O not a multiple of 4 or of a
# block's lanes, a batch past one block of slots
SHAPES = [(3, 8, 8, 16, 20, 1), (2, 4, 4, 13, 9, 1), (5, 2, 2, 12, 16, 1),
          (2, 3, 2, 8, 5, 1), (1, 5, 8, 4, 8, 1), (2, 11, 13, 5, 12, 1),
          (2, 17, 17, 3, 16, 1), (3, 7, 5, 13, 5, 1), (2, 4, 4, 5, 16, 0),
          (2, 3, 5, 4, 12, 2), (1, 16, 16, 20, 8, 1), (1, 2, 2, 40, 6, 1),
          (20, 1, 8, 6, 3, 1), (40, 4, 4, 8, 4, 1), (1, 32, 32, 3, 4, 1)]
VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]


def _log2(v):
    return max(v - 1, 0).bit_length()


class FwdKernel:
    """The kernel's index arithmetic for one shape and launch config, in the
    CUDA source's names (C entry, then the kernel)."""

    def __init__(self, B, H, W, C, O, pad, cfg, RB=None):
        self.B, self.H, self.W, self.C, self.O, self.pad = B, H, W, C, O, pad
        self.Ho, self.Wo = H + 2 * pad - K + 1, W + 2 * pad - K + 1
        self.WT, self.OG = cfg["WT"], cfg["OG"]
        self.RB = RB or cfg["RB"]
        self.compiled = self.WT in (2, 4, 8)
        assert self.compiled == cfg["compiled"]
        if self.compiled:
            assert pad == 1 and W == self.WT
        assert self.OG & (self.OG - 1) == 0 and self.OG <= THREADS // KCC
        self.halo = not self.compiled
        self._threads = {}
        self.TW = self.WT if self.compiled else 8
        self.TWH = self.TW if self.compiled else self.TW + K - 1
        self.lOG = _log2(self.OG)
        self.NT = THREADS // self.OG
        self.nTiles = B * -(-self.Wo // self.TW)
        self.nBands = -(-self.Ho // self.RB)
        self.nCC = -(-C // KCC)
        self.lCW = 4 if C >= KCC else 2 if C <= 4 else _log2(C)
        self.CW = 1 << self.lCW
        # the layout the config owns, held to what the kernel reads: a
        # slot's TWH columns of KCC channels, an o's KCC / 4 quads, float4s
        self.slotStride, self.wStride = cfg["slotStride"], cfg["wStride"]
        assert self.slotStride >= self.TWH * KCC and self.slotStride % 4 == 0
        assert self.wStride >= KCC // 4 * QUAD and self.wStride % 4 == 0
        self.xBuf = self.NT * self.slotStride
        self.bufStride = self.xBuf + self.OG * self.wStride
        self.xVec = C % 4 == 0
        self.grid = (-(-self.nTiles // self.NT) * self.nBands,
                     -(-O // self.OG))
        if RB is None:
            assert (self.TW, self.TWH, self.NT) == (cfg["TW"], cfg["TWH"],
                                                    cfg["NT"])
            assert cfg["bands"] == self.nBands
            assert tuple(cfg["grid"]) == self.grid
            assert cfg["smem"] == 4 * 2 * self.bufStride

    def block(self, bx, by):
        """The block-uniform walk: band rows [i0, i1), the virtual rows in
        the image [vBeg, vEnd), chunks."""
        band = bx % self.nBands
        i0 = band * self.RB
        i1 = min(i0 + self.RB, self.Ho)
        vBeg, vEnd = max(i0, self.pad), min(i1 + K - 1, self.H + self.pad)
        return {"band": band, "tb": bx // self.nBands, "i0": i0, "i1": i1,
                "vBeg": vBeg, "vEnd": vEnd, "o0": by * self.OG,
                "nCh": max(0, vEnd - vBeg) * self.nCC}

    def thread(self, bx, by, tid):
        key = (bx, by, tid)
        if key not in self._threads:
            self._threads[key] = self._thread(bx, by, tid)
        return self._threads[key]

    def _thread(self, bx, by, tid):
        blk = self.block(bx, by)
        warp, lane = tid >> 5, tid & 31
        og = lane & (self.OG - 1)
        slot = (warp << (5 - self.lOG)) + (lane >> self.lOG)
        tile = blk["tb"] * self.NT + slot
        strip, b = tile // self.B, tile % self.B
        o = blk["o0"] + og
        j0 = strip * self.TW
        col0 = j0 - self.pad if self.halo else 0
        col_ok = [0 <= col0 + q < self.W for q in range(self.TWH)]
        return {"og": og, "slot": slot, "tile": tile, "b": b, "o": o,
                "j0": j0, "col0": col0, "col_ok": col_ok,
                "tileOk": tile < self.nTiles,
                "active": tile < self.nTiles and o < self.O, **blk}

    def stage(self, bx, by, V, cc, buf, with_w):
        """A chunk's staging writes into ``buf`` ({float: source}): ("x",
        b, h, col, c), ("w", tap, c, o), ("nt" | "iv", o, c), or None
        (zero-filled).  Asserts each float is written once."""
        c0 = cc * KCC
        written = set()

        def put(d, src):
            assert d not in written, f"float {d} written twice"
            assert 0 <= d < self.bufStride
            written.add(d)
            buf[d] = src

        for tid in range(THREADS):
            th = self.thread(bx, by, tid)
            if not th["tileOk"]:
                continue
            h, dst = V - self.pad, th["slot"] * self.slotStride
            assert 0 <= h < self.H
            if self.xVec:
                for e in range(th["og"], self.TWH << (self.lCW - 2),
                               self.OG):
                    q, part = e >> (self.lCW - 2), e & (self.CW // 4 - 1)
                    ok = th["col_ok"][q] and c0 + 4 * part < self.C
                    assert (dst + q * KCC + 4 * part) % 4 == 0
                    for f in range(4):
                        put(dst + q * KCC + 4 * part + f,
                            ("x", th["b"], h, th["col0"] + q,
                             c0 + 4 * part + f) if ok else None)
            else:
                for e in range(th["og"], self.TWH << self.lCW, self.OG):
                    q, cl = e >> self.lCW, e & (self.CW - 1)
                    ok = th["col_ok"][q] and c0 + cl < self.C
                    put(dst + q * KCC + cl, ("x", th["b"], h,
                                             th["col0"] + q, c0 + cl)
                        if ok else None)
        if not with_w:
            return
        o0 = self.block(bx, by)["o0"]
        for tid in range(THREADS):
            for e in range(tid, (K * K) << (self.lCW + self.lOG), THREADS):
                ol, r = e & (self.OG - 1), e >> self.lOG
                cl, tap = r & (self.CW - 1), r >> self.lCW
                o, c = o0 + ol, c0 + cl
                put(self.xBuf + ol * self.wStride + (cl >> 2) * QUAD + 4 * tap
                    + (cl & 3), ("w", tap, c, o) if o < self.O and c < self.C
                    else None)
            if tid < self.CW << self.lOG:   # store_ts
                ol, cl = tid & (self.OG - 1), tid >> self.lOG
                o, c = o0 + ol, c0 + cl
                ok = o < self.O and c < self.C
                d = self.xBuf + ol * self.wStride + (cl >> 2) * QUAD + TS + \
                    (cl & 3)
                put(d, ("nt", o, c) if ok else None)
                put(d + 4, ("iv", o, c) if ok else None)

    def rm(self, V, blk):
        return [blk["i0"] <= V - di < blk["i1"] for di in range(K)]

    def taps(self):
        """(di, j, dj, q) of a quad's FMAs for one tap row, in order: output
        column j of the strip gets staged column q through tap column dj
        (a compiled width leaves out the q off the row)."""
        out = []
        for j, dj in itertools.product(range(self.TW), range(K)):
            q = j + dj if self.halo else j + dj - 1
            if 0 <= q < self.TWH:
                out.append((j, dj, q))
        return out


def _config(B, H, W, C, O, pad):
    return wc.fwd_launch_config(B, H, W, C, O, K, pad)


def _inputs(B, H, W, C, O, seed):
    rng = np.random.RandomState(seed)
    return (rng.normal(0, 1, (B, H, W, C)), rng.normal(0, 0.3, (K, K, C, O)),
            0.5 * rng.randn(O, C), 1.0 + 0.3 * rng.rand(O, C))


def _psi_core(z):
    """mexican_hat without its constant, as the kernel's psi_core."""
    z2 = z * z
    return (z2 - 1.0) * np.exp(-0.5 * z2)


def _replay(B, H, W, C, O, pad, arrays=None, RB=None):
    """Walks every block, chunk and active thread as the kernel does,
    checking each read against the staged buffers and counting the psi and
    tap FMAs issued (against ``chip_smoke.wav_fwd_issued``); with
    ``arrays`` also sums y in the kernel's order in float64 (psi =
    mexican_hat)."""
    cfg = _config(B, H, W, C, O, pad)
    kp = FwdKernel(B, H, W, C, O, pad, cfg, RB)
    assert cfg["smem"] <= wc.BLOCK_SMEM_MAX
    written = {}
    n_psi = n_fma = 0
    y = None
    if arrays is not None:
        x, w, t, s = arrays
        y = np.full((B, kp.Ho, kp.Wo, O), np.nan)
    taps = kp.taps()
    for bx, by in itertools.product(range(kp.grid[0]), range(kp.grid[1])):
        blk = kp.block(bx, by)
        threads = [kp.thread(bx, by, tid) for tid in range(THREADS)]
        act = [th for th in threads if th["active"]]
        bufs = [{}, {}]
        chunks = [(V, cc) for V in range(blk["vBeg"], blk["vEnd"])
                  for cc in range(kp.nCC)]
        assert len(chunks) == blk["nCh"]
        if chunks:
            kp.stage(bx, by, *chunks[0], bufs[0], True)
        accs = {th["slot"] * 32 + th["og"]: np.zeros((K, kp.TW)) for th in act}
        k = 0
        for V in range(blk["i0"], blk["i1"] + K - 1):
            rm = kp.rm(V, blk)
            for cc in (range(kp.nCC) if blk["vBeg"] <= V < blk["vEnd"]
                       else ()):
                assert chunks[k] == (V, cc)
                content = bufs[k & 1]
                c0 = cc * KCC
                nq = (min(KCC, C - c0) + 3) >> 2
                h = V - pad
                for th in act:
                    o, acc = th["o"], accs[th["slot"] * 32 + th["og"]]
                    xs = th["slot"] * kp.slotStride
                    for qd in range(nq):
                        ws = kp.xBuf + th["og"] * kp.wStride + qd * QUAD
                        cs = [c0 + 4 * qd + f for f in range(4)]
                        for f, c in enumerate(cs):
                            ok = c < C
                            assert content[ws + TS + f] == (
                                ("nt", o, c) if ok else None)
                            assert content[ws + TS + 4 + f] == (
                                ("iv", o, c) if ok else None)
                            for tap in range(K * K):
                                if rm[tap // K]:
                                    assert content[ws + 4 * tap + f] == (
                                        ("w", tap, c, o) if ok else None)
                        n_psi += 4 * sum(th["col_ok"])
                        n_fma += 4 * len(taps) * sum(rm)
                        ps = np.zeros((kp.TWH, 4))
                        for q in range(kp.TWH):
                            if not th["col_ok"][q]:
                                continue   # never read: psi = 0
                            col = th["col0"] + q
                            for f, c in enumerate(cs):
                                assert content[xs + q * KCC + 4 * qd + f] == (
                                    ("x", th["b"], h, col, c) if c < C
                                    else None), "x read from the wrong float"
                            if y is not None:
                                cv = [min(c, C - 1) for c in cs]
                                iv = np.where(np.array(cs) < C,
                                              1.0 / s[o, cv], 0.0)
                                xv = np.where(np.array(cs) < C,
                                              x[th["b"], h, col, cv], 0.0)
                                ps[q] = _psi_core(xv * iv - t[o, cv] * iv)
                        if y is None:
                            continue
                        cv = [min(c, C - 1) for c in cs]
                        cmask = np.array(cs) < C
                        for di in range(K):
                            if not rm[di]:
                                continue
                            for j, dj, q in taps:
                                wv = np.where(cmask, w[di, dj, cv, o], 0.0)
                                a = acc[K - 1 - di, j]
                                for f in range(4):
                                    a = wv[f] * ps[q, f] + a
                                acc[K - 1 - di, j] = a
                if k + 1 < len(chunks):   # the next chunk into the other
                    kp.stage(bx, by, *chunks[k + 1], bufs[(k + 1) & 1],
                             kp.nCC > 1 or k == 0)
                k += 1
            # output row V - 2 is complete: store it, then move the ring on
            i = V - (K - 1)
            for th in act:
                acc = accs[th["slot"] * 32 + th["og"]]
                if i >= blk["i0"]:
                    for j in range(kp.TW):
                        jj = th["j0"] + j
                        if jj >= kp.Wo:
                            continue
                        key = (th["b"], i, jj, th["o"])
                        assert key not in written, f"y {key} written twice"
                        written[key] = (bx, by)
                        if y is not None:
                            y[key] = MEX_C * acc[0, j]
                acc[:-1] = acc[1:].copy()
                acc[-1] = 0.0
        assert k == len(chunks)
    assert sorted(written) == list(itertools.product(
        range(B), range(kp.Ho), range(kp.Wo), range(O))), "y not covered"
    assert chip_smoke.wav_fwd_issued(dict(cfg, RB=kp.RB), B, H, W, C, O,
                                     pad) == (n_psi, n_fma)
    return cfg, kp, y


@pytest.mark.parametrize("B,H,W,C,O,pad", SHAPES)
def test_fwd_kernel_index_mapping_and_sum_order_f64(B, H, W, C, O, pad):
    """Reads, writes and coverage as the module docstring says, and the
    kernel's sums (per thread: virtual rows in order, each row's chunks,
    each chunk's quads, then tap rows, columns, tap columns and the quad's
    4 channels) replayed in float64 with psi = mexican_hat (its constant
    applied at the store) match ``psi_conv_reference`` to rounding."""
    arrays = _inputs(B, H, W, C, O, seed=B * 100 + H * 10 + C)
    _, _, y = _replay(B, H, W, C, O, pad, arrays)
    want = wc.psi_conv_reference(
        *(torch.from_numpy(a) for a in arrays), "mexican_hat", pad).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("B,H,W,C,O,pad,RB", [
    (2, 8, 8, 16, 12, 1, 3), (3, 7, 5, 13, 5, 1, 2), (2, 3, 5, 4, 12, 2, 2),
    (1, 6, 4, 20, 9, 1, 4), (2, 4, 4, 5, 16, 0, 1)])
def test_fwd_kernel_bands(B, H, W, C, O, pad, RB):
    """Bands of RB rows (the small-batch launches; ragged last band): each
    block reads only what it staged and the bands' rows cover y once."""
    _replay(B, H, W, C, O, pad, RB=RB)


@pytest.mark.parametrize("B,H,C,O", [
    (1, 32, 3, 4), (1, 16, 20, 5), (2, 8, 32, 8),
    (2, 4, 20, 4), (3, 2, 24, 4)])
def test_fwd_kernel_full_height_band_sum_order_f64(B, H, C, O):
    """One band of RB = H rows, the launch batch 1024 takes at every
    VGG16_small shape (32, 16 on the strips; 8, 4, 2 compiled): the ring
    of 3 output rows walks every input row of the plane, each block reads
    only what it staged, y is covered once, and the sums in float64 match
    ``psi_conv_reference``."""
    arrays = _inputs(B, H, H, C, O, seed=7 * H + C)
    _, kp, y = _replay(B, H, H, C, O, 1, arrays, RB=H)
    assert kp.nBands == 1
    want = wc.psi_conv_reference(
        *(torch.from_numpy(a) for a in arrays), "mexican_hat", 1).numpy()
    np.testing.assert_allclose(y, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())


@pytest.mark.parametrize("H,C,O", VGG16_SMALL)
def test_fwd_issued_model_matches_replay_at_vgg16_small(H, C, O):
    """At batch 1 (the bands batch 1 takes) and batch 2 with the whole
    plane as one band (the batch-1024 launch), the psi and tap FMAs the
    replay issues at each VGG16_small plane and C are what
    ``chip_smoke.wav_fwd_issued`` models (``_replay`` asserts it).  One o
    tile of OG channels stands for the O / OG alike: the kernel's walk and
    the model are the same for each."""
    cfg = _config(1, H, H, C, O, 1)
    OG = cfg["OG"]
    assert O % OG == 0 and _config(1, H, H, C, OG, 1)["OG"] == OG
    _replay(1, H, H, C, OG, 1, RB=cfg["RB"])
    _replay(2, H, H, C, OG, 1, RB=H)


@pytest.mark.parametrize("H,C,O", VGG16_SMALL)
def test_fwd_launch_at_vgg16_small(H, C, O):
    """At batch 1024 each VGG16_small shape gets one band, a compiled width
    on the 8x8, 4x4 and 2x2 planes (strips of 8 with a halo on the
    others), whole warps of 128-thread blocks, 4 per SM, a grid that puts
    blocks on every SM; psi is evaluated once per (pixel, o, channel) on
    the compiled widths, 1.19x at 32x32 and 1.125x at 16x16 (x 4/3 for the
    3 channels of the first conv), and the compiled widths issue only the
    interior taps."""
    B = 1024
    cfg = _config(B, H, H, C, O, 1)
    kp = FwdKernel(B, H, H, C, O, 1, cfg)
    assert cfg["threads"] == THREADS and THREADS % 32 == 0
    assert cfg["compiled"] == (H in wc.FWD_WIDTHS)
    assert cfg["WT"] == (H if cfg["compiled"] else 0)
    assert cfg["RB"] == H and cfg["bands"] == 1
    assert cfg["OG"] == (4 if H <= 4 else 8)
    assert cfg["blocks_per_sm"] == 4 == wc.SM_REGS // (THREADS * wc.FWD_REGS)
    assert cfg["smem"] <= wc.SM_SMEM // 4 - 1024
    assert cfg["blocks"] >= wc.SMS
    psi, fma = (n // (B * O) for n in chip_smoke.wav_fwd_issued(
        cfg, B, H, H, C, O))
    cq = 4 * -(-C // 4)   # channels in whole quads
    interior = sum(1 for i, j, di, dj in itertools.product(
        range(H), range(H), range(K), range(K))
        if 0 <= i + di - 1 < H and 0 <= j + dj - 1 < H)
    ratio = {32: 38 / 32, 16: 18 / 16}.get(H, 1.0)
    assert psi / (H * H * C) == pytest.approx(ratio * cq / C)
    if cfg["compiled"]:
        assert fma == interior * cq
    else:   # every tap column; the tap rows off the image left out
        assert fma == 3 * H * (3 * H - 2) * cq


def _parent_fwd_config(B, H, W, C, O, k, pad):
    """The launch configuration this kernel's tiling replaced: T x T tiles,
    OC lanes x 256 / OC tiles, CC channels within 96 KB; None where it
    raised."""
    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p
    Ho, Wo = H + 2 * pad - k + 1, W + 2 * pad - k + 1
    n = max(Ho, Wo)
    T = 2 if n <= 2 else 4 if n <= 4 else 8
    OC = min(32, pow2(O))
    S = 256 // OC
    P2 = (T + k - 1) ** 2
    for CC in range(min(C, 8), 0, -1):
        if 4 * (S * (CC * P2 + 1) + CC * k * k * OC + 2 * CC * OC) \
                <= 96 * 1024:
            return CC
    return None


def test_fwd_config_covers_every_shape_the_parent_took():
    """Every shape on a grid (widths and heights past the VGG planes, C and
    O from 1 to past a chunk or a block's lanes, pads 0-3, batches 1 to
    1024) that the previous configuration accepted gets a launch whose
    buffers fit the block's shared memory and whose grid covers every
    image, strip, row and output channel."""
    taken = 0
    for B, H, W, C, O, pad in itertools.product(
            (1, 5, 64, 1024), (1, 2, 3, 4, 7, 8, 32),
            (1, 2, 3, 4, 5, 8, 9, 16, 32, 100, 3000),
            (1, 3, 5, 16, 17, 300), (1, 5, 8, 33, 128), (0, 1, 2, 3)):
        if H + 2 * pad - K + 1 <= 0 or W + 2 * pad - K + 1 <= 0:
            continue
        if _parent_fwd_config(B, H, W, C, O, K, pad) is None:
            continue
        taken += 1
        cfg = _config(B, H, W, C, O, pad)
        kp = FwdKernel(B, H, W, C, O, pad, cfg)
        assert cfg["smem"] == 8 * kp.bufStride <= wc.BLOCK_SMEM_MAX
        assert kp.grid[0] // kp.nBands * kp.NT >= B * -(-kp.Wo // kp.TW)
        assert kp.nBands * kp.RB >= kp.Ho and kp.grid[1] * kp.OG >= O
        assert cfg["grid"][1] <= 65535
        if cfg["compiled"]:
            assert pad == 1 and W in wc.FWD_WIDTHS
    assert taken > 5000
