"""CPU replay of the WavKAN parameter-gradient kernel's index mapping
(``wav_conv2d_bwd_param_kernel`` in convkan_tpu_torch/csrc/wav_conv2d_bwd.cu)
and of its launch configuration (``param_launch_config``).

The card is needed to run the kernel; its arithmetic on indices is not.
``ParamKernel`` below repeats, step for step, the counters, ring slots,
staging rows and row masks of the CUDA source, and the tests hold what it
produces against the function's definition:

* every (image, input row) of a split is walked by exactly one row slot
  and step, every (o, c) by exactly one thread of one tile, and every tap
  a row issues reads the g row and column it needs (a tap whose g lies off
  the output frame is never issued on the compiled widths, and reads a
  zero-filled column on the others), so each (image, pixel, tap, o, c)
  whose g lies on the frame is summed exactly once;
* every shared-memory read lies inside the rows staged for it, in the
  ring slot and x buffer the kernel reads, and the staging writes stay
  inside the block's shared memory;
* at the VGG16_small shapes every lane owns a pair (channels past C in a
  thread's group of 4 are the only waste);
* the kernel's order of sums, replayed in float64, gives
  ``param_partials_reference``;
* every shape the previous launch configuration took still gets one.

Change the kernel's tiling and this file together.  Pure numpy and torch:
no JAX, no card.
"""

import itertools

import numpy as np
import pytest
import torch

from convkan_tpu_torch.kernels import wav_conv2d as wc

torch.set_num_threads(1)

VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]
# ragged shapes: C = 3, 5, 13 (not a multiple of 4), W = 5, 7 (generic
# widths), H = 1, pad 0 and 2 (generic), O = 5 (idle lanes, 4-byte g)
RAGGED = [(3, 7, 5, 13, 5, 1), (5, 5, 7, 5, 16, 1), (9, 1, 8, 6, 32, 1),
          (4, 6, 4, 3, 8, 1), (3, 4, 4, 5, 16, 0), (2, 3, 5, 4, 12, 2),
          (37, 3, 2, 13, 20, 1), (2, 1, 1, 3, 1, 1)]
K = 3


class ParamKernel:
    """The kernel's index arithmetic for one shape and launch config, in the
    CUDA source's names (C entry, then the kernel)."""

    def __init__(self, B, H, W, C, O, pad, cfg):
        self.B, self.H, self.W, self.C, self.O, self.pad = B, H, W, C, O, pad
        self.Ho, self.Wo = H + 2 * pad - K + 1, W + 2 * pad - K + 1
        self.OC, self.CG, self.RS, self.RB = (cfg["OC"], cfg["CG"], cfg["RS"],
                                              cfg["RB"])
        self.T, self.pipe = cfg["threads"], cfg["pipe"]
        self.S, self.ips = cfg["S"], cfg["ips"]
        self.CTILE = wc.PARAM_CT * self.CG
        self.uoff = pad - 1 if pad > 1 else 0
        self.goff = 1 if pad < 1 else 0
        self.HV = H + 2 * self.uoff
        self.compiled = bool(self.pipe and pad == 1 and W in wc.PARAM_WIDTHS)
        assert self.compiled == cfg["compiled"]
        self.gCols = W if self.compiled else W + K - 1
        self.gCol0 = 0 if self.compiled else pad - (K - 1)
        self.NR = 2 * self.RB + 2 if self.pipe else self.RB + 2
        self.gRow = self.gCols * self.OC
        self.xRow = W * self.CTILE
        self.ring = (self.NR * self.gRow + 3) // 4 * 4   # Xs offset
        self.nbuf = 2 if self.pipe else 1
        self.gVec = O % 4 == 0 and self.OC >= 4
        self.xVec = C % 4 == 0
        self.nW = self.T // 32

    # ---- VRow / DivMod / ring_add
    def divmod_(self, n):
        return divmod(n, self.HV)

    def add(self, vr, dm):
        b, hv = vr
        q, r = dm
        hv += r
        b += q
        if hv >= self.HV:
            hv -= self.HV
            b += 1
        return (b, hv)

    def ring_add(self, slot, n):
        assert 0 <= slot < self.NR and 0 <= n < self.NR
        slot += n
        return slot - self.NR if slot >= self.NR else slot

    # ---- one split: staging and the row walk in program order
    def run_split(self, split):
        """Yields ("x", kk, buf, r, b_abs, h), ("g", kk, slot, b_abs, oh)
        writes and ("row", kk, rs, i, buf, b_abs, h, rm, slots) reads in
        the kernel's program order (for PIPE: stage(kk + 1) before the
        compute of step kk)."""
        RB, RS, NR, HV = self.RB, self.RS, self.NR, self.HV
        img0 = split * self.ips
        nV = min(self.ips, self.B - img0) * HV
        nSteps = -(-nV // RB)
        byStep, byWarps, byOne = (self.divmod_(RB), self.divmod_(self.nW),
                                  self.divmod_(1))
        bySlots = self.divmod_(RS)
        warpsRing, slotsRing = self.nW % NR, RS % NR
        events = []

        def stage(kk, vs, base, buf):
            for warp in range(self.nW):
                byWarp, warpRing = self.divmod_(warp), warp % NR
                vr = self.add(vs, byWarp)
                v = kk * RB + warp
                r = warp
                while r < RB:
                    h = vr[1] - self.uoff
                    if v < nV and 0 <= h < self.H:
                        events.append(("x", kk, buf, r, img0 + vr[0], h))
                    r += self.nW
                    v += self.nW
                    vr = self.add(vr, byWarps)
                first = kk == 0
                nG = RB + 1 if first else RB
                vr = vs if first else self.add(vs, byOne)
                vr = self.add(vr, byWarp)
                v = warp if first else kk * RB + 1 + warp
                slot = self.ring_add(self.ring_add(base, 1 if first else 2),
                                     warpRing)
                j = warp
                while j < nG:
                    oh = vr[1] - self.goff
                    if v < nV and 0 <= oh < self.Ho:
                        events.append(("g", kk, slot, img0 + vr[0], oh))
                    j += self.nW
                    v += self.nW
                    vr = self.add(vr, byWarps)
                    slot = self.ring_add(slot, warpsRing)

        vs, base = (0, 0), 0
        if self.pipe:
            stage(0, vs, 0, 0)
        for kk in range(nSteps):
            buf = 0
            if self.pipe:
                buf = kk & 1
                if kk + 1 < nSteps:
                    stage(kk + 1, self.add(vs, byStep),
                          self.ring_add(base, RB), (kk + 1) & 1)
            else:
                stage(kk, vs, base, 0)
            for rs in range(RS):
                vr = self.add(vs, self.divmod_(rs))
                v = kk * RB + rs
                slot = self.ring_add(base, rs % NR)
                i = rs
                while i < RB:
                    h = vr[1] - self.uoff
                    if v < nV and 0 <= h < self.H:
                        oh0 = h + self.uoff - self.goff - 1
                        rm = sum(1 << r for r in range(K)
                                 if 0 <= oh0 + r < self.Ho)
                        s1 = self.ring_add(slot, 1)
                        s2 = self.ring_add(s1, 1)
                        events.append(("row", kk, rs, i, buf, img0 + vr[0], h,
                                       rm, (slot, s1, s2)))
                    i += RS
                    v += RS
                    vr = self.add(vr, bySlots)
                    slot = self.ring_add(slot, slotsRing)
            vs = self.add(vs, byStep)
            base = self.ring_add(base, RB)
        return events

    # ---- the columns a row reads
    def row_taps(self, rm):
        """(j, r, e, staged column) of every tap a row issues: compiled
        widths by their masks (the edge pixels peeled), the generic row
        every e of the rows in rm."""
        W = self.W
        out = []
        for j in range(W):
            if self.compiled:
                em = 6 if j == 0 else 3 if j == W - 1 else 7
                cols = {e: j - 1 + e for e in range(K)}
            else:
                em = 7
                cols = {e: j + e for e in range(K)}
            out += [(j, r, e, cols[e]) for r in range(K) for e in range(K)
                    if (rm >> r) & 1 and (em >> e) & 1]
        return out

    def g_chunks(self):
        """(dst float, staged column, lane o offset, ok) of a staged g row's
        copies: (float4 or float) x the row's columns."""
        out = []
        if self.gVec:
            lq = (self.OC.bit_length() - 1) - 2
            for e in range(self.gCols << lq):
                col, q = e >> lq, e & ((1 << lq) - 1)
                ow = col + self.gCol0
                for f in range(4):
                    out.append((4 * e + f, col, 4 * q + f,
                                0 <= ow < self.Wo and 4 * q < self.O))
        else:
            lOC = self.OC.bit_length() - 1
            for e in range(self.gRow):
                col, q = e >> lOC, e & (self.OC - 1)
                ow = col + self.gCol0
                out.append((e, col, q, 0 <= ow < self.Wo and q < self.O))
        return out

    def x_chunks(self, cT0):
        lCG = self.CG.bit_length() - 1
        out = []
        if self.xVec:
            for e in range(self.W << lCG):
                col, q = e >> lCG, e & (self.CG - 1)
                for f in range(4):
                    out.append((4 * e + f, col, 4 * q + f,
                                cT0 + 4 * q < self.C))
        else:
            for e in range(self.xRow):
                col, q = e >> (lCG + 2), e & (self.CTILE - 1)
                out.append((e, col, q, cT0 + q < self.C))
        return out

    def lanes(self):
        """(tile x, tile y, tid) -> (o, [c...] of its pairs) of every active
        thread, and the lanes without a pair."""
        owned, idle = [], 0
        lOC, lCG = self.OC.bit_length() - 1, self.CG.bit_length() - 1
        for bx, by in itertools.product(range(-(-self.O // self.OC)),
                                        range(-(-self.C // self.CTILE))):
            for tid in range(self.T):
                ol = tid & (self.OC - 1)
                cg = (tid >> lOC) & (self.CG - 1)
                rs = tid >> (lOC + lCG)
                o = (bx << lOC) + ol
                c0 = by * self.CTILE + wc.PARAM_CT * cg
                if rs < self.RS and o < self.O and c0 < self.C:
                    if rs == 0:
                        owned += [(o, c) for c in range(
                            c0, min(c0 + wc.PARAM_CT, self.C))]
                else:
                    idle += 1
        return owned, idle


def _config(B, H, W, C, O, pad):
    return wc.param_launch_config(B, H, W, C, O, K, pad)


def _check_mapping(B, H, W, C, O, pad, vgg):
    cfg = _config(B, H, W, C, O, pad)
    kp = ParamKernel(B, H, W, C, O, pad, cfg)
    # shared memory: what the kernel addresses fits what is launched
    floats = kp.ring + kp.nbuf * kp.RB * kp.xRow
    assert 4 * floats <= cfg["smem"] <= wc.BLOCK_SMEM_MAX
    if kp.RS > 1:
        assert 4 * wc.PARAM_VALS * kp.T <= cfg["smem"]
    assert kp.T % 32 == 0 and kp.OC * kp.CG * kp.RS <= kp.T
    # lanes: every (o, c) owned once; at VGG16_small no lane without a pair
    owned, idle = kp.lanes()
    assert sorted(owned) == sorted(itertools.product(range(O), range(C)))
    if vgg:
        assert idle == 0 and kp.OC * kp.CG * kp.RS == kp.T
        assert kp.compiled and kp.pipe
    # a staged g row's copies: every float of the row written once, each
    # column from its ow (zero off the frame), each lane from o0 + ol
    chunks = kp.g_chunks()
    assert sorted(d for d, *_ in chunks) == list(range(kp.gRow))
    gsrc = {}
    for d, col, ol, ok in chunks:
        assert d == col * kp.OC + ol
        gsrc[(col, ol)] = ok
    for cT0 in range(0, C, kp.CTILE):
        xch = kp.x_chunks(cT0)
        assert sorted(d for d, *_ in xch) == list(range(kp.xRow))
        assert all(d == col * kp.CTILE + q for d, col, q, _ in xch)
    # rows: staged where the kernel reads them, each walked once
    walked = {}
    for split in range(kp.S):
        ring = [None] * kp.NR
        xbuf = [[None] * kp.RB for _ in range(kp.nbuf)]
        for ev in kp.run_split(split):
            if ev[0] == "x":
                _, kk, buf, r, b, h = ev
                assert 0 <= r < kp.RB
                xbuf[buf][r] = (b, h)
            elif ev[0] == "g":
                _, kk, slot, b, oh = ev
                assert 0 <= slot < kp.NR
                assert kp.ips * split <= b < min(kp.B, kp.ips * (split + 1))
                ring[slot] = (b, oh)
            else:
                _, kk, rs, i, buf, b, h, rm, slots = ev
                assert kp.ips * split <= b < min(kp.B, kp.ips * (split + 1))
                key = (b, h)
                assert key not in walked, f"row {key} walked twice"
                walked[key] = (split, rs)
                assert xbuf[buf][i] == (b, h), "x row not staged"
                want = {r for r in range(K)
                        if 0 <= h + pad - K + 1 + r < kp.Ho}
                assert {r for r in range(K) if (rm >> r) & 1} == want
                for r in want:
                    assert ring[slots[r]] == (b, h + pad - K + 1 + r), \
                        "g row not staged where it is read"
    assert sorted(walked) == sorted(itertools.product(range(B), range(H)))
    # columns: each row's taps are the (pixel, tap) pairs whose g column
    # lies on the frame, each once (compiled widths), or every tap with the
    # off-frame columns zero-filled (the generic width)
    for rm in {7, 6, 3, 2, 5, 4, 1}:
        taps = kp.row_taps(rm)
        rows = [r for r in range(K) if (rm >> r) & 1]
        on = {(j, r, e) for j in range(W) for r in rows for e in range(K)
              if 0 <= j + pad - K + 1 + e < kp.Wo}
        got = [(j, r, e) for j, r, e, _ in taps]
        assert len(got) == len(set(got))
        for j, r, e, col in taps:
            assert 0 <= col < kp.gCols, "g column outside the staged row"
            ow = col + kp.gCol0
            assert ow == j + pad - K + 1 + e
            on_frame = 0 <= ow < kp.Wo
            assert all(gsrc[(col, ol)] == (on_frame and ol < O)
                       for ol in range(min(kp.OC, O)))
        if kp.compiled:
            assert set(got) == on
        else:
            assert set(got) >= on
    return cfg, kp


@pytest.mark.parametrize("H,C,O", VGG16_SMALL)
def test_param_kernel_index_mapping_emulation(H, C, O):
    """The VGG16_small shapes at batch 1024: rows, lanes, taps and shared
    memory as the module docstring says; the 4x4 and 2x2 planes issue no
    pad tap (issued/interior 1)."""
    cfg, kp = _check_mapping(1024, H, H, C, O, 1, vgg=True)
    issued = sum(len(kp.row_taps(7 if 0 < h < H - 1 else
                                 (6 if h == 0 else 3) if H > 1 else 2))
                 for h in range(H))
    interior = sum(1 for i, j, di, dj in itertools.product(
        range(H), range(H), range(K), range(K))
        if 0 <= i + 1 - di < H and 0 <= j + 1 - dj < H)
    assert issued == interior


@pytest.mark.parametrize("B,H,W,C,O,pad", RAGGED)
def test_param_kernel_index_mapping_emulation_ragged(B, H, W, C, O, pad):
    _check_mapping(B, H, W, C, O, pad, vgg=False)


def _psi_np(z):
    e = np.exp(-0.5 * z * z)
    c = 2.0 / (np.sqrt(3.0) * np.pi ** 0.25)
    return c * (z * z - 1.0) * e, c * z * e * (3.0 - z * z)


@pytest.mark.parametrize("B,H,W,C,O,pad", [
    (3, 7, 5, 13, 5, 1), (5, 4, 4, 6, 16, 1), (4, 6, 2, 3, 8, 1),
    (2, 3, 5, 4, 12, 2), (3, 4, 4, 5, 16, 0)])
def test_param_kernel_sum_order_replay_f64(B, H, W, C, O, pad):
    """The kernel's sums in its order (per row slot: its rows by step, the
    row's pixels, each pixel's taps r then e; then the slots in order),
    replayed in float64 with psi = mexican_hat, match the plain version's
    partials to rounding."""
    cfg = _config(B, H, W, C, O, pad)
    kp = ParamKernel(B, H, W, C, O, pad, cfg)
    rng = np.random.RandomState(B * 100 + H)
    x = rng.normal(0, 1, (B, H, W, C))
    w = rng.normal(0, 0.3, (K, K, C, O))
    t = 0.5 * rng.randn(O, C)
    s = 1.0 + 0.3 * rng.rand(O, C)
    g = rng.normal(0, 1, (B, kp.Ho, kp.Wo, O))
    iv = 1.0 / s
    nt = -t * iv
    # wf[r, e] = w[2 - r, 2 - e] as (O, C)
    wf = np.transpose(w[::-1, ::-1], (0, 1, 3, 2))
    got = np.zeros((kp.S, cfg["N"]))
    for split in range(kp.S):
        acc = [{"dw": np.zeros((K, K, O, C)), "dt": np.zeros((O, C)),
                "ds": np.zeros((O, C))} for _ in range(kp.RS)]
        for ev in kp.run_split(split):
            if ev[0] != "row":
                continue
            _, kk, rs, i, buf, b, h, rm, _ = ev
            a = acc[rs]
            for j, tap_list in itertools.groupby(kp.row_taps(rm),
                                                 key=lambda tp: tp[0]):
                z = x[b, h, j][None, :] * iv + nt          # (O, C)
                p, d = _psi_np(z)
                G = np.zeros((O, C))
                for _, r, e, col in tap_list:
                    ow = col + kp.gCol0
                    gv = g[b, h + pad - K + 1 + r, ow][:, None] \
                        if 0 <= ow < kp.Wo else np.zeros((O, 1))
                    G = gv * wf[r, e] + G
                    a["dw"][r, e] = p * gv + a["dw"][r, e]
                dg = d * G
                a["dt"] = a["dt"] + dg
                a["ds"] = dg * z + a["ds"]
        tot = acc[0]
        for a in acc[1:]:
            tot = {key: tot[key] + a[key] for key in tot}
        dw = np.transpose(tot["dw"][::-1, ::-1], (0, 1, 3, 2))  # (k,k,C,O)
        got[split] = np.concatenate([dw.reshape(-1),
                                     (-tot["dt"] * iv).reshape(-1),
                                     (-tot["ds"] * iv).reshape(-1)])
    want = wc.param_partials_reference(
        *(torch.from_numpy(a) for a in (x, w, t, s, g)), "mexican_hat", pad,
        kp.S, kp.ips).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-11,
                               atol=1e-11 * np.abs(want).max())


def _parent_param_config(B, H, W, C, O, k, pad):
    """The launch configuration this kernel's tiling replaced: one (o, c)
    pair per thread, RB rows within 96 KB; None where it raised."""
    def pow2(n):
        p = 1
        while p < n:
            p *= 2
        return p
    OC = min(32, pow2(O))
    CW = min(256 // OC, pow2(C))
    RB = min(B * H, 96 * 1024 // (4 * (k * (W + k - 1) * OC + W * CW)))
    return None if RB < 1 else RB


def test_param_config_covers_every_shape_the_parent_took():
    """Every shape on a grid (widths up to past the parent's limit at
    O = C = 1, pads 0-3) that the previous configuration accepted gets a
    launch whose copy fits the block's shared memory."""
    taken = 0
    for W, C, O, pad in itertools.product(
            (1, 2, 3, 5, 8, 31, 32, 33, 100, 234, 235, 1000, 3000, 6142,
             6143), (1, 3, 5, 13, 64, 128, 300), (1, 5, 16, 33, 128),
            (0, 1, 2, 3)):
        B, H = 2, 3
        if H + 2 * pad - K + 1 <= 0 or W + 2 * pad - K + 1 <= 0:
            continue
        if _parent_param_config(B, H, W, C, O, K, pad) is None:
            continue
        taken += 1
        cfg = _config(B, H, W, C, O, pad)
        assert cfg["smem"] <= wc.BLOCK_SMEM_MAX
        assert cfg["S"] * cfg["ips"] >= B > (cfg["S"] - 1) * cfg["ips"]
    assert taken > 1000
