"""The ordered reduction of per-split partial sums (csrc/ordered_sum.cuh,
run by kan_conv2d_bwd_dw_reduce and wav_conv2d_bwd_reduce) on the CPU:
its launch config, a numpy replay of the kernel's index mapping and add
order, and the plain version that follows that order.  The kernel itself
runs on the card (tests/test_torch_cuda.py, chip_smoke.py phases 6, 8, 10
and 14)."""

import numpy as np
import pytest
import torch

from convkan_tpu_torch.kernels import kan_conv2d as kc
from convkan_tpu_torch.kernels import wav_conv2d as wc

torch.set_num_threads(1)

# (H, C, O) of the VGG16_small convs (9 distinct shapes), batch 1024
VGG16_SMALL = [(32, 3, 16), (32, 16, 16), (16, 16, 32), (16, 32, 32),
               (8, 32, 64), (8, 64, 64), (4, 64, 128), (4, 128, 128),
               (2, 128, 128)]
KAN_PAIRS = [(kc.dw_launch_config(1024, H, H, C, O, 3, 1, 9)["S"],
              9 * C * 9 * O) for H, C, O in VGG16_SMALL]
WAV_PAIRS = [(cfg["S"], cfg["N"]) for cfg in (
    wc.param_launch_config(1024, H, H, C, O, 3, 1)
    for H, C, O in VGG16_SMALL)]
# S = 1; S = 7 with N = 45*99 (odd); odd N; N < 4; S = 1023; many splits
# over a few columns (the most leaves); N % 4 == 0 but not a whole block;
# and the WavKAN partials of the parameter kernel's earlier split rule
# (4 blocks per SM of one (o, c) pair per thread)
RAGGED = [(1, 1000), (7, 45 * 99), (513, 4455), (300, 3), (1023, 37),
          (1023, 64), (40, 1), (4, 8), (9, 4 * 257), (256, 5632),
          (128, 11264), (64, 22528), (32, 45056), (17, 90112),
          (9, 180224)]
PAIRS = list(dict.fromkeys(KAN_PAIRS + WAV_PAIRS + RAGGED))


def _ids(pairs):
    return [f"S{s}-N{n}" for s, n in pairs]


@pytest.mark.parametrize("S,N", PAIRS, ids=_ids(PAIRS))
def test_launch_config_invariants(S, N):
    cfg = kc.reduce_launch_config(S, N)
    Gw, Gc, VW = cfg["Gw"], cfg["Gc"], cfg["VW"]
    assert Gw in (1, 2, 4, 8) and 1 <= Gc <= kc.RED_MAX_RANKS
    assert VW == (4 if N % 4 == 0 else 1)
    assert cfg["cols"] == kc.RED_THREADS // Gw * VW
    # the leaves partition the splits in order: each split in exactly one
    leaves = cfg["leaves"]
    assert len(leaves) == Gw * Gc and leaves[0][0] == 0 and leaves[-1][1] == S
    assert all(a[1] == b[0] for a, b in zip(leaves, leaves[1:]))
    sizes = [hi - lo for lo, hi in leaves]
    assert min(sizes) >= (1 if len(leaves) == 1 else kc.RED_MIN_LEAF)
    gx = -(-(N // VW) // (kc.RED_THREADS // Gw))
    assert cfg["grid"] == (gx, Gc) and cfg["blocks"] == gx * Gc
    # ranks only after all rows, and only where 8 rows leave fewer blocks
    # than SMs and long leaves
    cluster = -(-(N // VW) // (kc.RED_THREADS // kc.RED_MAX_ROWS)) < \
        kc.RED_CLUSTER_GRID and S // kc.RED_MAX_ROWS > kc.RED_CLUSTER_LEAF
    assert Gc == 1 or (Gw == kc.RED_MAX_ROWS and cluster)
    # the last doubling (ranks after rows) was taken while the grid was
    # short of two blocks per SM; the next was not taken for a reason
    if len(leaves) > 1:
        pw, pc = (Gw, Gc // 2) if Gc > 1 else (Gw // 2, 1)
        prev = -(-(N // VW) // (kc.RED_THREADS // pw)) * pc
        assert prev < kc.RED_TARGET_BLOCKS
    assert cfg["blocks"] >= kc.RED_TARGET_BLOCKS or \
        S // (2 * len(leaves)) < kc.RED_MIN_LEAF or \
        (Gw == kc.RED_MAX_ROWS and (not cluster or Gc == kc.RED_MAX_RANKS
                                    or S // len(leaves)
                                    <= 2 * kc.RED_MIN_LEAF))


def test_launch_config_spreads_narrow_and_keeps_wide_in_one_pass():
    """The wide, small-S partials (S = 8..32 at N >= 180,224) take one
    leaf, one pass; the first convs' 512 splits (the KAN weight gradient's
    first, the WavKAN parameter kernel's first three: 32², 32², 16²)
    spread over 8 thread rows and 4 cluster ranks (leaves of 16); no other
    VGG16_small partial pays for a cluster (the launch sweep on the H100,
    PERF.md)."""
    one = [kc.reduce_launch_config(S, N) for S, N in
           KAN_PAIRS[5:] + WAV_PAIRS[7:]]
    assert all(c["Gw"] == c["Gc"] == 1 for c in one)
    for S, N in (KAN_PAIRS[0], *WAV_PAIRS[:3]):
        cfg = kc.reduce_launch_config(S, N)
        assert S == 512 and (cfg["Gw"], cfg["Gc"]) == (8, 4)
    assert all(kc.reduce_launch_config(S, N)["Gc"] == 1 for S, N in
               KAN_PAIRS[1:] + WAV_PAIRS[3:])


def emulate_kernel(partial: np.ndarray, cfg: dict):
    """numpy replay of ordered_sum_kernel: every thread (block x, rank,
    tid) of the grid with its row, vector and leaf as the kernel computes
    them; float32 adds in the kernel's order.  Returns (out, reads per
    (s, i), writes per i)."""
    S, N = partial.shape
    VW, Gw, Gc = cfg["VW"], cfg["Gw"], cfg["Gc"]
    T, nv = kc.RED_THREADS // Gw, N // VW
    gx, L = cfg["grid"][0], Gw * Gc
    bx, rank, tid = np.meshgrid(np.arange(gx), np.arange(Gc),
                                np.arange(kc.RED_THREADS), indexing="ij")
    row, t = tid // T, tid % T
    v = bx * T + t
    live = v < nv
    leaf = rank * Gw + row
    lo, hi = leaf * S // L, (leaf + 1) * S // L
    lanes = np.arange(VW)
    col = np.where(live, v, 0)[..., None] * VW + lanes       # (gx,Gc,256,VW)
    reads = np.zeros(S * N, np.int64)

    def load(s, mask):
        m = mask[..., None] & np.ones(VW, bool)
        reads[(s[..., None] * N + col)[m]] += 1  # distinct in one step
        return partial[np.where(mask, s, 0)[..., None], col]

    acc = load(lo, live)
    for j in range(1, int((hi - lo).max())):
        on = live & (lo + j < hi)
        acc = np.where(on[..., None], acc + load(lo + j, on), acc)
    # thread rows in row order, then ranks in rank order (row 0, rank 0
    # writes); the leaf sums of the other rows go through shared memory
    acc = acc.reshape(gx, Gc, Gw, T, VW)
    block = acc[:, :, 0]
    for w in range(1, Gw):
        block = block + acc[:, :, w]
    total = block[:, 0]
    for r in range(1, Gc):
        total = total + block[:, r]
    out = np.zeros(N, np.float32)
    writes = np.zeros(N, np.int64)
    vv = (np.arange(gx)[:, None] * T + np.arange(T)).reshape(-1)
    keep = vv < nv
    idx = (vv[keep][:, None] * VW + lanes).reshape(-1)
    out[idx] = total.reshape(-1, VW)[keep].reshape(-1)
    np.add.at(writes, idx, 1)
    return out, reads.reshape(S, N), writes


@pytest.mark.parametrize("S,N", PAIRS, ids=_ids(PAIRS))
def test_kernel_index_mapping_emulation(S, N):
    """Every (s, i) is read once and every i written once, and the
    replay's float32 result equals reduce_reference bit for bit."""
    rng = np.random.RandomState(S + N)
    partial = rng.standard_normal((S, N)).astype(np.float32)
    cfg = kc.reduce_launch_config(S, N)
    out, reads, writes = emulate_kernel(partial, cfg)
    assert (reads == 1).all() and (writes == 1).all()
    want = kc.reduce_reference(torch.from_numpy(partial)).numpy()
    assert want.dtype == np.float32
    assert np.array_equal(out.view(np.int32), want.view(np.int32))


@pytest.mark.parametrize("S,N", PAIRS, ids=_ids(PAIRS))
def test_grouped_sum_is_close_to_float64(S, N):
    """The grouped order changes the float32 rounding, not the sum: within
    1e-6 of the sum of |terms| of a float64 sum."""
    rng = np.random.RandomState(2 * S + N)
    partial = rng.standard_normal((S, N)).astype(np.float32)
    got = kc.reduce_reference(torch.from_numpy(partial)).double().numpy()
    p64 = partial.astype(np.float64)
    err = np.abs(got - p64.sum(0)) / np.abs(p64).sum(0)
    assert err.max() <= 1e-6


@pytest.mark.parametrize("S,N", [(8, 1327104), (16, 270336), (1, 77),
                                 (3, 45 * 99)])
def test_one_leaf_is_the_split_order_sum(S, N):
    """With one leaf the grouped sum is the old split-order sum, bitwise,
    and reduce_partials on the CPU is reduce_reference."""
    rng = np.random.RandomState(S)
    p = torch.from_numpy(rng.standard_normal((S, N)).astype(np.float32))
    cfg = kc.reduce_launch_config(S, N)
    assert len(cfg["leaves"]) == 1
    old = p[0].clone()
    for s in range(1, S):
        old += p[s]
    assert torch.equal(kc.reduce_reference(p), old)
    assert torch.equal(kc.reduce_partials(p), old)
    assert torch.equal(wc.reduce_partials(p), old)


def test_reference_takes_the_config_and_the_partials_shape():
    """An explicit cfg sets the order (one leaf: split order, bitwise); the
    result keeps the partials' trailing shape."""
    rng = np.random.RandomState(3)
    p = torch.from_numpy(rng.standard_normal((342, 9, 20)).astype(
        np.float32))
    one = {"Gw": 1, "Gc": 1, "leaves": [(0, 342)]}
    old = p[0].clone()
    for s in range(1, 342):
        old += p[s]
    assert torch.equal(kc.reduce_reference(p, one), old)
    got = kc.reduce_partials(p)
    assert got.shape == (9, 20)
    assert len(kc.reduce_launch_config(342, 180)["leaves"]) > 1
    assert torch.equal(got, kc.reduce_reference(p.reshape(342, 180))
                       .reshape(9, 20))
