// kan_conv2d_fwd — KAN convolution forward for Hopper (sm_90a), over the
// per-channel basis policies of kan_basis.cuh (B-spline with its base path,
// Chebyshev without one, Gram with a learnable operand and a base path).
//
// Replaces two Pallas TPU kernels of convkan_tpu, which compute the same
// function and differ only in how they fit TPU VMEM:
//   * convkan_tpu/kernels/wide_kan_conv.py, _make_core -> fwd_kernel
//     (one wide E @ W_all matmul, then a shifted sum over the taps);
//   * convkan_tpu/kernels/fused_kan_conv.py, fused_kan_conv2d -> kernel
//     (per-tap contractions of the basis and of act(x)).
// Hopper has no VMEM budget to split on, so this one kernel stands for both.
//
// Function (x NHWC float32, y NHWC float32, pre-norm output):
//   y[b,i,j,o] = sum_{di,dj} sum_r E[b,i+di,j+dj,r] * W_all[r, (di*k+dj)*O+o]
//   E = [P_0(x) .. P_{K-1}(x)(, act(x))] (R rows per channel: the basis
//   policy's) on the zero-padded frame, multiplied by the validity mask: the
//   pad is zero AFTER expansion (B-spline(0) != 0, T_0 = 1 everywhere).
//   W_all rows kk*C+c (basis kk of channel c), then C rows of the base path
//   where there is one; columns tap-major.  This is pack_w_all(...,
//   degree_major=False).
//
// What bounds it on the H100: arithmetic.  A (pixel, tap) pair whose input
// lies on the pad adds zero, so the work that counts is 2 * (interior pixel,
// tap) pairs * R*C*O FLOPs: 0.29 GFLOP per image over the 13 layers of
// KAN-VGG16_small (0.36 counting the pad taps) for the B-spline's R = 9.  Each input is read once and
// each output written once (a few MB per layer at batch 1024).  Operands are
// float32, so the ceiling is the FP32 rate outside the tensor cores (67
// TFLOP/s on an H100 SXM at 700 W): 4.34 ms for the model at batch 1024.
//
// The design (an implicit GEMM: M = output pixels, N = output channels, the
// reduction over taps x R x C):
//   * A block of 256 threads owns BM pixels x BN channels, BN = O rounded up
//     to 16..128, so that up to 128 channels the basis of an input tile is
//     computed once.  It walks the input channels in chunks of CC: a chunk's
//     input tile is expanded ONCE into R*CC masked rows in shared memory,
//     pixel-major with a row stride of an odd number of float4s (neighbouring
//     pixels in different banks), and every tap reads that tile shifted.
//   * Each thread keeps 8 pixels x 8 channels of sums in registers (8 x 4 at
//     BN = 16): per four reduction rows it loads 8 float4s of E and 8 of W
//     for 256 FMAs, 4 FMAs per float read from shared memory, and a warp's E
//     loads are broadcasts over the threads that share its pixels.
//   * The basis (Basis::expand of kan_basis.cuh): for the B-spline only the
//     ORDER+1 bases that can be non-zero at x are evaluated (bspline_span,
//     12 IEEE divides instead of 54; bit-identical values), the rest of the
//     row is written zero; Chebyshev's 4 rows of degree 3 are all dense, as
//     are Gram's 5.  Gram's operand beta (changed by every train step) is
//     read from device memory once per block, never passed by value.
//   * W_all (at most 5.3 MB) stays in the 50 MB L2.  Each tap's slice of the
//     chunk's rows is copied into shared memory with cp.async (no registers),
//     double-buffered: the next tap's slice is in flight while the current
//     one is consumed, one barrier per tap.
//   * Pad taps skipped where they are many (Ho*Wo <= 16: 44% of the pairs at
//     2x2 and 31% at 4x4 read the pad): pixels are ordered (position, image),
//     so each warp holds ONE output position over 8*TPW images, the set of
//     taps whose input lies in the image is uniform across the warp, and a
//     warp skips the others whole, without divergence.  The expanded tile
//     then holds only the images' own pixels (no pad frame).
//   * Channel splits where the tiles are few: S blocks of one thread-block
//     cluster take disjoint ranges of the channel chunks of one tile.  Each
//     writes its partial tile into its own shared memory; after a cluster
//     barrier, block z sums the z-th S-th of the tile over the S blocks'
//     shared memory (distributed shared memory) in rank order and writes y.
//     No atomics and a fixed order: two runs give the same bits.  The host
//     picks S so that about two waves of 2 blocks per SM run
//     (kernels/kan_conv2d.py, launch_config).
// Later work: tensor cores (wgmma on TF32/bf16 operands) and TMA staging.
//
// Numerics: explicitly rounded float32 basis (no FMA contraction, true IEEE
// divides); the knots (or the clamp bounds) arrive as float32 kernel
// arguments, Gram's beta as a device pointer.  Build WITHOUT --use_fast_math: it would turn the divides
// approximate and expf and tanhf into their approximations.
//
// Interface: a plain C entry point loaded with ctypes.  It launches on the
// caller's stream, allocates nothing, and returns the launch's error.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "kan_basis.cuh"

namespace cg = cooperative_groups;

namespace {

using namespace kan;

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kTM = 8;                  // output pixels per thread
constexpr int kMaxCC = 8;               // input channels per chunk
constexpr int kMaxRS = 76;              // R*CC padded, R <= 9, CC <= 8

// floats per expanded pixel (R*CC rounded up to an odd number of float4s)
__host__ __device__ constexpr int row_stride(int R, int CC) {
  const int f4 = (R * CC + 3) / 4;
  return 4 * (f4 % 2 ? f4 : f4 + 1);
}

// the row tables' length for R rows per channel: kMaxRS up to R = 9, else
// the widest row stride of CC <= kMaxCC (92 at Fourier's R = 11)
__host__ __device__ constexpr int max_rs(int R) {
  int m = kMaxRS;
  for (int cc = 1; cc <= kMaxCC; ++cc)
    if (row_stride(R, cc) > m) m = row_stride(R, cc);
  return m;
}
constexpr int kMaxSplits = 16;          // channel splits of a tile: a cluster
constexpr size_t kMaxSmem = 227 * 1024; // dynamic shared memory of a block

struct Shape {
  int B, H, W, C, O, k, pad, Ho, Wo;
  int skip;          // 1: pixels ordered (position, image), pad taps skipped
  int TH, TW, NB;    // dense tile: NB images x TH rows x TW columns
  int NG;            // skip tile: NG groups of G images, all their pixels
  int CC, S, nch;    // channels per chunk, channel splits, chunks
  int rs;            // floats per expanded pixel: R*CC padded
  int tileH, tileW;  // dense: rows and columns of the haloed tile
  int tilePix;       // pixels of the expanded tile
  int groups;        // skip: image groups, ceil(B / G)
  int tilesM;        // blocks along M (grid x)
  int vecW;          // weight slices copied as float4 (O % 4 == 0)
};

// The thread tile of a BN-column block: TN channels x kTM pixels per thread,
// TPN threads along N; a warp is TPW threads along M x TPN along N.
template <int BN>
struct Geo {
  static constexpr int TN = BN == 16 ? 4 : 8;
  static constexpr int NH = TN / 4;       // float4 column groups per thread
  static constexpr int TPN = BN / TN;
  static constexpr int TPW = 32 / TPN;
  static constexpr int TPM = kThreads / TPN;
  static constexpr int BM = TPM * kTM;    // output pixels per block
  static constexpr int G = TPW * kTM;     // skip: images per warp
  static constexpr int HALF = BN / NH;    // first column of group 1
};

// skip mode: the slot (image group x position) of warp w of a block.  Warps
// w and w + 4 share an SM sub-partition; pairing slot w with slot 11 - w
// gives the sub-partitions of a 2x2 layer's block complementary positions,
// whose taps inside the image overlap only at the centre tap.
__device__ __forceinline__ int warp_slot(int w) {
  return w < kWarps / 2 ? w : kWarps + kWarps / 2 - 1 - w;
}

__device__ __forceinline__ float comp(const float4& v, int u) {
  return u == 0 ? v.x : u == 1 ? v.y : u == 2 ? v.z : v.w;
}

// four channels o..o+3 of one output pixel
__device__ __forceinline__ void store4(float* yp, int o, int O, float4 v) {
  if ((O & 3) == 0) {
    if (o < O) *reinterpret_cast<float4*>(yp + o) = v;
    return;
  }
  if (o < O) yp[o] = v.x;
  if (o + 1 < O) yp[o + 1] = v.y;
  if (o + 2 < O) yp[o + 2] = v.z;
  if (o + 3 < O) yp[o + 3] = v.w;
}

// Block-local pixel m of this block: returns its y pixel (b*Ho + i)*Wo + j,
// or -1 outside the output; *tix is the expanded-tile pixel that its tap
// (0, 0) reads (skip mode: relative to the pad, possibly negative, and only
// read for taps inside the image).
//   dense: m = (nb*TH + ti)*TW + tj over the block's NB x TH x TW pixels;
//   skip:  m = w*G + r, warp w of the block (its slot: image group x
//          position), image r of the group.
template <int BN>
__device__ __forceinline__ int decode(const Shape& s, int m, int* tix) {
  using g = Geo<BN>;
  const int bx = blockIdx.x;
  if (s.skip) {
    const int P = s.Ho * s.Wo;
    const int w = m / g::G, r = m - w * g::G;
    const int slot = bx * kWarps + warp_slot(w);
    const int ig = slot / P, pos = slot - ig * P;
    const int i = pos / s.Wo, j = pos - i * s.Wo;
    const int li = (ig - bx * kWarps / P) * g::G + r;  // image in the tile
    *tix = ((i - s.pad) * s.W + (j - s.pad)) * (s.NG * g::G) + li;
    const int b = ig * g::G + r;
    if (ig >= s.groups || b >= s.B) return -1;
    return (b * s.Ho + i) * s.Wo + j;
  }
  const int colChunks = (s.Wo + s.TW - 1) / s.TW;
  const int rowChunks = (s.Ho + s.TH - 1) / s.TH;
  const int jc = bx % colChunks, t = bx / colChunks;
  const int ic = t % rowChunks, bg = t / rowChunks;
  const int per = s.TH * s.TW;
  const int nb = m / per, rem = m - nb * per;
  const int ti = rem / s.TW, tj = rem - ti * s.TW;
  const int b = bg * s.NB + nb, i = ic * s.TH + ti, j = jc * s.TW + tj;
  *tix = (nb * s.tileH + ti) * s.tileW + tj;
  if (nb >= s.NB || b >= s.B || i >= s.Ho || j >= s.Wo) {
    *tix = 0;  // read, never written: a pixel of the tile
    return -1;
  }
  return (b * s.Ho + i) * s.Wo + j;
}

template <class Basis, int BN>
__global__ void __launch_bounds__(kThreads, 2)
    kan_conv2d_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ w_all,
                          float* __restrict__ y, const Shape s,
                          const Knots kn, const float* __restrict__ extra) {
  using g = Geo<BN>;
  constexpr int R = Basis::R;  // rows of E per channel
  constexpr int TN = g::TN, NH = g::NH;
  // steps of the reduction loop unrolled: two at 8 x 4 sums per thread,
  // where registers allow the next step's loads early (timed on the H100)
  constexpr int kUnroll = TN == 4 ? 2 : 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  __shared__ float knS[kMaxKnots];
  // slice row rr: W_all row r*C + cl, or -1; and channel cl of the chunk
  __shared__ int rowG[max_rs(R)];
  __shared__ int rowCl[max_rs(R)];

  const int RS = s.rs;
  const int RC = R * s.CC;
  float* Es = smem;                    // [tilePix][RS]: expanded, masked input
  float* Ws = smem + s.tilePix * RS;   // [2][RS][BN]: two taps' weight slices

  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int tn = lane % g::TPN;
  const int tmw = lane / g::TPN;
  // this thread's pixel q is block-local pixel mb + q * ms: in skip mode the
  // images tmw, tmw + TPW, ... of the warp's slot
  const int mb = s.skip ? warp * g::G + tmw : warp * g::TPW + tmw;
  const int ms = s.skip ? g::TPW : g::TPM;
  int base[kTM];
#pragma unroll
  for (int q = 0; q < kTM; ++q) {
    int tix;
    decode<BN>(s, mb + q * ms, &tix);
    base[q] = tix * RS;
  }

  // where the block's tile starts: skip, the first image group; dense, the
  // image, row and column of tile pixel 0 (pad included)
  int b0, h0 = 0, w0 = 0;
  const int P = s.Ho * s.Wo;
  bool warpOn = true;  // skip: the warp has a slot
  int pi = 0, pj = 0;  // skip: the warp's output position, less the pad
  if (s.skip) {
    b0 = blockIdx.x * kWarps / P * g::G;
    const int slot = blockIdx.x * kWarps + warp_slot(warp);
    warpOn = slot < s.groups * P;
    pi = (slot % P) / s.Wo - s.pad;
    pj = (slot % P) % s.Wo - s.pad;
  } else {
    const int colChunks = (s.Wo + s.TW - 1) / s.TW;
    const int rowChunks = (s.Ho + s.TH - 1) / s.TH;
    const int t = blockIdx.x / colChunks;
    w0 = (blockIdx.x % colChunks) * s.TW - s.pad;
    h0 = (t % rowChunks) * s.TH - s.pad;
    b0 = (t / rowChunks) * s.NB;
  }

  for (int rr = tid; rr < RS; rr += kThreads) {
    rowG[rr] = rr < RC ? (rr / s.CC) * s.C + rr % s.CC : -1;
    rowCl[rr] = rr % s.CC;
  }
  if constexpr (Basis::kExtras > 0) {  // the operand, read once per block
    if (tid < Basis::kExtras) knS[tid] = __ldg(extra + tid);
  } else {
    if (tid < kMaxKnots) knS[tid] = kn.v[tid];
  }
  // the row padding RC..RS-1 of every pixel stays zero for all chunks
  for (int idx = tid; idx < s.tilePix * (RS - RC); idx += kThreads)
    Es[(idx / (RS - RC)) * RS + RC + idx % (RS - RC)] = 0.0f;

  float acc[kTM][TN];
#pragma unroll
  for (int q = 0; q < kTM; ++q)
#pragma unroll
    for (int n = 0; n < TN; ++n) acc[q][n] = 0.0f;

  const int o0 = blockIdx.y * BN;
  const int taps = s.k * s.k;
  const size_t wCols = (size_t)taps * s.O;
  const int NBt = s.NG * g::G;  // skip: images of the tile

  // the slice of tap `tap` for the chunk at c0 into dst: rows r*CC + cl,
  // columns o0..o0+BN-1, zero where no weight is (padding rows, channels
  // past C, columns past O)
  auto stageW = [&](int c0, int tap, float* dst) {
    const float* src = w_all + (size_t)tap * s.O + o0;
    if (s.vecW) {
      for (int idx = tid; idx < RS * (BN / 4); idx += kThreads) {
        const int rr = idx / (BN / 4), n = (idx - rr * (BN / 4)) * 4;
        const int gr = rowG[rr];
        const bool ok = gr >= 0 && c0 + rowCl[rr] < s.C && o0 + n < s.O;
        cp_async16(dst + rr * BN + n,
                   ok ? src + (size_t)(gr + c0) * wCols + n : w_all, ok);
      }
    } else {
      for (int idx = tid; idx < RS * BN; idx += kThreads) {
        const int rr = idx / BN, n = idx - rr * BN;
        const int gr = rowG[rr];
        const bool ok = gr >= 0 && c0 + rowCl[rr] < s.C && o0 + n < s.O;
        cp_async4(dst + rr * BN + n,
                  ok ? src + (size_t)(gr + c0) * wCols + n : w_all, ok);
      }
    }
    cp_async_commit();
  };

  // the chunk at c0 of the block's tile into Es, zero off the image: a
  // thread takes a tile pixel and its CC channels, and loads them first
  auto fillE = [&](int c0) {
    for (int p = tid; p < s.tilePix; p += kThreads) {
      int b, h, w;
      if (s.skip) {  // pixel p = (h*W + w)*NBt + image
        const int hw = p / NBt;
        b = b0 + p - hw * NBt;
        h = hw / s.W;
        w = hw - h * s.W;
      } else {       // pixel p = (nb*tileH + row)*tileW + column
        const int plane = s.tileH * s.tileW;
        const int nb = p / plane, rem = p - nb * plane;
        const int pr = rem / s.tileW;
        b = b0 + nb;
        h = h0 + pr;
        w = w0 + rem - pr * s.tileW;
      }
      const bool in = b < s.B && h >= 0 && h < s.H && w >= 0 && w < s.W;
      const float* xp =
          in ? x + (((size_t)b * s.H + h) * s.W + w) * s.C + c0 : x;
      float xv[kMaxCC];
#pragma unroll
      for (int cl = 0; cl < kMaxCC; ++cl)
        xv[cl] = in && cl < s.CC && c0 + cl < s.C ? __ldg(xp + cl) : 0.0f;
      float* Ep = Es + p * RS;
#pragma unroll
      for (int cl = 0; cl < kMaxCC; ++cl) {
        if (cl >= s.CC) break;
        if (in && c0 + cl < s.C) {
          Basis::expand(xv[cl], knS, Ep, s.CC, cl);
        } else {  // the mask: E is zero on the pad, whatever the basis at 0
#pragma unroll
          for (int r = 0; r < R; ++r) Ep[r * s.CC + cl] = 0.0f;
        }
      }
    }
  };

  const int ch0 = blockIdx.z * s.nch / s.S;
  const int ch1 = (blockIdx.z + 1) * s.nch / s.S;
  for (int ch = ch0; ch < ch1; ++ch) {
    const int c0 = ch * s.CC;
    __syncthreads();  // every reader of the previous chunk is done
    stageW(c0, 0, Ws);  // in flight while the basis is computed
    fillE(c0);
    for (int tap = 0; tap < taps; ++tap) {
      cp_async_wait_all();
      __syncthreads();  // E and this tap's slice are in; the other is free
      if (tap + 1 < taps) stageW(c0, tap + 1, Ws + ((tap + 1) & 1) * RS * BN);
      const int di = tap / s.k, dj = tap - di * s.k;
      if (s.skip && !(warpOn && (unsigned)(pi + di) < (unsigned)s.H &&
                      (unsigned)(pj + dj) < (unsigned)s.W))
        continue;  // the warp's input at this tap lies on the pad
      const float* Et =
          Es + (s.skip ? (di * s.W + dj) * NBt : di * s.tileW + dj) * RS;
      const float* Wt = Ws + (tap & 1) * RS * BN + tn * 4;
      // four reduction rows per step: the weights of all four first, then
      // pixel by pixel, the next pixel's E in flight during this one's FMAs
#pragma unroll kUnroll
      for (int rr = 0; rr < RS; rr += 4) {
        float4 wv[4][NH];
#pragma unroll
        for (int u = 0; u < 4; ++u)
#pragma unroll
          for (int h = 0; h < NH; ++h)
            wv[u][h] = *reinterpret_cast<const float4*>(Wt + (rr + u) * BN +
                                                        h * g::HALF);
        float4 e = *reinterpret_cast<const float4*>(Et + base[0] + rr);
#pragma unroll
        for (int q = 0; q < kTM; ++q) {
          const float4 next =
              q + 1 < kTM ? *reinterpret_cast<const float4*>(
                                Et + base[q + 1 < kTM ? q + 1 : q] + rr)
                          : e;
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float ev = comp(e, u);
#pragma unroll
            for (int h = 0; h < NH; ++h) {
              acc[q][4 * h + 0] = fmaf(ev, wv[u][h].x, acc[q][4 * h + 0]);
              acc[q][4 * h + 1] = fmaf(ev, wv[u][h].y, acc[q][4 * h + 1]);
              acc[q][4 * h + 2] = fmaf(ev, wv[u][h].z, acc[q][4 * h + 2]);
              acc[q][4 * h + 3] = fmaf(ev, wv[u][h].w, acc[q][4 * h + 3]);
            }
          }
          e = next;
        }
      }
    }
  }

  if (s.S == 1) {
#pragma unroll
    for (int q = 0; q < kTM; ++q) {
      int tix;
      const int out = decode<BN>(s, mb + q * ms, &tix);
      if (out < 0) continue;
      float* yp = y + (size_t)out * s.O;
#pragma unroll
      for (int h = 0; h < NH; ++h)
        store4(yp, o0 + h * g::HALF + tn * 4, s.O,
               make_float4(acc[q][4 * h], acc[q][4 * h + 1],
                           acc[q][4 * h + 2], acc[q][4 * h + 3]));
    }
    return;
  }

  // channel splits: the partial tile [BM][BN] into this block's shared
  // memory, then block z sums its share over the cluster in rank order
  __syncthreads();  // every reader of Es and Ws is done
  float4* part = smem4;
#pragma unroll
  for (int q = 0; q < kTM; ++q)
#pragma unroll
    for (int h = 0; h < NH; ++h)
      part[((mb + q * ms) * BN + h * g::HALF + tn * 4) / 4] =
          make_float4(acc[q][4 * h], acc[q][4 * h + 1], acc[q][4 * h + 2],
                      acc[q][4 * h + 3]);
  cg::cluster_group cluster = cg::this_cluster();
  cluster.sync();
  constexpr int n4 = g::BM * BN / 4;
  const int z = blockIdx.z;
  for (int f = z * n4 / s.S + tid; f < (z + 1) * n4 / s.S; f += kThreads) {
    float4 v = *cluster.map_shared_rank(part + f, 0);
    for (int r = 1; r < s.S; ++r) {
      const float4 u = *cluster.map_shared_rank(part + f, r);
      v.x += u.x;
      v.y += u.y;
      v.z += u.z;
      v.w += u.w;
    }
    const int m = f / (BN / 4), n = (f - m * (BN / 4)) * 4;
    int tix;
    const int out = decode<BN>(s, m, &tix);
    if (out >= 0) store4(y + (size_t)out * s.O, o0 + n, s.O, v);
  }
  cluster.sync();  // no block leaves while another reads its partial
}

size_t smem_bytes(const Shape& s, int BN, int BM) {
  size_t bytes =
      sizeof(float) * ((size_t)s.tilePix * s.rs + 2 * (size_t)s.rs * BN);
  if (s.S > 1 && bytes < sizeof(float) * (size_t)BM * BN)
    bytes = sizeof(float) * (size_t)BM * BN;  // the partial tile
  return bytes;
}

template <class Basis, int BN>
cudaError_t launch(const float* x, const float* w_all, float* y,
                   const Shape& s, const Knots& kn, const float* extra,
                   cudaStream_t stream) {
  auto kernel = kan_conv2d_fwd_kernel<Basis, BN>;
  const size_t smem = smem_bytes(s, BN, Geo<BN>::BM);
  if (smem > kMaxSmem) return cudaErrorInvalidValue;
  // raise the dynamic shared-memory cap once per instantiation, as needed
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const dim3 grid(s.tilesM, (s.O + BN - 1) / BN, s.S);
  if (s.S == 1) {
    kernel<<<grid, kThreads, smem, stream>>>(x, w_all, y, s, kn, extra);
    return cudaGetLastError();
  }
  static bool nonPortable = false;  // clusters of more than 8 blocks
  if (s.S > 8 && !nonPortable) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (err != cudaSuccess) return err;
    nonPortable = true;
  }
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 1;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = s.S;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, w_all, y, s, kn, extra);
}

template <class Basis>
cudaError_t launch_bn(int BN, const float* x, const float* w_all, float* y,
                      const Shape& s, const Knots& kn, const float* extra,
                      cudaStream_t stream) {
  switch (BN) {
    case 16: return launch<Basis, 16>(x, w_all, y, s, kn, extra, stream);
    case 32: return launch<Basis, 32>(x, w_all, y, s, kn, extra, stream);
    case 64: return launch<Basis, 64>(x, w_all, y, s, kn, extra, stream);
    case 128: return launch<Basis, 128>(x, w_all, y, s, kn, extra, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// Launches the forward on `stream`.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a tile or basis the build does not carry.
// The Python wrapper chooses the tile (kernels/kan_conv2d.py,
// launch_config: BN; skip; dense TH/TW/NB or skip NG; CC; S) and validates
// every tensor before calling.  The basis: its parameters (the knots, or
// the clamp bounds), their count, its order (spline order or degree), its
// code (kan_basis.cuh, with_basis) and the device pointer of its operand
// (Gram's beta; NULL for a basis without one).
int kan_conv2d_fwd(const void* x, const void* w_all, void* y, int B, int H,
                   int W, int C, int O, int k, int pad, int BN, int skip,
                   int TH, int TW, int NB, int NG, int CC, int S,
                   const float* params, int n_params, int order, int basis,
                   const void* extra, void* stream) {
  Shape s = {};
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.k = k; s.pad = pad;
  s.Ho = H + 2 * pad - k + 1;
  s.Wo = W + 2 * pad - k + 1;
  s.skip = skip; s.TH = TH; s.TW = TW; s.NB = NB; s.NG = NG;
  s.CC = CC; s.S = S;
  // R*CC rounded up to a multiple of 4 floats with an odd number of
  // float4s, so neighbouring pixels' float4 loads fall in different banks
  const int R = basis_rows(basis, n_params, order);
  const int NE = basis_extras(basis, n_params, order);
  s.rs = row_stride(R, CC);
  s.vecW = O % 4 == 0 && reinterpret_cast<uintptr_t>(w_all) % 16 == 0;
  Knots kn;
  if (s.Ho <= 0 || s.Wo <= 0 || CC < 1 || CC > kMaxCC || R < 1 ||
      (NE > 0) != (extra != nullptr) ||
      s.rs > max_rs(R) || !load_knots(params, n_params, &kn) ||
      (BN != 16 && BN != 32 && BN != 64 && BN != 128))
    return (int)cudaErrorInvalidValue;
  s.nch = (C + CC - 1) / CC;
  if (S < 1 || S > kMaxSplits || S > s.nch) return (int)cudaErrorInvalidValue;
  const int TN = BN == 16 ? 4 : 8;
  const int BM = kThreads / (BN / TN) * kTM;
  const int G = 32 / (BN / TN) * kTM;
  if (skip) {
    // NG must hold every image group that the 8 warp slots of a block reach
    const int P = s.Ho * s.Wo;
    s.groups = (B + G - 1) / G;
    int need = 1;
    for (int b = 0; b < P; ++b) {
      const int lo = b * kWarps / P, hi = (b * kWarps + kWarps - 1) / P;
      if (hi - lo + 1 > need) need = hi - lo + 1;
    }
    if (need > s.groups) need = s.groups;
    if (NG < need) return (int)cudaErrorInvalidValue;
    s.tilePix = NG * G * H * W;
    s.tilesM = (s.groups * P + kWarps - 1) / kWarps;
  } else {
    if (TH < 1 || TW < 1 || NB < 1 || NB * TH * TW > BM)
      return (int)cudaErrorInvalidValue;
    s.tileH = TH + k - 1;
    s.tileW = TW + k - 1;
    s.tilePix = NB * s.tileH * s.tileW;
    s.tilesM = ((B + NB - 1) / NB) * ((s.Ho + TH - 1) / TH) *
               ((s.Wo + TW - 1) / TW);
  }
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w_all);
  float* yp = static_cast<float*>(y);
  const float* ep = static_cast<const float*>(extra);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_basis(basis, n_params, order, [&](auto b) {
    return launch_bn<decltype(b)>(BN, xp, wp, yp, s, kn, ep, st);
  });
}

}  // extern "C"
