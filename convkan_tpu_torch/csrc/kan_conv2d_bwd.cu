// kan_conv2d_bwd — KAN convolution backward for Hopper (sm_90a), over the
// per-channel basis policies of kan_basis.cuh (B-spline with its base path,
// Chebyshev without one, Gram with a learnable operand and a base path).
//
// Replaces the Pallas TPU kernel convkan_tpu/kernels/wide_kan_conv.py,
// _make_core -> bwd_kernel (run_bwd, the custom_vjp backward of the wide
// KAN conv).  The forward is csrc/kan_conv2d_fwd.cu; the function is
//   y[b,i,j,o] = sum_{di,dj} sum_r E[b,i+di,j+dj,r] * W_all[r, (di*k+dj)*O+o]
//   E = [P_0(x) .. P_{K-1}(x)(, act(x))] (R rows per channel) on the
//   zero-padded frame, zero on the pad AFTER expansion; W_all rows kk*C + c,
//   columns tap-major.
// Given g = dL/dy (B, Ho, Wo, O) this file computes, as three kernels:
//
//   * kan_conv2d_bwd_dx: the data gradient.  For every interior input pixel
//     p and channel c,
//       dE[p, kk*C+c] = sum_taps sum_o g[p - tap + pad, o] * W_all[kk*C+c, tap*O+o]
//     (a transposed convolution, reduction k*k*O), and in the epilogue
//       dx[p, c] = sum_r dE[p, r*C+c] * E'_r(x)       (Basis::grad)
//     dE lives only in registers: a thread owns ONE channel of a few
//     pixels and keeps all R of its dE values, so the chain rule through
//     the basis runs in the same thread.  Pad pixels need no dE (the mask
//     zeroes them), so only interior pixels are computed.  For the B-spline
//     B' is the derivative of the forward's Cox-de Boor recurrence carried
//     along with it (the degree-0 indicator has derivative 0), and act' is
//     computed from x: no act(x) tensor is materialized; for Chebyshev T'_n
//     is carried along the recurrence, times tanh' inside the clamp.
//     A basis with a learnable operand (Gram's beta, the Pallas kernel's
//     extras) also needs its gradient, dbeta[j] = sum over every interior
//     (pixel, c) of sum_r dE[p, r*C+c] * dE_r/dbeta[j]
//     (Basis::grad_extra): the epilogue already holds dE, so each thread
//     sums its pixels' terms, the block sums its threads' in a fixed order
//     (warp shuffles, then the warps in order) and writes one partial row
//     per block; the reduction below sums the rows.  The first conv, whose
//     input is the image, launches this kernel with dx = NULL for the
//     operand's gradient alone.
//   * kan_conv2d_bwd_dw: the weight gradient, in partial sums.
//       dW[r, tap*O+o] = sum_{b,i,j} E[b, i+di, j+dj, r] * g[b, i, j, o]
//     written as a sum over interior input pixels p of E[p, r] * dZ[p, n],
//     dZ[p, tap*O+o] = g[p - tap + pad, o] (zero off the output frame).  E is
//     recomputed per pixel chunk in shared memory (never stored to global
//     memory); a block owns the R*CC rows of CC whole channels x a
//     BN-column tile of dW and one of S contiguous batch splits, and
//     writes its partial sum.
//   * kan_conv2d_bwd_dw_reduce: dW (and dbeta) = sum over the S partials
//     in a fixed order, the shared kernel of csrc/ordered_sum.cuh (a thread owns a
//     float4 of columns; S is cut into leaves summed by the thread rows of a
//     block and the ranks of a thread-block cluster where N is small,
//     combined in row order, then rank order).  With the fixed split and
//     the fixed orders, two runs give bit-identical dW (no atomics
//     anywhere).
//
// What bounds it on the H100: arithmetic, as in the forward.  dx and dW each
// cost 2 * (interior pixel, tap) pairs * R*C * O FLOPs, the forward's
// count (about 0.36 GFLOP per image each over B-spline KAN-VGG16_small), on
// float32
// operands outside the tensor cores (67 TFLOP/s); bytes are a few MB per
// layer.  What the design does about it:
//   * dx: a block of 256 pixels x 8 channels; a thread keeps ONE channel's
//     R dE values for 8 pixels (72 sums at the B-spline's R = 9, 32 at
//     Chebyshev's 4); the g tile of a chunk of 8
//     output channels and the weight slices of all k*k taps are staged with
//     16-byte cp.async, double-buffered across chunks (one barrier per
//     chunk); per tap and pair of output channels a thread loads 8 float2s
//     of g and 9 of W for 8 x 9 x 2 = 144 FMAs.  Where the plane has at most
//     16 pixels, a warp holds one position of 32 images and skips the taps
//     whose g lies off the plane (no pad pair computed).
//   * dW: each thread keeps ONE input channel's R expanded rows x 8
//     columns of sums (72 at R = 9) in registers; per pixel the channel's R
//     E values (float4s and single floats, the same address for every
//     thread of that channel) and two float4s of dZ feed 8R FMAs.  Rows are whole
//     channels, so no row is padded.  The column tile BN is a multiple of 8
//     that divides k*k*O where it can (144 at O = 16, 2 x 144 at O = 32,
//     3 x 192 at O = 64, 6 x 192 at O = 128: no padded column), as wide as
//     the block's threads cover: the basis (with its IEEE divides, the
//     costliest part per value) is recomputed once per column tile, and
//     for the B-spline only the ORDER+1 bases that can be non-zero at x are
//     evaluated (bspline_span of kan_basis.cuh: 12 divides instead of 54
//     for grid 5, order 3).  A block has CC*BN/8 threads rounded up to whole warps; where
//     that fills at most half of 256 (few channels, as in the first conv:
//     3 x 18 threads), PW = 256 / (CC*BN/8) copies of it split each chunk's
//     pixels and are summed in shared memory in slice order at the end (one
//     launch, a fixed order).  dZ is gathered one float4 (one tap, 4 output
//     channels) per load when O % 4 == 0.
// Later work, in order: for dW, a haloed g tile per chunk shared by the
// taps and double-buffered with cp.async, skipping pad pairs, fusing the
// reduction into the weight kernel (once its own split is redesigned); for
// both, tensor cores (3xTF32 wgmma) and only the ORDER+1 non-zero basis rows
// per value.
//
// Numerics: the basis values come from kan_basis.cuh, the forward's own
// code (explicitly rounded float32 operations, true IEEE divides, accurate
// tanhf and expf), so the E recomputed here is bit-identical to the
// forward's for finite x.  Build WITHOUT --use_fast_math.
//
// Interface: plain C entry points loaded with ctypes.  Each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cp_async.cuh"
#include "kan_basis.cuh"
#include "ordered_sum.cuh"

namespace {

using namespace kan;

constexpr int kThreads = 256;
constexpr int kDxTM = 8;                      // dx: pixels per thread
constexpr int kDxLanes = 8;                   // dx: channel lanes (CC <= 8)
constexpr int kDxSlots = kThreads / kDxLanes;  // dx: pixel slots
constexpr int kDxPixels = kDxSlots * kDxTM;   // dx: pixels per block
constexpr int kDxGroup = 32;                  // dx skip: images per warp
constexpr int kDwMaxThreads = 256;  // dW: threads of a block at most
constexpr int kDwTN = 8;            // dW: columns per thread (two float4s)

struct DxShape {
  int B, H, W, C, O, k, pad, Ho, Wo;
  int skip;          // 1: a warp per (position, 32 images), pad taps skipped
  int lw, lth, lp;   // dense: log2 of Wv (W rounded up to a power of two),
                     // of TH (rows per image slot), of P = TH*Wv slots
  int NB, NBt;       // dense: image slots (NB*P = 256, or 128..32 with the
                     // block's other pixels idle), planes of the tile
  int NG;            // skip: groups of 32 images whose g planes are staged
  int lcc, loc;      // log2 of CC (channels per block), of OC/4 (float4s of
                     // output channels per chunk)
  int stages;        // chunks staged at once: 2 (double-buffered) or 1
  int table;         // 1: the g tile's offsets in a table built once per
                     // block; 0 (large kernels at the edge of shared
                     // memory): counted again at every chunk
  int tileR, tileC;  // g tile radices: dense TH' + k - 1, W + k - 1 (TH' =
                     // min(TH, H)); skip Wo, NG*32
  int tilePix;       // g pixels staged per chunk
  int tilePitch;     // g pixels per float4 of output channels: tilePix and
                     // what slots past the image read (dense)
  int rowChunks;     // dense: row tiles per image
  int groups;        // skip: image groups, ceil(B / 32)
  int tilesM;        // blocks along the pixels (grid x)
  int dq[8];         // tile pixels from a thread's pixel q = 0 to pixel q
};

struct DwShape {
  int B, H, W, C, O, k, pad, Ho, Wo;
  int CC, BN, P, S, ips;  // channels, columns, pixels per chunk, splits,
                          // images per split
  int PW, threads;        // pixel slices; PW*CC*BN/8 in whole warps
};

// dW: floats per channel of an expanded pixel, R rounded up to float4s
__host__ __device__ constexpr int dw_channel_stride(int R) {
  return (R + 3) / 4 * 4;
}

// ------------------------------------------------------------ data gradient
// skip mode: the slot of warp w among its block's 8 (w < 4: w; else
// 4 + ((w - 4) ^ 1)).  Warps w and w + 4 share an SM sub-partition; on a
// 4x4 plane, whose block holds two rows of positions, a corner (4 taps)
// then shares with a centre position (9) and an edge (6) with an edge: at
// most 13 taps per sub-partition, not 15.
__device__ __forceinline__ int dx_warp_slot(int w) { return w ^ (w >> 2); }

// A pixel p = (d2*tileR + d1)*tileC + d0 of the g tile: dense (plane, row,
// column), skip (output row, output column, image); stepped by a fixed
// number of pixels by addition (the divides are in the constructor only).
struct TilePixel {
  int d0, d1, d2, s0, s1, s2;
  __device__ TilePixel(const DxShape& s, int p, int step) {
    d0 = p % s.tileC;
    d1 = p / s.tileC;
    d2 = d1 / s.tileR;
    d1 -= d2 * s.tileR;
    s0 = step % s.tileC;
    const int s12 = step / s.tileC;
    s2 = s12 / s.tileR;
    s1 = s12 - s2 * s.tileR;
  }
  __device__ __forceinline__ void next(const DxShape& s) {
    d0 += s0;
    if (d0 >= s.tileC) { d0 -= s.tileC; ++d1; }
    d1 += s1;
    if (d1 >= s.tileR) { d1 -= s.tileR; ++d2; }
    d2 += s2;
  }
  // g element offset of the pixel for the block at image b0, row i0, or -1
  // (zero: off the output frame or past the batch)
  __device__ __forceinline__ int offset(const DxShape& s, int b0,
                                        int i0) const {
    const int b = b0 + (s.skip ? d0 : d2);
    const int oi = s.skip ? d2 : i0 + s.pad - (s.k - 1) + d1;
    const int oj = s.skip ? d1 : s.pad - (s.k - 1) + d0;
    return b < s.B && (unsigned)oi < (unsigned)s.Ho &&
                   (unsigned)oj < (unsigned)s.Wo
               ? ((b * s.Ho + oi) * s.Wo + oj) * s.O
               : -1;
  }
};

// The dx element of thread pixel q (channel c) of the block, or -1 where
// the pixel is idle or off the image; the epilogue's pixel layout.
__device__ __forceinline__ long long dx_pixel(const DxShape& s, int q, int pm,
                                              int b0, int i0, int slot0,
                                              int tid, int c) {
  int b, i, j;
  if (s.skip) {
    const int P = s.H * s.W;
    const int slot = slot0 + dx_warp_slot(tid >> 5);
    const int ig = slot / P, pos = slot - ig * P;
    if (slot >= s.groups * P) return -1;
    i = pos / s.W;
    j = pos - i * s.W;
    b = ig * kDxGroup + (pm & 3) + 4 * q;
  } else {
    const int m = pm + kDxSlots * q;
    b = b0 + (m >> s.lp);
    i = i0 + ((m >> s.lw) & ((1 << s.lth) - 1));
    j = m & ((1 << s.lw) - 1);
    if ((m >> s.lp) >= s.NBt || i - i0 >= s.tileR - (s.k - 1)) return -1;
  }
  if (b >= s.B || i >= s.H || j >= s.W) return -1;
  return (((long long)b * s.H + i) * s.W + j) * s.C + c;
}

// Block: 256 input pixels x CC channels (CC <= 8, a power of two), grid y
// over the channel blocks.  Thread t is pixel slot pm = t >> 3 and channel
// lane tn = t & 7 (lanes tn >= CC idle): it owns channel c0 + tn of the
// block's pixels m = pm + 32q, q = 0..7, and keeps their 8 x R dE sums in
// registers.  The 256 pixel slots are laid out so that pixel q lies a
// block-uniform dq[q] tile pixels after pixel 0 (kernel arguments: the
// loads need one address register per thread, not eight):
//   dense: NB image slots x TH rows x Wv columns, Wv = W and TH rounded up
//     to powers of two (slots past the image idle; none on VGG16_small), m =
//     (nb*TH + r)*Wv + c; NB*TH*Wv = 256, or for large kernels 128, 64 or 32
//     (a smaller haloed tile; pixels m past the layout idle, dq 0); g is
//     staged as the haloed tile of the rows (NBt
//     planes of (min(TH, H) + k - 1) x (W + k - 1) pixels, zero off the
//     output frame), and tap (di, dj) of a pixel reads the tile di*tileC + dj
//     pixels before its tap-(0, 0) entry;
//   skip (planes of at most 16 pixels; the fallback of large kernels):
//     warp w holds ONE input position of 32 images (slot = 8*block +
//     dx_warp_slot(w) enumerates (image group, position)), pixel slot a =
//     pm & 3 images a, a+4, ..., a+28; g is staged as the whole output
//     planes of the block's NG groups of 32 images, position-major,
//     image-minor, without a halo, and a warp skips the taps whose g lies
//     off the output plane: uniform over the warp, so no pad pair is
//     computed.
// Output channels are staged OC at a time (two float4s; one for O = 4 or a
// fallback tile): the g tile as [o4][pixel] float4s and the weight slices
// of all k*k taps as [tap][r][o4][channel] float4s, so that a warp's four
// pixel slots read four neighbouring float4s of g and its eight lanes eight
// neighbouring float4s of W (no bank conflict; each a broadcast).  Every
// staged float4 is one 16-byte cp.async (zero-fill off the frame and past
// O); chunk n+1 is in flight while chunk n is consumed (double-buffered,
// one barrier per chunk).  Per tap and pair of output channels a thread
// loads 8 float2s of g and R of W for 8 x R x 2 FMAs (144 at R = 9): the
// same bytes
// per FMA as float4 loads with half the operand registers live, within the
// 128 registers that two blocks of 256 threads per SM allow (the float4
// form measured slower on the H100).
// Index work: the g tile's table and each warp's valid taps are built once
// per block, the pixel layouts decode by shifts, the staging loops advance
// pointers by addition and the tap loop multiplies: no divide in any loop.
// Without the TABLE (large kernels, where its int per pixel does not fit),
// each staging thread steps a TilePixel set up once per block instead.
template <class Basis, bool TABLE>
__global__ void __launch_bounds__(kThreads, 2)
    kan_conv2d_bwd_dx_kernel(const float* __restrict__ x,
                             const float* __restrict__ w_all,
                             const float* __restrict__ g,
                             float* __restrict__ dx, const DxShape s,
                             const Knots kn, const float* __restrict__ extra,
                             float* __restrict__ dextra) {
  constexpr int K1 = Basis::R;  // rows of E per channel
  extern __shared__ float4 smem4[];
  __shared__ float knS[kMaxKnots];

  const int k = s.k;
  const int T = k * k;
  const int lcc = s.lcc, loc = s.loc;
  const int CC = 1 << lcc, OC4 = 1 << loc;
  const int gF4 = s.tilePitch << loc;             // float4s of a g chunk
  const int stageF4 = gF4 + ((T * K1) << (lcc + loc));  // ... and weights
  int* gOff = reinterpret_cast<int*>(smem4 + s.stages * stageF4);
  // TABLE [tilePix]: g element offset of tile pixel p, or -1 (zero)
  const int tapWords = (T + 31) >> 5;
  unsigned* tapOk =
      reinterpret_cast<unsigned*>(gOff + (TABLE ? s.tilePix : 0));
  // skip: [8][tapWords]: bit tap of warp w's words, g on the output plane

  const int tid = threadIdx.x;
  const int tn = tid & (kDxLanes - 1);
  const int pm = tid >> 3;
  const int c0 = blockIdx.y << lcc;
  const int P = s.H * s.W;

  // where the block's pixels are: dense, images b0.. and rows i0..; skip,
  // the warp slots 8*blockIdx.x.. over (image group, position)
  int b0, i0 = 0, gbase;  // gbase: the tile pixel of pixel q = 0, tap (0, 0)
  const int slot0 = blockIdx.x * (kThreads / 32);
  const int igB = slot0 / P;
  if (s.skip) {
    b0 = igB * kDxGroup;
    const int slot = slot0 + dx_warp_slot(tid >> 5);  // this warp's
    const int ig = slot / P, pos = slot - ig * P, i = pos / s.W;
    const int iw = slot < s.groups * P ? i + s.pad : -s.Ho;  // off-plane
    const int jw = pos - i * s.W + s.pad;
    gbase = (iw * s.Wo + jw) * s.tileC + (ig - igB) * kDxGroup + (pm & 3);
    if ((tid & 31) == 0) {
      unsigned* bits = tapOk + (tid >> 5) * tapWords;
      for (int w = 0; w < tapWords; ++w) bits[w] = 0u;
      for (int di = 0, tap = 0; di < k; ++di)
        for (int dj = 0; dj < k; ++dj, ++tap)
          if ((unsigned)(iw - di) < (unsigned)s.Ho &&
              (unsigned)(jw - dj) < (unsigned)s.Wo)
            bits[tap >> 5] |= 1u << (tap & 31);
    }
  } else {
    const int bg = blockIdx.x / s.rowChunks;
    b0 = bg * s.NB;
    i0 = (blockIdx.x - bg * s.rowChunks) << s.lth;
    const int nb = pm >> s.lp, r = (pm >> s.lw) & ((1 << s.lth) - 1);
    gbase = (nb * s.tileR + r + k - 1) * s.tileC + (pm & ((1 << s.lw) - 1)) +
            k - 1;
  }
  if (TABLE) {  // the g tile's table: pixels tid, tid + 256, ...
    TilePixel px(s, tid, kThreads);
    for (int p = tid; p < s.tilePix; p += kThreads, px.next(s))
      gOff[p] = px.offset(s, b0, i0);
  }
  // without the table: this thread's first g pixel of every chunk
  const TilePixel gPix(s, tid >> loc, kThreads >> loc);
  if (tid == 0) {
#pragma unroll
    for (int i = 0; i < kMaxKnots; ++i) knS[i] = kn.v[i];
  }

  // chunk of output channels oc0 .. oc0 + 4*OC4 - 1 into buf: g float4 o4
  // of tile pixel p at buf[o4*tilePitch + p]; W_all row kk*C + c0 + cl (kk
  // < R = K1),
  // columns tap*O + oc0 + 4*o4 .. +3 at buf[gF4 + ((tap*K1 + kk)*OC4 +
  // o4)*CC + cl]
  const size_t wCols = (size_t)T * s.O;
  auto stage = [&](int oc0, float4* buf) {
    {
      const int o4 = tid & (OC4 - 1), oo = oc0 + 4 * o4, step = kThreads >> loc;
      const bool colOk = oo < s.O;
      const float* src = g + (colOk ? oo : 0);
      float4* dst = buf + o4 * s.tilePitch + (tid >> loc);
      if (TABLE) {
        const int* offp = gOff + (tid >> loc);
        const int* const end = gOff + s.tilePix;
#pragma unroll 1
        for (; offp < end; offp += step, dst += step) {
          const int off = *offp;
          const bool ok = off >= 0 && colOk;
          cp_async16(dst, src + (ok ? off : 0), ok);
        }
      } else {
        TilePixel px = gPix;
#pragma unroll 1
        for (int p = tid >> loc; p < s.tilePix;
             p += step, dst += step, px.next(s)) {
          const int off = px.offset(s, b0, i0);
          const bool ok = off >= 0 && colOk;
          cp_async16(dst, src + (ok ? off : 0), ok);
        }
      }
    }
    // thread e < K1*CC*OC4 (<= 256: the C entry checks) copies entry e =
    // (kk*OC4 + o4)*CC + cl of every tap's slice
    const int lr = lcc + loc;
    if (tid < (K1 << lr)) {
      const int cl = tid & (CC - 1), o4 = (tid >> lcc) & (OC4 - 1);
      const int kk = tid >> lr, oo = oc0 + 4 * o4;
      const bool ok = c0 + cl < s.C && oo < s.O;
      const float* src =
          ok ? w_all + (size_t)(kk * s.C + c0 + cl) * wCols + oo : w_all;
      float4* dst = buf + gF4 + tid;
#pragma unroll 1
      for (int tap = 0; tap < T; ++tap) {
        cp_async16(dst, src, ok);
        dst += K1 << lr;
        src += ok ? s.O : 0;
      }
    }
    cp_async_commit();
  };

  float acc[kDxTM][K1];
#pragma unroll
  for (int q = 0; q < kDxTM; ++q)
#pragma unroll
    for (int kk = 0; kk < K1; ++kk) acc[q][kk] = 0.0f;

  // tile pixels between taps: one tap row, one tap column
  const int sR = s.skip ? s.tileR * s.tileC : s.tileC;
  const int sC = s.skip ? s.tileC : 1;
  const int nChunks = (s.O + (4 << loc) - 1) >> (loc + 2);
  __syncthreads();  // the table is in
  stage(0, smem4);
  for (int n = 0; n < nChunks; ++n) {
    cp_async_wait_all();
    __syncthreads();  // chunk n is in; every reader of the other buffer done
    const float4* cur = smem4 + (n & (s.stages - 1)) * stageF4;
    if (s.stages == 2 && n + 1 < nChunks)
      stage((n + 1) << (loc + 2), smem4 + ((n + 1) & 1) * stageF4);
    // idle lanes (tn >= CC) read lane tn & (CC - 1)'s slices: every read
    // stays inside the staged chunk
    const float4* Wl = cur + gF4 + (tn & (CC - 1));
    for (int di = 0, tap = 0; di < k; ++di) {
      for (int dj = 0; dj < k; ++dj, ++tap) {
        if (s.skip &&
            !((tapOk[(tid >> 5) * tapWords + (tap >> 5)] >> (tap & 31)) & 1u))
          continue;  // the warp's g at this tap lies off the plane
        const float4* Gq = cur + gbase - (di * sR + dj * sC);
        for (int o4 = 0; o4 < OC4; ++o4) {
          const float4* Gt = Gq + o4 * s.tilePitch;
          const float4* Wt = Wl + ((tap * K1) << (lcc + loc)) + (o4 << lcc);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float2* Gt2 = reinterpret_cast<const float2*>(Gt) + hf;
            const float2* Wt2 = reinterpret_cast<const float2*>(Wt) + hf;
            float2 gv[kDxTM];
#pragma unroll
            for (int q = 0; q < kDxTM; ++q) gv[q] = Gt2[2 * s.dq[q]];
#pragma unroll
            for (int kk = 0; kk < K1; ++kk) {
              const float2 wv = Wt2[2 * (kk << (lcc + loc))];
#pragma unroll
              for (int q = 0; q < kDxTM; ++q) {
                acc[q][kk] = fmaf(gv[q].x, wv.x, acc[q][kk]);
                acc[q][kk] = fmaf(gv[q].y, wv.y, acc[q][kk]);
              }
            }
          }
        }
      }
    }
    if (s.stages == 1 && n + 1 < nChunks) {
      __syncthreads();  // every reader of the one buffer is done
      stage((n + 1) << (loc + 2), smem4);
    }
  }

  if constexpr (Basis::kExtras > 0) {
    // epilogue: dx (where it is stored) and the operand's gradient terms,
    // summed over the block in a fixed order into its partial row; the
    // operand (a few floats) in registers
    constexpr int NE = Basis::kExtras;
    float op[NE], de[NE];
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      op[e] = __ldg(extra + e);
      de[e] = 0.0f;
    }
    const int c = c0 + tn;
    if (tn < CC && c < s.C) {
#pragma unroll
      for (int q = 0; q < kDxTM; ++q) {
        const long long at = dx_pixel(s, q, pm, b0, i0, slot0, tid, c);
        if (at < 0) continue;
        const float v = Basis::grad_extra(__ldg(&x[at]), op, acc[q], de);
        if (dx != nullptr) dx[at] = v;
      }
    }
    __syncthreads();  // every reader of the staged chunks is done
    float* red = reinterpret_cast<float*>(smem4);  // [warp][NE]
#pragma unroll
    for (int e = 0; e < NE; ++e) {
      float v = de[e];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if ((tid & 31) == 0) red[(tid >> 5) * NE + e] = v;
    }
    __syncthreads();
    if (tid < NE) {
      float v = red[tid];
      for (int w = 1; w < kThreads / 32; ++w) v += red[w * NE + tid];
      dextra[((size_t)blockIdx.y * gridDim.x + blockIdx.x) * NE + tid] = v;
    }
    return;
  }

  // epilogue: the chain rule through the basis (and the base activation)
  const int c = c0 + tn;
  if (tn >= CC || c >= s.C) return;
  // pixel q: skip, image bq + 4q at (iq, jq); dense, slot m = pm + 32q
  int bq = 0, iq = 0, jq = 0;
  bool slotOn = true;
  if (s.skip) {
    const int slot = slot0 + dx_warp_slot(tid >> 5);
    const int ig = slot / P, pos = slot - ig * P;
    iq = pos / s.W;
    jq = pos - iq * s.W;
    bq = ig * kDxGroup + (pm & 3);
    slotOn = slot < s.groups * P;
  }
#pragma unroll
  for (int q = 0; q < kDxTM; ++q) {
    int b, i, j;
    if (s.skip) {
      b = bq + 4 * q;
      i = iq;
      j = jq;
    } else {
      const int m = pm + kDxSlots * q;
      b = b0 + (m >> s.lp);
      i = i0 + ((m >> s.lw) & ((1 << s.lth) - 1));
      j = m & ((1 << s.lw) - 1);
      if ((m >> s.lp) >= s.NBt || i - i0 >= s.tileR - (k - 1)) continue;
    }
    if (!slotOn || b >= s.B || i >= s.H || j >= s.W) continue;
    const size_t at = (((size_t)b * s.H + i) * s.W + j) * s.C + c;
    dx[at] = Basis::grad(__ldg(&x[at]), knS, acc[q]);
  }
}

// ---------------------------------------------------------- weight gradient
// Block (channel chunk, column tile, split): channels c0..c0+CC-1, columns
// n0..n0+BN-1 of the k*k*O tap-major columns, images [split*ips,
// split*ips + ips), summed over their interior pixels in chunks of P.
// Thread t is pixel slice t / (CC*G) (G = BN/8 column groups), channel
// cl = t % CC and column group tn = (t / CC) % G of the slice: it keeps
// channel cl's R expanded rows x columns {tn*4 .. tn*4+3, BN/2 + tn*4 ..
// BN/2 + tn*4+3} in registers and sums pixels slice, slice + PW, ... of
// each chunk.  The PW slices' tiles are added in slice order at the end.
template <class Basis>
__global__ void __launch_bounds__(kDwMaxThreads, 2)
    kan_conv2d_bwd_dw_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             float* __restrict__ partial, const DwShape s,
                             const Knots kn, const float* __restrict__ extra) {
  constexpr int K1 = Basis::R;  // rows of E per channel
  constexpr int ES = dw_channel_stride(K1);
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int RS = ES * s.CC;  // floats per expanded pixel
  __shared__ float knS[kMaxKnots];
  float* Es = smem;                    // [P][CC][ES]: expanded input
  float* Zs = Es + s.P * RS;           // [P][BN]: g gathered per column
  int* pixB = reinterpret_cast<int*>(Zs + s.P * s.BN);  // [P], -1: none
  int* pixH = pixB + s.P;
  int* pixW = pixH + s.P;

  const int c0 = blockIdx.x * s.CC;
  const int n0 = blockIdx.y * s.BN;
  const int split = blockIdx.z;
  const int k = s.k;
  const int TO = k * k * s.O;
  const int HW = s.H * s.W;

  const int tid = threadIdx.x;
  const int CG = s.CC * (s.BN / kDwTN);  // threads of one pixel slice
  const int slice = tid / CG;
  const int cl = (tid - slice * CG) % s.CC;
  const int tn = (tid - slice * CG) / s.CC;
  const bool active = slice < s.PW;
  const int halfBN = s.BN / 2;

  // the gather: VW consecutive columns per load (a float4 of one tap's
  // output channels when O % 4 == 0), column n0 + fq*VW, pixels fp0,
  // fp0 + fpStep, ... (BN / VW <= threads: the C entry checks)
  const int VW = s.O % 4 == 0 ? 4 : 1;
  const int Q = s.BN / VW;
  const int fpStep = s.threads / Q;
  const int fq = tid % Q;
  const int fp0 = tid < fpStep * Q ? tid / Q : s.P;
  const int ng = n0 + fq * VW;
  const bool colOk = ng < TO;
  const int ftap = colOk ? ng / s.O : 0;
  const int fo = ng - ftap * s.O;
  const int fdi = ftap / k, fdj = ftap - (ftap / k) * k;

  if constexpr (Basis::kExtras > 0) {  // the operand, read once per block
    if (tid < Basis::kExtras) knS[tid] = __ldg(extra + tid);
  } else {
    if (tid < kMaxKnots) knS[tid] = kn.v[tid];
  }

  float acc[K1][kDwTN];
#pragma unroll
  for (int i = 0; i < K1; ++i)
#pragma unroll
    for (int j = 0; j < kDwTN; ++j) acc[i][j] = 0.0f;

  const int bLo = split * s.ips;
  const int bHi = min(s.B, bLo + s.ips);
  const long long pixHi = (long long)bHi * HW;
  for (long long p0 = (long long)bLo * HW; p0 < pixHi; p0 += s.P) {
    __syncthreads();  // the previous chunk's readers are done
    for (int p = tid; p < s.P; p += s.threads) {
      const long long pg = p0 + p;
      if (pg < pixHi) {
        const int b = (int)(pg / HW);
        const int rem = (int)(pg - (long long)b * HW);
        pixB[p] = b;
        pixH[p] = rem / s.W;
        pixW[p] = rem - (rem / s.W) * s.W;
      } else {
        pixB[p] = -1;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < s.P * s.CC; idx += s.threads) {
      const int p = idx / s.CC;
      const int c = c0 + idx - p * s.CC;
      float* Ep = Es + idx * ES;  // pixel p, channel idx - p*CC
      if (pixB[p] >= 0 && c < s.C) {
        const float xv = __ldg(
            &x[(((size_t)pixB[p] * s.H + pixH[p]) * s.W + pixW[p]) * s.C + c]);
        Basis::store(xv, knS, Ep);
      } else {  // the mask: E is zero on the pad and past C
#pragma unroll
        for (int kk = 0; kk < K1; ++kk) Ep[kk] = 0.0f;
      }
    }
    for (int p = fp0; p < s.P; p += fpStep) {
      const int b = pixB[p];
      const int gi = pixH[p] + s.pad - fdi;
      const int gj = pixW[p] + s.pad - fdj;
      const bool ok = b >= 0 && colOk && gi >= 0 && gi < s.Ho && gj >= 0 &&
                      gj < s.Wo;
      const float* src =
          g + (ok ? (((size_t)b * s.Ho + gi) * s.Wo + gj) * s.O + fo : 0);
      if (VW == 4) {
        *reinterpret_cast<float4*>(Zs + p * s.BN + fq * 4) =
            ok ? __ldg(reinterpret_cast<const float4*>(src))
               : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      } else {
        Zs[p * s.BN + fq] = ok ? __ldg(src) : 0.0f;
      }
    }
    __syncthreads();
    if (active) {
      const float* Ep = Es + cl * ES;
      const float* Zp = Zs + tn * 4;
#pragma unroll 2
      for (int p = slice; p < s.P; p += s.PW) {
        // the channel's R values: float4s, then single floats
        float e[K1];
#pragma unroll
        for (int v = 0; v < K1 / 4; ++v) {
          const float4 ev =
              *reinterpret_cast<const float4*>(Ep + p * RS + 4 * v);
          e[4 * v] = ev.x;
          e[4 * v + 1] = ev.y;
          e[4 * v + 2] = ev.z;
          e[4 * v + 3] = ev.w;
        }
#pragma unroll
        for (int kk = K1 / 4 * 4; kk < K1; ++kk) e[kk] = Ep[p * RS + kk];
        const float4 za = *reinterpret_cast<const float4*>(Zp + p * s.BN);
        const float4 zb =
            *reinterpret_cast<const float4*>(Zp + p * s.BN + halfBN);
        const float z8[8] = {za.x, za.y, za.z, za.w, zb.x, zb.y, zb.z, zb.w};
#pragma unroll
        for (int i = 0; i < K1; ++i)
#pragma unroll
          for (int j = 0; j < kDwTN; ++j)
            acc[i][j] = fmaf(e[i], z8[j], acc[i][j]);
      }
    }
  }

  if (s.PW > 1) {  // slices 1..PW-1 hand their tiles to slice 0
    __syncthreads();  // the last chunk's readers are done
    float* Red = smem;  // [PW - 1][K1 * 8][CG]
    const int lt = tid - slice * CG;
    if (active && slice > 0) {
#pragma unroll
      for (int i = 0; i < K1; ++i)
#pragma unroll
        for (int j = 0; j < kDwTN; ++j)
          Red[(((slice - 1) * K1 + i) * kDwTN + j) * CG + lt] = acc[i][j];
    }
    __syncthreads();
    if (slice == 0) {
      for (int sl = 1; sl < s.PW; ++sl)
#pragma unroll
        for (int i = 0; i < K1; ++i)
#pragma unroll
          for (int j = 0; j < kDwTN; ++j)
            acc[i][j] += Red[(((sl - 1) * K1 + i) * kDwTN + j) * CG + lt];
    }
  }

  const int c = c0 + cl;
  if (slice != 0 || c >= s.C) return;
  const size_t D = (size_t)K1 * s.C;
#pragma unroll
  for (int kk = 0; kk < K1; ++kk) {
    float* dst = partial + ((size_t)split * D + (size_t)kk * s.C + c) * TO;
#pragma unroll
    for (int j = 0; j < kDwTN; ++j) {
      const int n = n0 + (j < 4 ? 0 : halfBN) + tn * 4 + (j & 3);
      if (n < TO) dst[n] = acc[kk][j];
    }
  }
}

template <typename Kernel>
cudaError_t grant_smem(Kernel kernel, size_t smem, size_t* granted) {
  // raise the dynamic shared-memory cap once per instantiation, as needed
  if (smem > *granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    *granted = smem;
  }
  return cudaSuccess;
}

// the staged chunks (g tile with what idle slots read past it, weight
// slices; OC/4 float4s per entry), the g tile's table (one int a pixel)
// and, skip, each warp's valid taps (a bit a tap)
size_t dx_smem(const DxShape& s, int R) {
  const size_t chunk = ((size_t)s.tilePitch + (size_t)s.k * s.k * R *
                                                  (1 << s.lcc)) << s.loc;
  return sizeof(float4) * s.stages * chunk +
         (s.table ? sizeof(int) * (size_t)s.tilePix : 0) +
         (s.skip ? sizeof(unsigned) * (kThreads / 32) * ((s.k * s.k + 31) / 32)
                 : 0);
}

// the staged chunk (expanded input, gathered g, pixel table), or the
// slices' tiles handed to slice 0 at the end, whichever is larger
size_t dw_smem(const DwShape& s, int R) {
  const size_t staged =
      sizeof(float) * (size_t)s.P * (dw_channel_stride(R) * s.CC + s.BN) +
      3 * sizeof(int) * (size_t)s.P;
  const size_t slices =
      sizeof(float) * (size_t)(s.PW - 1) * R * s.CC * s.BN;
  return staged > slices ? staged : slices;
}

template <class Basis, bool TABLE>
cudaError_t launch_dx(const float* x, const float* w_all, const float* g,
                      float* dx, const DxShape& s, const Knots& kn,
                      const float* extra, float* dextra,
                      cudaStream_t stream) {
  auto kernel = kan_conv2d_bwd_dx_kernel<Basis, TABLE>;
  static size_t granted = 48 * 1024;
  const size_t smem = dx_smem(s, Basis::R);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid(s.tilesM, (s.C + (1 << s.lcc) - 1) >> s.lcc);
  kernel<<<grid, kThreads, smem, stream>>>(x, w_all, g, dx, s, kn, extra,
                                           dextra);
  return cudaGetLastError();
}

template <class Basis>
cudaError_t launch_dw(const float* x, const float* g, float* partial,
                      const DwShape& s, const Knots& kn, const float* extra,
                      cudaStream_t stream) {
  auto kernel = kan_conv2d_bwd_dw_kernel<Basis>;
  static size_t granted = 48 * 1024;
  const size_t smem = dw_smem(s, Basis::R);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.C + s.CC - 1) / s.CC,
                  (s.k * s.k * s.O + s.BN - 1) / s.BN, s.S);
  kernel<<<grid, s.threads, smem, stream>>>(x, g, partial, s, kn, extra);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// log2 of v, or -1 unless v is a power of two in 1..2^30
int log2_exact(int v) {
  for (int l = 0; l <= 30; ++l)
    if (v == 1 << l) return l;
  return -1;
}

// Data gradient dx (B, H, W, C) of the KAN conv for g (B, Ho, Wo, O).
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a tile or
// basis the build does not carry (the basis arguments as the forward's).
// A basis with an operand also writes dextra: (tiles x channel blocks,
// kExtras) partial sums of its gradient, row blockIdx.y * tiles +
// blockIdx.x; dx may then be NULL (not stored).  The Python wrapper chooses the tile
// (kernels/kan_conv2d.py, dx_launch_config: skip; dense TH (rows per image
// slot) and NB (image slots), NB*TH*Wv = 256 (or 128, 64, 32 for large
// kernels) for Wv = W rounded up to a power of two, or skip NG; CC; OC;
// stages; table) and validates every tensor;
// O % 4 == 0 and w_all and g 16-byte aligned (the wrapper pads and copies).
int kan_conv2d_bwd_dx(const void* x, const void* w_all, const void* g,
                      void* dx, int B, int H, int W, int C, int O, int k,
                      int pad, int skip, int TH, int NB, int NG, int CC,
                      int OC, int stages, int table, const float* params,
                      int n_params, int order, int basis, const void* extra,
                      void* dextra, void* stream) {
  DxShape s = {};
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.k = k; s.pad = pad;
  s.Ho = H + 2 * pad - k + 1;
  s.Wo = W + 2 * pad - k + 1;
  s.skip = skip; s.NB = NB; s.NG = NG; s.stages = stages; s.table = table;
  s.lcc = CC <= 8 ? log2_exact(CC) : -1;
  s.loc = OC == 4 || OC == 8 ? log2_exact(OC / 4) : -1;
  const int K1 = basis_rows(basis, n_params, order);
  const int NE = basis_extras(basis, n_params, order);
  Knots kn;
  if (s.lcc < 0 || s.loc < 0 || (stages != 1 && stages != 2) ||
      (NE > 0) != (extra != nullptr) || (NE > 0) != (dextra != nullptr) ||
      (NE == 0 && dx == nullptr) ||
      (table != 0 && table != 1) || O % 4 != 0 || K1 < 1 ||
      (K1 << (s.lcc + s.loc)) > kThreads ||
      s.Ho <= 0 || s.Wo <= 0 || W > kDxPixels ||
      reinterpret_cast<size_t>(w_all) % 16 != 0 ||
      reinterpret_cast<size_t>(g) % 16 != 0 ||
      (long long)B * H * W * C >= (1LL << 31) ||
      (long long)B * s.Ho * s.Wo * O >= (1LL << 31) ||
      (long long)K1 * C * k * k * O >= (1LL << 31) ||
      !load_knots(params, n_params, &kn))
    return (int)cudaErrorInvalidValue;
  const int P = H * W;
  if (skip) {
    // NG must hold every image group that the 8 warp slots of a block
    // reach (as in the forward's skip tile)
    const int warps = kThreads / 32;
    s.groups = (B + kDxGroup - 1) / kDxGroup;
    int need = 1;
    for (int b = 0; b < P; ++b) {
      const int lo = b * warps / P, hi = (b * warps + warps - 1) / P;
      if (hi - lo + 1 > need) need = hi - lo + 1;
    }
    if (need > s.groups) need = s.groups;
    if (NG < need) return (int)cudaErrorInvalidValue;
    s.tileR = s.Wo;
    s.tileC = NG * kDxGroup;
    s.tilePix = s.tilePitch = s.Ho * s.Wo * s.tileC;
    s.tilesM = (s.groups * P + warps - 1) / warps;
    for (int q = 0; q < kDxTM; ++q) s.dq[q] = 4 * q;
  } else {
    int Wv = 1;
    while (Wv < W) Wv *= 2;
    s.lw = log2_exact(Wv);
    s.lth = log2_exact(TH);
    // 256 pixel slots, or (large kernels) 128, 64 or 32 with the block's
    // other pixels idle
    const int slots = NB * TH * Wv;
    if (s.lth < 0 || NB < 1 || slots > kDxPixels || slots < kDxSlots ||
        (slots & (slots - 1)) != 0 || (NB > 1 && TH < H))
      return (int)cudaErrorInvalidValue;
    s.lp = s.lw + s.lth;
    // the planes of the tile: every image slot's where pixel slots span
    // images (P < 32), else at most B (the idle slots' dq is 0)
    s.NBt = (1 << s.lp) < kDxSlots || NB < B ? NB : B;
    const int rows = TH < H ? TH : H;
    s.tileR = rows + k - 1;
    s.tileC = W + k - 1;
    s.tilePix = s.NBt * s.tileR * s.tileC;
    s.tilePitch = s.tilePix + (TH - rows) * s.tileC + (Wv - W);
    s.rowChunks = (H + TH - 1) / TH;
    s.tilesM = ((B + NB - 1) / NB) * s.rowChunks;
    for (int q = 0; q < kDxTM; ++q) {
      const int m = kDxSlots * q, nb = m >> s.lp;
      s.dq[q] = nb < s.NBt ? (nb * s.tileR + ((m >> s.lw) & (TH - 1))) *
                                     s.tileC + (m & (Wv - 1))
                           : 0;
    }
  }
  // the dynamic shared memory and the knots' static array within the 227
  // KB a block may have
  if (dx_smem(s, K1) + sizeof(float) * kMaxKnots > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w_all);
  const float* gp = static_cast<const float*>(g);
  float* dxp = static_cast<float*>(dx);
  const float* ep = static_cast<const float*>(extra);
  float* dep = static_cast<float*>(dextra);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_basis(basis, n_params, order, [&](auto b) {
    return table ? launch_dx<decltype(b), true>(xp, wp, gp, dxp, s, kn, ep,
                                                dep, st)
                 : launch_dx<decltype(b), false>(xp, wp, gp, dxp, s, kn, ep,
                                                 dep, st);
  });
}

// Weight-gradient partial sums (S, R*C, k*k*O): split s sums images
// [s*ips, min(B, s*ips + ips)).  The wrapper chooses CC/BN/P/S/ips/PW
// (dw_launch_config); g must be 16-byte aligned when O % 4 == 0.  The
// basis arguments (and operand) as the forward's.
int kan_conv2d_bwd_dw(const void* x, const void* g, void* partial, int B,
                      int H, int W, int C, int O, int k, int pad, int CC,
                      int BN, int P, int S, int ips, int PW,
                      const float* params, int n_params, int order, int basis,
                      const void* extra, void* stream) {
  DwShape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.k = k; s.pad = pad;
  s.Ho = H + 2 * pad - k + 1;
  s.Wo = W + 2 * pad - k + 1;
  s.CC = CC; s.BN = BN; s.P = P; s.S = S; s.ips = ips; s.PW = PW;
  const int K1 = basis_rows(basis, n_params, order);
  const int NE = basis_extras(basis, n_params, order);
  const long long slots = (long long)PW * CC * (BN / kDwTN);
  s.threads = (int)((slots + 31) / 32 * 32);
  const bool vec = O % 4 == 0;
  Knots kn;
  if (CC <= 0 || BN < kDwTN || BN % kDwTN != 0 || PW <= 0 ||
      slots > kDwMaxThreads || BN / (vec ? 4 : 1) > s.threads || P <= 0 ||
      S <= 0 || ips <= 0 || s.Ho <= 0 || s.Wo <= 0 || K1 < 1 ||
      (NE > 0) != (extra != nullptr) ||
      (vec && reinterpret_cast<size_t>(g) % 16 != 0) ||
      !load_knots(params, n_params, &kn) || dw_smem(s, K1) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* pp = static_cast<float*>(partial);
  const float* ep = static_cast<const float*>(extra);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return (int)with_basis(basis, n_params, order, [&](auto b) {
    return launch_dw<decltype(b)>(xp, gp, pp, s, kn, ep, st);
  });
}

// dW = the (S, N) partials summed over S in the fixed order of
// csrc/ordered_sum.cuh; VW, Gw and Gc from reduce_launch_config.
int kan_conv2d_bwd_dw_reduce(const void* partial, void* out, int S, int N,
                             int VW, int Gw, int Gc, void* stream) {
  return (int)ordered_sum::launch(partial, out, S, N, VW, Gw, Gc,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
