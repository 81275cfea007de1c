// wav_conv2d_bwd — WavKAN psi-conv backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel convkan_tpu/kernels/fused_wav_conv.py,
// _get_op -> _bwd_kernel (the custom_vjp backward of fused_wav_conv2d).
// The forward is csrc/wav_conv2d_fwd.cu; the function is
//   y[b,i,j,o] = sum_{c,di,dj} w[di,dj,c,o] * psi(z[b,i+di-pad,j+dj-pad,o,c])
//   z = (x - t[o,c]) / s[o,c],  psi := 0 on the pad (3x3 kernel).
// Given g = dL/dy (B, Ho, Wo, O) and, at an input pixel q,
//   G[q,o,c] = sum_{di,dj} g[q + pad - (di,dj), o] * w[di,dj,c,o]
// (zero off the output frame), this file computes, as three kernels:
//
//   * wav_conv2d_bwd_dx: the data gradient
//       dx[q,c] = sum_o psi'(z) * G / s
//     A thread owns 4 input channels (x and the sums as float4s) of a tile
//     of pixels (a row segment of 8, a row of 4, two rows of 2) and
//     loops over all of O: per o it loads the 9 taps' weights and the
//     scale factors of its 4 channels once and each g value of its window
//     once, so one g load feeds 4 channels' FMAs, and one exp per (pixel,
//     o, c) gives psi'.  Rows of the widths 8, 4 and 2 (the small planes,
//     where the pad taps are 8-56% of all) are unrolled with the pad taps
//     left out; g, the weights and the factors are staged per chunk of 8
//     output channels by cp.async into a double buffer (see the kernel).
//   * wav_conv2d_bwd_param: the parameter gradients, in partial sums over
//     fixed batch splits,
//       dw[di,dj,c,o] = sum_q psi(z[q]) * g[q + pad - (di,dj), o]
//       dt[o,c] = -sum_q psi'(z) * G / s
//       ds[o,c] = -sum_q psi'(z) * G * z / s
//     A thread owns one output channel o and 4 input channels (4 pairs) and
//     walks the rows of its split with a 3x3 window of g in registers (3
//     new loads per pixel serve the 4 pairs, x is one float4): one exp per
//     pair and pixel gives psi and psi', which feed 9 FMAs into dw, 9 into
//     G, and the dt / ds sums.  Rows of the widths VGG16_small has are
//     unrolled at compile time with the pad taps left out; g and x rows are
//     staged once per block by cp.async into a double-buffered ring (see
//     the kernel).  dt and ds live here, not in the data gradient, so that
//     skipping dx (the first conv) never drops them.
//   * wav_conv2d_bwd_reduce: the partials summed over the splits in a
//     fixed order, the kernel of csrc/ordered_sum.cuh that the KAN weight
//     gradient shares (leaves of splits over thread rows and cluster ranks
//     where N is small, combined in row order, then rank order).  With the
//     fixed split and the fixed orders, two runs give bit-identical dw, dt
//     and ds (no atomics anywhere).
//
// What bounds it on the H100: operations, as in the forward.  Each (input
// pixel, c, o) costs one wavelet evaluation and 9 FMAs in each of the two
// kernels (plus 9 for dw); bytes are a few MB per layer.  psi is never
// stored: both kernels recompute it from x, t and s.  In the data gradient
// the issue slots go to psi' (about 13 instructions with its exp) and the
// 9 FMAs per (pixel, o, c); the tile keeps the loads to about 1 and the pad
// taps out, and the double buffer keeps the staging off the FMAs' path.
// Later work: the data gradient recomputes psi' that the parameter kernel
// also evaluates; a fused kernel would pay one exp per triple instead of
// two.
//
// Interface: plain C entry points loaded with ctypes.  Each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "cp_async.cuh"
#include "ordered_sum.cuh"
#include "wav_psi.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 3;  // kernel size the build carries
// input channels per thread (one float4 of x), in both kernels
constexpr int kCT = 4;
// parameter kernel: its sums, and the launch bounds (threads, blocks per SM)
constexpr int kParamVals = kCT * (kK * kK + 2);
constexpr int kParamThreads = 128, kParamMinBlocks = 3;
// data gradient: the launch bounds, output channels per staged chunk, and
// floats per channel group and o in the staged weights: 9 taps, 1/s, -t/s
// and psi''s factor (float4 each), and one float4 of padding so that the 8
// groups a quarter warp reads lie in distinct banks
constexpr int kDxThreads = 128, kDxMinBlocks = 3;
constexpr int kDxOCH = 8;
constexpr int kDxGroup = 4 * (kK * kK + 4);

struct DxShape {
  int B, H, W, C, O, pad, Ho, Wo;
  int lCG, lNPB;       // log2 of the channel groups, of the tile positions
  int nSeg, nRG, nRB;  // segments per row, row groups per image, row blocks
  int NIB, NGR;        // images per block, staged g rows per image
  int imgStride;       // floats per staged image: NGR * (P + 2) * 8 + 4
  int gBuf, wStride;   // floats of g per buffer; of weights per o
  int bufStride, nCh;  // floats per buffer; chunks of kDxOCH output channels
  int xVec, gVec;      // 16-byte loads of x (C % 4 == 0), of g (O % 4 == 0)
};

struct ParamShape {
  int B, H, W, C, O, pad, Ho, Wo;
  int lOC, lCG;        // log2 of the lanes (output channels), channel groups
  int RS, RB, S, ips;  // row slots, rows per step, splits, images per split
  int HV, uoff, goff;  // virtual rows per image: input row h at uoff + h,
                       // g row oh at goff + oh
  int gCols, gCol0;    // staged g columns per row, the first one's ow
  int NR;              // g rows in the ring
  int gVec, xVec;      // 16-byte copies of g (O % 4 == 0), of x (C % 4 == 0)
  size_t N;            // floats per split: 9*C*O + 2*O*C
};

// ------------------------------------------------------------ data gradient
// Block (image block, row segment, row block; channel tile) of 4 warps: lane
// cg + CG * il of warp wp holds channel group cg (kCT = 4 input channels c0
// = cT0 + 4 cg .. + 3) of image ib * NIB + il + (32 / CG) * (wp >> lNPB) at
// tile position (row group) rb * NPB + (wp & (NPB - 1)).  A thread keeps x
// and the dx sums of a tile of RT rows x P pixels of its 4 channels in
// registers (float4s) and walks all of O in chunks of kDxOCH: per o, 12
// float4 loads (9 taps' weights, 1/s, -t/s, psi''s factor) and one g value
// per tile column and row, each feeding the 4 channels' FMAs.  A warp's
// lanes share one tile position, so its row mask is uniform, and read g of
// 32 / CG images at once, in distinct banks (image stride / 4 odd).  Each
// block sums over all of O in one fixed order: no atomics, no second pass.
//
// Tiles.  Compiled widths (pad 1; WT = 8, 4: a row, H >= 2; WT = 2: two
// rows, H even) take the whole row with no halo: each pixel's valid taps
// are template masks (the edge columns peeled) and the g rows off the top
// or bottom of the frame a template mask picked once per warp (VM).  Every
// other shape (WT = 0; the widths 32 and 16 too) takes segments of 8 pixels
// of one row with the halo zero-filled and issues every tap.
//
// Staging.  Per chunk, the block's rect of g (NIB images x NGR rows x P + 2
// columns x kDxOCH o, o fastest, zero off the frame) and the chunk's
// weights (transposed to channels fastest) go into one of two buffers by
// cp.async; 1/s, -t/s and psi''s factor are stored there by the threads
// from t and s loaded before the previous chunk's FMAs.  Chunk k + 1 loads
// while chunk k's FMAs run, one barrier per chunk.  Positions come from
// counters and shifts; the block's own position takes the only divides.
template <int P, int RT>
struct DxTile {
  float4 x[RT][P];    // x of the tile's pixels, 4 channels each
  float4 acc[RT][P];  // their dx sums
};

__device__ __forceinline__ void fma4(float4& a, float g, const float4& w) {
  a.x = fmaf(g, w.x, a.x);
  a.y = fmaf(g, w.y, a.y);
  a.z = fmaf(g, w.z, a.z);
  a.w = fmaf(g, w.w, a.w);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// the chunk's first `no` output channels for one tile: g of rect row a,
// column sc at gq[(a * (P + 2) + sc) * kDxOCH] (+1 per o), the weights and
// factors at wq (+wStride per o).  VM: the rect rows on the frame; EL, ER:
// the halo columns on the frame (or zero-filled): taps outside are left out
template <int WAV, int P, int RT, int VM, bool EL, bool ER>
__device__ __forceinline__ void dx_chunk(DxTile<P, RT>& tl, const float* gq,
                                         const float* wq, int no,
                                         int wStride) {
  constexpr int NGC = P + kK - 1;
  for (int oo = 0; oo < no; ++oo, ++gq, wq += wStride) {
    float4 wv[kK][kK];  // w[2 - r][2 - e]: rect row rho + r, column j + e
#pragma unroll
    for (int r = 0; r < kK; ++r)
#pragma unroll
      for (int e = 0; e < kK; ++e)
        wv[r][e] = ld4(wq + 4 * ((kK - 1 - r) * kK + kK - 1 - e));
    const float4 iv = ld4(wq + 4 * kK * kK);
    const float4 nt = ld4(wq + 4 * kK * kK + 4);
    const float4 kv = ld4(wq + 4 * kK * kK + 8);
    float win[RT + kK - 1][kK] = {};  // rect columns sc - 2 .. sc
#pragma unroll
    for (int sc = 0; sc < NGC; ++sc) {
#pragma unroll
      for (int a = 0; a < RT + kK - 1; ++a) {
        win[a][0] = win[a][1];
        win[a][1] = win[a][2];
        const bool on =
            ((VM >> a) & 1) && (sc > 0 || EL) && (sc < NGC - 1 || ER);
        win[a][2] = on ? gq[(a * NGC + sc) * kDxOCH] : 0.0f;
      }
      if (sc < kK - 1) continue;
      const int j = sc - (kK - 1);
#pragma unroll
      for (int rho = 0; rho < RT; ++rho) {
        float4 G = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll
        for (int r = 0; r < kK; ++r) {
          if (!((VM >> (rho + r)) & 1)) continue;
#pragma unroll
          for (int e = 0; e < kK; ++e) {
            if ((j + e == 0 && !EL) || (j + e == NGC - 1 && !ER)) continue;
            fma4(G, win[rho + r][e], wv[r][e]);
          }
        }
        const float4 xv = tl.x[rho][j];
        float4& a = tl.acc[rho][j];
        a.x = fmaf(wav::dpsi_by<WAV>(fmaf(xv.x, iv.x, nt.x), kv.x), G.x, a.x);
        a.y = fmaf(wav::dpsi_by<WAV>(fmaf(xv.y, iv.y, nt.y), kv.y), G.y, a.y);
        a.z = fmaf(wav::dpsi_by<WAV>(fmaf(xv.z, iv.z, nt.z), kv.z), G.z, a.z);
        a.w = fmaf(wav::dpsi_by<WAV>(fmaf(xv.w, iv.w, nt.w), kv.w), G.w, a.w);
      }
    }
  }
}

// WT: 0 (segments of 8, every tap) or a compiled width 8, 4, 2
template <int WAV, int WT>
__global__ void __launch_bounds__(kDxThreads, kDxMinBlocks)
    wav_conv2d_bwd_dx_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ t,
                             const float* __restrict__ s,
                             const float* __restrict__ g,
                             float* __restrict__ dx, const DxShape sh) {
  constexpr int P = WT == 0 ? 8 : WT;
  constexpr int RT = WT == 2 ? 2 : 1;
  constexpr int NGC = P + kK - 1;
  constexpr int nW = kDxThreads / 32;
  extern __shared__ float4 dsmem4[];
  float* const smem = reinterpret_cast<float*>(dsmem4);
  const int CG = 1 << sh.lCG, CTILE = kCT << sh.lCG, NPB = 1 << sh.lNPB;
  const int np = CG >> 2;  // (o, channel) pairs a thread stages: 8*CTILE/128
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int cg = lane & (CG - 1);
  const int pw = warp & (NPB - 1);
  const int i = ((warp >> sh.lNPB) << (5 - sh.lCG)) + (lane >> sh.lCG);
  int bx = blockIdx.x;  // (image block, segment, row block), divided once
  const int rb = bx % sh.nRB;
  bx /= sh.nRB;
  const int seg = bx % sh.nSeg;
  const int ib = bx / sh.nSeg;
  const int b = ib * sh.NIB + i;
  const int rg = rb * NPB + pw;
  const int h0 = rg * RT, w0 = seg * P;
  const int cT0 = blockIdx.y * CTILE, c0 = cT0 + kCT * cg;
  const bool active = b < sh.B && rg < sh.nRG && c0 < sh.C;
  const int nc = min(kCT, sh.C - c0);
  // the block's rect: staged row gr is g row ohR + gr, column gc is ow0 + gc
  const int ohR = rb * NPB * RT + sh.pad - (kK - 1);
  const int ow0 = w0 + sh.pad - (kK - 1);

  DxTile<P, RT> tl;
#pragma unroll
  for (int rho = 0; rho < RT; ++rho)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      tl.acc[rho][j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      const int h = h0 + rho, wc = w0 + j;
      if (active && h < sh.H && wc < sh.W) {
        const float* p =
            x + (((size_t)b * sh.H + h) * sh.W + wc) * sh.C + c0;
        if (sh.xVec) {
          v = __ldg(reinterpret_cast<const float4*>(p));
        } else {
          v.x = __ldg(p);
          if (nc > 1) v.y = __ldg(p + 1);
          if (nc > 2) v.z = __ldg(p + 2);
          if (nc > 3) v.w = __ldg(p + 3);
        }
      }
      tl.x[rho][j] = v;
    }

  const size_t gImg = (size_t)sh.Ho * sh.Wo * sh.O;
  // this thread's (o, channel) pairs of a chunk: e = tid + 128 q, o = oc0 +
  // (e & 7), channel cT0 + cl with cl = e >> 3, at float (cl >> 2) *
  // kDxGroup + (cl & 3) of o's weights (tap at +4 tap; 1/s, -t/s and psi''s
  // factor at +36, +40, +44)
  auto pair = [&](int q, int oc0, int& o, int& c, int& off) {
    const int e = tid + q * kDxThreads;
    const int cl = e >> 3;
    o = oc0 + (e & (kDxOCH - 1));
    c = cT0 + cl;
    off = sh.gBuf + (e & (kDxOCH - 1)) * sh.wStride + (cl >> 2) * kDxGroup +
          (cl & 3);
  };
  float tp[2] = {0.0f, 0.0f}, sp[2] = {1.0f, 1.0f};
  auto load_ts = [&](int kk) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= np) break;
      int o, c, off;
      pair(q, kk * kDxOCH, o, c, off);
      const bool ok = c < sh.C && o < sh.O;
      tp[q] = ok ? __ldg(&t[(size_t)o * sh.C + c]) : 0.0f;
      sp[q] = ok ? __ldg(&s[(size_t)o * sh.C + c]) : 1.0f;
    }
  };
  auto store_ts = [&](int kk, float* buf) {
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= np) break;
      int o, c, off;
      pair(q, kk * kDxOCH, o, c, off);
      const bool ok = c < sh.C && o < sh.O;
      const float iv = ok ? 1.0f / sp[q] : 0.0f;
      buf[off + 4 * kK * kK] = iv;
      buf[off + 4 * kK * kK + 4] = -tp[q] * iv;
      buf[off + 4 * kK * kK + 8] = wav::dpsi_coef<WAV>(iv);
    }
  };
  // cp.async of chunk kk's g rect (a warp per staged row, lanes over
  // (column, o)) and weights (a thread per pair, its 9 taps)
  auto stage = [&](int kk, float* buf) {
    const int oc0 = kk * kDxOCH;
    int i2 = 0, gr = warp;
    while (gr >= sh.NGR) {
      gr -= sh.NGR;
      ++i2;
    }
    while (i2 < sh.NIB) {
      const int b2 = ib * sh.NIB + i2, oh = ohR + gr;
      const bool rowOk = b2 < sh.B && (unsigned)oh < (unsigned)sh.Ho;
      const float* src =
          rowOk ? g + (size_t)b2 * gImg + (size_t)oh * sh.Wo * sh.O + oc0 : g;
      float* dst = buf + i2 * sh.imgStride + gr * NGC * kDxOCH;
      if (sh.gVec) {  // float4 q of column col
        for (int e = lane; e < NGC * (kDxOCH / 4); e += 32) {
          const int col = e >> 1, q = e & 1, ow = ow0 + col;
          const bool ok = rowOk && (unsigned)ow < (unsigned)sh.Wo &&
                          oc0 + 4 * q < sh.O;
          kan::cp_async16(dst + 4 * e,
                          ok ? src + (size_t)ow * sh.O + 4 * q : g, ok);
        }
      } else {
        for (int e = lane; e < NGC * kDxOCH; e += 32) {
          const int col = e >> 3, q = e & (kDxOCH - 1), ow = ow0 + col;
          const bool ok =
              rowOk && (unsigned)ow < (unsigned)sh.Wo && oc0 + q < sh.O;
          kan::cp_async4(dst + e, ok ? src + (size_t)ow * sh.O + q : g, ok);
        }
      }
      gr += nW;
      while (gr >= sh.NGR) {
        gr -= sh.NGR;
        ++i2;
      }
    }
    const size_t tapStride = (size_t)sh.C * sh.O;
#pragma unroll
    for (int q = 0; q < 2; ++q) {
      if (q >= np) break;
      int o, c, off;
      pair(q, oc0, o, c, off);
      const bool ok = c < sh.C && o < sh.O;
      const float* src = ok ? w + (size_t)c * sh.O + o : w;
#pragma unroll
      for (int tap = 0; tap < kK * kK; ++tap)
        kan::cp_async4(buf + off + 4 * tap, ok ? src + tap * tapStride : w,
                       ok);
    }
    kan::cp_async_commit();
  };

  // the rect rows of this warp's tile on the frame (compiled widths: pad 1,
  // Ho = H)
  int vm = 0;
#pragma unroll
  for (int a = 0; a < RT + kK - 1; ++a)
    vm |= ((unsigned)(h0 - 1 + a) < (unsigned)sh.Ho) << a;
  const int gOff = i * sh.imgStride + pw * RT * NGC * kDxOCH;
  const int wOff = sh.gBuf + cg * kDxGroup;

  stage(0, smem);
  load_ts(0);
  store_ts(0, smem);
  for (int kk = 0; kk < sh.nCh; ++kk) {
    float* const buf = smem + (kk & 1) * sh.bufStride;
    float* const nbuf = smem + ((kk + 1) & 1) * sh.bufStride;
    const bool next = kk + 1 < sh.nCh;
    kan::cp_async_wait_all();
    __syncthreads();  // chunk kk is in; every reader of chunk kk - 1 done
    if (next) {
      stage(kk + 1, nbuf);
      load_ts(kk + 1);
    }
    if (active) {
      const int no = min(kDxOCH, sh.O - kk * kDxOCH);
      const float* gq = buf + gOff;
      const float* wq = buf + wOff;
      const int ws = sh.wStride;
      if constexpr (WT == 0) {
        dx_chunk<WAV, P, RT, 7, true, true>(tl, gq, wq, no, ws);
      } else if constexpr (RT == 1) {
        if (vm == 7) {
          dx_chunk<WAV, P, RT, 7, false, false>(tl, gq, wq, no, ws);
        } else if (vm == 6) {
          dx_chunk<WAV, P, RT, 6, false, false>(tl, gq, wq, no, ws);
        } else {
          dx_chunk<WAV, P, RT, 3, false, false>(tl, gq, wq, no, ws);
        }
      } else {
        if (vm == 15) {
          dx_chunk<WAV, P, RT, 15, false, false>(tl, gq, wq, no, ws);
        } else if (vm == 14) {
          dx_chunk<WAV, P, RT, 14, false, false>(tl, gq, wq, no, ws);
        } else if (vm == 7) {
          dx_chunk<WAV, P, RT, 7, false, false>(tl, gq, wq, no, ws);
        } else {
          dx_chunk<WAV, P, RT, 6, false, false>(tl, gq, wq, no, ws);
        }
      }
    }
    if (next) store_ts(kk + 1, nbuf);
  }

  if (!active) return;
#pragma unroll
  for (int rho = 0; rho < RT; ++rho)
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const int h = h0 + rho, wc = w0 + j;
      if (h >= sh.H || wc >= sh.W) continue;
      float* p = dx + (((size_t)b * sh.H + h) * sh.W + wc) * sh.C + c0;
      const float4 v = tl.acc[rho][j];
      if (sh.xVec) {
        *reinterpret_cast<float4*>(p) = v;
      } else {
        p[0] = v.x;
        if (nc > 1) p[1] = v.y;
        if (nc > 2) p[2] = v.z;
        if (nc > 3) p[3] = v.w;
      }
    }
}

// ---------------------------------------------------- parameter gradients
// Block (o tile of OC lanes, c tile of CG groups of kCT channels, split):
// thread (ol, cg, rs), tid = ol + OC * (cg + CG * rs), keeps the sums of
// output channel o = o0 + ol and the kCT input channels c0 + kCT*cg ..
// +kCT-1 in registers (ParamAcc): the g window it loads serves kCT pairs,
// its x is one float4 (channels fastest in shared memory), and the kCT
// chains of G hide each other's FMA latency.  Row slot rs takes rows rs,
// rs + RS, ... of each step; the slots' sums are added in slot order at the
// end (RS > 1 only where O x C is small: the first convs).  The 88 weights
// and sums of 4 pairs fit only a thread of up to 168 registers: blocks of at
// most 128 threads, 3 per SM (kParamThreads, kParamMinBlocks); 256-thread
// blocks at 128 registers spilled.
//
// Rows.  A split's images are walked as one sequence of "virtual" rows,
// HV per image: input row h of image b at b*HV + uoff + h, output row oh of
// g at b*HV + goff + oh, so that input row u reads the g rows u - 1 .. u + 1
// (whichever lie on the output frame) for any pad.  A step covers RB
// consecutive virtual rows.  The g rows live in a ring of NR rows: g row v
// (split-relative) at slot (v + 1) mod NR; step k reads rows kRB - 1 ..
// kRB + RB and stages rows kRB + RB + 1 .. kRB + 2RB for step k + 1 (with
// PIPE, 16- or 4-byte cp.async into a ring of 2RB + 2 rows and a second x
// buffer while the FMAs run; without, plain loads into RB + 2 rows between
// two barriers), so every g row and every x row is copied into shared
// memory once per block.  Small planes: RB covers whole images (one barrier
// for several).  Positions come from counters (VRow) advanced by
// block-uniform steps whose quotients and remainders by HV are taken once
// per block: no divide or modulo by a runtime value inside a loop.
//
// Pad taps.  Where pad = 1, W is a compiled width (WT: 32, 16, 8, 4, 2) and
// the ring is pipelined, g is staged without halo columns and a row runs
// unrolled over compile-time columns: each pixel's valid taps are template
// masks (the edge columns peeled), and a g row off the top or bottom of the
// frame is skipped by one uniform branch per row (4 row variants).  Every other
// shape (WT = 0) stages g with its two halo columns zero-filled and issues
// every tap of every row that lies on the frame.
struct ParamAcc {
  float wf[kCT][kK][kK];  // w[2 - r][2 - e] for staged g row r, column e
  float dw[kCT][kK][kK];  // the same index
  float iv[kCT], nt[kCT];  // 1/s and -t/s: z = x * iv + nt
  float dt[kCT], ds[kCT];
};

// quotient and remainder of a block-uniform step by HV, taken once
struct DivMod {
  int q, r;
  __device__ DivMod(int n, int d) : q(n / d), r(n % d) {}
};

// (image, virtual row) of a split-relative virtual row, advanced by counters
struct VRow {
  int b, hv;
  __device__ __forceinline__ void add(const DivMod& d, int HV) {
    hv += d.r;
    b += d.q;
    if (hv >= HV) {
      hv -= HV;
      ++b;
    }
  }
};

__device__ __forceinline__ int ring_add(int slot, int n, int NR) {
  slot += n;  // slot < NR and n < NR
  return slot >= NR ? slot - NR : slot;
}

// one input pixel of the thread's kCT pairs: psi and psi' of each, then
// the taps of the masks RM (staged g rows r) and EM (window columns e)
template <int WAV, int RM, int EM>
__device__ __forceinline__ void param_pixel(ParamAcc& a,
                                            const float (&win)[kK][kK],
                                            const float* xp) {
  const float4 v = *reinterpret_cast<const float4*>(xp);  // a broadcast
  const float xs[kCT] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int ch = 0; ch < kCT; ++ch) {
    const float z = fmaf(xs[ch], a.iv[ch], a.nt[ch]);
    float p, d;
    wav::psi_dpsi<WAV>(z, &p, &d);
    float G = 0.0f;
#pragma unroll
    for (int r = 0; r < kK; ++r) {
      if (!((RM >> r) & 1)) continue;
#pragma unroll
      for (int e = 0; e < kK; ++e) {
        if (!((EM >> e) & 1)) continue;
        G = fmaf(win[r][e], a.wf[ch][r][e], G);
        a.dw[ch][r][e] = fmaf(p, win[r][e], a.dw[ch][r][e]);
      }
    }
    const float dg = d * G;
    a.dt[ch] += dg;
    a.ds[ch] = fmaf(dg, z, a.ds[ch]);
  }
}

// one input row of compile-time width W (pad 1, no halo columns): g row r
// at gr[r] (column stride OC), x at xr (pixel stride CTILE); window column
// e of pixel j is g column j - 1 + e
template <int WAV, int W, int RM>
__device__ __forceinline__ void param_row(ParamAcc& a,
                                          const float* const (&gr)[kK],
                                          const float* xr, int OC,
                                          int CTILE) {
  float win[kK][kK];
  const float* gp[kK];
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    gp[r] = gr[r];
    win[r][0] = 0.0f;
    win[r][1] = ((RM >> r) & 1) ? gp[r][0] : 0.0f;
    win[r][2] = ((RM >> r) & 1) ? gp[r][OC] : 0.0f;
    gp[r] += 2 * OC;
  }
  param_pixel<WAV, RM, 6>(a, win, xr);
#pragma unroll 4
  for (int j = 1; j < W - 1; ++j) {
#pragma unroll
    for (int r = 0; r < kK; ++r) {
      win[r][0] = win[r][1];
      win[r][1] = win[r][2];
      win[r][2] = ((RM >> r) & 1) ? *gp[r] : 0.0f;
      gp[r] += OC;
    }
    param_pixel<WAV, RM, 7>(a, win, xr + j * CTILE);
  }
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    win[r][0] = win[r][1];
    win[r][1] = win[r][2];
  }
  param_pixel<WAV, RM, 3>(a, win, xr + (W - 1) * CTILE);
}

// a row of any width (halo columns staged, zero off the frame): window
// column e of pixel j is staged column j + e; rows off the frame (rm)
// read nothing and add zeros
template <int WAV>
__device__ __forceinline__ void param_row_any(ParamAcc& a,
                                              const float* const (&gr)[kK],
                                              const float* xr, int W, int rm,
                                              int OC, int CTILE) {
  float win[kK][kK];
  const float* gp[kK];
#pragma unroll
  for (int r = 0; r < kK; ++r) {
    gp[r] = gr[r];
    win[r][1] = ((rm >> r) & 1) ? gp[r][0] : 0.0f;
    win[r][2] = ((rm >> r) & 1) ? gp[r][OC] : 0.0f;
    gp[r] += 2 * OC;
  }
  for (int j = 0; j < W; ++j) {
#pragma unroll
    for (int r = 0; r < kK; ++r) {
      win[r][0] = win[r][1];
      win[r][1] = win[r][2];
      win[r][2] = ((rm >> r) & 1) ? *gp[r] : 0.0f;
      gp[r] += OC;
    }
    param_pixel<WAV, 7, 7>(a, win, xr + j * CTILE);
  }
}

// the row's variant by its mask of g rows on the frame (pad 1: the middle
// row always is)
template <int WAV, int WT>
__device__ __forceinline__ void param_row_of(ParamAcc& a,
                                             const float* const (&gr)[kK],
                                             const float* xr, int W, int rm,
                                             int OC, int CTILE) {
  if constexpr (WT == 0) {
    param_row_any<WAV>(a, gr, xr, W, rm, OC, CTILE);
  } else if (rm == 7) {
    param_row<WAV, WT, 7>(a, gr, xr, OC, CTILE);
  } else if (rm == 6) {
    param_row<WAV, WT, 6>(a, gr, xr, OC, CTILE);
  } else if (rm == 3) {
    param_row<WAV, WT, 3>(a, gr, xr, OC, CTILE);
  } else {
    param_row<WAV, WT, 2>(a, gr, xr, OC, CTILE);
  }
}

template <bool PIPE>
__device__ __forceinline__ void copy16(float* dst, const float* src,
                                       bool ok) {
  if (PIPE) {
    kan::cp_async16(dst, src, ok);
  } else {
    *reinterpret_cast<float4*>(dst) =
        ok ? __ldg(reinterpret_cast<const float4*>(src))
           : make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  }
}

template <bool PIPE>
__device__ __forceinline__ void copy4(float* dst, const float* src, bool ok) {
  if (PIPE) {
    kan::cp_async4(dst, src, ok);
  } else {
    *dst = ok ? __ldg(src) : 0.0f;
  }
}

template <int WAV, int WT, bool PIPE>
__global__ void __launch_bounds__(kParamThreads, kParamMinBlocks)
    wav_conv2d_bwd_param_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                const float* __restrict__ t,
                                const float* __restrict__ s,
                                const float* __restrict__ g,
                                float* __restrict__ partial,
                                const ParamShape sh) {
  extern __shared__ float4 psmem4[];
  float* const smem = reinterpret_cast<float*>(psmem4);
  const int OC = 1 << sh.lOC, CG = 1 << sh.lCG, CTILE = kCT << sh.lCG;
  const int W = WT > 0 ? WT : sh.W;
  const int HV = sh.HV, NR = sh.NR, RB = sh.RB, RS = sh.RS;
  const int gRow = sh.gCols << sh.lOC;  // floats per staged g row
  const int xRow = W * CTILE;           // floats per staged x row
  float* const Gs = smem;               // [NR][gCols][OC]
  // [PIPE ? 2 : 1][RB][W][CTILE], 16-byte aligned
  float* const Xs = Gs + ((NR * gRow + 3) & ~3);

  const int tid = threadIdx.x;
  const int ol = tid & (OC - 1);
  const int cg = (tid >> sh.lOC) & (CG - 1);
  const int rs = tid >> (sh.lOC + sh.lCG);  // >= RS: no pair (fallback)
  const int o0 = blockIdx.x << sh.lOC;
  const int cT0 = blockIdx.y * CTILE;
  const int o = o0 + ol, c0 = cT0 + kCT * cg;
  const int split = blockIdx.z;
  const bool active = rs < RS && o < sh.O && c0 < sh.C;

  ParamAcc a;
#pragma unroll
  for (int ch = 0; ch < kCT; ++ch) {
    const int c = c0 + ch;
    const bool ok = active && c < sh.C;
#pragma unroll
    for (int r = 0; r < kK; ++r)
#pragma unroll
      for (int e = 0; e < kK; ++e) {
        a.dw[ch][r][e] = 0.0f;
        a.wf[ch][r][e] =
            ok ? __ldg(&w[((size_t)((kK - 1 - r) * kK + kK - 1 - e) * sh.C +
                           c) * sh.O + o])
               : 0.0f;
      }
    const float tv = ok ? __ldg(&t[(size_t)o * sh.C + c]) : 0.0f;
    const float iv = ok ? 1.0f / __ldg(&s[(size_t)o * sh.C + c]) : 0.0f;
    a.iv[ch] = iv;
    a.nt[ch] = -tv * iv;
    a.dt[ch] = 0.0f;
    a.ds[ch] = 0.0f;
  }

  // the split's virtual rows, and the block-uniform steps (one divide each)
  const int img0 = split * sh.ips;
  const int nV = min(sh.ips, sh.B - img0) * HV;
  const int nSteps = (nV + RB - 1) / RB;
  const int nW = blockDim.x >> 5, warp = tid >> 5, lane = tid & 31;
  const DivMod byStep(RB, HV), byWarps(nW, HV), byWarp(warp, HV),
      bySlots(RS, HV), bySlot(rs, HV), byOne(1, HV);
  const int warpsRing = nW % NR, warpRing = warp % NR, slotsRing = RS % NR,
            slotRing = rs % NR;
  const int bufStride = RB * xRow;
  const size_t xImg = (size_t)sh.H * sh.W * sh.C;
  const size_t gImg = (size_t)sh.Ho * sh.Wo * sh.O;

  // stage step kk (virtual rows kk*RB .. at (b, hv) = at): its x rows into
  // buffer xb, and the g rows it is the first to need into the ring (step
  // 0: rows 0 .. RB at slots 1 ..; later steps: kk*RB + 1 .. kk*RB + RB at
  // slots ring0 + 2 .., ring0 = the slot of row kk*RB - 1).  A warp per row.
  auto stage = [&](int kk, VRow at, int ring0, float* xb) {
    {
      VRow vr = at;
      vr.add(byWarp, HV);
      int v = kk * RB + warp;
      float* dst = xb + warp * xRow;
      for (int r = warp; r < RB;
           r += nW, v += nW, vr.add(byWarps, HV), dst += nW * xRow) {
        const int h = vr.hv - sh.uoff;
        if (v >= nV || (unsigned)h >= (unsigned)sh.H) continue;
        const float* src = x + (size_t)(img0 + vr.b) * xImg +
                           (size_t)h * sh.W * sh.C + cT0;
        if (sh.xVec) {  // float4 q (the group's channels) of column col
          for (int e = lane; e < (W << sh.lCG); e += 32) {
            const int col = e >> sh.lCG, q = e & (CG - 1);
            const bool ok = cT0 + kCT * q < sh.C;
            copy16<PIPE>(dst + 4 * e,
                         ok ? src + (size_t)col * sh.C + kCT * q : x, ok);
          }
        } else {
          for (int e = lane; e < xRow; e += 32) {
            const int col = e >> (sh.lCG + 2), q = e & (CTILE - 1);
            const bool ok = cT0 + q < sh.C;
            copy4<PIPE>(dst + e, ok ? src + (size_t)col * sh.C + q : x, ok);
          }
        }
      }
    }
    {
      const bool first = kk == 0;
      const int nG = first ? RB + 1 : RB;
      VRow vr = at;
      if (!first) vr.add(byOne, HV);
      vr.add(byWarp, HV);
      int v = first ? warp : kk * RB + 1 + warp;
      int slot = ring_add(ring_add(ring0, first ? 1 : 2, NR), warpRing, NR);
      for (int j = warp; j < nG; j += nW, v += nW, vr.add(byWarps, HV),
               slot = ring_add(slot, warpsRing, NR)) {
        const int oh = vr.hv - sh.goff;
        if (v >= nV || (unsigned)oh >= (unsigned)sh.Ho) continue;
        const float* src = g + (size_t)(img0 + vr.b) * gImg +
                           (size_t)oh * sh.Wo * sh.O + o0;
        float* dst = Gs + slot * gRow;
        if (sh.gVec) {
          const int lq = sh.lOC - 2;
          for (int e = lane; e < (sh.gCols << lq); e += 32) {
            const int col = e >> lq, q = e & ((1 << lq) - 1);
            const int ow = col + sh.gCol0;
            const bool ok =
                (unsigned)ow < (unsigned)sh.Wo && o0 + 4 * q < sh.O;
            copy16<PIPE>(dst + 4 * e,
                         ok ? src + (size_t)ow * sh.O + 4 * q : g, ok);
          }
        } else {
          for (int e = lane; e < gRow; e += 32) {
            const int col = e >> sh.lOC, q = e & (OC - 1);
            const int ow = col + sh.gCol0;
            const bool ok = (unsigned)ow < (unsigned)sh.Wo && o0 + q < sh.O;
            copy4<PIPE>(dst + e, ok ? src + (size_t)ow * sh.O + q : g, ok);
          }
        }
      }
    }
    if (PIPE) kan::cp_async_commit();
  };

  VRow vs{0, 0};  // step kk's first virtual row
  int base = 0;   // ring slot of g row kk*RB - 1
  if (PIPE) stage(0, vs, 0, Xs);
  for (int kk = 0; kk < nSteps; ++kk) {
    float* xb = Xs;
    if (PIPE) {
      kan::cp_async_wait_all();
      __syncthreads();  // step kk is in; every reader of step kk - 1 done
      xb += (kk & 1) * bufStride;
      if (kk + 1 < nSteps) {
        VRow vn = vs;
        vn.add(byStep, HV);
        stage(kk + 1, vn, ring_add(base, RB, NR),
              Xs + ((kk + 1) & 1) * bufStride);
      }
    } else {
      __syncthreads();  // every reader of step kk - 1 done
      stage(kk, vs, base, Xs);
      __syncthreads();
    }
    if (active) {
      VRow vr = vs;
      vr.add(bySlot, HV);
      int v = kk * RB + rs;
      int slot = ring_add(base, slotRing, NR);
      const float* xr = xb + rs * xRow + kCT * cg;
      for (int i = rs; i < RB; i += RS, v += RS, vr.add(bySlots, HV),
               slot = ring_add(slot, slotsRing, NR), xr += RS * xRow) {
        const int h = vr.hv - sh.uoff;
        if (v >= nV || (unsigned)h >= (unsigned)sh.H) continue;
        // g rows r = 0..2 of this row: output rows h + uoff - goff - 1 + r
        const int oh0 = h + sh.uoff - sh.goff - 1;
        int rm = 0;
#pragma unroll
        for (int r = 0; r < kK; ++r)
          rm |= ((unsigned)(oh0 + r) < (unsigned)sh.Ho) << r;
        const int s1 = ring_add(slot, 1, NR), s2 = ring_add(s1, 1, NR);
        const float* const gr[kK] = {Gs + slot * gRow + ol,
                                     Gs + s1 * gRow + ol,
                                     Gs + s2 * gRow + ol};
        param_row_of<WAV, WT>(a, gr, xr, W, rm, OC, CTILE);
      }
    }
    vs.add(byStep, HV);
    base = ring_add(base, RB, NR);
  }

  const int stride = OC * CG;  // threads between row slots
  if (RS > 1) {
    // the row slots' sums added in slot order, kept by slot 0
    __syncthreads();  // every reader of the staged rows is done
    const int T = blockDim.x;
    float* red = smem + tid;  // [kParamVals][T]
#pragma unroll
    for (int ch = 0; ch < kCT; ++ch) {
#pragma unroll
      for (int r = 0; r < kK; ++r)
#pragma unroll
        for (int e = 0; e < kK; ++e)
          red[((ch * kK + r) * kK + e) * T] = a.dw[ch][r][e];
      red[(kCT * kK * kK + ch) * T] = a.dt[ch];
      red[(kCT * kK * kK + kCT + ch) * T] = a.ds[ch];
    }
    __syncthreads();
    if (rs == 0) {
#pragma unroll
      for (int ch = 0; ch < kCT; ++ch) {
#pragma unroll
        for (int r = 0; r < kK; ++r)
#pragma unroll
          for (int e = 0; e < kK; ++e) {
            const float* q = red + ((ch * kK + r) * kK + e) * T;
            float v = q[0];
            for (int n = 1; n < RS; ++n) v += q[n * stride];
            a.dw[ch][r][e] = v;
          }
        const float* qt = red + (kCT * kK * kK + ch) * T;
        const float* qs = red + (kCT * kK * kK + kCT + ch) * T;
        float vt = qt[0], vsum = qs[0];
        for (int n = 1; n < RS; ++n) {
          vt += qt[n * stride];
          vsum += qs[n * stride];
        }
        a.dt[ch] = vt;
        a.ds[ch] = vsum;
      }
    }
  }

  if (!active || rs != 0) return;
  float* dst = partial + (size_t)split * sh.N;
  const size_t nw = (size_t)kK * kK * sh.C * sh.O;
#pragma unroll
  for (int ch = 0; ch < kCT; ++ch) {
    const int c = c0 + ch;
    if (c >= sh.C) break;
#pragma unroll
    for (int r = 0; r < kK; ++r)
#pragma unroll
      for (int e = 0; e < kK; ++e)
        dst[((size_t)((kK - 1 - r) * kK + kK - 1 - e) * sh.C + c) * sh.O + o] =
            a.dw[ch][r][e];
    dst[nw + (size_t)o * sh.C + c] = -a.dt[ch] * a.iv[ch];
    dst[nw + (size_t)sh.O * sh.C + (size_t)o * sh.C + c] =
        -a.ds[ch] * a.iv[ch];
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

size_t dx_smem(const DxShape& sh) {
  // one buffer per chunk in flight: two where O takes more than one chunk
  return sizeof(float) * (sh.nCh > 1 ? 2 : 1) * (size_t)sh.bufStride;
}

size_t param_smem(const ParamShape& sh, bool pipe, int threads) {
  // the g ring (rounded to 16 bytes), the x buffers; the row slots' sums
  // reuse it at the end
  const size_t ring = ((size_t)sh.NR * (sh.gCols << sh.lOC) + 3) & ~(size_t)3;
  const size_t f =
      ring + (pipe ? 2 : 1) * (size_t)sh.RB * sh.W * (kCT << sh.lCG);
  const size_t red = sh.RS > 1 ? (size_t)kParamVals * threads : 0;
  return sizeof(float) * (f > red ? f : red);
}

struct Ptrs {
  const float *x, *w, *t, *s, *g;
  float* out;
};

template <int WAV, int WT>
cudaError_t launch_dx(const Ptrs& p, const DxShape& sh, unsigned blocks,
                      cudaStream_t st) {
  auto kernel = wav_conv2d_bwd_dx_kernel<WAV, WT>;
  static size_t granted = 48 * 1024;
  const size_t smem = dx_smem(sh);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int ctile = kCT << sh.lCG;
  const dim3 grid(blocks, (sh.C + ctile - 1) / ctile);
  kernel<<<grid, kDxThreads, smem, st>>>(p.x, p.w, p.t, p.s, p.g, p.out, sh);
  return cudaGetLastError();
}

template <int WAV>
cudaError_t launch_dx_width(int WT, const Ptrs& p, const DxShape& sh,
                            unsigned blocks, cudaStream_t st) {
  switch (WT) {
    case 8: return launch_dx<WAV, 8>(p, sh, blocks, st);
    case 4: return launch_dx<WAV, 4>(p, sh, blocks, st);
    case 2: return launch_dx<WAV, 2>(p, sh, blocks, st);
    default: return launch_dx<WAV, 0>(p, sh, blocks, st);
  }
}

template <int WAV, int WT, bool PIPE>
cudaError_t launch_param(const Ptrs& p, const ParamShape& sh, int threads,
                         cudaStream_t st) {
  auto kernel = wav_conv2d_bwd_param_kernel<WAV, WT, PIPE>;
  static size_t granted = 48 * 1024;
  const size_t smem = param_smem(sh, PIPE, threads);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int ctile = kCT << sh.lCG;
  const dim3 grid((sh.O + (1 << sh.lOC) - 1) >> sh.lOC,
                  (sh.C + ctile - 1) / ctile, sh.S);
  kernel<<<grid, threads, smem, st>>>(p.x, p.w, p.t, p.s, p.g, p.out, sh);
  return cudaGetLastError();
}

bool param_compiled_width(int W, int pad) {
  return pad == 1 && (W == 2 || W == 4 || W == 8 || W == 16 || W == 32);
}

template <int WAV>
cudaError_t launch_param_width(const Ptrs& p, const ParamShape& sh,
                               int threads, bool pipe, cudaStream_t st) {
  if (pipe && param_compiled_width(sh.W, sh.pad)) {
    switch (sh.W) {
      case 32: return launch_param<WAV, 32, true>(p, sh, threads, st);
      case 16: return launch_param<WAV, 16, true>(p, sh, threads, st);
      case 8: return launch_param<WAV, 8, true>(p, sh, threads, st);
      case 4: return launch_param<WAV, 4, true>(p, sh, threads, st);
      default: return launch_param<WAV, 2, true>(p, sh, threads, st);
    }
  }
  return pipe ? launch_param<WAV, 0, true>(p, sh, threads, st)
              : launch_param<WAV, 0, false>(p, sh, threads, st);
}

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

bool pow2_upto(int v, int hi) { return v > 0 && v <= hi && !(v & (v - 1)); }

Ptrs ptrs(const void* x, const void* w, const void* t, const void* s,
          const void* g, void* out) {
  return {static_cast<const float*>(x), static_cast<const float*>(w),
          static_cast<const float*>(t), static_cast<const float*>(s),
          static_cast<const float*>(g), static_cast<float*>(out)};
}

}  // namespace

extern "C" {

// Data gradient dx (B, H, W, C) for g (B, Ho, Wo, O).  Returns a
// cudaError_t (0 = success); cudaErrorInvalidValue for a tile, kernel size
// or wavelet the build does not carry.  The Python wrapper chooses WT (0 or
// a compiled width: 8 or 4 with H >= 2, 2 with H even, pad 1), CG (channel
// groups of 4 per block: 4 or 8) and NPB (tile positions per block: 1, 2,
// 4) in kernels/wav_conv2d.py, dx_launch_config, and validates every tensor.
int wav_conv2d_bwd_dx(const void* x, const void* w, const void* t,
                      const void* s, const void* g, void* dx, int B, int H,
                      int W, int C, int O, int k, int pad, int WT, int CG,
                      int NPB, int wavelet, void* stream) {
  DxShape sh;
  sh.B = B; sh.H = H; sh.W = W; sh.C = C; sh.O = O; sh.pad = pad;
  sh.Ho = H + 2 * pad - k + 1;
  sh.Wo = W + 2 * pad - k + 1;
  const bool compiled =
      pad == 1 && W == WT &&
      (WT == 8 || WT == 4 ? H >= 2 : WT == 2 && H % 2 == 0);
  if (k != kK || (WT != 0 && !compiled) || (CG != 4 && CG != 8) ||
      (NPB != 1 && NPB != 2 && NPB != 4) || B <= 0 || C <= 0 || O <= 0 ||
      pad < 0 || sh.Ho <= 0 || sh.Wo <= 0 || wavelet < 0 || wavelet > 4)
    return (int)cudaErrorInvalidValue;
  const int P = WT == 0 ? 8 : WT, RT = WT == 2 ? 2 : 1;
  sh.lCG = log2_of(CG);
  sh.lNPB = log2_of(NPB);
  sh.nSeg = (W + P - 1) / P;
  sh.nRG = (H + RT - 1) / RT;
  sh.nRB = (sh.nRG + NPB - 1) / NPB;
  sh.NIB = (32 / CG) * (4 / NPB);
  sh.NGR = NPB * RT + kK - 1;
  sh.imgStride = sh.NGR * (P + kK - 1) * kDxOCH + 4;
  sh.gBuf = sh.NIB * sh.imgStride;
  sh.wStride = CG * kDxGroup;
  sh.bufStride = sh.gBuf + kDxOCH * sh.wStride;
  sh.nCh = (O + kDxOCH - 1) / kDxOCH;
  sh.xVec = C % 4 == 0;
  sh.gVec = O % 4 == 0;
  const long blocks = (long)((B + sh.NIB - 1) / sh.NIB) * sh.nSeg * sh.nRB;
  if (blocks > 0x7fffffffL || (C + 4 * CG - 1) / (4 * CG) > 65535 ||
      dx_smem(sh) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const Ptrs p = ptrs(x, w, t, s, g, dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned nb = (unsigned)blocks;
  switch (wavelet) {
    case wav::kMexicanHat:
      return (int)launch_dx_width<wav::kMexicanHat>(WT, p, sh, nb, st);
    case wav::kMorlet:
      return (int)launch_dx_width<wav::kMorlet>(WT, p, sh, nb, st);
    case wav::kDog: return (int)launch_dx_width<wav::kDog>(WT, p, sh, nb, st);
    case wav::kMeyer:
      return (int)launch_dx_width<wav::kMeyer>(WT, p, sh, nb, st);
    default: return (int)launch_dx_width<wav::kShannon>(WT, p, sh, nb, st);
  }
}

// Parameter-gradient partial sums (S, 9*C*O + 2*O*C): [dw (3,3,C,O),
// dt (O,C), ds (O,C)] of images [q*ips, min(B, q*ips + ips)) for split q.
// The wrapper chooses OC/CG/RS/RB/threads/pipe/S/ips (param_launch_config):
// blocks of `threads` (whole warps) hold OC output channels x CG groups of
// 4 input channels x RS row slots and step through RB rows at a time;
// pipe: cp.async into a double-buffered ring (the compiled widths need it).
int wav_conv2d_bwd_param(const void* x, const void* w, const void* t,
                         const void* s, const void* g, void* partial, int B,
                         int H, int W, int C, int O, int k, int pad, int OC,
                         int CG, int RS, int RB, int threads, int pipe, int S,
                         int ips, int wavelet, void* stream) {
  ParamShape sh;
  sh.B = B; sh.H = H; sh.W = W; sh.C = C; sh.O = O; sh.pad = pad;
  sh.Ho = H + 2 * pad - k + 1;
  sh.Wo = W + 2 * pad - k + 1;
  sh.lOC = log2_of(OC); sh.lCG = log2_of(CG);
  sh.RS = RS; sh.RB = RB; sh.S = S; sh.ips = ips;
  sh.uoff = pad > 1 ? pad - 1 : 0;
  sh.goff = pad < 1 ? 1 : 0;
  sh.HV = H + 2 * sh.uoff;
  const bool compiled = pipe && param_compiled_width(W, pad);
  sh.gCols = compiled ? W : W + kK - 1;
  sh.gCol0 = compiled ? 0 : pad - (kK - 1);
  sh.NR = pipe ? 2 * RB + 2 : RB + 2;
  sh.gVec = O % 4 == 0 && OC >= 4;
  sh.xVec = C % 4 == 0;
  sh.N = (size_t)kK * kK * C * O + 2 * (size_t)O * C;
  if (k != kK || !pow2_upto(OC, 32) || !pow2_upto(CG, kThreads) ||
      threads < 32 || threads > kParamThreads || threads % 32 != 0 ||
      RS < 1 ||
      (long)OC * CG * RS > threads || RB < 1 || S <= 0 || S > 65535 ||
      ips <= 0 || (long)(S - 1) * ips >= B || (long)S * ips < B || pad < 0 ||
      sh.Ho <= 0 || sh.Wo <= 0 || wavelet < 0 || wavelet > 4 ||
      param_smem(sh, pipe, threads) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const Ptrs p = ptrs(x, w, t, s, g, partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wavelet) {
    case wav::kMexicanHat:
      return (int)launch_param_width<wav::kMexicanHat>(p, sh, threads, pipe,
                                                       st);
    case wav::kMorlet:
      return (int)launch_param_width<wav::kMorlet>(p, sh, threads, pipe, st);
    case wav::kDog:
      return (int)launch_param_width<wav::kDog>(p, sh, threads, pipe, st);
    case wav::kMeyer:
      return (int)launch_param_width<wav::kMeyer>(p, sh, threads, pipe, st);
    default:
      return (int)launch_param_width<wav::kShannon>(p, sh, threads, pipe,
                                                    st);
  }
}

// The (S, N) partials summed over S in the fixed order of
// csrc/ordered_sum.cuh; VW, Gw and Gc from reduce_launch_config.
int wav_conv2d_bwd_reduce(const void* partial, void* out, int S, int N,
                          int VW, int Gw, int Gc, void* stream) {
  return (int)ordered_sum::launch(partial, out, S, N, VW, Gw, Gc,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
