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
//     A thread owns one channel c of a strip of TW pixels of one input row
//     and loops over o; the three g rows the strip reads are staged in
//     shared memory per chunk of output channels (broadcast to the lanes,
//     which hold neighbouring channels), G is formed in registers and
//     psi'(z) applied at once.  Only interior pixels are computed (the pad
//     has no input).
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
// stored: both kernels recompute it from x, t and s.  Later work: the data
// gradient recomputes psi' that the parameter kernel also evaluates; a
// fused kernel would pay one exp per triple instead of two.
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
// parameter kernel: input channels per thread (one float4 of x), its sums,
// and the launch bounds (threads, blocks per SM)
constexpr int kCT = 4;
constexpr int kParamVals = kCT * (kK * kK + 2);
constexpr int kParamThreads = 128, kParamMinBlocks = 3;

struct DxShape {
  int B, H, W, C, O, pad, Ho, Wo;
  int CL, NS, OCH;     // lanes (input channels), strips, staged out chans
  int nSeg, nStrips;   // strips per row, B * H * nSeg
  int stripStride;     // floats per staged strip: OCH * 3 * (TW+2) + 1
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
template <int WAV, int TW>
__global__ void __launch_bounds__(kThreads, 2)
    wav_conv2d_bwd_dx_kernel(const float* __restrict__ x,
                             const float* __restrict__ w,
                             const float* __restrict__ t,
                             const float* __restrict__ s,
                             const float* __restrict__ g,
                             float* __restrict__ dx, const DxShape sh) {
  constexpr int TP = TW + kK - 1;  // g columns a strip reads
  constexpr int GR = kK * TP;      // floats per (strip, o): 3 rows of TP
  extern __shared__ float smem[];
  float* Gs = smem;                              // [NS][OCH][3][TP] (+1)
  float* Ws = Gs + sh.NS * sh.stripStride;       // [OCH][k*k][CL]
  float* Ts = Ws + sh.OCH * kK * kK * sh.CL;     // [OCH][CL]
  float* Is = Ts + sh.OCH * sh.CL;               // [OCH][CL]: 1/s

  const int tid = threadIdx.x;
  const int cl = tid % sh.CL;
  const int sl = tid / sh.CL;
  const int c = blockIdx.y * sh.CL + cl;
  const int strip = blockIdx.x * sh.NS + sl;
  const int perImg = sh.H * sh.nSeg;
  int b = 0, h = 0, w0 = 0;
  if (strip < sh.nStrips) {
    b = strip / perImg;
    const int rem = strip - b * perImg;
    h = rem / sh.nSeg;
    w0 = (rem % sh.nSeg) * TW;
  }
  const bool active = strip < sh.nStrips && c < sh.C;

  float xr[TW], acc[TW];
#pragma unroll
  for (int j = 0; j < TW; ++j) {
    acc[j] = 0.0f;
    xr[j] = (active && w0 + j < sh.W)
                ? __ldg(&x[(((size_t)b * sh.H + h) * sh.W + w0 + j) * sh.C + c])
                : 0.0f;
  }

  for (int oc0 = 0; oc0 < sh.O; oc0 += sh.OCH) {
    __syncthreads();  // the previous chunk's readers are done
    // g rows h + pad - 2 .. h + pad, columns w0 + pad - 2 .. w0 + TW - 1 +
    // pad, of every strip: idx -> (strip, row*TP + col, o), o fastest
    const int nG = sh.NS * GR * sh.OCH;
    for (int idx = tid; idx < nG; idx += kThreads) {
      const int oo = idx % sh.OCH;
      const int rest = idx / sh.OCH;
      const int rc = rest % GR;
      const int st = rest / GR;
      const int sg = blockIdx.x * sh.NS + st;
      const int og = oc0 + oo;
      float v = 0.0f;
      if (sg < sh.nStrips && og < sh.O) {
        const int bb = sg / perImg;
        const int rem = sg - bb * perImg;
        const int oh = rem / sh.nSeg + sh.pad - (kK - 1) + rc / TP;
        const int ow = (rem % sh.nSeg) * TW + sh.pad - (kK - 1) + rc % TP;
        if (oh >= 0 && oh < sh.Ho && ow >= 0 && ow < sh.Wo)
          v = __ldg(&g[(((size_t)bb * sh.Ho + oh) * sh.Wo + ow) * sh.O + og]);
      }
      Gs[st * sh.stripStride + oo * GR + rc] = v;
    }
    // weights: idx -> (o, tap, lane), lane fastest
    for (int idx = tid; idx < sh.OCH * kK * kK * sh.CL; idx += kThreads) {
      const int cc = blockIdx.y * sh.CL + idx % sh.CL;
      const int rest = idx / sh.CL;
      const int tap = rest % (kK * kK);
      const int og = oc0 + rest / (kK * kK);
      Ws[idx] = (cc < sh.C && og < sh.O)
                    ? __ldg(&w[((size_t)tap * sh.C + cc) * sh.O + og])
                    : 0.0f;
    }
    for (int idx = tid; idx < sh.OCH * sh.CL; idx += kThreads) {
      const int cc = blockIdx.y * sh.CL + idx % sh.CL;
      const int og = oc0 + idx / sh.CL;
      const bool ok = cc < sh.C && og < sh.O;
      Ts[idx] = ok ? __ldg(&t[(size_t)og * sh.C + cc]) : 0.0f;
      Is[idx] = ok ? 1.0f / __ldg(&s[(size_t)og * sh.C + cc]) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    const int no = min(sh.OCH, sh.O - oc0);
    const float* gp = Gs + sl * sh.stripStride;
    for (int oo = 0; oo < no; ++oo) {
      // wf[r][cc] = w[2-r][2-cc]: staged g row r, column j + cc meets tap
      // (2 - r, 2 - cc) at pixel j
      float wf[kK][kK];
#pragma unroll
      for (int r = 0; r < kK; ++r)
#pragma unroll
        for (int cc = 0; cc < kK; ++cc)
          wf[r][cc] = Ws[(oo * kK * kK + (kK - 1 - r) * kK + (kK - 1 - cc)) *
                             sh.CL + cl];
      const float tv = Ts[oo * sh.CL + cl];
      const float iv = Is[oo * sh.CL + cl];
      float gr[kK][TP];
#pragma unroll
      for (int r = 0; r < kK; ++r)
#pragma unroll
        for (int col = 0; col < TP; ++col)
          gr[r][col] = gp[oo * GR + r * TP + col];
#pragma unroll
      for (int j = 0; j < TW; ++j) {
        float G = 0.0f;
#pragma unroll
        for (int r = 0; r < kK; ++r)
#pragma unroll
          for (int cc = 0; cc < kK; ++cc)
            G = fmaf(gr[r][j + cc], wf[r][cc], G);
        const float d = wav::dpsi<WAV>((xr[j] - tv) * iv);
        acc[j] = fmaf(d * G, iv, acc[j]);
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int j = 0; j < TW; ++j)
    if (w0 + j < sh.W)
      dx[(((size_t)b * sh.H + h) * sh.W + w0 + j) * sh.C + c] = acc[j];
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
  return sizeof(float) * ((size_t)sh.NS * sh.stripStride +
                          (size_t)sh.OCH * kK * kK * sh.CL +
                          2 * (size_t)sh.OCH * sh.CL);
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

template <int WAV, int TW>
cudaError_t launch_dx(const Ptrs& p, const DxShape& sh, cudaStream_t st) {
  auto kernel = wav_conv2d_bwd_dx_kernel<WAV, TW>;
  static size_t granted = 48 * 1024;
  const size_t smem = dx_smem(sh);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.nStrips + sh.NS - 1) / sh.NS,
                  (sh.C + sh.CL - 1) / sh.CL);
  kernel<<<grid, kThreads, smem, st>>>(p.x, p.w, p.t, p.s, p.g, p.out, sh);
  return cudaGetLastError();
}

template <int WAV>
cudaError_t launch_dx_tile(int TW, const Ptrs& p, const DxShape& sh,
                           cudaStream_t st) {
  if (TW == 2) return launch_dx<WAV, 2>(p, sh, st);
  if (TW == 4) return launch_dx<WAV, 4>(p, sh, st);
  return launch_dx<WAV, 8>(p, sh, st);
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
// or wavelet the build does not carry.  The Python wrapper chooses
// TW/CL/OCH (kernels/wav_conv2d.py, dx_launch_config) and validates every
// tensor.
int wav_conv2d_bwd_dx(const void* x, const void* w, const void* t,
                      const void* s, const void* g, void* dx, int B, int H,
                      int W, int C, int O, int k, int pad, int TW, int CL,
                      int OCH, int wavelet, void* stream) {
  DxShape sh;
  sh.B = B; sh.H = H; sh.W = W; sh.C = C; sh.O = O; sh.pad = pad;
  sh.Ho = H + 2 * pad - k + 1;
  sh.Wo = W + 2 * pad - k + 1;
  sh.CL = CL; sh.OCH = OCH;
  sh.NS = CL > 0 ? kThreads / CL : 0;
  if (k != kK || (TW != 2 && TW != 4 && TW != 8) || !pow2_upto(CL, 32) ||
      OCH <= 0 || pad < 0 || sh.Ho <= 0 || sh.Wo <= 0 || wavelet < 0 ||
      wavelet > 4)
    return (int)cudaErrorInvalidValue;
  sh.nSeg = (W + TW - 1) / TW;
  sh.nStrips = B * H * sh.nSeg;
  sh.stripStride = OCH * kK * (TW + kK - 1) + 1;
  if (dx_smem(sh) > 227 * 1024) return (int)cudaErrorInvalidValue;
  const Ptrs p = ptrs(x, w, t, s, g, dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wavelet) {
    case wav::kMexicanHat:
      return (int)launch_dx_tile<wav::kMexicanHat>(TW, p, sh, st);
    case wav::kMorlet: return (int)launch_dx_tile<wav::kMorlet>(TW, p, sh, st);
    case wav::kDog: return (int)launch_dx_tile<wav::kDog>(TW, p, sh, st);
    case wav::kMeyer: return (int)launch_dx_tile<wav::kMeyer>(TW, p, sh, st);
    default: return (int)launch_dx_tile<wav::kShannon>(TW, p, sh, st);
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
