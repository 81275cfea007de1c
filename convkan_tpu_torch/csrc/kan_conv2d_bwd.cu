// kan_conv2d_bwd — B-spline KAN convolution backward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel convkan_tpu/kernels/wide_kan_conv.py,
// _make_core -> bwd_kernel (run_bwd, the custom_vjp backward of the wide
// KAN conv).  The forward is csrc/kan_conv2d_fwd.cu; the function is
//   y[b,i,j,o] = sum_{di,dj} sum_r E[b,i+di,j+dj,r] * W_all[r, (di*k+dj)*O+o]
//   E = [B_0(x) .. B_{K-1}(x), act(x)] on the zero-padded frame, zero on the
//   pad AFTER expansion; W_all rows kk*C + c, columns tap-major.
// Given g = dL/dy (B, Ho, Wo, O) this file computes, as three kernels:
//
//   * kan_conv2d_bwd_dx: the data gradient.  For every interior input pixel
//     p and channel c,
//       dE[p, kk*C+c] = sum_taps sum_o g[p - tap + pad, o] * W_all[kk*C+c, tap*O+o]
//     (a transposed convolution, reduction k*k*O), and in the epilogue
//       dx[p, c] = sum_kk dE[p, kk*C+c] * B'_kk(x) + dE[p, K*C+c] * act'(x).
//     dE lives only in registers: a thread owns ONE channel of a few
//     pixels and keeps all K+1 of its dE values, so the chain rule through
//     the basis runs in the same thread.  Pad pixels need no dE (the mask
//     zeroes them), so only interior pixels are computed.  B' is the
//     derivative of the forward's Cox-de Boor recurrence carried along with
//     it (the degree-0 indicator has derivative 0), and act' is computed
//     from x: no act(x) tensor is materialized.
//   * kan_conv2d_bwd_dw: the weight gradient, in partial sums.
//       dW[r, tap*O+o] = sum_{b,i,j} E[b, i+di, j+dj, r] * g[b, i, j, o]
//     written as a sum over interior input pixels p of E[p, r] * dZ[p, n],
//     dZ[p, tap*O+o] = g[p - tap + pad, o] (zero off the output frame).  E is
//     recomputed per pixel chunk in shared memory (never stored to global
//     memory); a block owns the (K+1)*CC rows of CC whole channels x a
//     BN-column tile of dW and one of S contiguous batch splits, and
//     writes its partial sum.
//   * kan_conv2d_bwd_dw_reduce: dW = sum over the S partials in a fixed
//     order, the shared kernel of csrc/ordered_sum.cuh (a thread owns a
//     float4 of columns; S is cut into leaves summed by the thread rows of a
//     block and the ranks of a thread-block cluster where N is small,
//     combined in row order, then rank order).  With the fixed split and
//     the fixed orders, two runs give bit-identical dW (no atomics
//     anywhere).
//
// What bounds it on the H100: arithmetic, as in the forward.  dx and dW each
// cost 2 * (interior pixel, tap) pairs * (K+1)*C * O FLOPs, the forward's
// count (about 0.36 GFLOP per image each over KAN-VGG16_small), on float32
// operands outside the tensor cores (67 TFLOP/s); bytes are a few MB per
// layer.  What the design does about it:
//   * dx: the haloed g tile of an output-channel chunk and the weight slices
//     of all k*k taps for the block's channels are staged in shared memory
//     once per chunk; per four output channels a thread does 4 float4 g
//     loads + (K+1) float4 weight loads for 4*(K+1)*4 = 144 FMAs.
//   * dW: each thread keeps ONE input channel's K+1 = 9 expanded rows x 8
//     columns of sums (72) in registers; per pixel the channel's 9 E values
//     (two float4s and a float, the same address for every thread of that
//     channel) and two float4s of dZ feed 72 FMAs.  Rows are whole
//     channels, so no row is padded.  The column tile BN is a multiple of 8
//     that divides k*k*O where it can (144 at O = 16, 2 x 144 at O = 32,
//     3 x 192 at O = 64, 6 x 192 at O = 128: no padded column), as wide as
//     the block's threads cover: the basis (with its IEEE divides, the
//     costliest part per value) is recomputed once per column tile, and
//     only the ORDER+1 bases that can be non-zero at x are evaluated
//     (bspline_span of kan_bspline.cuh: 12 divides instead of 54 for grid 5,
//     order 3).  A block has CC*BN/8 threads rounded up to whole warps; where
//     that fills at most half of 256 (few channels, as in the first conv:
//     3 x 18 threads), PW = 256 / (CC*BN/8) copies of it split each chunk's
//     pixels and are summed in shared memory in slice order at the end (one
//     launch, a fixed order).  dZ is gathered one float4 (one tap, 4 output
//     channels) per load when O % 4 == 0.
// Later work, in order: a haloed g tile per chunk shared by the taps and
// double-buffered with cp.async; skipping pad pairs; fusing the dW
// reduction into the weight kernel (once its own split is redesigned);
// tensor cores (3xTF32 wgmma); only the ORDER+1 non-zero basis rows per
// value.
//
// Numerics: the basis values come from kan_bspline.cuh, the forward's own
// code (explicitly rounded float32 operations, true IEEE divides), so the E
// recomputed here is bit-identical to the forward's for finite x.  Build
// WITHOUT --use_fast_math.
//
// Interface: plain C entry points loaded with ctypes.  Each launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "kan_bspline.cuh"
#include "ordered_sum.cuh"

namespace {

using namespace kan;

constexpr int kThreads = 256;
constexpr int kDxTM = 4;          // dx: pixels per thread
constexpr int kDxThreadsM = 32;   // dx: pixel slots of threads
constexpr int kDxMaxCC = 8;       // dx: channels per block (one per thread)
constexpr int kDwMaxThreads = 256;  // dW: threads of a block at most
constexpr int kDwTN = 8;            // dW: columns per thread (two float4s)

struct DxShape {
  int B, H, W, C, O, k, pad, Ho, Wo;
  int TH, NB, CC, OC;  // block tile: input rows, images, channels, O chunk
  int tileH, tileW;    // haloed g tile: TH + k - 1 rows, W + k - 1 columns
  int gs;              // floats per staged pixel / weight row: OC padded
};

struct DwShape {
  int B, H, W, C, O, k, pad, Ho, Wo;
  int CC, BN, P, S, ips;  // channels, columns, pixels per chunk, splits,
                          // images per split
  int PW, threads;        // pixel slices; PW*CC*BN/8 in whole warps
};

// dW: floats per channel of an expanded pixel, K+1 rounded up to float4s
__host__ __device__ constexpr int dw_channel_stride(int K1) {
  return (K1 + 3) / 4 * 4;
}

// d act / dx: SiLU' = s (1 + x (1 - s)); GELU' (erf) = Phi(x) + x phi(x)
template <int ACT>
__device__ __forceinline__ float base_act_grad(float x) {
  if (ACT == 0) {
    const float s = 1.0f / (1.0f + expf(-x));
    return s * (1.0f + x * (1.0f - s));
  }
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
  const float pdf = expf(-0.5f * x * x) * 0.39894228040143267794f;
  return cdf + x * pdf;
}

// d B_i / dx over the same knot span, carried through the recurrence with
// the values (the degree-0 indicator has derivative 0):
//   b_i <- a b_i + c b_{i+1},   a = (x - t_i)/dr,  c = (t_{i+k+1} - x)/dd
//   d_i <- b_i/dr + a d_i - b_{i+1}/dd + c d_{i+1}
// with the same f32-rounded knot deltas, zero guard and IEEE divides.
// Returns j as bspline_span does; D[m] is the derivative of basis
// j - ORDER + m.
template <int NK, int ORDER>
__device__ __forceinline__ int bspline_span_grad(float x, const float* kn,
                                                 float* D) {
  int j = -1;
#pragma unroll
  for (int i = 0; i < NK - 1; ++i)
    if (x >= kn[i] && x < kn[i + 1]) j = i;
  float N[ORDER + 1];
  N[0] = 1.0f;
  D[0] = 0.0f;
#pragma unroll
  for (int k = 1; k <= ORDER; ++k) {
    float nw[ORDER + 1], nd[ORDER + 1];
#pragma unroll
    for (int m = 0; m <= k; ++m) {
      const int i = j - k + m;
      float v = 0.0f, dv = 0.0f;
      if (i >= 0 && i <= NK - 2 - k) {
        float dr = __fsub_rn(kn[i + k], kn[i]);
        float dd = __fsub_rn(kn[i + k + 1], kn[i + 1]);
        if (dr == 0.0f) dr = 1.0f;
        if (dd == 0.0f) dd = 1.0f;
        if (m >= 1) {
          const float a = __fdiv_rn(__fsub_rn(x, kn[i]), dr);
          v = __fmul_rn(a, N[m - 1]);
          dv = __fdiv_rn(N[m - 1], dr) + a * D[m - 1];
        }
        if (m <= k - 1) {
          const float c = __fdiv_rn(__fsub_rn(kn[i + k + 1], x), dd);
          const float t2 = __fmul_rn(c, N[m]);
          v = m >= 1 ? __fadd_rn(v, t2) : t2;
          dv += c * D[m] - __fdiv_rn(N[m], dd);
        }
      }
      nw[m] = v;
      nd[m] = dv;
    }
#pragma unroll
    for (int m = 0; m <= k; ++m) {
      N[m] = nw[m];
      D[m] = nd[m];
    }
  }
  return j;
}

// ------------------------------------------------------------ data gradient
// Block: NB images x TH input rows x all W columns x CC channels; thread
// (tm, tn) owns channel c0 + tn of pixels tm, tm + 32, tm + 64, tm + 96.
template <int NK, int ORDER, int ACT>
__global__ void __launch_bounds__(kThreads, 2)
    kan_conv2d_bwd_dx_kernel(const float* __restrict__ x,
                             const float* __restrict__ w_all,
                             const float* __restrict__ g,
                             float* __restrict__ dx, const DxShape s,
                             const Knots kn) {
  constexpr int K = NK - ORDER - 1;
  constexpr int K1 = K + 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int k = s.k;
  const int T = k * k;
  const int R9 = K1 * s.CC;  // weight rows of the block: kk*CC + cl
  const int GS = s.gs;
  const int tilePlane = s.tileH * s.tileW;
  const int tilePix = s.NB * tilePlane;
  float* Gs = smem;                   // [tilePix][GS]: haloed g chunk
  float* Ws = Gs + tilePix * GS;      // [T][R9][GS]: weight chunk
  int* rowG = reinterpret_cast<int*>(Ws + T * R9 * GS);  // [R9]: kk*C + cl
  __shared__ float knS[kMaxKnots];

  const int rowChunks = (s.H + s.TH - 1) / s.TH;
  const int b0 = (blockIdx.x / rowChunks) * s.NB;
  const int i0 = (blockIdx.x % rowChunks) * s.TH;
  const int c0 = blockIdx.y * s.CC;

  const int tid = threadIdx.x;
  const int tn = tid % s.CC;
  const int tm = tid / s.CC;
  const bool active = tm < kDxThreadsM;
  const int pixPerImg = s.TH * s.W;
  const int MT = s.NB * pixPerImg;

  // tile offset of each pixel's g at tap (0, 0): row ti + k - 1, column
  // j + k - 1; tap (di, dj) reads (di * tileW + dj) pixels before it
  int gbase[kDxTM];
  bool valid[kDxTM];
#pragma unroll
  for (int q = 0; q < kDxTM; ++q) {
    const int m = tm + q * kDxThreadsM;
    const int nb = m / pixPerImg;
    const int rem = m - nb * pixPerImg;
    const int ti = rem / s.W;
    const int j = rem - ti * s.W;
    valid[q] = active && m < MT && b0 + nb < s.B && i0 + ti < s.H;
    gbase[q] = valid[q] ? (nb * tilePlane + (ti + k - 1) * s.tileW + j + k - 1)
                        : (k - 1) * s.tileW + k - 1;  // a safe dummy
    gbase[q] *= GS;
  }
  for (int r = tid; r < R9; r += kThreads)
    rowG[r] = (r / s.CC) * s.C + r % s.CC;
  if (tid < kMaxKnots) knS[tid] = kn.v[tid];

  float acc[kDxTM][K1];
#pragma unroll
  for (int q = 0; q < kDxTM; ++q)
#pragma unroll
    for (int kk = 0; kk < K1; ++kk) acc[q][kk] = 0.0f;

  const size_t wCols = (size_t)T * s.O;
  const int gRow0 = i0 + s.pad - (k - 1);  // g row of tile row 0
  const int gCol0 = s.pad - (k - 1);       // g column of tile column 0
  for (int oc0 = 0; oc0 < s.O; oc0 += s.OC) {
    __syncthreads();  // rowG is ready; the previous chunk's readers are done
    for (int idx = tid; idx < tilePix * s.OC; idx += kThreads) {
      const int pix = idx / s.OC;
      const int o = idx - pix * s.OC;
      const int nb = pix / tilePlane;
      const int rem = pix - nb * tilePlane;
      const int gr = rem / s.tileW;
      const int gc = rem - gr * s.tileW;
      const int b = b0 + nb, gi = gRow0 + gr, gj = gCol0 + gc, oo = oc0 + o;
      float v = 0.0f;
      if (b < s.B && gi >= 0 && gi < s.Ho && gj >= 0 && gj < s.Wo && oo < s.O)
        v = __ldg(&g[(((size_t)b * s.Ho + gi) * s.Wo + gj) * s.O + oo]);
      Gs[pix * GS + o] = v;
    }
    for (int idx = tid; idx < T * R9 * s.OC; idx += kThreads) {
      const int o = idx % s.OC;
      const int tr = idx / s.OC;
      const int tap = tr / R9;
      const int r = tr - tap * R9;
      const int cl = r % s.CC;
      float v = 0.0f;
      if (c0 + cl < s.C && oc0 + o < s.O)
        v = __ldg(&w_all[(size_t)(rowG[r] + c0) * wCols + (size_t)tap * s.O +
                         oc0 + o]);
      Ws[tr * GS + o] = v;
    }
    __syncthreads();
    if (active) {
      for (int tap = 0; tap < T; ++tap) {
        const int di = tap / k, dj = tap - (tap / k) * k;
        const int shift = (di * s.tileW + dj) * GS;
        const float* Wt = Ws + (tap * R9 + tn) * GS;  // row kk*CC + tn
        for (int o = 0; o < s.OC; o += 4) {
          float4 wv[K1];
#pragma unroll
          for (int kk = 0; kk < K1; ++kk)
            wv[kk] = *reinterpret_cast<const float4*>(Wt + kk * s.CC * GS + o);
#pragma unroll
          for (int q = 0; q < kDxTM; ++q) {
            const float4 gv =
                *reinterpret_cast<const float4*>(Gs + gbase[q] - shift + o);
#pragma unroll
            for (int kk = 0; kk < K1; ++kk) {
              acc[q][kk] = fmaf(gv.x, wv[kk].x, acc[q][kk]);
              acc[q][kk] = fmaf(gv.y, wv[kk].y, acc[q][kk]);
              acc[q][kk] = fmaf(gv.z, wv[kk].z, acc[q][kk]);
              acc[q][kk] = fmaf(gv.w, wv[kk].w, acc[q][kk]);
            }
          }
        }
      }
    }
  }

  // epilogue: the chain rule through the basis and the base activation
  const int c = c0 + tn;
  if (!active || c >= s.C) return;
#pragma unroll
  for (int q = 0; q < kDxTM; ++q) {
    if (!valid[q]) continue;
    const int m = tm + q * kDxThreadsM;
    const int nb = m / pixPerImg;
    const int rem = m - nb * pixPerImg;
    const int ti = rem / s.W;
    const int j = rem - ti * s.W;
    const size_t at =
        (((size_t)(b0 + nb) * s.H + (i0 + ti)) * s.W + j) * s.C + c;
    const float xv = __ldg(&x[at]);
    float D[ORDER + 1];
    const int j0 = bspline_span_grad<NK, ORDER>(xv, knS, D) - ORDER;
    float sum = acc[q][K] * base_act_grad<ACT>(xv);
    // basis kk = j0 + m has derivative D[m]; the others have 0 (static
    // register indices only)
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int m = 0; m <= ORDER; ++m)
        if (kk == j0 + m) sum = fmaf(acc[q][kk], D[m], sum);
    dx[at] = sum;
  }
}

// ---------------------------------------------------------- weight gradient
// Block (channel chunk, column tile, split): channels c0..c0+CC-1, columns
// n0..n0+BN-1 of the k*k*O tap-major columns, images [split*ips,
// split*ips + ips), summed over their interior pixels in chunks of P.
// Thread t is pixel slice t / (CC*G) (G = BN/8 column groups), channel
// cl = t % CC and column group tn = (t / CC) % G of the slice: it keeps
// channel cl's K+1 expanded rows x columns {tn*4 .. tn*4+3, BN/2 + tn*4 ..
// BN/2 + tn*4+3} in registers and sums pixels slice, slice + PW, ... of
// each chunk.  The PW slices' tiles are added in slice order at the end.
template <int NK, int ORDER, int ACT>
__global__ void __launch_bounds__(kDwMaxThreads, 2)
    kan_conv2d_bwd_dw_kernel(const float* __restrict__ x,
                             const float* __restrict__ g,
                             float* __restrict__ partial, const DwShape s,
                             const Knots kn) {
  constexpr int K = NK - ORDER - 1;
  constexpr int K1 = K + 1;
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

  if (tid < kMaxKnots) knS[tid] = kn.v[tid];

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
        float N[ORDER + 1];
        const int j = bspline_span<NK, ORDER>(xv, knS, N);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) Ep[kk] = 0.0f;
        if (j >= 0) {
#pragma unroll
          for (int m = 0; m <= ORDER; ++m) {
            const int kk = j - ORDER + m;
            if (kk >= 0 && kk < K) Ep[kk] = N[m];
          }
        }
        Ep[K] = base_act<ACT>(xv);
      } else {
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
        // the channel's K+1 values: float4s, then single floats
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

size_t dx_smem(const DxShape& s, int K1) {
  return sizeof(float) *
             ((size_t)s.NB * s.tileH * s.tileW * s.gs +
              (size_t)s.k * s.k * K1 * s.CC * s.gs) +
         sizeof(int) * (size_t)K1 * s.CC;
}

// the staged chunk (expanded input, gathered g, pixel table), or the
// slices' tiles handed to slice 0 at the end, whichever is larger
size_t dw_smem(const DwShape& s, int K1) {
  const size_t staged =
      sizeof(float) * (size_t)s.P * (dw_channel_stride(K1) * s.CC + s.BN) +
      3 * sizeof(int) * (size_t)s.P;
  const size_t slices =
      sizeof(float) * (size_t)(s.PW - 1) * K1 * s.CC * s.BN;
  return staged > slices ? staged : slices;
}

template <int NK, int ORDER, int ACT>
cudaError_t launch_dx(const float* x, const float* w_all, const float* g,
                      float* dx, const DxShape& s, const Knots& kn,
                      cudaStream_t stream) {
  auto kernel = kan_conv2d_bwd_dx_kernel<NK, ORDER, ACT>;
  static size_t granted = 48 * 1024;
  const size_t smem = dx_smem(s, NK - ORDER);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const int rowChunks = (s.H + s.TH - 1) / s.TH;
  const dim3 grid(rowChunks * ((s.B + s.NB - 1) / s.NB),
                  (s.C + s.CC - 1) / s.CC);
  kernel<<<grid, kThreads, smem, stream>>>(x, w_all, g, dx, s, kn);
  return cudaGetLastError();
}

template <int NK, int ORDER, int ACT>
cudaError_t launch_dw(const float* x, const float* g, float* partial,
                      const DwShape& s, const Knots& kn, cudaStream_t stream) {
  auto kernel = kan_conv2d_bwd_dw_kernel<NK, ORDER, ACT>;
  static size_t granted = 48 * 1024;
  const size_t smem = dw_smem(s, NK - ORDER);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((s.C + s.CC - 1) / s.CC,
                  (s.k * s.k * s.O + s.BN - 1) / s.BN, s.S);
  kernel<<<grid, s.threads, smem, stream>>>(x, g, partial, s, kn);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Data gradient dx (B, H, W, C) of the KAN conv for g (B, Ho, Wo, O).
// Returns a cudaError_t (0 = success); cudaErrorInvalidValue for a tile or
// spline the build does not carry.  The Python wrapper chooses TH/NB/CC/OC
// (kernels/kan_conv2d.py, dx_launch_config) and validates every tensor.
int kan_conv2d_bwd_dx(const void* x, const void* w_all, const void* g,
                      void* dx, int B, int H, int W, int C, int O, int k,
                      int pad, int TH, int NB, int CC, int OC,
                      const float* knots, int n_knots, int order, int act,
                      void* stream) {
  DxShape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.k = k; s.pad = pad;
  s.Ho = H + 2 * pad - k + 1;
  s.Wo = W + 2 * pad - k + 1;
  s.TH = TH; s.NB = NB; s.CC = CC; s.OC = OC;
  s.tileH = TH + k - 1;
  s.tileW = W + k - 1;
  // OC rounded to an odd number of float4s, so the CC channels' weight
  // rows read by neighbouring threads fall in different banks
  s.gs = (OC / 4) % 2 == 1 ? OC : OC + 4;
  Knots kn;
  if (CC <= 0 || CC > kDxMaxCC || OC <= 0 || OC % 4 != 0 || TH <= 0 ||
      NB <= 0 || NB * TH * W > kDxThreadsM * kDxTM || s.Ho <= 0 ||
      s.Wo <= 0 || (act != 0 && act != 1) || !load_knots(knots, n_knots, &kn))
    return (int)cudaErrorInvalidValue;
  if (dx_smem(s, n_knots - order) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w_all);
  const float* gp = static_cast<const float*>(g);
  float* dxp = static_cast<float*>(dx);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_knots == 12 && order == 3) {  // grid_size 5, spline_order 3
    return (int)(act == 0 ? launch_dx<12, 3, 0>(xp, wp, gp, dxp, s, kn, st)
                          : launch_dx<12, 3, 1>(xp, wp, gp, dxp, s, kn, st));
  }
  return (int)cudaErrorInvalidValue;
}

// Weight-gradient partial sums (S, (K+1)*C, k*k*O): split s sums images
// [s*ips, min(B, s*ips + ips)).  The wrapper chooses CC/BN/P/S/ips/PW
// (dw_launch_config); g must be 16-byte aligned when O % 4 == 0.
int kan_conv2d_bwd_dw(const void* x, const void* g, void* partial, int B,
                      int H, int W, int C, int O, int k, int pad, int CC,
                      int BN, int P, int S, int ips, int PW,
                      const float* knots, int n_knots, int order, int act,
                      void* stream) {
  DwShape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.k = k; s.pad = pad;
  s.Ho = H + 2 * pad - k + 1;
  s.Wo = W + 2 * pad - k + 1;
  s.CC = CC; s.BN = BN; s.P = P; s.S = S; s.ips = ips; s.PW = PW;
  const int K1 = n_knots - order;
  const long long slots = (long long)PW * CC * (BN / kDwTN);
  s.threads = (int)((slots + 31) / 32 * 32);
  const bool vec = O % 4 == 0;
  Knots kn;
  if (CC <= 0 || BN < kDwTN || BN % kDwTN != 0 || PW <= 0 ||
      slots > kDwMaxThreads || BN / (vec ? 4 : 1) > s.threads || P <= 0 ||
      S <= 0 || ips <= 0 || s.Ho <= 0 || s.Wo <= 0 ||
      (act != 0 && act != 1) ||
      (vec && reinterpret_cast<size_t>(g) % 16 != 0) ||
      !load_knots(knots, n_knots, &kn) || dw_smem(s, K1) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* gp = static_cast<const float*>(g);
  float* pp = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_knots == 12 && order == 3) {
    return (int)(act == 0 ? launch_dw<12, 3, 0>(xp, gp, pp, s, kn, st)
                          : launch_dw<12, 3, 1>(xp, gp, pp, s, kn, st));
  }
  return (int)cudaErrorInvalidValue;
}

// dW = the (S, N) partials summed over S in the fixed order of
// csrc/ordered_sum.cuh; VW, Gw and Gc from reduce_launch_config.
int kan_conv2d_bwd_dw_reduce(const void* partial, void* out, int S, int N,
                             int VW, int Gw, int Gc, void* stream) {
  return (int)ordered_sum::launch(partial, out, S, N, VW, Gw, Gc,
                                  static_cast<cudaStream_t>(stream));
}

}  // extern "C"
