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
//       dt[o,c] = -sum_q psi'(z) * G / s,   ds[o,c] = -sum_q psi'(z) * G * z / s
//     A thread owns one (o, c) pair and walks the pixels of its split row
//     by row with a 3x3 window of g in registers (3 new loads per pixel):
//     one exp per pixel gives psi and psi', which feed 9 FMAs into dw, 9
//     into G, and the dt / ds sums.  dt and ds live here, not in the data
//     gradient, so that skipping dx (the first conv) never drops them.
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

#include "ordered_sum.cuh"
#include "wav_psi.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 3;  // kernel size the build carries

struct DxShape {
  int B, H, W, C, O, pad, Ho, Wo;
  int CL, NS, OCH;     // lanes (input channels), strips, staged out chans
  int nSeg, nStrips;   // strips per row, B * H * nSeg
  int stripStride;     // floats per staged strip: OCH * 3 * (TW+2) + 1
};

struct ParamShape {
  int B, H, W, C, O, pad, Ho, Wo;
  int OC, CW, RB, S, ips;  // lanes (output channels), input channels,
                           // staged rows, splits, images per split
  int gRow;                // floats of staged g per input row: 3*(W+2)*OC
  size_t N;                // floats per split: 9*C*O + 2*O*C
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
// Block (o chunk, c chunk, split): thread (ol, cw) owns o = o0 + ol and
// c = c0 + cw; the split's images are walked RB rows (of all images, in
// order) at a time.
template <int WAV>
__global__ void __launch_bounds__(kThreads)
    wav_conv2d_bwd_param_kernel(const float* __restrict__ x,
                                const float* __restrict__ w,
                                const float* __restrict__ t,
                                const float* __restrict__ s,
                                const float* __restrict__ g,
                                float* __restrict__ partial,
                                const ParamShape sh) {
  extern __shared__ float smem[];
  const int WP = sh.W + kK - 1;
  float* Gs = smem;                    // [RB][3][WP][OC]
  float* Xs = Gs + sh.RB * sh.gRow;    // [RB][W][CW]

  const int tid = threadIdx.x;
  const int nThreads = blockDim.x;
  const int ol = tid % sh.OC;
  const int cw = tid / sh.OC;
  const int o = blockIdx.x * sh.OC + ol;
  const int c = blockIdx.y * sh.CW + cw;
  const int split = blockIdx.z;
  const bool active = o < sh.O && c < sh.C;

  float wf[kK][kK], dwf[kK][kK];  // index (2 - di, 2 - dj), as in dx
  float tv = 0.0f, iv = 0.0f, dtA = 0.0f, dsA = 0.0f;
#pragma unroll
  for (int r = 0; r < kK; ++r)
#pragma unroll
    for (int cc = 0; cc < kK; ++cc) {
      dwf[r][cc] = 0.0f;
      wf[r][cc] = active ? __ldg(&w[((size_t)((kK - 1 - r) * kK + kK - 1 - cc) *
                                         sh.C + c) * sh.O + o])
                         : 0.0f;
    }
  if (active) {
    tv = __ldg(&t[(size_t)o * sh.C + c]);
    iv = 1.0f / __ldg(&s[(size_t)o * sh.C + c]);
  }

  // global rows R = b * H + h of the split's images
  const int rLo = split * sh.ips * sh.H;
  const int rHi = min(sh.B, (split + 1) * sh.ips) * sh.H;
  for (int r0 = rLo; r0 < rHi; r0 += sh.RB) {
    const int nr = min(sh.RB, rHi - r0);
    __syncthreads();  // the previous rows' readers are done
    // g rows h + pad - 2 .. h + pad of each input row, columns
    // pad - 2 .. W - 1 + pad: idx -> (row, r*WP + col, o), o fastest
    for (int idx = tid; idx < nr * kK * WP * sh.OC; idx += nThreads) {
      const int oo = idx % sh.OC;
      const int rest = idx / sh.OC;
      const int rc = rest % (kK * WP);
      const int R = r0 + rest / (kK * WP);
      const int bb = R / sh.H;
      const int oh = R - bb * sh.H + sh.pad - (kK - 1) + rc / WP;
      const int ow = rc % WP + sh.pad - (kK - 1);
      const int og = blockIdx.x * sh.OC + oo;
      float v = 0.0f;
      if (og < sh.O && oh >= 0 && oh < sh.Ho && ow >= 0 && ow < sh.Wo)
        v = __ldg(&g[(((size_t)bb * sh.Ho + oh) * sh.Wo + ow) * sh.O + og]);
      Gs[idx] = v;
    }
    // x rows: idx -> (row, column, channel), channel fastest
    for (int idx = tid; idx < nr * sh.W * sh.CW; idx += nThreads) {
      const int cg = blockIdx.y * sh.CW + idx % sh.CW;
      const int rest = idx / sh.CW;
      const int R = r0 + rest / sh.W;
      Xs[idx] = cg < sh.C
                    ? __ldg(&x[((size_t)R * sh.W + rest % sh.W) * sh.C + cg])
                    : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    for (int rr = 0; rr < nr; ++rr) {
      const float* gp = Gs + rr * sh.gRow + ol;  // + (r * WP + col) * OC
      const float* xp = Xs + rr * sh.W * sh.CW + cw;
      // win[r][cc]: staged g row r, column ww + cc (tap (2 - r, 2 - cc))
      float win[kK][kK];
#pragma unroll
      for (int r = 0; r < kK; ++r) {
        win[r][0] = 0.0f;
#pragma unroll
        for (int cc = 1; cc < kK; ++cc)
          win[r][cc] = gp[(r * WP + cc - 1) * sh.OC];
      }
      for (int ww = 0; ww < sh.W; ++ww) {
#pragma unroll
        for (int r = 0; r < kK; ++r) {
#pragma unroll
          for (int cc = 0; cc < kK - 1; ++cc) win[r][cc] = win[r][cc + 1];
          win[r][kK - 1] = gp[(r * WP + ww + kK - 1) * sh.OC];
        }
        const float z = (xp[ww * sh.CW] - tv) * iv;
        float p, d;
        wav::psi_dpsi<WAV>(z, &p, &d);
        float G = 0.0f;
#pragma unroll
        for (int r = 0; r < kK; ++r)
#pragma unroll
          for (int cc = 0; cc < kK; ++cc) {
            G = fmaf(win[r][cc], wf[r][cc], G);
            dwf[r][cc] = fmaf(p, win[r][cc], dwf[r][cc]);
          }
        const float dg = d * G;
        dtA += dg;
        dsA = fmaf(dg, z, dsA);
      }
    }
  }

  if (!active) return;
  float* dst = partial + (size_t)split * sh.N;
#pragma unroll
  for (int r = 0; r < kK; ++r)
#pragma unroll
    for (int cc = 0; cc < kK; ++cc)
      dst[((size_t)((kK - 1 - r) * kK + kK - 1 - cc) * sh.C + c) * sh.O + o] =
          dwf[r][cc];
  const size_t nw = (size_t)kK * kK * sh.C * sh.O;
  dst[nw + (size_t)o * sh.C + c] = -dtA * iv;
  dst[nw + (size_t)sh.O * sh.C + (size_t)o * sh.C + c] = -dsA * iv;
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

size_t param_smem(const ParamShape& sh) {
  return sizeof(float) * (size_t)sh.RB * (sh.gRow + (size_t)sh.W * sh.CW);
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

template <int WAV>
cudaError_t launch_param(const Ptrs& p, const ParamShape& sh,
                         cudaStream_t st) {
  auto kernel = wav_conv2d_bwd_param_kernel<WAV>;
  static size_t granted = 48 * 1024;
  const size_t smem = param_smem(sh);
  const cudaError_t err = grant_smem(kernel, smem, &granted);
  if (err != cudaSuccess) return err;
  const dim3 grid((sh.O + sh.OC - 1) / sh.OC, (sh.C + sh.CW - 1) / sh.CW,
                  sh.S);
  kernel<<<grid, sh.OC * sh.CW, smem, st>>>(p.x, p.w, p.t, p.s, p.g, p.out,
                                            sh);
  return cudaGetLastError();
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
// The wrapper chooses OC/CW/RB/S/ips (param_launch_config).
int wav_conv2d_bwd_param(const void* x, const void* w, const void* t,
                         const void* s, const void* g, void* partial, int B,
                         int H, int W, int C, int O, int k, int pad, int OC,
                         int CW, int RB, int S, int ips, int wavelet,
                         void* stream) {
  ParamShape sh;
  sh.B = B; sh.H = H; sh.W = W; sh.C = C; sh.O = O; sh.pad = pad;
  sh.Ho = H + 2 * pad - k + 1;
  sh.Wo = W + 2 * pad - k + 1;
  sh.OC = OC; sh.CW = CW; sh.RB = RB; sh.S = S; sh.ips = ips;
  sh.gRow = kK * (W + kK - 1) * OC;
  sh.N = (size_t)kK * kK * C * O + 2 * (size_t)O * C;
  if (k != kK || !pow2_upto(OC, 32) || !pow2_upto(CW, kThreads) ||
      OC * CW > kThreads || RB <= 0 || S <= 0 || S > 65535 || ips <= 0 ||
      (S - 1) * ips >= B || pad < 0 || sh.Ho <= 0 || sh.Wo <= 0 ||
      wavelet < 0 || wavelet > 4 || param_smem(sh) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const Ptrs p = ptrs(x, w, t, s, g, partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wavelet) {
    case wav::kMexicanHat:
      return (int)launch_param<wav::kMexicanHat>(p, sh, st);
    case wav::kMorlet: return (int)launch_param<wav::kMorlet>(p, sh, st);
    case wav::kDog: return (int)launch_param<wav::kDog>(p, sh, st);
    case wav::kMeyer: return (int)launch_param<wav::kMeyer>(p, sh, st);
    default: return (int)launch_param<wav::kShannon>(p, sh, st);
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
