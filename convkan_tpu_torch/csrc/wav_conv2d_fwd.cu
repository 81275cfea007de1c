// wav_conv2d_fwd — WavKAN psi-conv forward for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel convkan_tpu/kernels/fused_wav_conv.py,
// _get_op -> _fwd_kernel (the forward of fused_wav_conv2d).
//
// Function (x NHWC float32, w (3,3,C,O), t and s (O,C), y NHWC float32):
//   y[b,i,j,o] = sum_{c,di,dj} w[di,dj,c,o] * psi((x_pad[b,i+di,j+dj,c] - t[o,c]) / s[o,c])
// with psi := 0 on the pad: the reference pads the psi map, and
// psi(-t/s) != 0 (mexican_hat(0) = -0.867).  The (B,H,W,O*C) psi tensor of
// the XLA path never exists: psi is formed in registers and contracted at
// once.  The kernel multiplies by 1/s (computed once per (o,c) with an IEEE
// divide), as the Pallas kernel does; the plain version divides.
//
// What bounds it on the H100: operations.  Every (input pixel, c, o) needs
// one psi (one expf and ~10 other operations for mexican_hat) that feeds
// k*k = 9 multiply-adds; KAN-VGG16_small has sum H*W*C*O = 2,211,840 such
// triples per image, so at batch 1024 about 2.27e9 psi and 2.0e10 FMAs per
// forward (4.1e10 FLOPs, 0.61 ms at the FP32 rate of 67 TFLOP/s; one SFU
// exp per psi is about as long again).  Bytes are only x, w and y.
//
// What the design does about it:
//   * A thread owns one output channel o and a T x T tile of output pixels
//     (T = 8, or 4 / 2 for small planes): T*T sums in registers.  For each
//     input channel it evaluates psi once per input pixel of the tile's
//     (T+2)^2 halo that lies inside the image (pad positions are skipped:
//     psi = 0 there), row by row, and each value feeds up to 9 FMAs from
//     registers.  psi is recomputed only on the halo shared with the
//     neighbouring tiles (1.0 - 1.4x over VGG16_small's layers).
//   * A block is OC output channels (one per lane, so a warp's lanes read
//     the same x value: a shared-memory broadcast) x S = 256/OC tiles.  It
//     stages CC input channels at a time: the x tiles with their halo, the
//     weights, t and 1/s of its channels.  No shared-memory tile of psi:
//     registers hold it.
// Later work: a shared psi tile across the OC lanes for large O, bf16
// operands, tensor cores for the tap sums.
//
// Interface: a plain C entry point loaded with ctypes.  It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

#include "wav_psi.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kK = 3;  // kernel size the build carries

struct FwdShape {
  int B, H, W, C, O, pad, Ho, Wo;
  int OC, S, CC;       // lanes (output channels), tiles, staged channels
  int tilesH, tilesW;  // tiles per image down and across
  int nTiles;          // B * tilesH * tilesW
  int tileStride;      // floats per staged tile: CC * (T+2)^2 + 1 (odd)
};

template <int WAV, int T>
__global__ void __launch_bounds__(kThreads, 2)
    wav_conv2d_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ t,
                          const float* __restrict__ s, float* __restrict__ y,
                          const FwdShape sh) {
  constexpr int TP = T + kK - 1;  // haloed tile edge
  constexpr int P2 = TP * TP;
  extern __shared__ float smem[];
  float* Xs = smem;                              // [S][CC][P2] (+1 per tile)
  float* Ws = Xs + sh.S * sh.tileStride;         // [CC][k*k][OC]
  float* Ts = Ws + sh.CC * kK * kK * sh.OC;      // [CC][OC]
  float* Is = Ts + sh.CC * sh.OC;                // [CC][OC]: 1/s

  const int tid = threadIdx.x;
  const int ol = tid % sh.OC;
  const int sl = tid / sh.OC;
  const int o = blockIdx.y * sh.OC + ol;
  const int tile = blockIdx.x * sh.S + sl;
  const int perImg = sh.tilesH * sh.tilesW;
  const bool active = tile < sh.nTiles && o < sh.O;

  // the tile's origin and which halo rows / columns lie in the image
  int b = 0, i0 = 0, j0 = 0;
  unsigned rowOk = 0, colOk = 0;
  if (tile < sh.nTiles) {
    b = tile / perImg;
    const int rem = tile - b * perImg;
    i0 = (rem / sh.tilesW) * T;
    j0 = (rem % sh.tilesW) * T;
#pragma unroll
    for (int p = 0; p < TP; ++p) {
      const int h = i0 + p - sh.pad, ww = j0 + p - sh.pad;
      if (h >= 0 && h < sh.H) rowOk |= 1u << p;
      if (ww >= 0 && ww < sh.W) colOk |= 1u << p;
    }
  }

  float acc[T][T];
#pragma unroll
  for (int r = 0; r < T; ++r)
#pragma unroll
    for (int q = 0; q < T; ++q) acc[r][q] = 0.0f;

  for (int c0 = 0; c0 < sh.C; c0 += sh.CC) {
    __syncthreads();  // the previous chunk's readers are done
    // x tiles with halo: idx -> (tile, position, channel), channel fastest
    // so that neighbouring threads read neighbouring addresses
    const int nX = sh.S * P2 * sh.CC;
    for (int idx = tid; idx < nX; idx += kThreads) {
      const int cl = idx % sh.CC;
      const int sp = idx / sh.CC;
      const int pos = sp % P2;
      const int st = sp / P2;
      const int tg = blockIdx.x * sh.S + st;
      const int c = c0 + cl;
      float v = 0.0f;
      if (tg < sh.nTiles && c < sh.C) {
        const int bb = tg / perImg;
        const int rem = tg - bb * perImg;
        const int h = (rem / sh.tilesW) * T + pos / TP - sh.pad;
        const int ww = (rem % sh.tilesW) * T + pos % TP - sh.pad;
        if (h >= 0 && h < sh.H && ww >= 0 && ww < sh.W)
          v = __ldg(&x[(((size_t)bb * sh.H + h) * sh.W + ww) * sh.C + c]);
      }
      Xs[st * sh.tileStride + cl * P2 + pos] = v;
    }
    // weights: idx -> (channel, tap, lane), lane fastest
    for (int idx = tid; idx < sh.CC * kK * kK * sh.OC; idx += kThreads) {
      const int oo = idx % sh.OC;
      const int ct = idx / sh.OC;
      const int tap = ct % (kK * kK);
      const int c = c0 + ct / (kK * kK);
      const int og = blockIdx.y * sh.OC + oo;
      Ws[idx] = (c < sh.C && og < sh.O)
                    ? __ldg(&w[((size_t)tap * sh.C + c) * sh.O + og])
                    : 0.0f;
    }
    for (int idx = tid; idx < sh.CC * sh.OC; idx += kThreads) {
      const int oo = idx % sh.OC;
      const int c = c0 + idx / sh.OC;
      const int og = blockIdx.y * sh.OC + oo;
      const bool ok = c < sh.C && og < sh.O;
      Ts[idx] = ok ? __ldg(&t[(size_t)og * sh.C + c]) : 0.0f;
      Is[idx] = ok ? 1.0f / __ldg(&s[(size_t)og * sh.C + c]) : 0.0f;
    }
    __syncthreads();
    if (!active) continue;
    const int nc = min(sh.CC, sh.C - c0);
    for (int cl = 0; cl < nc; ++cl) {
      float wv[kK][kK];
#pragma unroll
      for (int di = 0; di < kK; ++di)
#pragma unroll
        for (int dj = 0; dj < kK; ++dj)
          wv[di][dj] = Ws[(cl * kK * kK + di * kK + dj) * sh.OC + ol];
      const float tv = Ts[cl * sh.OC + ol];
      const float iv = Is[cl * sh.OC + ol];
      const float* xp = Xs + sl * sh.tileStride + cl * P2;
#pragma unroll
      for (int pr = 0; pr < TP; ++pr) {
        if (!((rowOk >> pr) & 1u)) continue;  // a pad row: psi = 0
        float ps[TP];
#pragma unroll
        for (int pc = 0; pc < TP; ++pc) {
          ps[pc] = 0.0f;
          if ((colOk >> pc) & 1u)
            ps[pc] = wav::psi<WAV>((xp[pr * TP + pc] - tv) * iv);
        }
        // halo row pr feeds output row pr - di through tap row di
#pragma unroll
        for (int di = 0; di < kK; ++di) {
          const int r = pr - di;
          if (r < 0 || r >= T) continue;
#pragma unroll
          for (int q = 0; q < T; ++q)
#pragma unroll
            for (int dj = 0; dj < kK; ++dj)
              acc[r][q] = fmaf(wv[di][dj], ps[q + dj], acc[r][q]);
        }
      }
    }
  }

  if (!active) return;
#pragma unroll
  for (int r = 0; r < T; ++r) {
    const int i = i0 + r;
    if (i >= sh.Ho) continue;
#pragma unroll
    for (int q = 0; q < T; ++q) {
      const int j = j0 + q;
      if (j < sh.Wo)
        y[(((size_t)b * sh.Ho + i) * sh.Wo + j) * sh.O + o] = acc[r][q];
    }
  }
}

size_t fwd_smem(const FwdShape& sh) {
  return sizeof(float) * ((size_t)sh.S * sh.tileStride +
                          (size_t)sh.CC * kK * kK * sh.OC +
                          2 * (size_t)sh.CC * sh.OC);
}

template <int WAV, int T>
cudaError_t launch(const float* x, const float* w, const float* t,
                   const float* s, float* y, const FwdShape& sh,
                   cudaStream_t stream) {
  auto kernel = wav_conv2d_fwd_kernel<WAV, T>;
  const size_t smem = fwd_smem(sh);
  // raise the dynamic shared-memory cap once per instantiation, as needed
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const dim3 grid((sh.nTiles + sh.S - 1) / sh.S, (sh.O + sh.OC - 1) / sh.OC);
  kernel<<<grid, kThreads, smem, stream>>>(x, w, t, s, y, sh);
  return cudaGetLastError();
}

template <int WAV>
cudaError_t launch_tile(int T, const float* x, const float* w, const float* t,
                        const float* s, float* y, const FwdShape& sh,
                        cudaStream_t stream) {
  if (T == 2) return launch<WAV, 2>(x, w, t, s, y, sh, stream);
  if (T == 4) return launch<WAV, 4>(x, w, t, s, y, sh, stream);
  return launch<WAV, 8>(x, w, t, s, y, sh, stream);
}

}  // namespace

extern "C" {

// Launches the forward on `stream`.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a tile, kernel size or wavelet the build does
// not carry.  The Python wrapper chooses T/OC/CC (kernels/wav_conv2d.py,
// fwd_launch_config) and validates every tensor before calling.
int wav_conv2d_fwd(const void* x, const void* w, const void* t,
                   const void* s, void* y, int B, int H, int W, int C, int O,
                   int k, int pad, int T, int OC, int CC, int wavelet,
                   void* stream) {
  FwdShape sh;
  sh.B = B; sh.H = H; sh.W = W; sh.C = C; sh.O = O; sh.pad = pad;
  sh.Ho = H + 2 * pad - k + 1;
  sh.Wo = W + 2 * pad - k + 1;
  sh.OC = OC; sh.CC = CC;
  sh.S = OC > 0 ? kThreads / OC : 0;
  const int TP = T + kK - 1;
  sh.tileStride = CC * TP * TP + 1;
  if (k != kK || (T != 2 && T != 4 && T != 8) || OC <= 0 || OC > 32 ||
      (OC & (OC - 1)) != 0 || CC <= 0 || pad < 0 || sh.Ho <= 0 ||
      sh.Wo <= 0 || wavelet < 0 || wavelet > 4)
    return (int)cudaErrorInvalidValue;
  sh.tilesH = (sh.Ho + T - 1) / T;
  sh.tilesW = (sh.Wo + T - 1) / T;
  sh.nTiles = B * sh.tilesH * sh.tilesW;
  if (fwd_smem(sh) > 227 * 1024) return (int)cudaErrorInvalidValue;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* tp = static_cast<const float*>(t);
  const float* sp = static_cast<const float*>(s);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (wavelet) {
    case wav::kMexicanHat:
      return (int)launch_tile<wav::kMexicanHat>(T, xp, wp, tp, sp, yp, sh, st);
    case wav::kMorlet:
      return (int)launch_tile<wav::kMorlet>(T, xp, wp, tp, sp, yp, sh, st);
    case wav::kDog:
      return (int)launch_tile<wav::kDog>(T, xp, wp, tp, sp, yp, sh, st);
    case wav::kMeyer:
      return (int)launch_tile<wav::kMeyer>(T, xp, wp, tp, sp, yp, sh, st);
    default:
      return (int)launch_tile<wav::kShannon>(T, xp, wp, tp, sp, yp, sh, st);
  }
}

}  // extern "C"
