// kan_conv2d_fwd — B-spline KAN convolution forward for Hopper (sm_90a).
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
//   E = [B_0(x) .. B_{K-1}(x), act(x)] on the zero-padded frame, multiplied by
//   the validity mask: the pad is zero AFTER expansion (B-spline(0) != 0).
//   W_all rows kk*C+c (basis kk of channel c), then C rows of the base path;
//   columns tap-major.  This is pack_w_all(..., degree_major=False).
//
// What bounds it on the H100: arithmetic.  The useful work is
// 2*B*Ho*Wo*k*k*(K+1)*C*O FLOPs (about 0.358 GFLOP per image over the 13
// layers of KAN-VGG16_small), while each input is read once and each output
// written once (a few MB per layer at batch 1024).  Operands are float32, so
// the ceiling is the FP32 rate outside the tensor cores (67 TFLOP/s on an
// H100 SXM at 700 W): about 5.5 ms for the whole model at batch 1024.
//
// What the design does about that bound:
//   * A block owns NB images x TH output rows x all Wo columns x BN output
//     channels.  It walks the input channels in chunks of CC: the haloed x
//     tile is expanded ONCE into (K+1)*CC masked rows in shared memory, and
//     then every tap reads that tile shifted, so the basis (about 160
//     operations per value, with true divides) costs little next to the
//     9*(K+1)*BN multiply-adds each expanded value feeds.
//   * Each thread keeps a 4-pixel x 4-channel tile of sums in registers.
//     The expanded tile is stored pixel-major ([pixel][(K+1)*CC], row
//     stride padded so neighbouring pixels hit different banks), so four
//     reduction steps cost one float4 load per pixel plus four float4 loads
//     of weights: 8 shared-memory loads feed 64 FMAs.
//   * W_all (at most 9*128 x 9*128 floats, 5.3 MB) is read from global memory
//     and stays in the 50 MB L2.  Each tap's CC-channel slice is staged in
//     shared memory, double-buffered: the next tap's slice is loaded into
//     registers while the current one is consumed, so the L2 latency hides
//     behind the FMAs and each tap costs one barrier.
// Later work: tensor cores (wgmma on TF32/bf16 operands) and TMA staging.
//
// Numerics: the basis uses the reference recurrence step for step with
// explicitly rounded float32 operations (no FMA contraction, true IEEE
// divides); the knots arrive as float32 kernel arguments.  Build WITHOUT
// --use_fast_math: it would turn the divides approximate and expf into
// __expf.
//
// Interface: a plain C entry point loaded with ctypes.  It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTM = 4;  // output pixels per thread
constexpr int kTN = 4;  // output channels per thread (one float4)
constexpr int kMaxKnots = 32;
constexpr int kMaxRS = 76;  // (K+1)*CC padded, for K+1 = 9 and CC <= 8
constexpr int kWRegs = (kMaxRS + 3) / 4;  // weight rows a thread stages (BN=64)

struct Knots {
  float v[kMaxKnots];
};

struct Shape {
  int B, H, W, C, O, k, pad, Ho, Wo;
  int BN, TH, NB, CC;  // block tile: channels, rows, images, input chunk
  int tile;            // padded-frame pixels in a block's tile
  int rs;              // floats per expanded pixel: (K+1)*CC rounded up
};

template <int ACT>
__device__ __forceinline__ float base_act(float x) {
  if (ACT == 0) return x / (1.0f + expf(-x));                        // SiLU
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));      // GELU
}

// Cox-de Boor over NK knots, degree ORDER: writes NK-ORDER-1 bases.
template <int NK, int ORDER>
__device__ __forceinline__ void bspline(float x, const Knots& kn,
                                        float* out) {
  float b[NK - 1];
#pragma unroll
  for (int i = 0; i < NK - 1; ++i)
    b[i] = (x >= kn.v[i] && x < kn.v[i + 1]) ? 1.0f : 0.0f;
#pragma unroll
  for (int k = 1; k <= ORDER; ++k) {
#pragma unroll
    for (int i = 0; i < NK - 1 - k; ++i) {
      float dr = __fsub_rn(kn.v[i + k], kn.v[i]);
      float dd = __fsub_rn(kn.v[i + k + 1], kn.v[i + 1]);
      if (dr == 0.0f) dr = 1.0f;
      if (dd == 0.0f) dd = 1.0f;
      const float t1 = __fmul_rn(__fdiv_rn(__fsub_rn(x, kn.v[i]), dr), b[i]);
      const float t2 =
          __fmul_rn(__fdiv_rn(__fsub_rn(kn.v[i + k + 1], x), dd), b[i + 1]);
      b[i] = __fadd_rn(t1, t2);
    }
  }
#pragma unroll
  for (int i = 0; i < NK - ORDER - 1; ++i) out[i] = b[i];
}

// WR: weight rows each thread stages per tap (ceil(rs / (256 / BN))); a
// template argument so the staging registers match the tile width
template <int NK, int ORDER, int ACT, int WR>
__global__ void __launch_bounds__(kThreads, 2)
    kan_conv2d_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ w_all,
                          float* __restrict__ y, const Shape s,
                          const Knots kn) {
  constexpr int K = NK - ORDER - 1;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);

  const int k = s.k;
  const int Wp = s.W + 2 * s.pad;
  const int tileH = s.TH + k - 1;
  const int imgPlane = tileH * Wp;
  const int RS = s.rs;
  const int R = (K + 1) * s.CC;
  float* Es = smem;                // [tile][RS]: expanded, masked input
  float* Ws = smem + s.tile * RS;  // [2][RS][BN]: two taps' weight slices

  const int rowChunks = (s.Ho + s.TH - 1) / s.TH;
  const int b0 = (blockIdx.x / rowChunks) * s.NB;
  const int i0 = (blockIdx.x % rowChunks) * s.TH;
  const int o0 = blockIdx.y * s.BN;

  const int tid = threadIdx.x;
  const int threadsN = s.BN / kTN;
  const int threadsM = kThreads / threadsN;
  const int tn = tid % threadsN;
  const int tm = tid / threadsN;
  const int pixPerImg = s.TH * s.Wo;
  const int MT = s.NB * pixPerImg;

  int base[kTM];
  bool valid[kTM];
#pragma unroll
  for (int q = 0; q < kTM; ++q) {
    const int m = tm + q * threadsM;
    const int nb = m / pixPerImg;
    const int rem = m - nb * pixPerImg;
    const int ti = rem / s.Wo;
    const int j = rem - ti * s.Wo;
    valid[q] = m < MT && b0 + nb < s.B && i0 + ti < s.Ho;
    base[q] = (valid[q] ? nb * imgPlane + ti * Wp + j : 0) * RS;
  }
  // the row padding R..RS-1 of every pixel stays zero for all chunks
  for (int idx = tid; idx < s.tile * (RS - R); idx += kThreads)
    Es[(idx / (RS - R)) * RS + R + idx % (RS - R)] = 0.0f;

  float acc[kTM][kTN];
#pragma unroll
  for (int q = 0; q < kTM; ++q)
#pragma unroll
    for (int n = 0; n < kTN; ++n) acc[q][n] = 0.0f;

  // row rr of a weight slice is W_all row kk*C + c0 + cl, rr = kk*CC + cl
  int* rowG = reinterpret_cast<int*>(Ws + 2 * RS * s.BN);  // [RS]: kk*C+cl
  int* rowCl = rowG + RS;                                   // [RS]: cl
  for (int rr = tid; rr < RS; rr += kThreads) {
    rowG[rr] = rr < R ? (rr / s.CC) * s.C + rr % s.CC : -1;
    rowCl[rr] = rr % s.CC;
  }
  const size_t wCols = (size_t)k * k * s.O;
  // each thread stages column wn of rows wr0, wr0 + wStep, ...
  const int wn = tid % s.BN, wr0 = tid / s.BN, wStep = kThreads / s.BN;
  float wreg[WR];
  int c0 = 0;
  auto loadW = [&](int tap) {
    const int o = o0 + wn;
#pragma unroll
    for (int u = 0; u < WR; ++u) {
      const int rr = wr0 + u * wStep;
      wreg[u] = 0.0f;
      if (rr < RS && o < s.O) {
        const int g = rowG[rr];
        if (g >= 0 && c0 + rowCl[rr] < s.C)
          wreg[u] = __ldg(&w_all[(size_t)(g + c0) * wCols +
                                 (size_t)tap * s.O + o]);
      }
    }
  };
  auto storeW = [&](float* dst) {
#pragma unroll
    for (int u = 0; u < WR; ++u) {
      const int rr = wr0 + u * wStep;
      if (rr < RS) dst[rr * s.BN + wn] = wreg[u];
    }
  };

  for (; c0 < s.C; c0 += s.CC) {
    __syncthreads();  // every reader of the previous chunk is done
    for (int idx = tid; idx < s.CC * s.tile; idx += kThreads) {
      const int pix = idx / s.CC;
      const int cl = idx - pix * s.CC;
      const int nb = pix / imgPlane;
      const int rem = pix - nb * imgPlane;
      const int pr = rem / Wp;
      const int pc = rem - pr * Wp;
      const int b = b0 + nb, h = i0 + pr - s.pad, w = pc - s.pad, c = c0 + cl;
      const bool ok = b < s.B && h >= 0 && h < s.H && w >= 0 && w < s.W &&
                      c < s.C;
      float* Ep = Es + pix * RS + cl;
      if (ok) {
        const float xv = __ldg(&x[(((size_t)b * s.H + h) * s.W + w) * s.C + c]);
        float bas[K];
        bspline<NK, ORDER>(xv, kn, bas);
#pragma unroll
        for (int kk = 0; kk < K; ++kk) Ep[kk * s.CC] = bas[kk];
        Ep[K * s.CC] = base_act<ACT>(xv);
      } else {
#pragma unroll
        for (int kk = 0; kk <= K; ++kk) Ep[kk * s.CC] = 0.0f;
      }
    }

    // weights: tap t's slice is read from Ws[t & 1] while tap t+1's is in
    // flight from L2 into registers, then stored to the other buffer
    loadW(0);
    storeW(Ws);
    __syncthreads();  // Es and the first weight slice are ready
    for (int tap = 0; tap < k * k; ++tap) {
      if (tap + 1 < k * k) loadW(tap + 1);
      const int di = tap / k, dj = tap - (tap / k) * k;
      const float* Et = Es + (di * Wp + dj) * RS;
      const float* Wr = Ws + (tap & 1) * RS * s.BN + tn * kTN;
      // four reduction steps per iteration: one float4 of E per pixel and
      // four float4s of W feed 64 FMAs
#pragma unroll 2
      for (int rr = 0; rr < RS; rr += 4) {
        float4 wv[4];
#pragma unroll
        for (int u = 0; u < 4; ++u)
          wv[u] = *reinterpret_cast<const float4*>(Wr + (rr + u) * s.BN);
#pragma unroll
        for (int q = 0; q < kTM; ++q) {
          const float4 ev = *reinterpret_cast<const float4*>(Et + base[q] + rr);
          const float e4[4] = {ev.x, ev.y, ev.z, ev.w};
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            acc[q][0] = fmaf(e4[u], wv[u].x, acc[q][0]);
            acc[q][1] = fmaf(e4[u], wv[u].y, acc[q][1]);
            acc[q][2] = fmaf(e4[u], wv[u].z, acc[q][2]);
            acc[q][3] = fmaf(e4[u], wv[u].w, acc[q][3]);
          }
        }
      }
      if (tap + 1 < k * k) storeW(Ws + ((tap + 1) & 1) * RS * s.BN);
      __syncthreads();  // this tap's readers are done; the next slice is in
    }
  }

#pragma unroll
  for (int q = 0; q < kTM; ++q) {
    if (!valid[q]) continue;
    const int m = tm + q * threadsM;
    const int nb = m / pixPerImg;
    const int rem = m - nb * pixPerImg;
    const int ti = rem / s.Wo;
    const int j = rem - ti * s.Wo;
    float* yp = y + (((size_t)(b0 + nb) * s.Ho + (i0 + ti)) * s.Wo + j) * s.O;
#pragma unroll
    for (int n = 0; n < kTN; ++n) {
      const int o = o0 + tn * kTN + n;
      if (o < s.O) yp[o] = acc[q][n];
    }
  }
}

template <int NK, int ORDER, int ACT, int WR>
cudaError_t launch(const float* x, const float* w_all, float* y,
                   const Shape& s, const Knots& kn, cudaStream_t stream) {
  constexpr int K = NK - ORDER - 1;
  const size_t smem =
      sizeof(float) * (size_t)s.rs * (size_t)(s.tile + 2 * s.BN + 2);
  auto kernel = kan_conv2d_fwd_kernel<NK, ORDER, ACT, WR>;
  // raise the dynamic shared-memory cap once per instantiation, as needed
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  const int rowChunks = (s.Ho + s.TH - 1) / s.TH;
  const dim3 grid(rowChunks * ((s.B + s.NB - 1) / s.NB),
                  (s.O + s.BN - 1) / s.BN);
  kernel<<<grid, kThreads, smem, stream>>>(x, w_all, y, s, kn);
  return cudaGetLastError();
}

// picks the smallest staging width that covers this tile's weight rows
template <int NK, int ORDER, int ACT>
cudaError_t launch_any(const float* x, const float* w_all, float* y,
                       const Shape& s, const Knots& kn, cudaStream_t stream) {
  const int rows = (s.rs + kThreads / s.BN - 1) / (kThreads / s.BN);
  if (rows <= 2) return launch<NK, ORDER, ACT, 2>(x, w_all, y, s, kn, stream);
  if (rows <= 5) return launch<NK, ORDER, ACT, 5>(x, w_all, y, s, kn, stream);
  if (rows <= 10)
    return launch<NK, ORDER, ACT, 10>(x, w_all, y, s, kn, stream);
  return launch<NK, ORDER, ACT, kWRegs>(x, w_all, y, s, kn, stream);
}

}  // namespace

extern "C" {

// Launches the forward on `stream`.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a tile or spline the build does not carry.
// The Python wrapper chooses BN/TH/NB/CC (kernels/kan_conv2d.py,
// launch_config) and validates every tensor before calling.
int kan_conv2d_fwd(const void* x, const void* w_all, void* y, int B, int H,
                   int W, int C, int O, int k, int pad, int BN, int TH, int NB,
                   int CC, const float* knots, int n_knots, int order, int act,
                   void* stream) {
  Shape s;
  s.B = B; s.H = H; s.W = W; s.C = C; s.O = O; s.k = k; s.pad = pad;
  s.Ho = H + 2 * pad - k + 1;
  s.Wo = W + 2 * pad - k + 1;
  s.BN = BN; s.TH = TH; s.NB = NB; s.CC = CC;
  s.tile = NB * (TH + k - 1) * (W + 2 * pad);
  // (K+1)*CC rounded up to a multiple of 4 floats with an odd number of
  // float4s, so neighbouring pixels' float4 loads fall in different banks
  const int K1 = n_knots - order;
  s.rs = (K1 * CC + 3) / 4 * 4;
  if ((s.rs / 4) % 2 == 0) s.rs += 4;
  if (BN < kTN || BN > 64 || kThreads % BN != 0 || s.Ho <= 0 || s.Wo <= 0 ||
      NB * TH * s.Wo > (kThreads / (BN / kTN)) * kTM || n_knots > kMaxKnots ||
      (s.rs + kThreads / BN - 1) / (kThreads / BN) > kWRegs || CC <= 0 ||
      (act != 0 && act != 1))
    return (int)cudaErrorInvalidValue;
  Knots kn;
  for (int i = 0; i < kMaxKnots; ++i) kn.v[i] = i < n_knots ? knots[i] : 0.0f;
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w_all);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n_knots == 12 && order == 3) {  // grid_size 5, spline_order 3
    return (int)(act == 0 ? launch_any<12, 3, 0>(xp, wp, yp, s, kn, st)
                          : launch_any<12, 3, 1>(xp, wp, yp, s, kn, st));
  }
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
