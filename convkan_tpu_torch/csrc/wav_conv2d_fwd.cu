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
// once.  z is one FMA, x * (1/s) + (-t/s), with 1/s (an IEEE divide) and
// -t/s formed once per (o, c) and chunk; the plain version divides.  The
// wavelet's leading constant (mexican_hat's) multiplies each output once.
//
// What bounds it on the H100: operations.  Every (input pixel, c, o) needs
// one psi (one expf and ~5 other operations for mexican_hat) that feeds up
// to k*k = 9 multiply-adds; KAN-VGG16_small has sum H*W*C*O = 2,211,840
// such triples per image, so at batch 1024 about 2.27e9 psi and 2.0e10
// FMAs per forward.  Bytes are only x, w and y.
//
// What the design does about it:
//   * A thread owns one output channel o of a strip of TW output columns
//     and walks the rows of its band top to bottom: each input ("virtual")
//     row's psi values are computed once and feed the up to 3 output rows
//     it touches, kept as a ring of 3 rows of sums in registers; the
//     oldest row is complete after each input row and is stored.  So psi
//     is never recomputed across rows, and across columns only on the
//     strip's 2 halo columns (the generic strips of 8: 1.19x at 32x32,
//     1.13x at 16x16).  Pad rows are never computed (their psi is 0).
//   * Compiled widths (pad 1, W = 8, 4, 2: the strip is the whole row)
//     have no halo, and their pad taps are left out at compile time.
//     Every other shape takes strips of 8 columns with the halo, the
//     columns off the image skipped.
//   * x is read as a float4 of 4 input channels, whose psi values feed the
//     9 taps' weights of the 4 channels (float4s too), so one load serves
//     4 psi and a weight load 4 FMAs.
//   * A block is 128 threads: OG output channels (lanes) x NT = 128 / OG
//     tile slots, each slot a (strip, image) of the block's band of RB
//     output rows.  The lanes of a slot share its x (a shared-memory
//     broadcast), the slots of an o share its weights.
//   * Staging: per (input row, chunk of 16 channels), each slot's x columns
//     (by the slot's own lanes) and the chunk's weights, transposed to
//     channels fastest by 4-byte copies, go into one of two buffers by
//     cp.async; -t/s and 1/s are stored there by the threads.  A warp
//     issues chunk k + 1's copies as soon as it has done chunk k's FMAs, so
//     they land while the other warps finish theirs and at the one barrier
//     per chunk (issuing them before the FMAs read 1% slower on the H100:
//     4 blocks an SM already hide each other's waits).  Positions come
//     from counters and shifts; the block's own position takes the only
//     divides.
// The sum of each output runs over input rows, then chunks, then channel
// quads, then taps in a fixed order: two calls give bit-identical y.
//
// Interface: a plain C entry point loaded with ctypes.  It launches on the
// caller's stream, allocates nothing, and returns cudaGetLastError().

#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>
#include <stdint.h>

#include "cp_async.cuh"
#include "wav_psi.cuh"

namespace {

constexpr int kK = 3;  // kernel size the build carries
// launch bounds (threads, blocks per SM), input channels per staged chunk,
// and floats per (o, channel quad) of the staged weights: 9 taps, -t/s and
// 1/s, a float4 each
constexpr int kThreads = 128, kMinBlocks = 4;
constexpr int kCC = 16, kLCC = 4;  // and its log2
constexpr int kQuad = 4 * (kK * kK + 2);
constexpr int kTS = 4 * kK * kK;  // -t/s at +kTS, 1/s at +kTS + 4
constexpr int kGenericTW = 8;     // strip width of the generic tile

struct FwdShape {
  int B, H, W, C, O, pad, Ho, Wo;
  int lOG, NT;          // log2 of the lanes (output channels); tile slots
  int nTiles;           // (strip, image) tiles: strip * B + b
  int RB, nBands;       // output rows per band, bands
  int nCC, lCW;         // chunks of kCC channels per input row; log2 of
                        // the channels a chunk stages (C < kCC: fewer)
  int slotStride;       // floats of a slot's staged x (>= TWH * kCC)
  int wStride;          // floats of an o's staged weights (>= its quads)
  int xBuf, bufStride;  // floats of x per buffer; per buffer
  int xVec;             // 16-byte copies of x (C % 4 == 0, x aligned)
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// a += the 4 channels' w * psi, channel by channel
__device__ __forceinline__ float dot4(float a, const float4& w,
                                      const float4& p) {
  a = fmaf(w.x, p.x, a);
  a = fmaf(w.y, p.y, a);
  a = fmaf(w.z, p.z, a);
  return fmaf(w.w, p.w, a);
}

// Block (tile block, band; o tile): lane og + OG * (slot within the warp)
// of warp wp holds output channel o0 + og of slot (wp << (5 - lOG)) +
// (lane >> lOG), tile tb * NT + slot = strip * B + b (images fastest, so a
// warp's slots share a strip).  The band is output rows [i0, i1); virtual
// row V in [i0, i1 + 2) is input row V - pad (rows off the image stage
// nothing: psi = 0) and feeds output row V - di through tap row di.
// TW: the strip's output columns; HALO: the generic strip (staged columns
// j0 - pad .. j0 - pad + TW + 1, those off the image skipped), else a
// compiled width (pad 1, the whole row, the taps off it left out).
template <int WAV, int TW, bool HALO>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    wav_conv2d_fwd_kernel(const float* __restrict__ x,
                          const float* __restrict__ w,
                          const float* __restrict__ t,
                          const float* __restrict__ s, float* __restrict__ y,
                          const FwdShape sh) {
  constexpr int TWH = HALO ? TW + kK - 1 : TW;  // staged columns
  extern __shared__ float4 fsmem4[];
  float* const smem = reinterpret_cast<float*>(fsmem4);
  const int OG = 1 << sh.lOG, CW = 1 << sh.lCW;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int og = lane & (OG - 1);
  const int slot = (warp << (5 - sh.lOG)) + (lane >> sh.lOG);
  // the block's position and this slot's tile: the only divides
  const int band = blockIdx.x % sh.nBands;
  const int tile = (blockIdx.x / sh.nBands) * sh.NT + slot;
  const int strip = tile / sh.B;
  const int b = tile - strip * sh.B;
  const int o0 = blockIdx.y * OG, o = o0 + og;
  const bool tileOk = tile < sh.nTiles;
  const bool active = tileOk && o < sh.O;
  const int j0 = strip * TW;
  const int col0 = HALO ? j0 - sh.pad : 0;  // image column of staged col 0
  const int i0 = band * sh.RB, i1 = min(i0 + sh.RB, sh.Ho);
  // virtual rows inside the image, and the chunks they take
  const int vBeg = max(i0, sh.pad), vEnd = min(i1 + kK - 1, sh.H + sh.pad);
  const int nCh = max(0, vEnd - vBeg) * sh.nCC;
  unsigned colOk = (1u << TWH) - 1;  // staged columns inside the image
  if (HALO) {
#pragma unroll
    for (int q = 0; q < TWH; ++q)
      if ((unsigned)(col0 + q) >= (unsigned)sh.W) colOk &= ~(1u << q);
  }

  // cp.async of chunk (V, cc): the slot's x columns (its own lanes), and,
  // with withW, the chunk's weights (every thread; (tap, c, o) -> o's
  // stride, quad, tap, channel)
  auto stage = [&](int V, int cc, float* buf, bool withW) {
    const int c0 = cc * kCC;
    if (tileOk) {
      const float* row =
          x + ((((long long)b * sh.H + (V - sh.pad)) * sh.W + col0) * sh.C +
               c0);
      float* dst = buf + slot * sh.slotStride;
      if (sh.xVec) {  // float4 `part` of column q
        for (int e = og; e < (TWH << (sh.lCW - 2)); e += OG) {
          const int q = e >> (sh.lCW - 2), part = e & ((CW >> 2) - 1);
          const bool ok = ((colOk >> q) & 1) && c0 + 4 * part < sh.C;
          kan::cp_async16(dst + q * kCC + 4 * part,
                          ok ? row + (size_t)q * sh.C + 4 * part : x, ok);
        }
      } else {
        for (int e = og; e < (TWH << sh.lCW); e += OG) {
          const int q = e >> sh.lCW, cl = e & (CW - 1);
          const bool ok = ((colOk >> q) & 1) && c0 + cl < sh.C;
          kan::cp_async4(dst + q * kCC + cl,
                         ok ? row + (size_t)q * sh.C + cl : x, ok);
        }
      }
    }
    if (withW) {
      float* dst = buf + sh.xBuf;
      for (int e = tid; e < (kK * kK << (sh.lCW + sh.lOG)); e += kThreads) {
        const int ol = e & (OG - 1), r = e >> sh.lOG;
        const int cl = r & (CW - 1), tap = r >> sh.lCW;
        const int oo = o0 + ol, c = c0 + cl;
        const bool ok = oo < sh.O && c < sh.C;
        kan::cp_async4(
            dst + ol * sh.wStride + (cl >> 2) * kQuad + 4 * tap + (cl & 3),
            ok ? w + ((size_t)tap * sh.C + c) * sh.O + oo : w, ok);
      }
    }
    kan::cp_async_commit();
  };
  // -t/s and 1/s of this thread's (o, channel) pair of a chunk (OG * CW <=
  // kThreads): lane ol = tid & (OG - 1), channel cl = tid >> lOG
  auto stage_ts = [&](int cc, float* buf) {
    const int ol = tid & (OG - 1), cl = tid >> sh.lOG;
    if (cl >= CW) return;
    const int oo = o0 + ol, c = cc * kCC + cl;
    const bool ok = oo < sh.O && c < sh.C;
    const float iv = ok ? 1.0f / __ldg(&s[(size_t)oo * sh.C + c]) : 0.0f;
    float* d = buf + sh.xBuf + ol * sh.wStride + (cl >> 2) * kQuad + kTS +
               (cl & 3);
    d[0] = ok ? -__ldg(&t[(size_t)oo * sh.C + c]) * iv : 0.0f;
    d[4] = iv;
  };

  // the ring of output rows: acc[0] is row V - 2, acc[1] V - 1, acc[2] V
  float acc[kK][TW];
#pragma unroll
  for (int r = 0; r < kK; ++r)
#pragma unroll
    for (int j = 0; j < TW; ++j) acc[r][j] = 0.0f;

  // one chunk's channel quads: psi of the staged columns, then the taps
  // of the tap rows di whose output row lies in the band (rm)
  auto compute = [&](const float* buf, int nq, unsigned rm) {
    const float* xs = buf + slot * sh.slotStride;
    const float* ws = buf + sh.xBuf + og * sh.wStride;
    for (int qd = 0; qd < nq; ++qd, xs += 4, ws += kQuad) {
      const float4 nt = ld4(ws + kTS), iv = ld4(ws + kTS + 4);
      float4 ps[TWH];
#pragma unroll
      for (int q = 0; q < TWH; ++q) {
        ps[q] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        if (!HALO || ((colOk >> q) & 1)) {
          const float4 xv = ld4(xs + q * kCC);
          ps[q].x = wav::psi_core<WAV>(fmaf(xv.x, iv.x, nt.x));
          ps[q].y = wav::psi_core<WAV>(fmaf(xv.y, iv.y, nt.y));
          ps[q].z = wav::psi_core<WAV>(fmaf(xv.z, iv.z, nt.z));
          ps[q].w = wav::psi_core<WAV>(fmaf(xv.w, iv.w, nt.w));
        }
      }
#pragma unroll
      for (int di = 0; di < kK; ++di) {
        if (!((rm >> di) & 1u)) continue;
        float4 wv[kK];
#pragma unroll
        for (int dj = 0; dj < kK; ++dj) wv[dj] = ld4(ws + 4 * (di * kK + dj));
#pragma unroll
        for (int j = 0; j < TW; ++j)
#pragma unroll
          for (int dj = 0; dj < kK; ++dj) {
            const int q = HALO ? j + dj : j + dj - 1;
            if (q < 0 || q >= TWH) continue;  // a compiled width's pad tap
            acc[kK - 1 - di][j] = dot4(acc[kK - 1 - di][j], wv[dj], ps[q]);
          }
      }
    }
  };

  if (nCh > 0) {
    stage(vBeg, 0, smem, true);
    stage_ts(0, smem);
  }
  constexpr float kScale = wav::psi_scale<WAV>();
  float* const yb =
      y + ((size_t)b * sh.Ho * sh.Wo + j0) * sh.O + o;  // row 0 of the strip
  int k = 0;  // chunk
  for (int V = i0; V < i1 + kK - 1; ++V) {
    if (V >= vBeg && V < vEnd) {
      unsigned rm = 0;  // tap rows whose output row V - di is in the band
#pragma unroll
      for (int di = 0; di < kK; ++di)
        rm |= (unsigned)(V - di >= i0 && V - di < i1) << di;
      for (int cc = 0; cc < sh.nCC; ++cc, ++k) {
        float* const buf = smem + (k & 1) * sh.bufStride;
        float* const nbuf = smem + ((k + 1) & 1) * sh.bufStride;
        const bool next = k + 1 < nCh;
        const int ccn = cc + 1 < sh.nCC ? cc + 1 : 0;
        // one chunk per row: the other buffer holds its weights from k - 1
        const bool withW = sh.nCC > 1 || k == 0;
        kan::cp_async_wait_all();
        __syncthreads();  // chunk k is in; every reader of chunk k - 1 done
        if (active) compute(buf, (min(kCC, sh.C - cc * kCC) + 3) >> 2, rm);
        if (next) {  // into the buffer of chunk k - 1, whose readers are done
          stage(ccn ? V : V + 1, ccn, nbuf, withW);
          if (withW) stage_ts(ccn, nbuf);
        }
      }
    }
    // output row V - 2 is complete: store it, and move the ring on
    if (active && V - (kK - 1) >= i0) {
      float* yp = yb + (size_t)(V - (kK - 1)) * sh.Wo * sh.O;
#pragma unroll
      for (int j = 0; j < TW; ++j)
        if (!HALO || j0 + j < sh.Wo) yp[(size_t)j * sh.O] = kScale * acc[0][j];
    }
#pragma unroll
    for (int j = 0; j < TW; ++j) {
      acc[0][j] = acc[1][j];
      acc[1][j] = acc[2][j];
      acc[2][j] = 0.0f;
    }
  }
}

template <int WAV, int TW, bool HALO>
cudaError_t launch(const float* x, const float* w, const float* t,
                   const float* s, float* y, const FwdShape& sh, dim3 grid,
                   size_t smem, cudaStream_t stream) {
  auto kernel = wav_conv2d_fwd_kernel<WAV, TW, HALO>;
  // raise the dynamic shared-memory cap once per instantiation, as needed
  static size_t granted = 48 * 1024;
  if (smem > granted) {
    const cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
    granted = smem;
  }
  kernel<<<grid, kThreads, smem, stream>>>(x, w, t, s, y, sh);
  return cudaGetLastError();
}

template <int WAV>
cudaError_t launch_width(int WT, const float* x, const float* w,
                         const float* t, const float* s, float* y,
                         const FwdShape& sh, dim3 grid, size_t smem,
                         cudaStream_t stream) {
  if (WT == 8)
    return launch<WAV, 8, false>(x, w, t, s, y, sh, grid, smem, stream);
  if (WT == 4)
    return launch<WAV, 4, false>(x, w, t, s, y, sh, grid, smem, stream);
  if (WT == 2)
    return launch<WAV, 2, false>(x, w, t, s, y, sh, grid, smem, stream);
  return launch<WAV, kGenericTW, true>(x, w, t, s, y, sh, grid, smem, stream);
}

int log2_of(int v) {
  int l = 0;
  while ((1 << l) < v) ++l;
  return l;
}

}  // namespace

extern "C" {

// Launches the forward on `stream`.  Returns a cudaError_t (0 = success);
// cudaErrorInvalidValue for a kernel size, width or wavelet the build does
// not carry, or a launch that does not fit.  The launch configuration
// (kernels/wav_conv2d.py, fwd_launch_config) owns the tile and the staging
// layout: WT (a compiled width 8, 4, 2 at pad 1 with W == WT, or 0: the
// generic strips of 8), OG (output channels of a block, a power of two up
// to 128 / kCC = 8), RB (output rows of a band), the floats of a slot's
// staged x and of an o's staged weights, the grid and the shared memory;
// this entry only checks that they hold what the kernel reads.  The
// wrapper validates every tensor before calling.
int wav_conv2d_fwd(const void* x, const void* w, const void* t,
                   const void* s, void* y, int B, int H, int W, int C, int O,
                   int k, int pad, int WT, int OG, int RB, int slotStride,
                   int wStride, int gridX, int gridY, int smem, int wavelet,
                   void* stream) {
  FwdShape sh;
  sh.B = B; sh.H = H; sh.W = W; sh.C = C; sh.O = O; sh.pad = pad;
  sh.Ho = H + 2 * pad - k + 1;
  sh.Wo = W + 2 * pad - k + 1;
  const bool compiled = WT == 8 || WT == 4 || WT == 2;
  if (k != kK || (WT != 0 && !(compiled && pad == 1 && W == WT)) ||
      OG < 1 || OG > kThreads / kCC || (OG & (OG - 1)) != 0 || RB < 1 ||
      B <= 0 ||
      C <= 0 || O <= 0 || pad < 0 || sh.Ho <= 0 || sh.Wo <= 0 ||
      wavelet < 0 || wavelet > 4)
    return (int)cudaErrorInvalidValue;
  const int TW = compiled ? WT : kGenericTW;
  const int TWH = compiled ? TW : TW + kK - 1;
  sh.lOG = log2_of(OG);
  sh.NT = kThreads / OG;
  const long nTiles = (long)B * ((sh.Wo + TW - 1) / TW);
  sh.RB = RB;
  sh.nBands = (sh.Ho + RB - 1) / RB;
  sh.nCC = (C + kCC - 1) / kCC;
  sh.lCW = C >= kCC ? kLCC : C <= 4 ? 2 : log2_of(C);
  sh.slotStride = slotStride;
  sh.wStride = wStride;
  sh.xBuf = sh.NT * slotStride;
  sh.bufStride = sh.xBuf + OG * wStride;
  sh.xVec = C % 4 == 0 && (reinterpret_cast<uintptr_t>(x) & 15) == 0;
  // the strides hold a slot's columns and an o's quads, float4-aligned;
  // the two buffers fit the shared memory given, within the block's cap;
  // the grid covers every (tile, band) and o
  if (slotStride < TWH * kCC || slotStride % 4 != 0 ||
      wStride < (kCC / 4) * kQuad || wStride % 4 != 0 ||
      (long)smem < 2L * (long)sizeof(float) * sh.bufStride ||
      smem > 227 * 1024 || nTiles > 0x7fffffffL || gridX <= 0 ||
      gridX % sh.nBands != 0 || (long)(gridX / sh.nBands) * sh.NT < nTiles ||
      gridY <= 0 || gridY > 65535 || (long)gridY * OG < O)
    return (int)cudaErrorInvalidValue;
  sh.nTiles = (int)nTiles;
  const dim3 grid((unsigned)gridX, (unsigned)gridY);
  const float* xp = static_cast<const float*>(x);
  const float* wp = static_cast<const float*>(w);
  const float* tp = static_cast<const float*>(t);
  const float* sp = static_cast<const float*>(s);
  float* yp = static_cast<float*>(y);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t sm = (size_t)smem;
  switch (wavelet) {
    case wav::kMexicanHat:
      return (int)launch_width<wav::kMexicanHat>(WT, xp, wp, tp, sp, yp, sh,
                                                 grid, sm, st);
    case wav::kMorlet:
      return (int)launch_width<wav::kMorlet>(WT, xp, wp, tp, sp, yp, sh, grid,
                                             sm, st);
    case wav::kDog:
      return (int)launch_width<wav::kDog>(WT, xp, wp, tp, sp, yp, sh, grid,
                                          sm, st);
    case wav::kMeyer:
      return (int)launch_width<wav::kMeyer>(WT, xp, wp, tp, sp, yp, sh, grid,
                                            sm, st);
    default:
      return (int)launch_width<wav::kShannon>(WT, xp, wp, tp, sp, yp, sh,
                                              grid, sm, st);
  }
}

}  // extern "C"
