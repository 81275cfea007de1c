// kan_bspline.cuh — the B-spline expansion of a KAN conv's input in float32,
// shared by csrc/kan_conv2d_fwd.cu and csrc/kan_conv2d_bwd.cu, so that the
// backward recomputes exactly the basis values the forward used.
//
// E = [B_0(x) .. B_{K-1}(x), act(x)]: the bases of basis/bspline.py's
// Cox-de Boor recurrence over NK knots at degree ORDER (K = NK - ORDER - 1)
// and the base path's SiLU or GELU.  Built without --use_fast_math: the
// recurrence needs true IEEE divides, and expf/erff the accurate versions.
#pragma once

#include <math.h>

namespace kan {

constexpr int kMaxKnots = 32;

// The knots as a kernel argument (by value); kernels copy them to shared
// memory, since bspline_span indexes them dynamically.
struct Knots {
  float v[kMaxKnots];
};

inline bool load_knots(const float* knots, int n_knots, Knots* kn) {
  if (n_knots > kMaxKnots) return false;
  for (int i = 0; i < kMaxKnots; ++i) kn->v[i] = i < n_knots ? knots[i] : 0.0f;
  return true;
}

template <int ACT>
__device__ __forceinline__ float base_act(float x) {
  if (ACT == 0) return x / (1.0f + expf(-x));                        // SiLU
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));      // GELU
}

// The B-spline bases at x, the values of the full Cox-de Boor recurrence
// (every basis at every level, as basis/bspline.py computes them) bit for
// bit for finite x, evaluating only the ORDER+1 bases over the knot interval
// j that holds x: every other basis is exactly 0 in the full recurrence, and
// adding a zero term leaves a float32 sum unchanged.  ORDER*(ORDER+1)
// divides instead of two per basis and level (12 instead of 54 for 12 knots
// and order 3), with the recurrence's explicitly rounded operations (no FMA
// contraction) and its zero guard on the knot deltas.
// Returns j (-1: x outside the grid or not finite, all bases 0); N[m] is
// basis j - ORDER + m.
template <int NK, int ORDER>
__device__ __forceinline__ int bspline_span(float x, const float* kn,
                                            float* N) {
  int j = -1;
#pragma unroll
  for (int i = 0; i < NK - 1; ++i)
    if (x >= kn[i] && x < kn[i + 1]) j = i;
  N[0] = 1.0f;
#pragma unroll
  for (int k = 1; k <= ORDER; ++k) {
    float nw[ORDER + 1];
#pragma unroll
    for (int m = 0; m <= k; ++m) {
      const int i = j - k + m;  // basis i of level k (exists for i <= NK-2-k)
      float v = 0.0f;
      if (i >= 0 && i <= NK - 2 - k) {
        float dr = __fsub_rn(kn[i + k], kn[i]);
        float dd = __fsub_rn(kn[i + k + 1], kn[i + 1]);
        if (dr == 0.0f) dr = 1.0f;
        if (dd == 0.0f) dd = 1.0f;
        if (m >= 1)  // b_i of level k-1 is N[m-1]
          v = __fmul_rn(__fdiv_rn(__fsub_rn(x, kn[i]), dr), N[m - 1]);
        if (m <= k - 1) {  // b_{i+1} of level k-1 is N[m]
          const float t2 =
              __fmul_rn(__fdiv_rn(__fsub_rn(kn[i + k + 1], x), dd), N[m]);
          v = m >= 1 ? __fadd_rn(v, t2) : t2;
        }
      }
      nw[m] = v;
    }
#pragma unroll
    for (int m = 0; m <= k; ++m) N[m] = nw[m];
  }
  return j;
}

}  // namespace kan
