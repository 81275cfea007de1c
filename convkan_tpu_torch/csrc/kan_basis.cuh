// kan_basis.cuh — the per-channel expansion of a KAN conv's input in
// float32, shared by csrc/kan_conv2d_fwd.cu and csrc/kan_conv2d_bwd.cu, so
// that the backward recomputes exactly the basis values the forward used.
//
// A basis policy gives R, the rows of E per input channel, kExtras, the
// length of its learnable operand (0: none), and device functions over p
// (the kernels' copy in shared memory of the parameters, or of the operand
// where the policy has one), each of which the kernels call once per
// (pixel, channel):
//   expand(x, p, dst, stride, col)  row r of x at dst[r * stride + col]
//                                   (the forward's tile of CC channels);
//   store(x, p, dst)                row r of x at dst[r] (the weight
//                                   gradient's tile);
//   grad(x, p, acc)                 sum_r acc[r] * dE_r/dx (the data
//                                   gradient's epilogue);
//   grad_extra(x, p, acc, de)       the same, and adds sum_r acc[r] *
//                                   dE_r/dp[j] to de[j] (a policy with an
//                                   operand; its data-gradient epilogue).
// Six policies:
//   * BSpline<NK, ORDER, ACT>: E = [B_0(x) .. B_{K-1}(x), act(x)], the bases
//     of basis/bspline.py's Cox-de Boor recurrence over NK knots at degree
//     ORDER (K = NK - ORDER - 1) and the base path's SiLU (ACT 0), GELU
//     (ACT 1), hardswish (ACT 2), identity (ACT 3: a conv built with
//     base_activation=None) or ReLU (ACT 4); R = K + 1; p = the knots.
//   * Cheby<DEG>: E = [T_0(t) .. T_DEG(t)], t = min(max(tanh x, lo), hi),
//     by the recurrence T_n = 2t T_{n-1} - T_{n-2} of basis/poly.py's
//     chebyshev_basis_recurrence_list; no base path; R = DEG + 1; p = {lo,
//     hi}, the float32 values of -1 + eps and 1 - eps.
//   * Gram<DEG, ACT>: E = [act(p_0(t)) .. act(p_DEG(t)), act(x)], t = tanh
//     x, by the recurrence p_i = t p_{i-1} - (c_i beta[i-1]) p_{i-2} of
//     basis/poly.py's gram_basis_cols with the learnable operand beta
//     (DEG + 1 values, a device array: p = beta) and the SiLU (ACT 0) or
//     identity (ACT 3) of nn/kan_conv.py's "gram" family on every row (with
//     identity the rows are the bare polynomials); R = DEG + 2.
//   * Recur3<K, ACT>: E = [P_0(t) .. P_{K-1}(t), act(x)], t = tanh x, by
//     the three-term recurrence P_0 = c0, P_1 = (A_1 t + B_1) / D_1, P_n =
//     ((A_n t + B_n) P_{n-1} - C_n P_{n-2}) / D_n of basis/poly.py's
//     recur3_cols: Jacobi, Bessel, Fibonacci, Gegenbauer, Hermite, Laguerre,
//     Lucas and the Taylor monomials, each its own coefficients; R = K + 1;
//     p = {c0, A_1, B_1, D_1, then A_n, B_n, C_n, D_n for n = 2..K-1}.
//   * Bernstein<DEG>: E = [b_0(s) .. b_DEG(s), x], s = sigmoid x, by the
//     reference's de Casteljau sweep from an all-ones buffer (every b_i is
//     exactly 1 for s in [0, 1], and its derivative exactly 0), and the
//     identity base row; R = DEG + 2; no parameters.
//   * Fourier<G, ACT>: E = [cos(1 x) .. cos(G x), sin(1 x) .. sin(G x),
//     act(x)]; R = 2 G + 1; no parameters.
// Built without --use_fast_math: the B-spline recurrence needs true IEEE
// divides, and expf/erff/tanhf the accurate versions.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace kan {

constexpr int kMaxKnots = 32;

// The basis parameters (the knots, or Chebyshev's clamp bounds) as a kernel
// argument (by value); kernels copy them to shared memory, since
// bspline_span indexes them dynamically.
struct Knots {
  float v[kMaxKnots];
};

inline bool load_knots(const float* knots, int n_knots, Knots* kn) {
  if (n_knots > kMaxKnots) return false;
  for (int i = 0; i < kMaxKnots; ++i) kn->v[i] = i < n_knots ? knots[i] : 0.0f;
  return true;
}

// hardswish x * relu6(x + 3) / 6 in torch's order of operations (its CPU
// kernel and jax.nn.hard_swish): a product, then an IEEE divide
__host__ __device__ __forceinline__ float hardswish(float x) {
  return x * fminf(fmaxf(x + 3.0f, 0.0f), 6.0f) / 6.0f;
}

// its derivative as torch's backward takes it: 0 at x <= -3, x/3 + 1/2 on
// (-3, 3), 1 at x >= 3
__host__ __device__ __forceinline__ float hardswish_grad(float x) {
  if (x <= -3.0f) return 0.0f;
  if (x < 3.0f) return x / 3.0f + 0.5f;
  return 1.0f;
}

// ReLU as torch's clamp_min(x, 0) takes it: x unless x < 0 (so -0 and NaN
// pass through)
__host__ __device__ __forceinline__ float relu(float x) {
  return x < 0.0f ? 0.0f : x;
}

// its derivative as torch's and jax.nn.relu's backward take it: 1 for
// x > 0, else 0 (0 at x = 0)
__host__ __device__ __forceinline__ float relu_grad(float x) {
  return x > 0.0f ? 1.0f : 0.0f;
}

template <int ACT>
__device__ __forceinline__ float base_act(float x) {
  if (ACT == 0) return x / (1.0f + expf(-x));                        // SiLU
  if (ACT == 2) return hardswish(x);
  if (ACT == 3) return x;                                        // identity
  if (ACT == 4) return relu(x);
  return 0.5f * x * (1.0f + erff(x * 0.70710678118654752440f));      // GELU
}

// d act / dx: SiLU' = s (1 + x (1 - s)); GELU' (erf) = Phi(x) + x phi(x);
// hardswish' of hardswish_grad; identity' = 1; ReLU' of relu_grad
template <int ACT>
__device__ __forceinline__ float base_act_grad(float x) {
  if (ACT == 3) return 1.0f;
  if (ACT == 4) return relu_grad(x);
  if (ACT == 0) {
    const float s = 1.0f / (1.0f + expf(-x));
    return s * (1.0f + x * (1.0f - s));
  }
  if (ACT == 2) return hardswish_grad(x);
  const float cdf = 0.5f * (1.0f + erff(x * 0.70710678118654752440f));
  const float pdf = expf(-0.5f * x * x) * 0.39894228040143267794f;
  return cdf + x * pdf;
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

// The B-spline policy: only the ORDER+1 bases of x's knot span are
// evaluated (bspline_span), the rest of the row is 0; the base path's row
// last.
template <int NK, int ORDER, int ACT>
struct BSpline {
  static constexpr int K = NK - ORDER - 1;
  static constexpr int R = K + 1;
  static constexpr int kExtras = 0;

  // the span's bases selected into their rows by static indices
  __device__ __forceinline__ static void expand(float x, const float* kn,
                                                float* dst, int stride,
                                                int col) {
    float N[ORDER + 1];
    const int j = bspline_span<NK, ORDER>(x, kn, N);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) {
      float v = 0.0f;
#pragma unroll
      for (int m = 0; m <= ORDER; ++m)
        if (kk == j - ORDER + m) v = N[m];
      dst[kk * stride + col] = v;
    }
    dst[K * stride + col] = base_act<ACT>(x);
  }

  // zeros, then the span's bases stored at their rows
  __device__ __forceinline__ static void store(float x, const float* kn,
                                               float* dst) {
    float N[ORDER + 1];
    const int j = bspline_span<NK, ORDER>(x, kn, N);
#pragma unroll
    for (int kk = 0; kk < K; ++kk) dst[kk] = 0.0f;
    if (j >= 0) {
#pragma unroll
      for (int m = 0; m <= ORDER; ++m) {
        const int kk = j - ORDER + m;
        if (kk >= 0 && kk < K) dst[kk] = N[m];
      }
    }
    dst[K] = base_act<ACT>(x);
  }

  // basis kk = j0 + m has derivative D[m]; the others have 0 (static
  // register indices only)
  __device__ __forceinline__ static float grad(float x, const float* kn,
                                               const float* acc) {
    float D[ORDER + 1];
    const int j0 = bspline_span_grad<NK, ORDER>(x, kn, D) - ORDER;
    float sum = acc[K] * base_act_grad<ACT>(x);
#pragma unroll
    for (int kk = 0; kk < K; ++kk)
#pragma unroll
      for (int mm = 0; mm <= ORDER; ++mm)
        if (kk == j0 + mm) sum = fmaf(acc[kk], D[mm], sum);
    return sum;
  }
};

// The Chebyshev policy: every row is dense (T_0 = 1 at every x: E is zero
// on the pad only because the kernels mask the pad AFTER the expansion).
// The recurrence is explicitly rounded (no FMA contraction), in the order
// of operations of the plain version: T_n = (2 t) T_{n-1} - T_{n-2}.
template <int DEG>
struct Cheby {
  static_assert(DEG >= 1, "degree 0 is not compiled");
  static constexpr int K = DEG + 1;
  static constexpr int R = K;
  static constexpr int kExtras = 0;

  __device__ __forceinline__ static void expand(float x, const float* p,
                                                float* dst, int stride,
                                                int col) {
    const float t = fminf(fmaxf(tanhf(x), p[0]), p[1]);
    const float t2 = __fmul_rn(2.0f, t);
    float e[R];
    e[0] = 1.0f;
    e[1] = t;
#pragma unroll
    for (int n = 2; n <= DEG; ++n)
      e[n] = __fsub_rn(__fmul_rn(t2, e[n - 1]), e[n - 2]);
#pragma unroll
    for (int n = 0; n < R; ++n) dst[n * stride + col] = e[n];
  }

  __device__ __forceinline__ static void store(float x, const float* p,
                                               float* dst) {
    expand(x, p, dst, 1, 0);
  }

  // sum_n acc[n] T'_n(t) (1 - tanh^2 x), zero where the clamp holds t
  // (|x| past about 8.3 in float32): T'_0 = 0, T'_1 = 1, T'_n = 2 T_{n-1}
  // + 2t T'_{n-1} - T'_{n-2}
  __device__ __forceinline__ static float grad(float x, const float* p,
                                               const float* acc) {
    const float th = tanhf(x);
    if (!(th > p[0] && th < p[1])) return 0.0f;
    float T[R], D[R];
    T[0] = 1.0f;
    T[1] = th;
    D[0] = 0.0f;
    D[1] = 1.0f;
    float sum = acc[1];
#pragma unroll
    for (int n = 2; n <= DEG; ++n) {
      T[n] = 2.0f * th * T[n - 1] - T[n - 2];
      D[n] = 2.0f * T[n - 1] + 2.0f * th * D[n - 1] - D[n - 2];
      sum = fmaf(acc[n], D[n], sum);
    }
    return sum * (1.0f - th * th);
  }
};

// c_i of the Gram recurrence, ((m+n)(m-n)n^2) / (m^2/(4n^2-1)) with
// n = i - 1, m = i, in double and then rounded to float32, as the plain
// version's Python float meets a float32 beta (c_2 = 2.25, c_3 = 33.33...)
__host__ __device__ constexpr double gram_coef(int i) {
  const double n = i - 1, m = i;
  return ((m + n) * (m - n) * n * n) / (m * m / (4.0 * n * n - 1.0));
}

// The Gram policy: every row is dense (act(p_0) = act(1) at every x: E is
// zero on the pad only because the kernels mask the pad AFTER the
// expansion).  The recurrence is explicitly rounded (no FMA contraction),
// in the order of operations of the plain version: p_i = t p_{i-1} -
// (c_i beta[i-1]) p_{i-2}.  p: beta (DEG + 1 values; beta[0] and
// beta[DEG] never enter, so their gradient is exactly 0).
template <int DEG, int ACT>
struct Gram {
  static_assert(DEG >= 2, "degrees below 2 are not compiled");
  static constexpr int K = DEG + 1;
  static constexpr int R = K + 1;
  static constexpr int kExtras = DEG + 1;

  // t = tanh x and p_0 .. p_DEG
  __device__ __forceinline__ static float values(float x, const float* b,
                                                 float* p) {
    const float t = tanhf(x);
    p[0] = 1.0f;
    p[1] = t;
#pragma unroll
    for (int i = 2; i <= DEG; ++i)
      p[i] = __fsub_rn(__fmul_rn(t, p[i - 1]),
                       __fmul_rn(__fmul_rn((float)gram_coef(i), b[i - 1]),
                                 p[i - 2]));
    return t;
  }

  __device__ __forceinline__ static void expand(float x, const float* b,
                                                float* dst, int stride,
                                                int col) {
    float p[K];
    values(x, b, p);
#pragma unroll
    for (int n = 0; n < K; ++n) dst[n * stride + col] = base_act<ACT>(p[n]);
    dst[K * stride + col] = base_act<ACT>(x);
  }

  __device__ __forceinline__ static void store(float x, const float* b,
                                               float* dst) {
    expand(x, b, dst, 1, 0);
  }

  // dx = sum_n acc[n] act'(p_n) p_n'(t) (1 - t^2) + acc[K] act'(x), and
  // de[j] += sum_n acc[n] act'(p_n) dp_n/dbeta[j], with the derivatives
  // carried along the recurrence: p_0' = 0, p_1' = 1, p_i' = p_{i-1} + t
  // p_{i-1}' - c_i beta[i-1] p_{i-2}'; dp_i/dbeta[j] = t dp_{i-1}/dbeta[j]
  // - c_i beta[i-1] dp_{i-2}/dbeta[j] - [j = i-1] c_i p_{i-2}.
  __device__ __forceinline__ static float grad_extra(float x, const float* b,
                                                     const float* acc,
                                                     float* de) {
    float p[K], d[K], db[K][K];
    const float t = values(x, b, p);
    d[0] = 0.0f;
    d[1] = 1.0f;
#pragma unroll
    for (int j = 0; j < K; ++j) db[0][j] = db[1][j] = 0.0f;
#pragma unroll
    for (int i = 2; i <= DEG; ++i) {
      const float c = (float)gram_coef(i);
      const float cb = c * b[i - 1];
      d[i] = p[i - 1] + t * d[i - 1] - cb * d[i - 2];
#pragma unroll
      for (int j = 0; j < K; ++j)
        db[i][j] = t * db[i - 1][j] - cb * db[i - 2][j] -
                   (j == i - 1 ? c * p[i - 2] : 0.0f);
    }
    float sum = 0.0f;
#pragma unroll
    for (int n = 1; n < K; ++n) {
      const float an = acc[n] * base_act_grad<ACT>(p[n]);
      sum = fmaf(an, d[n], sum);
#pragma unroll
      for (int j = 1; j < DEG; ++j) de[j] = fmaf(an, db[n][j], de[j]);
    }
    return fmaf(acc[K], base_act_grad<ACT>(x), sum * (1.0f - t * t));
  }

  __device__ __forceinline__ static float grad(float x, const float* b,
                                               const float* acc) {
    float de[K] = {};
    return grad_extra(x, b, acc, de);
  }
};

// The three-term recurrence policy (Recur3 above).  Explicitly rounded
// (no FMA contraction), in the order of operations of the plain version,
// which is each family's JAX list function's: a zero B adds +0, a C of -1
// subtracts -P_{n-2}, a D of 1 divides exactly.  Every row is dense (P_0 =
// c0 at every x: E is zero on the pad only because the kernels mask the pad
// AFTER the expansion).
template <int K, int ACT>
struct Recur3 {
  static_assert(K >= 2, "fewer than two rows are not compiled");
  static constexpr int R = K + 1;
  static constexpr int kExtras = 0;

  // t = tanh x and P_0 .. P_{K-1}
  __device__ __forceinline__ static float values(float x, const float* c,
                                                 float* P) {
    const float t = tanhf(x);
    P[0] = c[0];
    P[1] = __fdiv_rn(__fadd_rn(__fmul_rn(c[1], t), c[2]), c[3]);
#pragma unroll
    for (int n = 2; n < K; ++n) {
      const float* q = c + 4 * n - 4;
      P[n] = __fdiv_rn(
          __fsub_rn(__fmul_rn(__fadd_rn(__fmul_rn(q[0], t), q[1]), P[n - 1]),
                    __fmul_rn(q[2], P[n - 2])),
          q[3]);
    }
    return t;
  }

  __device__ __forceinline__ static void expand(float x, const float* c,
                                                float* dst, int stride,
                                                int col) {
    float P[K];
    values(x, c, P);
#pragma unroll
    for (int n = 0; n < K; ++n) dst[n * stride + col] = P[n];
    dst[K * stride + col] = base_act<ACT>(x);
  }

  __device__ __forceinline__ static void store(float x, const float* c,
                                               float* dst) {
    expand(x, c, dst, 1, 0);
  }

  // sum_n acc[n] P_n'(t) (1 - t^2) + acc[K] act'(x), the derivatives
  // carried along the recurrence: P_0' = 0, P_1' = A_1 / D_1, P_n' =
  // ((A_n t + B_n) P_{n-1}' + A_n P_{n-1} - C_n P_{n-2}') / D_n
  __device__ __forceinline__ static float grad(float x, const float* c,
                                               const float* acc) {
    float P[K], D[K];
    const float t = values(x, c, P);
    D[0] = 0.0f;
    D[1] = c[1] / c[3];
    float sum = acc[1] * D[1];
#pragma unroll
    for (int n = 2; n < K; ++n) {
      const float* q = c + 4 * n - 4;
      D[n] = ((q[0] * t + q[1]) * D[n - 1] + q[0] * P[n - 1] -
              q[2] * D[n - 2]) / q[3];
      sum = fmaf(acc[n], D[n], sum);
    }
    return fmaf(acc[K], base_act_grad<ACT>(x), sum * (1.0f - t * t));
  }
};

// The Bernstein policy: the reference's sweep, new b_i = b_i (1 - s) +
// b_{i+1} s over the first DEG + 1 - j slots at sweep j, explicitly
// rounded, from b = 1; the base row is x (base_input "raw").
template <int DEG>
struct Bernstein {
  static constexpr int K = DEG + 1;
  static constexpr int R = K + 1;
  static constexpr int kExtras = 0;

  // the rows, and with D their derivatives in s along the sweep: d_i' =
  // (d_i (1 - s) - b_i) + d_{i+1} s + b_{i+1}, exactly 0 from b = 1
  __device__ __forceinline__ static float sweep(float x, float* b, float* d) {
    const float s = 1.0f / (1.0f + expf(-x));
    const float u = __fsub_rn(1.0f, s);
#pragma unroll
    for (int i = 0; i < K; ++i) b[i] = 1.0f;
    if (d != nullptr) {
#pragma unroll
      for (int i = 0; i < K; ++i) d[i] = 0.0f;
    }
#pragma unroll
    for (int j = 1; j <= DEG; ++j) {
#pragma unroll
      for (int i = 0; i <= DEG - j; ++i) {
        if (d != nullptr)
          d[i] = __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(d[i], u), b[i]),
                                     __fmul_rn(d[i + 1], s)),
                           b[i + 1]);
        b[i] = __fadd_rn(__fmul_rn(b[i], u), __fmul_rn(b[i + 1], s));
      }
    }
    return s;
  }

  __device__ __forceinline__ static void expand(float x, const float*,
                                                float* dst, int stride,
                                                int col) {
    float b[K];
    sweep(x, b, nullptr);
#pragma unroll
    for (int n = 0; n < K; ++n) dst[n * stride + col] = b[n];
    dst[K * stride + col] = x;
  }

  __device__ __forceinline__ static void store(float x, const float* p,
                                               float* dst) {
    expand(x, p, dst, 1, 0);
  }

  // sum_n acc[n] b_n'(s) s (1 - s) + acc[K]: the rows' part is exactly 0
  __device__ __forceinline__ static float grad(float x, const float*,
                                               const float* acc) {
    float b[K], d[K];
    const float s = sweep(x, b, d);
    float sum = 0.0f;
#pragma unroll
    for (int n = 0; n < K; ++n) sum = fmaf(acc[n], d[n], sum);
    return fmaf(sum, s * (1.0f - s), acc[K]);
  }
};

// The Fourier policy: cos(k x) and sin(k x) for k = 1..G of the rounded
// product k x (sincosf, the accurate version), then the base row.
template <int G, int ACT>
struct Fourier {
  static constexpr int K = 2 * G;
  static constexpr int R = K + 1;
  static constexpr int kExtras = 0;

  __device__ __forceinline__ static void expand(float x, const float*,
                                                float* dst, int stride,
                                                int col) {
#pragma unroll
    for (int k = 1; k <= G; ++k) {
      float sn, cs;
      sincosf(__fmul_rn((float)k, x), &sn, &cs);
      dst[(k - 1) * stride + col] = cs;
      dst[(G + k - 1) * stride + col] = sn;
    }
    dst[K * stride + col] = base_act<ACT>(x);
  }

  __device__ __forceinline__ static void store(float x, const float* p,
                                               float* dst) {
    expand(x, p, dst, 1, 0);
  }

  // sum_k k (acc[G + k - 1] cos(k x) - acc[k - 1] sin(k x)) + acc[K] act'(x)
  __device__ __forceinline__ static float grad(float x, const float*,
                                               const float* acc) {
    float sum = 0.0f;
#pragma unroll
    for (int k = 1; k <= G; ++k) {
      float sn, cs;
      sincosf(__fmul_rn((float)k, x), &sn, &cs);
      sum = fmaf((float)k, acc[G + k - 1] * cs - acc[k - 1] * sn, sum);
    }
    return fmaf(acc[K], base_act_grad<ACT>(x), sum);
  }
};

// Calls f(Basis{}) with the policy of a C entry's basis code and returns
// what f returns; cudaErrorInvalidValue for a basis the build does not
// carry.  Codes (kernels/kan_conv2d.py COMPILED): 0 and 1, the B-spline of
// 12 knots (grid 5) at order 3 with SiLU and GELU; 2, Chebyshev of degree 3
// (its two clamp bounds as the parameters); 3, Gram of degree 3 with SiLU
// (no parameters; beta as the operand); 4, the B-spline of 0 and 1 with
// hardswish; 5 and 6, the B-spline of 0 and the Gram of 3 with the identity
// (the projections of EfficientNetV2, built with base_activation=None);
// 7 and 8, the three-term recurrence of 4 rows with SiLU (Bessel,
// Fibonacci, Gegenbauer, Hermite, Laguerre, Lucas at degree 3) and with the
// identity (Jacobi); 9, that of 3 rows with SiLU (Taylor, degree 3); 10,
// Bernstein of degree 3 (identity base row); 11, Fourier of grid 5 with
// SiLU; 12, the B-spline of 0 with ReLU (MobileNetV1's convs).
template <class F>
cudaError_t with_basis(int code, int n_params, int order, F&& f) {
  if (code == 0 && n_params == 12 && order == 3) return f(BSpline<12, 3, 0>{});
  if (code == 1 && n_params == 12 && order == 3) return f(BSpline<12, 3, 1>{});
  if (code == 2 && n_params == 2 && order == 3) return f(Cheby<3>{});
  if (code == 3 && n_params == 0 && order == 3) return f(Gram<3, 0>{});
  if (code == 4 && n_params == 12 && order == 3) return f(BSpline<12, 3, 2>{});
  if (code == 5 && n_params == 12 && order == 3) return f(BSpline<12, 3, 3>{});
  if (code == 6 && n_params == 0 && order == 3) return f(Gram<3, 3>{});
  if (code == 7 && n_params == 12 && order == 3) return f(Recur3<4, 0>{});
  if (code == 8 && n_params == 12 && order == 3) return f(Recur3<4, 3>{});
  if (code == 9 && n_params == 8 && order == 3) return f(Recur3<3, 0>{});
  if (code == 10 && n_params == 0 && order == 3) return f(Bernstein<3>{});
  if (code == 11 && n_params == 0 && order == 5) return f(Fourier<5, 0>{});
  if (code == 12 && n_params == 12 && order == 3) return f(BSpline<12, 3, 4>{});
  return cudaErrorInvalidValue;
}

// R of a C entry's basis, or -1 for one the build does not carry
inline int basis_rows(int code, int n_params, int order) {
  int rows = -1;
  with_basis(code, n_params, order, [&](auto b) {
    rows = decltype(b)::R;
    return cudaSuccess;
  });
  return rows;
}

// the length of a C entry's basis operand (0: none), or -1 for a basis
// the build does not carry
inline int basis_extras(int code, int n_params, int order) {
  int n = -1;
  with_basis(code, n_params, order, [&](auto b) {
    n = decltype(b)::kExtras;
    return cudaSuccess;
  });
  return n;
}

}  // namespace kan
