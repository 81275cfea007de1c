// wav_psi.cuh — the WavKAN mother wavelets psi(z) and psi'(z) in float32,
// shared by csrc/wav_conv2d_fwd.cu and csrc/wav_conv2d_bwd.cu.
//
// The closed forms of convkan_tpu/kernels/fused_wav_conv.py (PSI) term for
// term, as kernels/wav_conv2d.py keeps them in PyTorch.  One exp serves psi
// and psi' where the wavelet has one (mexican_hat, morlet, dog); sincosf
// gives a sine and a cosine of one argument together.  Shannon here is
// sin(z)/z alone: its Hamming window over the input channels is folded into
// the weights by the caller.  Built without --use_fast_math, so expf, sinf,
// cosf and the divides are the accurate versions, not the __expf family.
#pragma once

#include <math.h>

namespace wav {

enum Wavelet { kMexicanHat = 0, kMorlet = 1, kDog = 2, kMeyer = 3,
               kShannon = 4 };

constexpr float kMexC = 0.8673250705840776f;  // 2 / (sqrt(3) pi^(1/4))
constexpr float kPi = 3.14159265358979323846f;

// Meyer's auxiliary polynomial nu(t) and its derivative 140 t^3 (1 - t)^3
__device__ __forceinline__ float nu(float t) {
  const float t2 = t * t;
  return t2 * t2 * (35.0f - 84.0f * t + 70.0f * t2 - 20.0f * t2 * t);
}

__device__ __forceinline__ float dnu(float t) {
  const float u = 1.0f - t;
  return 140.0f * t * t * t * u * u * u;
}

// psi(z) into *p and psi'(z) into *d; the compiler drops what a caller
// does not read
template <int WAV>
__device__ __forceinline__ void psi_dpsi(float z, float* p, float* d) {
  if (WAV == kMexicanHat) {
    const float z2 = z * z;
    const float e = expf(-0.5f * z2);
    *p = kMexC * (z2 - 1.0f) * e;
    *d = kMexC * z * e * (3.0f - z2);
  } else if (WAV == kMorlet) {
    const float e = expf(-0.5f * z * z);
    float s5, c5;
    sincosf(5.0f * z, &s5, &c5);
    *p = e * c5;
    *d = -e * (z * c5 + 5.0f * s5);
  } else if (WAV == kDog) {
    const float e = expf(-0.5f * z * z);
    *p = -z * e;
    *d = (z * z - 1.0f) * e;
  } else if (WAV == kMeyer) {
    // aux = 1 for v <= 1/2, 0 for v >= 1, cos(pi/2 nu(2v - 1)) between;
    // its derivative lives on the open band 1/2 < v < 1 only
    const float v = fabsf(z);
    float aux = 1.0f, daux = 0.0f;
    if (v >= 1.0f) {
      aux = 0.0f;
    } else if (v > 0.5f) {
      const float t = 2.0f * v - 1.0f;
      float sn, cn;
      sincosf(0.5f * kPi * nu(t), &sn, &cn);
      aux = cn;
      daux = -kPi * sn * dnu(t);
    }
    float sv, cv;
    sincosf(kPi * v, &sv, &cv);
    *p = sv * aux;
    const float dv = kPi * cv * aux + sv * daux;
    *d = z > 0.0f ? dv : (z < 0.0f ? -dv : 0.0f);  // sign(z) * dv
  } else {  // kShannon: sin(z)/z, 1 at 0; psi' by a series near 0
    float sz, cz;
    sincosf(z, &sz, &cz);
    *p = z == 0.0f ? 1.0f : sz / z;
    // (z cos z - sin z) / z^2 cancels: in float32 it keeps no digit at
    // |z| = 1e-4 (the reference's series threshold) and few below 1e-2.
    // Its Taylor series, sum_n (-1)^n 2n z^(2n-1) / (2n+1)!, is used up to
    // |z| = 1/2, where the z^11 term is below float32 rounding; below 1e-4
    // it equals the reference's -z/3 + z^3/30 to float32 rounding.
    const float z2 = z * z;
    *d = fabsf(z) < 0.5f
             ? z * (-1.0f / 3.0f +
                    z2 * (1.0f / 30.0f +
                          z2 * (-1.0f / 840.0f +
                                z2 * (1.0f / 45360.0f -
                                      z2 * (1.0f / 3991680.0f)))))
             : (z * cz - sz) / z2;
  }
}

template <int WAV>
__device__ __forceinline__ float psi(float z) {
  float p, d;
  psi_dpsi<WAV>(z, &p, &d);
  return p;
}

// psi(z) without the wavelet's leading constant (mexican_hat's), which a
// caller applies once to a sum of such terms: psi = psi_scale * psi_core
template <int WAV>
__device__ __forceinline__ float psi_core(float z) {
  if (WAV == kMexicanHat) {
    const float z2 = z * z;
    return (z2 - 1.0f) * expf(-0.5f * z2);
  }
  return psi<WAV>(z);
}

template <int WAV>
__host__ __device__ constexpr float psi_scale() {
  return WAV == kMexicanHat ? kMexC : 1.0f;
}

template <int WAV>
__device__ __forceinline__ float dpsi(float z) {
  float p, d;
  psi_dpsi<WAV>(z, &p, &d);
  return d;
}

// v * psi'(z) as dpsi_by(z, dpsi_coef(v)): the wavelet's leading constant
// (mexican_hat's) is folded into the factor, taken once per (o, c), so a
// call costs no more multiplies than psi'(z) alone
template <int WAV>
__device__ __forceinline__ float dpsi_coef(float v) {
  return WAV == kMexicanHat ? kMexC * v : v;
}

template <int WAV>
__device__ __forceinline__ float dpsi_by(float z, float k) {
  if (WAV == kMexicanHat) {
    const float z2 = z * z;
    return k * z * expf(-0.5f * z2) * (3.0f - z2);
  }
  return k * dpsi<WAV>(z);
}

}  // namespace wav
