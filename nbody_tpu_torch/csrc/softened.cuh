// The softened inverse cube 1 / (|d|^2 + eps^2)^{3/2} of the pair kernels
// K1, K3 and K5, in two instances picked on the host by softened(eps2).
//
// kSoft (eps^2 a normal float): |d|^2 + eps^2 >= eps^2 is normal, so the
//   r == 0 guard cannot fire and is left out; eps^2 seeds the first FMA of
//   |d|^2 (three FMAs); the rsqrt is the MUFU instruction alone
//   (rsqrt.approx.ftz: flushing subnormal inputs changes nothing when no
//   input is subnormal, and saves the scaling rsqrtf wraps around it).
// !kSoft (eps = 0, or eps^2 below the smallest normal float): r^2 == 0 (a
//   self or coincident pair) is replaced by 1, and the pair then adds 0
//   through d = 0; rsqrtf keeps its handling of subnormal r^2.

#pragma once

#include <cfloat>

namespace nbody {

__device__ __forceinline__ float rsqrt_ftz(float x) {
  float y;
  asm("rsqrt.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <bool kSoft>
__device__ __forceinline__ float softened_ir3(float dx, float dy, float dz,
                                              float eps2) {
  const float r2 = fmaf(dz, dz, fmaf(dy, dy, fmaf(dx, dx, eps2)));
  const float ir = kSoft ? rsqrt_ftz(r2) : rsqrtf(r2 > 0.f ? r2 : 1.f);
  return ir * ir * ir;
}

inline bool softened(float eps2) { return eps2 >= FLT_MIN; }

}  // namespace nbody
