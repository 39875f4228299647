// Helpers shared by the denoiser kernels K4 (reproject.cu) and K5
// (atrous.cu). Float semantics follow the plain PyTorch versions (see each
// kernel's header); the kernels build with -fmad=false and no fast math.
#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace denoise {

// max / min that return NaN if an operand is NaN, as torch.clamp_min /
// clamp_max do for a bound that is not NaN, in one instruction (PTX max.NaN /
// min.NaN). They may differ from torch in the sign of a zero result (a and
// b zeros of opposite sign), which changes no output's value. One
// instruction instead of a compare and a select: the run-time-sigma_n K5
// chain took 0.2388-0.2394 ms with these and 0.2518-0.2520 with the
// compare and select on the H100 (PERF.md).
__device__ __forceinline__ float maxp(float a, float b) {
  float r;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}
__device__ __forceinline__ float minp(float a, float b) {
  float r;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(r) : "f"(a), "f"(b));
  return r;
}

__device__ __forceinline__ int clampi(int v, int lo, int hi) { return v < lo ? lo : (v > hi ? hi : v); }

__device__ __forceinline__ float lum(float r, float g, float b) {
  return 0.2125f * r + 0.7154f * g + 0.0721f * b;
}

// clamp(x, 0, 1) ** sigma_n, the normal weight: kSq squarings when known at
// compile time (sigma_n = 2^kSq), else n_sq squarings at run time, or powf
// when sigma_n is no power of two (n_sq < 0). The first squaring removes
// the sign of a zero from the clamp (sigma_n >= 2).
template <int kSq>
__device__ __forceinline__ float pow_weight(float x, float sigma_n, int n_sq) {
  x = minp(maxp(x, 0.f), 1.f);
  if (kSq >= 0) {
#pragma unroll
    for (int i = 0; i < kSq; ++i) x = x * x;
    return x;
  }
  if (n_sq < 0) return powf(x, sigma_n);
  for (int i = 0; i < n_sq; ++i) x = x * x;
  return x;
}

// the default sigma_n = 128 = 2^7, specialised at compile time: with the
// run-time loop, K5's chain took 1.55x and K4 1.16x as long on the H100
// (PERF.md)
constexpr int kDefaultSquarings = 7;

}  // namespace denoise
