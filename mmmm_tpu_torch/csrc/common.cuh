// Constants and element conversions shared by the port's kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmmm {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// The first slot of n appended rows (the fused decode forms): write_index w
// wrapped once from the end, then clamped to [0, Smax - n], so a window
// that would pass Smax shifts back whole (the reference's
// dynamic_update_slice rule, as K2, K5 and K8 apply it).
__device__ __forceinline__ int append_slot(int w, int Smax, int n = 1) {
  if (w < 0) w += Smax;
  return w < 0 ? 0 : (w > Smax - n ? Smax - n : w);
}

// (a, b) each rounded to bf16 (to nearest, ties to even), as floats: one
// packed conversion for the two (cvt.rn.bf16x2.f32), a shift back each.
__device__ __forceinline__ float2 bf16r2(float a, float b) {
  return __bfloat1622float2(__floats2bfloat162_rn(a, b));
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

}  // namespace mmmm
