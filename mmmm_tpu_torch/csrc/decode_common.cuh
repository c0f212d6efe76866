// Shared by the decode-attention kernels over a (B, H, Smax, D) cache (K1
// decode_attn.cu, K6 decode_window.cu): a lane holds 4 consecutive head-dim
// values of a query or cache row, read with one 8-byte (bf16) or 16-byte
// (fp32) load, or, when D % 4 != 0 (rows not aligned to those loads), with
// scalar loads that stop at D.
#pragma once

#include "common.cuh"

namespace mmmm {

__device__ __forceinline__ void load4(const __nv_bfloat16* p, float out[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  const __nv_bfloat162 lo = *reinterpret_cast<const __nv_bfloat162*>(&raw.x);
  const __nv_bfloat162 hi = *reinterpret_cast<const __nv_bfloat162*>(&raw.y);
  const float2 a = __bfloat1622float2(lo);
  const float2 b = __bfloat1622float2(hi);
  out[0] = a.x;
  out[1] = a.y;
  out[2] = b.x;
  out[3] = b.y;
}

__device__ __forceinline__ void load4(const float* p, float out[4]) {
  const float4 raw = *reinterpret_cast<const float4*>(p);
  out[0] = raw.x;
  out[1] = raw.y;
  out[2] = raw.z;
  out[3] = raw.w;
}

// The 4 values at p of which the first n (>= 1) lie in the row: one vector
// load where `vec` (D % 4 == 0), else scalar loads, zero past the row.
template <typename T>
__device__ __forceinline__ void load4(const T* p, int n, bool vec, float out[4]) {
  if (vec) {
    load4(p, out);
    return;
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) out[e] = e < n ? to_f(p[e]) : 0.f;
}

}  // namespace mmmm
