// fp32 body of the two prefill-style attention kernels (K3 flash forward,
// K4 dense attention; bf16 takes attn_mma.cuh): one block per (sample, head,
// 64-query tile) streams 32-key K/V tiles through shared memory with an
// online (flash) softmax.
//
// Thread layout: 128 threads; the thread pair (2r, 2r+1) owns query row
// q0 + r. The head dim is padded to DP = 8 * NJ and split between the pair:
// thread half `h` owns the float4 chunks d = 8*j + 4*h + {0..3}, so each
// thread keeps DP/2 query values and DP/2 accumulators in registers and a
// q.k dot product is two half sums joined by one shuffle. Padded lanes are
// zero in q, K and V, so any head dim D <= DP is exact (64 for the SAM
// encoder). All arithmetic is full fp32 on CUDA cores (no TF32), as the CPU
// reference is.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmmm {

constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kBQ = 64;            // query rows per block
constexpr int kBK = 32;            // keys per shared-memory tile
constexpr int kTileThreads = 2 * kBQ;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// q: (B, Sq, H, D); k, v: (B, Skv, H, D); out: (B, Sq, H, D), all contiguous.
// MASKED=false: every key < Skv is valid (dense encoder attention).
// MASKED=true: key j is valid for query i iff qseg[i] == kseg[j] != 0 and,
// when `causal`, i >= j; rows with no valid key give out = 0 and lse = 0.
// lse (B, H, Sq) fp32 is written when non-null.
template <typename T, int NJ, bool MASKED>
__global__ void __launch_bounds__(kTileThreads)
attn_tile_kernel(const T* __restrict__ q, const T* __restrict__ k,
                 const T* __restrict__ v, T* __restrict__ out,
                 float* __restrict__ lse, const int* __restrict__ qseg,
                 const int* __restrict__ kseg, int Sq, int Skv, int H, int D,
                 float scale, int causal) {
  constexpr int DP = 8 * NJ;
  __shared__ __align__(16) float Ks[kBK][DP];
  __shared__ __align__(16) float Vs[kBK][DP];
  __shared__ int kseg_s[kBK];

  const int tid = threadIdx.x;
  const int r = tid >> 1;
  const int half = tid & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBQ;
  const int qi = q0 + r;
  const bool q_ok = qi < Sq;

  float qr[NJ][4];
  float acc[NJ][4];
  const size_t q_off = ((size_t)(b * Sq + (q_ok ? qi : 0)) * H + h) * D;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * j + 4 * half + e;
      qr[j][e] = (q_ok && d < D) ? to_f(q[q_off + d]) : 0.f;
      acc[j][e] = 0.f;
    }
  }
  const int qs = MASKED ? (q_ok ? qseg[b * Sq + qi] : 0) : 1;

  float m = kNegInf;
  float l = 0.f;
  // causal: keys above the tile's last query are never valid; their tiles
  // are skipped, loads included
  int k_end = Skv;
  if (MASKED && causal) k_end = min(Skv, q0 + kBQ);

  for (int k0 = 0; k0 < k_end; k0 += kBK) {
    __syncthreads();  // the previous tile is consumed
    for (int idx = tid; idx < kBK * DP; idx += kTileThreads) {
      const int kk = idx / DP;
      const int d = idx - kk * DP;
      const int kj = k0 + kk;
      float kv = 0.f, vv = 0.f;
      if (kj < Skv && d < D) {
        const size_t off = ((size_t)(b * Skv + kj) * H + h) * D + d;
        kv = to_f(k[off]);
        vv = to_f(v[off]);
      }
      Ks[kk][d] = kv;
      Vs[kk][d] = vv;
    }
    if (MASKED && tid < kBK) {
      const int kj = k0 + tid;
      kseg_s[tid] = kj < Skv ? kseg[b * Skv + kj] : 0;
    }
    __syncthreads();

    float s[kBK];
    unsigned ok_bits = 0u;
    float t_max = kNegInf;
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      float part = 0.f;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 kv4 = *reinterpret_cast<const float4*>(&Ks[kk][8 * j + 4 * half]);
        part += qr[j][0] * kv4.x + qr[j][1] * kv4.y + qr[j][2] * kv4.z + qr[j][3] * kv4.w;
      }
      part += __shfl_xor_sync(0xffffffffu, part, 1);
      const int kj = k0 + kk;
      bool ok = kj < Skv;
      if (MASKED) ok = ok && qs != 0 && kseg_s[kk] == qs && (!causal || qi >= kj);
      s[kk] = ok ? part * scale : kNegInf;
      ok_bits |= (ok ? 1u : 0u) << kk;
      t_max = fmaxf(t_max, s[kk]);
    }
    const float m_new = fmaxf(m, t_max);
    const float alpha = expf(m - m_new);
    float p_sum = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[j][e] *= alpha;
    }
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float p = ((ok_bits >> kk) & 1u) ? expf(s[kk] - m_new) : 0.f;
      p_sum += p;
#pragma unroll
      for (int j = 0; j < NJ; ++j) {
        const float4 v4 = *reinterpret_cast<const float4*>(&Vs[kk][8 * j + 4 * half]);
        acc[j][0] += p * v4.x;
        acc[j][1] += p * v4.y;
        acc[j][2] += p * v4.z;
        acc[j][3] += p * v4.w;
      }
    }
    l = l * alpha + p_sum;
    m = m_new;
  }

  if (!q_ok) return;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * j + 4 * half + e;
      if (d < D) out[q_off + d] = from_f<T>(l > 0.f ? acc[j][e] / l : 0.f);
    }
  }
  if (lse != nullptr && half == 0) {
    lse[((size_t)b * H + h) * Sq + qi] = l > 0.f ? m + logf(l) : 0.f;
  }
}

// Smallest compiled padded head block that holds D (D <= 128).
inline int pick_nj(int D) {
  if (D <= 16) return 2;
  if (D <= 32) return 4;
  if (D <= 64) return 8;
  if (D <= 88) return 11;
  if (D <= 112) return 14;
  if (D <= 128) return 16;
  return 0;
}

template <typename T, bool MASKED>
cudaError_t launch_attn_tile(const void* q, const void* k, const void* v, void* out,
                             float* lse, const int* qseg, const int* kseg, int B,
                             int Sq, int Skv, int H, int D, float scale, int causal,
                             cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D <= 0) return cudaErrorInvalidValue;
  const dim3 grid((Sq + kBQ - 1) / kBQ, H, B);
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k);
  const T* vp = static_cast<const T*>(v);
  T* op = static_cast<T*>(out);
#define MMMM_TILE_CASE(NJ_)                                                        \
  case NJ_:                                                                        \
    attn_tile_kernel<T, NJ_, MASKED><<<grid, kTileThreads, 0, stream>>>(           \
        qp, kp, vp, op, lse, qseg, kseg, Sq, Skv, H, D, scale, causal);            \
    break;
  switch (pick_nj(D)) {
    MMMM_TILE_CASE(2)
    MMMM_TILE_CASE(4)
    MMMM_TILE_CASE(8)
    MMMM_TILE_CASE(11)
    MMMM_TILE_CASE(14)
    MMMM_TILE_CASE(16)
    default:
      return cudaErrorInvalidValue;
  }
#undef MMMM_TILE_CASE
  return cudaGetLastError();
}

}  // namespace mmmm
