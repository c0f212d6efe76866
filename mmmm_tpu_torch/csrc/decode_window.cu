// K6: verify-window decode attention for speculative decoding: NQ <= 8
// queries per sample against a (B, H, Smax, D) KV cache that already holds
// the window's rows.
//
// Replaces: mmmm_tpu/ops/decode_kernel.py decode_attention_pallas_window
// (Pallas body `_decode_window_kernel`). Query j of sample b sees the slots
// below write_index[b] + j + 1: the whole prefix plus the window causally.
//
// What bounds it on an H100: bytes. A verify step reads each valid K and V
// row once for all NQ queries (about 21 MB at B=4, H=32, D=128, 330 slots
// in bf16) and does 4 * NQ FLOPs per cache element, far below the
// operations bound, so the least time is ~6 us at 3.35 TB/s, the same as a
// single-token step. That is the point of verifying a window: NQ tokens for
// one pass over the cache.
//
// Design: one block per (sample, head), 8 warps; warp w walks the slots
// w, w + 8, ... two at a time, below write_index + NQ. A lane holds 4
// head-dim values of every query and of the K/V row (scalar loads when D %
// 4 != 0), so each K row feeds all NQ dot products (NQ butterfly
// reductions per slot) and each V row all NQ accumulators. Each warp keeps NQ online-softmax states in fp32; the 8
// partial states of each query are merged through shared memory. Masked
// slots never enter a sum, so a query with no valid slot gives zeros, as
// the TPU kernel does.
#include "decode_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 2;

// VEC: D % 4 == 0, the rows are read with vector loads.
template <typename T, int NQ, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
decode_window_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ write_index,
                     T* __restrict__ out, int H, int Smax, int D, float scale) {
  __shared__ float m_s[kWarps][NQ];
  __shared__ float l_s[kWarps][NQ];
  __shared__ float acc_s[kWarps][NQ][128];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = 4 * lane;
  const bool lane_ok = d0 < D;
  const int t = write_index[b];
  // query j sees slots < len(j) = clamp(t + j + 1, 0, Smax)
  int len_end = t + NQ;
  len_end = len_end < 0 ? 0 : (len_end > Smax ? Smax : len_end);

  float qv[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    if (lane_ok) {
      mmmm::load4(q + (((size_t)b * NQ + j) * H + h) * D + d0, D - d0, VEC, qv[j]);  // q: (B, NQ, H, D)
    } else {
#pragma unroll
      for (int e = 0; e < 4; ++e) qv[j][e] = 0.f;
    }
  }
  const T* kb = kc + (size_t)bh * Smax * D;
  const T* vb = vc + (size_t)bh * Smax * D;

  float m[NQ], l[NQ], acc[NQ][4];
#pragma unroll
  for (int j = 0; j < NQ; ++j) {
    m[j] = mmmm::kNegInf;
    l[j] = 0.f;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  }

  for (int s0 = warp; s0 < len_end; s0 += kWarps * kUnroll) {
    float kr[kUnroll][4];
    float vr[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kWarps;
      if (lane_ok && s < len_end) {
        mmmm::load4(kb + (size_t)s * D + d0, D - d0, VEC, kr[u]);
        mmmm::load4(vb + (size_t)s * D + d0, D - d0, VEC, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int s = s0 + u * kWarps;
      float sc[NQ];
#pragma unroll
      for (int j = 0; j < NQ; ++j)
        sc[j] = qv[j][0] * kr[u][0] + qv[j][1] * kr[u][1] + qv[j][2] * kr[u][2] +
                qv[j][3] * kr[u][3];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
        for (int j = 0; j < NQ; ++j) sc[j] += __shfl_xor_sync(0xffffffffu, sc[j], off);
      }
#pragma unroll
      for (int j = 0; j < NQ; ++j) {
        if (s < t + j + 1 && s < Smax) {
          const float x = sc[j] * scale;
          const float m_new = fmaxf(m[j], x);
          const float alpha = expf(m[j] - m_new);
          const float p = expf(x - m_new);
          l[j] = l[j] * alpha + p;
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = acc[j][e] * alpha + p * vr[u][e];
          m[j] = m_new;
        }
      }
    }
  }

  if (lane == 0) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
      m_s[warp][j] = m[j];
      l_s[warp][j] = l[j];
    }
  }
  if (lane_ok) {
#pragma unroll
    for (int j = 0; j < NQ; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc_s[warp][j][d0 + e] = acc[j][e];
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < NQ * D; i += kWarps * 32) {
    const int j = i / D;
    const int d = i - j * D;
    float m_all = mmmm::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_s[w][j]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w][j] - m_all);
      l_all += l_s[w][j] * c;
      o += acc_s[w][j][d] * c;
    }
    out[(((size_t)b * NQ + j) * H + h) * D + d] = mmmm::from_f<T>(l_all > 0.f ? o / l_all : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* k_cache, const void* v_cache, const int* widx,
           void* out, int B, int NQ, int H, int Smax, int D, float scale, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_cache);
  const T* vp = static_cast<const T*>(v_cache);
  T* op = static_cast<T*>(out);
  const dim3 grid(B * H), block(kWarps * 32);
  switch (NQ) {
#define MMMM_WINDOW_CASE(N)                                                                 \
  case N:                                                                                   \
    if (D % 4 == 0)                                                                         \
      decode_window_kernel<T, N, true><<<grid, block, 0, st>>>(qp, kp, vp, widx, op, H, Smax, \
                                                               D, scale);                   \
    else                                                                                    \
      decode_window_kernel<T, N, false><<<grid, block, 0, st>>>(qp, kp, vp, widx, op, H,     \
                                                                Smax, D, scale);            \
    break;
    MMMM_WINDOW_CASE(1)
    MMMM_WINDOW_CASE(2)
    MMMM_WINDOW_CASE(3)
    MMMM_WINDOW_CASE(4)
    MMMM_WINDOW_CASE(5)
    MMMM_WINDOW_CASE(6)
    MMMM_WINDOW_CASE(7)
    MMMM_WINDOW_CASE(8)
#undef MMMM_WINDOW_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, NQ, H, D); k_cache, v_cache: (B, H, Smax, D); write_index (B,)
// int32. 1 <= NQ <= 8, D <= 128.
extern "C" int mmmm_decode_attention_window(const void* q, const void* k_cache,
                                            const void* v_cache, const void* write_index,
                                            void* out, int B, int NQ, int H, int Smax, int D,
                                            float scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128 || NQ < 1 || NQ > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* widx = static_cast<const int*>(write_index);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, k_cache, v_cache, widx, out, B, NQ, H, Smax, D, scale, st);
  return launch<float>(q, k_cache, v_cache, widx, out, B, NQ, H, Smax, D, scale, st);
}
