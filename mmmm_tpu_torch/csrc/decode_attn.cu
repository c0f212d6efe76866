// K1: single-token decode attention against a (B, H, Smax, D) KV cache.
//
// Replaces: mmmm_tpu/ops/decode_kernel.py decode_attention_pallas, both of
// its TPU forms: _decode_attention_pallas_full (Pallas body `_decode_kernel`)
// and decode_attention_pallas_ragged (`_decode_kernel_ragged`). The two
// existed only because a full K+V read overflowed VMEM on long caches; one
// length-aware kernel covers both here.
//
// What bounds it on an H100: bytes. Each call reads the valid K and V rows
// once (about 17-21 MB at B=4, H=32, D=128, kv_len 193..320 in bf16) and does
// two FLOPs per byte, so the least time is ~5-6 us at 3.35 TB/s.
//
// Design: one block per (sample, head), 8 warps. The block reads only the
// slots below kv_len[b]; warp w takes keys in groups of 4 so that 4 rows of
// K and V are in flight per warp before the first shuffle reduction. A lane
// holds 4 consecutive head-dim values (8-byte bf16 loads; scalar loads when
// D % 4 != 0; D <= 128). Each warp keeps its own online-softmax state (fp32); the 8 partial
// states are merged through shared memory. Output is (B, 1, H, D) in the
// input dtype; kv_len = 0 gives zeros, as the TPU kernel does.
#include "decode_common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 4;

// VEC: D % 4 == 0, the rows are read with vector loads.
template <typename T, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                   const T* __restrict__ vc, const int* __restrict__ kv_len,
                   T* __restrict__ out, int H, int Smax, int D, float scale) {
  __shared__ float m_s[kWarps];
  __shared__ float l_s[kWarps];
  __shared__ float acc_s[kWarps][128];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int d0 = 4 * lane;
  const bool lane_ok = d0 < D;
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > Smax ? Smax : len);

  float qv[4] = {0.f, 0.f, 0.f, 0.f};
  if (lane_ok) mmmm::load4(q + (size_t)bh * D + d0, D - d0, VEC, qv);  // q: (B, 1, H, D)
  const T* kb = kc + (size_t)bh * Smax * D;
  const T* vb = vc + (size_t)bh * Smax * D;

  float m = mmmm::kNegInf;
  float l = 0.f;
  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  for (int j0 = warp * kUnroll; j0 < len; j0 += kWarps * kUnroll) {
    float kr[kUnroll][4];
    float vr[kUnroll][4];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      if (lane_ok && j < len) {
        mmmm::load4(kb + (size_t)j * D + d0, D - d0, VEC, kr[u]);
        mmmm::load4(vb + (size_t)j * D + d0, D - d0, VEC, vr[u]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e) kr[u][e] = vr[u][e] = 0.f;
      }
    }
    float s[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      s[u] = qv[0] * kr[u][0] + qv[1] * kr[u][1] + qv[2] * kr[u][2] + qv[3] * kr[u][3];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      s[u] *= scale;
      if (j0 + u < len) m_new = fmaxf(m_new, s[u]);
    }
    const float alpha = expf(m - m_new);
    l *= alpha;
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[e] *= alpha;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (j0 + u < len) {
        const float p = expf(s[u] - m_new);
        l += p;
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[e] += p * vr[u][e];
      }
    }
    m = m_new;
  }

  if (lane == 0) {
    m_s[warp] = m;
    l_s[warp] = l;
  }
  if (lane_ok) {
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_s[warp][d0 + e] = acc[e];
  }
  __syncthreads();
  const int d = threadIdx.x;
  if (d < D) {
    float m_all = mmmm::kNegInf;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m_all = fmaxf(m_all, m_s[w]);
    float l_all = 0.f, o = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float c = expf(m_s[w] - m_all);
      l_all += l_s[w] * c;
      o += acc_s[w][d] * c;
    }
    out[(size_t)bh * D + d] = mmmm::from_f<T>(l_all > 0.f ? o / l_all : 0.f);
  }
}

template <typename T>
void launch(const void* q, const void* k_cache, const void* v_cache, const int* lens, void* out,
            int B, int H, int Smax, int D, float scale, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_cache);
  const T* vp = static_cast<const T*>(v_cache);
  T* op = static_cast<T*>(out);
  if (D % 4 == 0)
    decode_attn_kernel<T, true><<<B * H, kWarps * 32, 0, st>>>(qp, kp, vp, lens, op, H, Smax, D,
                                                               scale);
  else
    decode_attn_kernel<T, false><<<B * H, kWarps * 32, 0, st>>>(qp, kp, vp, lens, op, H, Smax, D,
                                                                scale);
}

}  // namespace

extern "C" int mmmm_decode_attention(const void* q, const void* k_cache,
                                     const void* v_cache, const void* kv_len,
                                     void* out, int B, int H, int Smax, int D,
                                     float scale, int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (is_bf16)
    launch<__nv_bfloat16>(q, k_cache, v_cache, lens, out, B, H, Smax, D, scale, st);
  else
    launch<float>(q, k_cache, v_cache, lens, out, B, H, Smax, D, scale, st);
  return static_cast<int>(cudaGetLastError());
}
