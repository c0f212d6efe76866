// K9: single-token decode attention over an int8 KV cache with one bf16
// scale per (sample, head, slot).
//
// Replaces: mmmm_tpu/ops/decode_kernel.py decode_attention_pallas_q8, both of
// its TPU forms: _decode_attention_pallas_q8_full (Pallas body
// `_decode_kernel_q8`) and decode_attention_pallas_q8_ragged
// (`_decode_kernel_q8_ragged`, its fp32 cast). As for K1, the two existed
// because a full read overflowed VMEM; one length-aware kernel covers both.
// It computes what the TPU kernel does, in fp32:
//   logits = (q . k_q) * k_s * scale;  out = sum_j p_j * v_s[j] * v_q[j] / l.
//
// What bounds it on an H100: bytes. A call reads the valid int8 K and V rows
// and their scales once (about 8.5 MB at B=4, H=32, D=128, kv_len ~260),
// half the bytes of K1 on a bf16 cache: ~2.6 us at 3.35 TB/s.
//
// Design: one block per (sample, head), 8 warps. A slot's int8 row of D
// bytes is read by D/16 lanes with one 16-byte load each, so a warp reads
// 32 / (D/16) slots at once (4 at D = 128), two such groups per iteration;
// the slot's two scales are read once, by the first lane of its group, and
// broadcast with a shuffle. Each lane group keeps its own online-softmax
// state in fp32 over 16 head-dim values; all group states are merged through
// shared memory. Only slots below kv_len[b] are read; kv_len = 0 gives zeros.
#include "attn_tile.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 2;

__device__ __forceinline__ void load16(const __nv_bfloat16* p, float out[16]) {
#pragma unroll
  for (int c = 0; c < 2; ++c) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + 8 * c);
    const unsigned w[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&w[i]));
      out[8 * c + 2 * i] = f.x;
      out[8 * c + 2 * i + 1] = f.y;
    }
  }
}

__device__ __forceinline__ void load16(const float* p, float out[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 raw = *reinterpret_cast<const float4*>(p + 4 * c);
    out[4 * c] = raw.x;
    out[4 * c + 1] = raw.y;
    out[4 * c + 2] = raw.z;
    out[4 * c + 3] = raw.w;
  }
}

__device__ __forceinline__ float int8_at(const int4& r, int i) {
  const int w = i < 4 ? r.x : (i < 8 ? r.y : (i < 12 ? r.z : r.w));
  return static_cast<float>(static_cast<signed char>(w >> (8 * (i & 3))));
}

// LPS = lanes per slot = D / 16.
template <typename T, int LPS>
__global__ void __launch_bounds__(kWarps * 32)
decode_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                 const __nv_bfloat16* __restrict__ ks, const int8_t* __restrict__ vq,
                 const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                 T* __restrict__ out, int H, int Smax, float scale) {
  constexpr int D = 16 * LPS;
  constexpr int G = 32 / LPS;  // slots a warp reads at once
  __shared__ float m_s[kWarps * G];
  __shared__ float l_s[kWarps * G];
  __shared__ float acc_s[kWarps * G * D];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / LPS;           // slot group of this lane
  const int d0 = 16 * (lane % LPS);   // its 16 head-dim values
  const int leader = g * LPS;         // first lane of the group
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > Smax ? Smax : len);

  float qv[16];
  load16(q + (size_t)bh * D + d0, qv);  // q: (B, 1, H, D)
  const size_t row0 = (size_t)bh * Smax;

  float m = mmmm::kNegInf;
  float l = 0.f;
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

  for (int base = warp * G * kUnroll; base < len; base += kWarps * G * kUnroll) {
    int4 kr[kUnroll], vr[kUnroll];
    float ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * G + g;
      kr[u] = vr[u] = make_int4(0, 0, 0, 0);
      ksc[u] = vsc[u] = 0.f;
      if (j < len) {
        kr[u] = *reinterpret_cast<const int4*>(kq + (row0 + j) * D + d0);
        vr[u] = *reinterpret_cast<const int4*>(vq + (row0 + j) * D + d0);
        if (lane == leader) {
          ksc[u] = __bfloat162float(ks[row0 + j]);
          vsc[u] = __bfloat162float(vs[row0 + j]);
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + u * G + g;
      float s = 0.f;
#pragma unroll
      for (int e = 0; e < 16; ++e) s += qv[e] * int8_at(kr[u], e);
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
      const float k_s = __shfl_sync(0xffffffffu, ksc[u], leader);
      const float v_s = __shfl_sync(0xffffffffu, vsc[u], leader);
      if (j < len) {
        const float x = s * k_s * scale;
        const float m_new = fmaxf(m, x);
        const float alpha = expf(m - m_new);
        const float p = expf(x - m_new);
        l = l * alpha + p;
        const float w = p * v_s;
#pragma unroll
        for (int e = 0; e < 16; ++e) acc[e] = acc[e] * alpha + w * int8_at(vr[u], e);
        m = m_new;
      }
    }
  }

  const int grp = warp * G + g;
  if (lane == leader) {
    m_s[grp] = m;
    l_s[grp] = l;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) acc_s[grp * D + d0 + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float m_all = mmmm::kNegInf;
    for (int i = 0; i < kWarps * G; ++i) m_all = fmaxf(m_all, m_s[i]);
    float l_all = 0.f, o = 0.f;
    for (int i = 0; i < kWarps * G; ++i) {
      const float c = expf(m_s[i] - m_all);
      l_all += l_s[i] * c;
      o += acc_s[i * D + d] * c;
    }
    out[(size_t)bh * D + d] = mmmm::from_f<T>(l_all > 0.f ? o / l_all : 0.f);
  }
}

template <typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const int* lens, void* out, int B, int H, int Smax, int D, float scale,
           cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const int8_t* kqp = static_cast<const int8_t*>(kq);
  const int8_t* vqp = static_cast<const int8_t*>(vq);
  const __nv_bfloat16* ksp = static_cast<const __nv_bfloat16*>(ks);
  const __nv_bfloat16* vsp = static_cast<const __nv_bfloat16*>(vs);
  T* op = static_cast<T*>(out);
  const dim3 grid(B * H), block(kWarps * 32);
  switch (D) {
#define MMMM_Q8_CASE(DIM)                                                                 \
  case DIM:                                                                               \
    decode_q8_kernel<T, DIM / 16><<<grid, block, 0, st>>>(qp, kqp, ksp, vqp, vsp, lens, op, \
                                                          H, Smax, scale);                \
    break;
    MMMM_Q8_CASE(16)
    MMMM_Q8_CASE(32)
    MMMM_Q8_CASE(64)
    MMMM_Q8_CASE(128)
#undef MMMM_Q8_CASE
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, 1, H, D) bf16 or fp32; kq, vq: (B, H, Smax, D) int8; ks, vs:
// (B, H, Smax, 1) bf16; kv_len (B,) int32. D is 16, 32, 64 or 128.
extern "C" int mmmm_decode_attention_q8(const void* q, const void* kq, const void* ks,
                                        const void* vq, const void* vs, const void* kv_len,
                                        void* out, int B, int H, int Smax, int D, float scale,
                                        int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, lens, out, B, H, Smax, D, scale, st);
  return launch<float>(q, kq, ks, vq, vs, lens, out, B, H, Smax, D, scale, st);
}
