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
// bytes is read by LPS lanes (D/16 rounded up to a power of two), 16 bytes
// each, with one 16-byte load where D % 16 == 0 and byte loads that stop at
// D otherwise; so a warp reads 32 / LPS slots at once (4 at D = 128), two
// such groups per iteration;
// the slot's two scales are read once, by the first lane of its group, and
// broadcast with a shuffle. Each lane group keeps its own online-softmax
// state in fp32 over 16 head-dim values; all group states are merged through
// shared memory. Only slots below kv_len[b] are read; kv_len = 0 gives zeros.
#include "common.cuh"

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

// The 16 int8 values at p of which the first n lie in the row (byte loads,
// zero past the row), packed as one 16-byte load would give them.
__device__ __forceinline__ int4 load_i8x16(const int8_t* p, int n) {
  int w[4] = {0, 0, 0, 0};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (e < n) w[e >> 2] |= static_cast<int>(static_cast<uint8_t>(p[e])) << (8 * (e & 3));
  return make_int4(w[0], w[1], w[2], w[3]);
}

template <typename T>
__device__ __forceinline__ void load16_tail(const T* p, int n, float out[16]) {
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = e < n ? mmmm::to_f(p[e]) : 0.f;
}

__device__ __forceinline__ float int8_at(const int4& r, int i) {
  const int w = i < 4 ? r.x : (i < 8 ? r.y : (i < 12 ? r.z : r.w));
  return static_cast<float>(static_cast<signed char>(w >> (8 * (i & 3))));
}

// LPS = lanes per slot, D <= 16 LPS; VEC: D % 16 == 0 (16-byte loads).
template <typename T, int LPS, bool VEC>
__global__ void __launch_bounds__(kWarps * 32)
decode_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                 const __nv_bfloat16* __restrict__ ks, const int8_t* __restrict__ vq,
                 const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                 T* __restrict__ out, int H, int Smax, int D, float scale) {
  constexpr int DP = 16 * LPS;
  constexpr int G = 32 / LPS;  // slots a warp reads at once
  __shared__ float m_s[kWarps * G];
  __shared__ float l_s[kWarps * G];
  __shared__ float acc_s[kWarps * G * DP];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane / LPS;           // slot group of this lane
  const int d0 = 16 * (lane % LPS);   // its 16 head-dim values
  const int leader = g * LPS;         // first lane of the group
  const int n = D - d0;               // of its values, those in the row
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > Smax ? Smax : len);

  float qv[16];
  if (VEC && n > 0) load16(q + (size_t)bh * D + d0, qv);  // q: (B, 1, H, D)
  else load16_tail(q + (size_t)bh * D + d0, n, qv);
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
        if (VEC) {
          if (n > 0) {
            kr[u] = *reinterpret_cast<const int4*>(kq + (row0 + j) * D + d0);
            vr[u] = *reinterpret_cast<const int4*>(vq + (row0 + j) * D + d0);
          }
        } else {
          kr[u] = load_i8x16(kq + (row0 + j) * D + d0, n);
          vr[u] = load_i8x16(vq + (row0 + j) * D + d0, n);
        }
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
  for (int e = 0; e < 16; ++e) acc_s[grp * DP + d0 + e] = acc[e];
  __syncthreads();
  for (int d = threadIdx.x; d < D; d += kWarps * 32) {
    float m_all = mmmm::kNegInf;
    for (int i = 0; i < kWarps * G; ++i) m_all = fmaxf(m_all, m_s[i]);
    float l_all = 0.f, o = 0.f;
    for (int i = 0; i < kWarps * G; ++i) {
      const float c = expf(m_s[i] - m_all);
      l_all += l_s[i] * c;
      o += acc_s[i * DP + d] * c;
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
  const int lps = D <= 16 ? 1 : (D <= 32 ? 2 : (D <= 64 ? 4 : 8));
  const bool vec = D % 16 == 0;
#define MMMM_Q8_CASE(LPS_)                                                                \
  case LPS_:                                                                              \
    if (vec)                                                                              \
      decode_q8_kernel<T, LPS_, true><<<grid, block, 0, st>>>(qp, kqp, ksp, vqp, vsp, lens, \
                                                              op, H, Smax, D, scale);     \
    else                                                                                  \
      decode_q8_kernel<T, LPS_, false><<<grid, block, 0, st>>>(qp, kqp, ksp, vqp, vsp,     \
                                                               lens, op, H, Smax, D, scale); \
    break;
  switch (lps) {
    MMMM_Q8_CASE(1)
    MMMM_Q8_CASE(2)
    MMMM_Q8_CASE(4)
    MMMM_Q8_CASE(8)
  }
#undef MMMM_Q8_CASE
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, out: (B, 1, H, D) bf16 or fp32; kq, vq: (B, H, Smax, D) int8; ks, vs:
// (B, H, Smax, 1) bf16; kv_len (B,) int32. 0 < D <= 128.
extern "C" int mmmm_decode_attention_q8(const void* q, const void* kq, const void* ks,
                                        const void* vq, const void* vs, const void* kv_len,
                                        void* out, int B, int H, int Smax, int D, float scale,
                                        int is_bf16, void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, lens, out, B, H, Smax, D, scale, st);
  return launch<float>(q, kq, ks, vq, vs, lens, out, B, H, Smax, D, scale, st);
}
