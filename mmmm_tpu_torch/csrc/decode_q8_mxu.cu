// K10: single-token decode attention over an int8 KV cache as exact
// split-int8 integer dots.
//
// Replaces: mmmm_tpu/ops/decode_kernel.py decode_attention_pallas_q8_mxu
// (Pallas body `_decode_kernel_q8_mxu`, with `_q14_split` of q, which the
// reference runs before the kernel and this kernel runs inside). Per
// (sample, head), all as the reference:
//   q = (128 * q_hi + q_lo) * q_s,     q_s = max|q| / 16256 (14-bit split)
//   s32 = 128 * <k_q, q_hi> + <k_q, q_lo>                      (int32)
//   logit = s32 * k_s * (q_s * scale), masked at slot >= kv_len
//   w = softmax(logit) * v_s;  w14 = rint(w / w_s), w_s = max(w) / 16256
//   o32 = 128 * <v_q^T, w_hi> + <v_q^T, w_lo>;  out = o32 * w_s
// Integer sums are taken modulo 2^32 (unsigned, then reinterpreted), which
// is what the reference's int32 arithmetic gives: |o32| can pass 2^31 above
// kv_len ~1040 under near-uniform attention, and then kernel, plain version
// and reference wrap alike. The integers are exact and independent of the
// order of summation; only exp and the softmax sums round differently.
//
// What bounds it on an H100: bytes, as K9 (the valid int8 K and V rows and
// their scales, read once).
//
// Design: one block per (sample, head), 8 warps. The q split happens in the
// block (a block-wide max, IEEE division, round-half-even). Logits: a slot's
// int8 K row is read by LPS lanes, 16 bytes each (LPS the power of two with
// 16 LPS >= D, lanes past D hold zeros), and dotted with the packed q_hi and
// q_lo by __dp4a; the Smax logits stay in shared memory (in a global fp32
// workspace the wrapper allocates where 6 bytes a slot would not fit) for
// the full-row softmax (the weights' maximum is needed before they are
// split). Values: each thread owns one 4-byte word column of V (4 head
// dims) and a share of the slots; four slots' words are transposed with
// __byte_perm so that one __dp4a multiplies 4 slots of one head dim by the
// packed w_hi (or w_lo) of those slots. Rows of a head dim that is not a
// multiple of 16 are not 16-byte aligned: they are read a byte at a time,
// zero past D (VEC = false). int8 mma.sync m16n8k32 is later work.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;

__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r = fmaxf(r, red[i]);
  __syncthreads();
  return r;
}

__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float r = red[0];
#pragma unroll
  for (int i = 1; i < kWarps; ++i) r += red[i];
  __syncthreads();
  return r;
}

// 16 bytes of an int8 row from head dim d0, zero past D: one 16-byte load
// where rows are 16-byte aligned (VEC: D % 16 == 0), else byte loads.
template <bool VEC>
__device__ __forceinline__ int4 load_row16(const int8_t* row, int d0, int D) {
  if (d0 >= D) return make_int4(0, 0, 0, 0);
  if (VEC) return *reinterpret_cast<const int4*>(row + d0);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (d0 + e < D) w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[d0 + e])) << (8 * (e & 3));
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                   static_cast<int>(w[3]));
}

// The 4 bytes of an int8 row from head dim d0 (a multiple of 4), zero past D.
template <bool VEC>
__device__ __forceinline__ unsigned load_row4(const int8_t* row, int d0, int D) {
  if (d0 >= D) return 0u;
  if (VEC) return *reinterpret_cast<const unsigned*>(row + d0);
  unsigned w = 0u;
#pragma unroll
  for (int e = 0; e < 4; ++e)
    if (d0 + e < D) w |= static_cast<unsigned>(static_cast<uint8_t>(row[d0 + e])) << (8 * e);
  return w;
}

// LPS = lanes per K row (16 LPS >= D). 6 * roundup(Smax, 4) bytes a block
// (fp32 logits, then the int8 w_hi and w_lo of every slot): dynamic shared
// memory, or the block's slice of `scratch` where the wrapper passes one.
template <typename T, int LPS, bool VEC>
__global__ void __launch_bounds__(kThreads)
decode_q8_mxu_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                     const __nv_bfloat16* __restrict__ ks, const int8_t* __restrict__ vq,
                     const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                     T* __restrict__ out, unsigned char* __restrict__ scratch, int H, int Smax,
                     int D, float scale) {
  constexpr int DP = 16 * LPS;         // D rounded up to the lanes' 16-byte pieces
  constexpr int G = 32 / LPS;          // K rows a warp reads at once
  constexpr int WC = DP / 4;           // 4-byte word columns of a V row
  constexpr int NSG = kThreads / WC;   // slot groups of the value pass
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float red[kWarps];
  __shared__ __align__(16) int8_t qsplit[2][DP];
  __shared__ unsigned osum[NSG][DP];

  const int smax4 = (Smax + 3) & ~3;
  float* logit = reinterpret_cast<float*>(
      scratch == nullptr ? smem : scratch + (size_t)blockIdx.x * 6 * smax4);
  int8_t* whi = reinterpret_cast<int8_t*>(logit + smax4);
  int8_t* wlo = whi + smax4;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  int len = kv_len[b];
  len = len < 0 ? 0 : (len > Smax ? Smax : len);
  const size_t row0 = (size_t)bh * Smax;

  // ---- q -> (q_hi, q_lo, q_s) -------------------------------------------------------
  const float qv = tid < D ? mmmm::to_f(q[(size_t)bh * D + tid]) : 0.f;
  const float qs = fmaxf(block_max(fabsf(qv), red), 1e-8f) / 16256.f;
  if (tid < DP) {  // lanes past D hold zeros
    const int x14 = __float2int_rn(qv / qs);
    const int hi = x14 >> 7;
    qsplit[0][tid] = static_cast<int8_t>(hi);
    qsplit[1][tid] = static_cast<int8_t>(x14 - hi * 128);
  }
  __syncthreads();

  // ---- logits of the valid slots ------------------------------------------------------
  {
    const int g = lane / LPS;
    const int d0 = 16 * (lane % LPS);
    const int4 qh = *reinterpret_cast<const int4*>(&qsplit[0][d0]);
    const int4 ql = *reinterpret_cast<const int4*>(&qsplit[1][d0]);
    const float qss = qs * scale;
    for (int base = warp * G; base < len; base += kWarps * G) {
      const int j = base + g;
      int a = 0, c = 0;
      if (j < len) {
        const int4 kr = load_row16<VEC>(kq + (row0 + j) * D, d0, D);
        a = __dp4a(kr.x, qh.x, a);
        a = __dp4a(kr.y, qh.y, a);
        a = __dp4a(kr.z, qh.z, a);
        a = __dp4a(kr.w, qh.w, a);
        c = __dp4a(kr.x, ql.x, c);
        c = __dp4a(kr.y, ql.y, c);
        c = __dp4a(kr.z, ql.z, c);
        c = __dp4a(kr.w, ql.w, c);
      }
#pragma unroll
      for (int off = LPS / 2; off > 0; off >>= 1) {
        a += __shfl_xor_sync(0xffffffffu, a, off);
        c += __shfl_xor_sync(0xffffffffu, c, off);
      }
      if (j < len && lane % LPS == 0) {
        const int s32 = static_cast<int>(128u * static_cast<unsigned>(a) + static_cast<unsigned>(c));
        logit[j] = (static_cast<float>(s32) * __bfloat162float(ks[row0 + j])) * qss;
      }
    }
  }
  __syncthreads();

  // ---- softmax, folded with v_s, split to (w_hi, w_lo) ----------------------------------
  float mx = mmmm::kNegInf;
  for (int j = tid; j < len; j += kThreads) mx = fmaxf(mx, logit[j]);
  mx = block_max(mx, red);
  float sum = 0.f;
  for (int j = tid; j < len; j += kThreads) {
    const float p = expf(logit[j] - mx);
    logit[j] = p;
    sum += p;
  }
  const float denom = fmaxf(block_sum(sum, red), 1e-30f);
  float wmx = 0.f;
  for (int j = tid; j < len; j += kThreads) {
    const float w = (logit[j] / denom) * __bfloat162float(vs[row0 + j]);
    logit[j] = w;
    wmx = fmaxf(wmx, w);
  }
  const float ws = fmaxf(block_max(wmx, red), 1e-30f) / 16256.f;
  for (int j = tid; j < smax4; j += kThreads) {
    int hi = 0, lo = 0;
    if (j < len) {
      const int w14 = __float2int_rn(logit[j] / ws);
      hi = w14 >> 7;
      lo = w14 - hi * 128;
    }
    whi[j] = static_cast<int8_t>(hi);
    wlo[j] = static_cast<int8_t>(lo);
  }
  __syncthreads();

  // ---- o32 = 128 <v_q^T, w_hi> + <v_q^T, w_lo> -----------------------------------------
  {
    const int c = tid % WC;
    const int sg = tid / WC;
    int ah[4] = {0, 0, 0, 0}, al[4] = {0, 0, 0, 0};
    for (int j0 = 4 * sg; j0 < len; j0 += 4 * NSG) {
      unsigned r[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        r[i] = j0 + i < Smax ? load_row4<VEC>(vq + (row0 + j0 + i) * D, 4 * c, D) : 0u;
      // t[d] = byte d of r[0..3]: head dim 4c + d of the four slots
      const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
      const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
      const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
      const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
      const int t[4] = {static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                        static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                        static_cast<int>(__byte_perm(hi01, hi23, 0x7632))};
      const int wh = *reinterpret_cast<const int*>(whi + j0);
      const int wl = *reinterpret_cast<const int*>(wlo + j0);
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        ah[d] = __dp4a(t[d], wh, ah[d]);
        al[d] = __dp4a(t[d], wl, al[d]);
      }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d)
      osum[sg][4 * c + d] = 128u * static_cast<unsigned>(ah[d]) + static_cast<unsigned>(al[d]);
  }
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    unsigned o = 0u;
    for (int s = 0; s < NSG; ++s) o += osum[s][d];
    out[(size_t)bh * D + d] = mmmm::from_f<T>(static_cast<float>(static_cast<int>(o)) * ws);
  }
}

template <typename T, int LPS, bool VEC>
int launch_lps(const T* q, const int8_t* kq, const __nv_bfloat16* ks, const int8_t* vq,
               const __nv_bfloat16* vs, const int* lens, T* out, unsigned char* scratch, int B,
               int H, int Smax, int D, float scale, cudaStream_t st) {
  auto* kern = decode_q8_mxu_kernel<T, LPS, VEC>;
  const size_t smem = scratch == nullptr ? 6 * (size_t)((Smax + 3) & ~3) : 0;
  if (smem > 40 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<B * H, kThreads, smem, st>>>(q, kq, ks, vq, vs, lens, out, scratch, H, Smax, D, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LPS>
int launch_vec(const T* q, const int8_t* kq, const __nv_bfloat16* ks, const int8_t* vq,
               const __nv_bfloat16* vs, const int* lens, T* out, unsigned char* scratch, int B,
               int H, int Smax, int D, float scale, cudaStream_t st) {
  if (D % 16 == 0)
    return launch_lps<T, LPS, true>(q, kq, ks, vq, vs, lens, out, scratch, B, H, Smax, D, scale,
                                    st);
  return launch_lps<T, LPS, false>(q, kq, ks, vq, vs, lens, out, scratch, B, H, Smax, D, scale,
                                   st);
}

template <typename T>
int launch(const void* q, const void* kq, const void* ks, const void* vq, const void* vs,
           const int* lens, void* out, void* scratch, int B, int H, int Smax, int D, float scale,
           cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const int8_t* kqp = static_cast<const int8_t*>(kq);
  const int8_t* vqp = static_cast<const int8_t*>(vq);
  const __nv_bfloat16* ksp = static_cast<const __nv_bfloat16*>(ks);
  const __nv_bfloat16* vsp = static_cast<const __nv_bfloat16*>(vs);
  T* op = static_cast<T*>(out);
  unsigned char* w = static_cast<unsigned char*>(scratch);
  if (D <= 16) return launch_vec<T, 1>(qp, kqp, ksp, vqp, vsp, lens, op, w, B, H, Smax, D, scale, st);
  if (D <= 32) return launch_vec<T, 2>(qp, kqp, ksp, vqp, vsp, lens, op, w, B, H, Smax, D, scale, st);
  if (D <= 64) return launch_vec<T, 4>(qp, kqp, ksp, vqp, vsp, lens, op, w, B, H, Smax, D, scale, st);
  return launch_vec<T, 8>(qp, kqp, ksp, vqp, vsp, lens, op, w, B, H, Smax, D, scale, st);
}

}  // namespace

// q, out: (B, 1, H, D) bf16 or fp32; kq, vq: (B, H, Smax, D) int8; ks, vs:
// (B, H, Smax, 1) bf16; kv_len (B,) int32; 1 <= D <= 128. scratch: null, or
// B * H * 6 * roundup(Smax, 4) bytes of scratch for the logits and split
// weights where they do not fit in shared memory (ops/decode_kernel.py
// q8_mxu_in_shared).
extern "C" int mmmm_decode_attention_q8_mxu(const void* q, const void* kq, const void* ks,
                                            const void* vq, const void* vs,
                                            const void* kv_len, void* out, void* scratch, int B,
                                            int H, int Smax, int D, float scale, int is_bf16,
                                            void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* lens = static_cast<const int*>(kv_len);
  if (is_bf16)
    return launch<__nv_bfloat16>(q, kq, ks, vq, vs, lens, out, scratch, B, H, Smax, D, scale,
                                 st);
  return launch<float>(q, kq, ks, vq, vs, lens, out, scratch, B, H, Smax, D, scale, st);
}
