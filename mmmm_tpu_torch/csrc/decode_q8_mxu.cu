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
// Design: one block per (sample, head), 8 warps, on the staged read of
// decode_q8_stage.cuh: where the head's rows fit in shared memory (the
// flagship) all of its K and V bytes are requested as the block starts, K
// and V on barriers of their own; else K and then V stream through a ring.
//   1. The q split in registers while K arrives (q is requested with
//      kv_len, before the copies): each group of LPS lanes
//      (16 LPS >= D, lanes past D hold zeros) holds the whole row, 16 head
//      dims a lane, so the max is a shuffle among them; IEEE division and
//      round-half-even as the reference.
//   2. Logits from shared memory: a slot's K row by LPS lanes, two slots a
//      lane group at once, dotted with the packed q_hi and q_lo by __dp4a;
//      the max rides along. The logits
//      stay in shared memory (in a global fp32 workspace the wrapper
//      allocates where 6 bytes a slot would not fit) for the full-row
//      softmax, since the weights' maximum is needed before they are split.
//   3. exp and the sum in one pass; w = (p / denom) * v_s and its max in
//      one pass (v_s from the V stage; from global memory on the ring); the
//      split to (w_hi, w_lo).
//   4. Values from shared memory: each thread owns one 4-byte word column
//      of V (4 head dims) and a share of the slots; four slots' words are
//      transposed with __byte_perm so that one __dp4a multiplies 4 slots of
//      one head dim by the packed w_hi (or w_lo) of those slots; the slot
//      groups' sums merge in a fixed order.
// Three block reductions (the max, the sum, the max of w), each one
// __syncthreads. Rows of a head dim that is not a multiple of 16 are read a
// byte at a time, zero past D (VEC = false). int8 mma.sync m16n8k32 on these
// stages measured slower (decode_q8_stage.cuh).
//
// The fused form (APPEND; ops/decode_kernel.py decode_attention_q8_append
// with q8_mxu) also does the decode step's quantize_kv of the new K and V
// rows and K8's append (kv_append_pallas_q8) in this launch, as K9's does:
// the new rows and write_index are requested with q, before the staged
// rows; the warp whose lane group takes slot t in the K pass (append_warp)
// quantizes them into registers beside q's split;
// the K pass takes slot t = clamp(wrap(write_index[b]), 0, Smax - 1)'s row
// and scale from registers, the softmax its V scale, the value pass its V
// row from a 128-byte copy in shared memory (its threads own word columns,
// not a lane group's 16 head dims; the softmax takes the new V scale from
// shared memory too); after the block's last read that warp's first lane
// group writes the rows and scales to the four leaves (warp 0 where t >=
// kv_len). The integers and the order of every sum are K8's then
// K10's, so the output and the caches are theirs to the bit.
#include "decode_q8_stage.cuh"

namespace {

using mmmm::q8::kThreads;
using mmmm::q8::kWarps;

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// LPS = lanes per K row (16 LPS >= D). 6 * roundup(Smax, 4) bytes a block
// (fp32 logits, then the int8 w_hi and w_lo of every slot): dynamic shared
// memory after the stages, or the block's slice of `scratch` where the
// wrapper passes one.
// APPEND: the fused form, with the step's new rows `nr`; the stores of the
// append go through the cache pointers (written once, after their last read).
template <typename T, int LPS, bool VEC, bool APPEND>
__global__ void __launch_bounds__(kThreads)
decode_q8_mxu_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                     const __nv_bfloat16* __restrict__ ks, const int8_t* __restrict__ vq,
                     const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                     T* __restrict__ out, unsigned char* __restrict__ scratch, int H, int Smax,
                     int D, float scale, int C, int NS, mmmm::q8::NewRows<T> nr) {
  constexpr int DP = 16 * LPS;         // D rounded up to the lanes' 16-byte pieces
  constexpr int G = 32 / LPS;          // K rows a warp reads at once
  constexpr int WC = DP / 4;           // 4-byte word columns of a V row
  constexpr int NSG = kThreads / WC;   // slot groups of the value pass
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[mmmm::q8::kMaxStages];
  __shared__ float red_m[kWarps], red_s[kWarps], red_w[kWarps];
  __shared__ unsigned osum[NSG][DP];
  // the fused form's new V row by word column, and its scale, for every thread
  __shared__ unsigned vnew_w[APPEND ? WC : 1];
  __shared__ __nv_bfloat16 vs_new;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int g = lane / LPS;
  const int d0 = 16 * (lane % LPS);
  float qv[16];
  mmmm::q8::load_q16<VEC>(q + (size_t)bh * D + d0, D - d0, qv);
  int len = kv_len[b];
  float kx[16], vx[16];  // the fused form's new rows, requested with q and kv_len
  int tn = -1;           // the new row's slot
  if constexpr (APPEND) {
    const int h = bh - b * H;
    mmmm::q8::load_q16<VEC>(nr.k + (size_t)b * nr.ksb + (size_t)h * nr.ksh + d0, D - d0, kx);
    mmmm::q8::load_q16<VEC>(nr.v + (size_t)b * nr.vsb + (size_t)h * nr.vsh + d0, D - d0, vx);
    tn = nr.write_index[b];
  }
  len = len < 0 ? 0 : (len > Smax ? Smax : len);
  const size_t row0 = (size_t)bh * Smax;
  const int smax4 = (Smax + 3) & ~3;

  const mmmm::q8::Ring ring{smem, bar, kq + row0 * D, vq + row0 * D, ks + row0, vs + row0,
                            C, NS, D, len, (len + C - 1) / C, false};
  const int nc = ring.n_chunks;
  const bool refill = ring.items() > NS;
  float* logit = reinterpret_cast<float*>(
      scratch == nullptr ? smem + (size_t)NS * mmmm::q8::stage_bytes(C, D)
                         : scratch + (size_t)bh * 6 * smax4);
  int8_t* whi = reinterpret_cast<int8_t*>(logit + smax4);
  int8_t* wlo = whi + smax4;
  ring.start();

  // ---- 1. q -> (q_hi, q_lo, q_s), a lane group holding the row ---------------------
  int4 qh, ql;
  float qs;
  {
    float amax = 0.f;
#pragma unroll
    for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(qv[e]));
#pragma unroll
    for (int off = LPS / 2; off > 0; off >>= 1)
      amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
    qs = fmaxf(amax, 1e-8f) / 16256.f;
    unsigned hw[4] = {0u, 0u, 0u, 0u}, lw[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int x14 = __float2int_rn(qv[e] / qs);
      const int hi = x14 >> 7;
      hw[e >> 2] |= static_cast<unsigned>(hi & 0xFF) << (8 * (e & 3));
      lw[e >> 2] |= static_cast<unsigned>((x14 - hi * 128) & 0xFF) << (8 * (e & 3));
    }
    qh = make_int4(hw[0], hw[1], hw[2], hw[3]);
    ql = make_int4(lw[0], lw[1], lw[2], lw[3]);
  }
  // the fused form: the new rows quantized beside q (the V row's words to
  // shared memory for the value pass; the barriers below publish them)
  int4 kn = make_int4(0, 0, 0, 0), vn = kn;
  __nv_bfloat16 ksn = __float2bfloat16_rn(0.f), vsn = ksn;
  int owner = 0;
  if constexpr (APPEND) {
    tn = mmmm::append_slot(tn, Smax);
    owner = mmmm::q8::append_warp(tn, len, C, G);
    if (warp == owner) {
      float s;
      kn = mmmm::q8::quantize_row16<LPS>(kx, s);
      ksn = __float2bfloat16_rn(s);
      vn = mmmm::q8::quantize_row16<LPS>(vx, s);
      vsn = __float2bfloat16_rn(s);
      if (lane < LPS) {
        vnew_w[4 * lane] = static_cast<unsigned>(vn.x);
        vnew_w[4 * lane + 1] = static_cast<unsigned>(vn.y);
        vnew_w[4 * lane + 2] = static_cast<unsigned>(vn.z);
        vnew_w[4 * lane + 3] = static_cast<unsigned>(vn.w);
      }
      if (lane == 0) vs_new = vsn;
    }
  }

  // ---- 2. logits of the valid slots, and their max ---------------------------------
  float mx = mmmm::kNegInf;
  {
    const float qss = qs * scale;
    for (int c = 0; c < nc; ++c) {
      ring.wait(c);
      const int8_t* rows = ring.rows(c);
      const __nv_bfloat16* sc = ring.scales(c);
      const int cnt = ring.count(c);
      const int tc = tn - c * C;  // the new row's slot in this chunk, if it holds it
      float* lg = logit + c * C;
      for (int base = warp * G; base < cnt; base += 2 * kWarps * G) {
        const int j[2] = {base + g, base + kWarps * G + g};
        int a[2] = {0, 0}, cc[2] = {0, 0};
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (j[u] < cnt) {
            int4 kr = mmmm::q8::load_row16<VEC>(rows + (size_t)j[u] * D, d0, D);
            if (APPEND && j[u] == tc) kr = kn;
            a[u] = __dp4a(kr.x, qh.x, a[u]);
            cc[u] = __dp4a(kr.x, ql.x, cc[u]);
            a[u] = __dp4a(kr.y, qh.y, a[u]);
            cc[u] = __dp4a(kr.y, ql.y, cc[u]);
            a[u] = __dp4a(kr.z, qh.z, a[u]);
            cc[u] = __dp4a(kr.z, ql.z, cc[u]);
            a[u] = __dp4a(kr.w, qh.w, a[u]);
            cc[u] = __dp4a(kr.w, ql.w, cc[u]);
          }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < 2; ++u) {
            a[u] += __shfl_xor_sync(0xffffffffu, a[u], off);
            cc[u] += __shfl_xor_sync(0xffffffffu, cc[u], off);
          }
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (j[u] < cnt) {
            const int s32 = static_cast<int>(128u * static_cast<unsigned>(a[u]) +
                                             static_cast<unsigned>(cc[u]));
            const __nv_bfloat16 ksc = APPEND && j[u] == tc ? ksn : sc[j[u]];
            const float x = (static_cast<float>(s32) * __bfloat162float(ksc)) * qss;
            mx = fmaxf(mx, x);
            if (lane % LPS == 0) lg[j[u]] = x;
          }
      }
      if (refill) {
        __syncthreads();
        ring.release(c);
      }
    }
  }
  mx = warp_max(mx);
  if (lane == 0) red_m[warp] = mx;
  __syncthreads();

  // ---- 3. softmax folded with v_s, split to (w_hi, w_lo) ---------------------------
  float m = red_m[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) m = fmaxf(m, red_m[w]);
  float sum = 0.f;
  for (int j = tid; j < len; j += kThreads) {
    const float p = expf(logit[j] - m);
    logit[j] = p;
    sum += p;
  }
  sum = warp_sum(sum);
  if (lane == 0) red_s[warp] = sum;
  __syncthreads();
  float den = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) den += red_s[w];
  const float denom = fmaxf(den, 1e-30f);
  // one chunk: v_s from the V stage (requested with K); on the ring it
  // arrives with V's rows after the softmax, so it is read from global memory
  const __nv_bfloat16* vsc = vs + row0;
  if (nc == 1) {
    ring.wait(1);
    vsc = ring.scales(1);
  }
  float wmx = 0.f;
  for (int j = tid; j < len; j += kThreads) {
    const float w = (logit[j] / denom) * __bfloat162float(APPEND && j == tn ? vs_new : vsc[j]);
    logit[j] = w;
    wmx = fmaxf(wmx, w);
  }
  wmx = warp_max(wmx);
  if (lane == 0) red_w[warp] = wmx;
  __syncthreads();
  float wmax = red_w[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) wmax = fmaxf(wmax, red_w[w]);
  const float ws = fmaxf(wmax, 1e-30f) / 16256.f;
  for (int j = tid; j < ((len + 3) & ~3); j += kThreads) {  // zero to a whole 4 slots
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

  // ---- 4. o32 = 128 <v_q^T, w_hi> + <v_q^T, w_lo> ---------------------------------
  {
    const int cw = tid % WC;
    const int sg = tid / WC;
    int ah[4] = {0, 0, 0, 0}, al[4] = {0, 0, 0, 0};
    for (int c = 0; c < nc; ++c) {
      const int i = nc + c;
      ring.wait(i);
      const int8_t* rows = ring.rows(i);
      const int cnt = ring.count(i);
      const int c0 = c * C;
      const int tc = tn - c0;
      // rows past cnt (to a whole 4) lie inside the stage and meet zero weights
      for (int j0 = 4 * sg; j0 < cnt; j0 += 4 * NSG) {
        unsigned r[4];
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          r[u] = mmmm::q8::load_row4<VEC>(rows + (size_t)(j0 + u) * D, 4 * cw, D);
          if (APPEND && j0 + u == tc) r[u] = vnew_w[cw];
        }
        // t[d] = byte d of r[0..3]: head dim 4 cw + d of the four slots
        const unsigned lo01 = __byte_perm(r[0], r[1], 0x5140);
        const unsigned lo23 = __byte_perm(r[2], r[3], 0x5140);
        const unsigned hi01 = __byte_perm(r[0], r[1], 0x7362);
        const unsigned hi23 = __byte_perm(r[2], r[3], 0x7362);
        const int t[4] = {static_cast<int>(__byte_perm(lo01, lo23, 0x5410)),
                          static_cast<int>(__byte_perm(lo01, lo23, 0x7632)),
                          static_cast<int>(__byte_perm(hi01, hi23, 0x5410)),
                          static_cast<int>(__byte_perm(hi01, hi23, 0x7632))};
        const int wh = *reinterpret_cast<const int*>(whi + c0 + j0);
        const int wl = *reinterpret_cast<const int*>(wlo + c0 + j0);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          ah[d] = __dp4a(t[d], wh, ah[d]);
          al[d] = __dp4a(t[d], wl, al[d]);
        }
      }
      if (refill) {
        __syncthreads();
        ring.release(i);
      }
    }
#pragma unroll
    for (int d = 0; d < 4; ++d)
      osum[sg][4 * cw + d] = 128u * static_cast<unsigned>(ah[d]) + static_cast<unsigned>(al[d]);
  }
  __syncthreads();
  // ---- the fused form's append, after every read of the block (the barrier above) ----
  if constexpr (APPEND)
    mmmm::q8::write_new_rows<LPS, VEC>(const_cast<int8_t*>(kq), const_cast<__nv_bfloat16*>(ks),
                                       const_cast<int8_t*>(vq), const_cast<__nv_bfloat16*>(vs),
                                       row0 + tn, D, owner, kn, vn, ksn, vsn);
  for (int d = tid; d < D; d += kThreads) {
    unsigned o = 0u;
    for (int s = 0; s < NSG; ++s) o += osum[s][d];
    out[(size_t)bh * D + d] = mmmm::from_f<T>(static_cast<float>(static_cast<int>(o)) * ws);
  }
}

// Dynamic shared memory of a launch: the stages, then (without a workspace)
// the logits and split weights.
size_t k10_smem(int C, int NS, int D, int Smax, bool in_shared) {
  return (size_t)NS * mmmm::q8::stage_bytes(C, D) +
         (in_shared ? (size_t)6 * ((Smax + 3) & ~3) : 0);
}

struct Args {
  const void *q, *kq, *ks, *vq, *vs;
  const int* lens;
  void* out;
  void* scratch;
  int B, H, Smax, D;
  float scale;
  int C, NS;
  const void *kn, *vn;  // the fused form's new rows, else null
  const int* widx;
  int ksb, ksh, vsb, vsh;
  cudaStream_t st;
};

template <typename T, int LPS, bool VEC, bool APPEND>
int launch_form(const Args& a) {
  auto* kern = decode_q8_mxu_kernel<T, LPS, VEC, APPEND>;
  const size_t smem = k10_smem(a.C, a.NS, a.D, a.Smax, a.scratch == nullptr);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                 static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const mmmm::q8::NewRows<T> nr{static_cast<const T*>(a.kn), static_cast<const T*>(a.vn), a.widx,
                                a.ksb, a.ksh, a.vsb, a.vsh};
  kern<<<a.B * a.H, kThreads, smem, a.st>>>(
      static_cast<const T*>(a.q), static_cast<const int8_t*>(a.kq),
      static_cast<const __nv_bfloat16*>(a.ks), static_cast<const int8_t*>(a.vq),
      static_cast<const __nv_bfloat16*>(a.vs), a.lens, static_cast<T*>(a.out),
      static_cast<unsigned char*>(a.scratch), a.H, a.Smax, a.D, a.scale, a.C, a.NS, nr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LPS>
int launch_lps(bool vec, const Args& a) {
  if (a.kn != nullptr)
    return vec ? launch_form<T, LPS, true, true>(a) : launch_form<T, LPS, false, true>(a);
  return vec ? launch_form<T, LPS, true, false>(a) : launch_form<T, LPS, false, false>(a);
}

template <typename T>
int launch(const Args& a) {
  // 16-byte row, q and new-row loads: whole 16-byte pieces from 16-byte-aligned bases
  const bool vec = a.D % 16 == 0 &&
                   ((reinterpret_cast<uintptr_t>(a.q) | reinterpret_cast<uintptr_t>(a.kq) |
                     reinterpret_cast<uintptr_t>(a.vq)) & 15) == 0;
  if (vec && a.kn != nullptr &&
      !mmmm::q8::rows_aligned16(a.kn, a.vn, sizeof(T), a.ksb, a.ksh, a.vsb, a.vsh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (a.D <= 16) return launch_lps<T, 1>(vec, a);
  if (a.D <= 32) return launch_lps<T, 2>(vec, a);
  if (a.D <= 64) return launch_lps<T, 4>(vec, a);
  return launch_lps<T, 8>(vec, a);
}

}  // namespace

// q, out: (B, 1, H, D) bf16 or fp32; kq, vq: (B, H, Smax, D) int8; ks, vs:
// (B, H, Smax, 1) bf16; kv_len (B,) int32; 1 <= D <= 128. scratch: null, or
// B * H * 6 * roundup(Smax, 4) bytes of scratch for the logits and split
// weights where they do not fit in shared memory (ops/decode_kernel.py
// q8_mxu_in_shared). chunk, stages: the staged read's plan
// (ops/decode_kernel.py q8_stage_plan). k_new, v_new, write_index: all null
// for the read alone, or the fused form's new rows ((B, 1, H, D) in q's
// dtype, strides k_sb, k_sh, v_sb, v_sh elements over b and h, unit stride
// over D) and (B,) int32 slots, quantized and appended first.
extern "C" int mmmm_decode_attention_q8_mxu(const void* q, const void* kq, const void* ks,
                                            const void* vq, const void* vs,
                                            const void* kv_len, void* out, void* scratch, int B,
                                            int H, int Smax, int D, float scale, int is_bf16,
                                            int chunk, int stages, const void* k_new,
                                            const void* v_new, const void* write_index,
                                            int k_sb, int k_sh, int v_sb, int v_sh,
                                            void* stream) {
  const bool fused = k_new != nullptr;
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128 || chunk < 16 || chunk % 16 ||
      stages < 2 || stages > mmmm::q8::kMaxStages || fused != (v_new != nullptr) ||
      fused != (write_index != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kq, ks, vq, vs, static_cast<const int*>(kv_len), out, scratch, B, H, Smax, D,
               scale, chunk, stages, k_new, v_new, static_cast<const int*>(write_index), k_sb,
               k_sh, v_sb, v_sh, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

// The dynamic shared memory K10 asks for under a plan.
extern "C" int mmmm_decode_q8_mxu_smem(int chunk, int stages, int D, int Smax, int in_shared) {
  return static_cast<int>(k10_smem(chunk, stages, D, Smax, in_shared != 0));
}
