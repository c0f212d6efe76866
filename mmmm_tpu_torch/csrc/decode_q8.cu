// K9: single-token decode attention over an int8 KV cache with one bf16
// scale per (sample, head, slot).
//
// Replaces: mmmm_tpu/ops/decode_kernel.py decode_attention_pallas_q8, both of
// its TPU forms: _decode_attention_pallas_q8_full (Pallas body
// `_decode_kernel_q8`) and decode_attention_pallas_q8_ragged
// (`_decode_kernel_q8_ragged`, its fp32 cast). As for K1, the two existed
// because a full read overflowed VMEM; one length-aware kernel covers both.
// It computes what the TPU kernel does, in fp32, as its two-pass softmax:
//   logits = (q . k_q) * k_s * scale;  out = sum_j p_j * v_s[j] * v_q[j] / l.
// BF16 is the ragged body's cast="bf16" (MMMM_Q8_CAST=bf16): q rounded to
// bf16, each product q_d k_q[j, d] rounded to bf16 and summed in fp32; the
// weight w_j = bf16(p_j * v_s[j]), each w_j v_q[j, d] rounded to bf16 and
// summed in fp32. p_j is taken against the running max, as the reference's
// blocks take it (one chunk at the flagship: the row's max).
//
// What bounds it on an H100: bytes. A call reads the valid int8 K and V rows
// and their scales once (about 8.5 MB at B=4, H=32, D=128, kv_len 256),
// half the bytes of K1 on a bf16 cache: ~2.6 us at 3.35 TB/s.
//
// Design: one block per (sample, head), 8 warps, on the staged read of
// decode_q8_stage.cuh: where the head's rows fit in shared memory (the
// flagship) all of its K and V bytes are requested as the block starts, on
// two barriers; else they stream through a ring of chunks. For each chunk
// of slots, as the reference kernel does:
//   1. logits from shared memory: LPS lanes a slot (D/16 rounded up to a
//      power of two), 16 head dims each, so a warp takes 2 x 32 / LPS slots
//      at once; the chunk's max rides along (one block max);
//   2. the chunk's exps, p = exp(logit - m) with m the running max, kept in
//      shared memory, and their sum (per thread);
//   3. the weighted rows, p * v_s * v_q, each lane group over its share of
//      the chunk's slots, into 16 fp32 sums a lane.
// Over several chunks the state (m, sums) is rescaled once a chunk, never a
// slot. The lane groups' sums merge in a fixed order (shuffles in a warp,
// then the 8 warps through shared memory), so repeats are bit-equal. The
// int8 values become floats through a byte permute into 2^23's mantissa and
// one subtraction (i8x16_to_f32), not the slower conversion unit. Rows with
// D % 16 != 0 are read a byte at a time (VEC = false). kv_len = 0 gives zeros.
//
// The fused form (APPEND; ops/decode_kernel.py decode_attention_q8_append)
// also does the decode step's quantize_kv of the new K and V rows and K8's
// append (kv_append_pallas_q8, `_kv_append_q8_kernel`) in this launch. The
// head's new rows (in q's dtype) and write_index are requested with q,
// before the staged rows (behind the bulk copies they would arrive late);
// the warp whose lane group takes slot t = clamp(wrap(write_index[b]), 0,
// Smax - 1) quantizes the rows into registers while the staged rows are in
// flight (each lane group the whole row, 16 head dims a lane, the max by
// shuffles: quantize_row16; append_warp), and that lane group takes the new
// row and scale from registers in place of the staged ones, in both passes
// (one compare and select a slot), so the arithmetic is K8's then K9's to
// the bit; after the block's last read, that warp's first lane group writes
// the rows and scales to the four leaves (warp 0 where t >= kv_len, which
// no pass reads). Rows stay int8, scales
// bf16: the caches match kv_append_q8_plain's bit for bit. (Putting the new
// rows over the staged ones in shared memory, behind a barrier, measured
// slower: PERF.md §6.)
#include "decode_q8_stage.cuh"

namespace {

using mmmm::bf16r2;
using mmmm::q8::kThreads;
using mmmm::q8::kWarps;

// APPEND: the fused form, with the step's new rows `nr`; the stores of the
// append go through the cache pointers (written once, after their last read).
// Two blocks an SM (the flagship's plan takes 83 KB of shared memory a
// block): without the hint ptxas held the fused D <= 16 instance to 80
// registers, and it spilled.
template <typename T, int LPS, bool VEC, bool APPEND, bool BF16>
__global__ void __launch_bounds__(kThreads, 2)
decode_q8_kernel(const T* __restrict__ q, const int8_t* __restrict__ kq,
                 const __nv_bfloat16* __restrict__ ks, const int8_t* __restrict__ vq,
                 const __nv_bfloat16* __restrict__ vs, const int* __restrict__ kv_len,
                 T* __restrict__ out, int H, int Smax, int D, float scale, int C, int NS,
                 mmmm::q8::NewRows<T> nr) {
  constexpr int DP = 16 * LPS;
  constexpr int G = 32 / LPS;  // slots a warp takes at once
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ uint64_t bar[mmmm::q8::kMaxStages];
  __shared__ float red_m[kWarps];
  __shared__ float red_l[kWarps];
  __shared__ float acc_s[kWarps][DP];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane / LPS;          // slot group of this lane
  const int d0 = 16 * (lane % LPS);  // its 16 head-dim values
  const int n = D - d0;              // of its values, those in the row
  const int bh = blockIdx.x;
  const int b = bh / H;
  float qv[16];
  mmmm::q8::load_q16<VEC>(q + (size_t)bh * D + d0, n, qv);  // q: (B, 1, H, D)
  if constexpr (BF16) {
#pragma unroll
    for (int e = 0; e < 16; e += 2) {
      const float2 r = bf16r2(qv[e], qv[e + 1]);
      qv[e] = r.x;
      qv[e + 1] = r.y;
    }
  }
  int len = kv_len[b];
  float kx[16], vx[16];  // the fused form's new rows, requested with q and kv_len
  int t = -1;
  if constexpr (APPEND) {
    const int h = bh - b * H;
    mmmm::q8::load_q16<VEC>(nr.k + (size_t)b * nr.ksb + (size_t)h * nr.ksh + d0, n, kx);
    mmmm::q8::load_q16<VEC>(nr.v + (size_t)b * nr.vsb + (size_t)h * nr.vsh + d0, n, vx);
    t = nr.write_index[b];
  }
  len = len < 0 ? 0 : (len > Smax ? Smax : len);
  const size_t row0 = (size_t)bh * Smax;

  const mmmm::q8::Ring ring{smem, bar, kq + row0 * D, vq + row0 * D, ks + row0, vs + row0,
                            C, NS, D, len, (len + C - 1) / C, true};
  float* lg = reinterpret_cast<float*>(smem + (size_t)NS * mmmm::q8::stage_bytes(C, D));
  float* pw = lg + C;
  ring.start();

  // the fused form: the warp that reads slot t quantizes the new rows while
  // the staged rows arrive
  int4 kn = make_int4(0, 0, 0, 0), vn = kn;
  __nv_bfloat16 ksn = __float2bfloat16_rn(0.f), vsn = ksn;
  int owner = 0;
  if constexpr (APPEND) {
    t = mmmm::append_slot(t, Smax);
    owner = mmmm::q8::append_warp(t, len, C, G);
    if (warp == owner) {
      float s;
      kn = mmmm::q8::quantize_row16<LPS>(kx, s);
      ksn = __float2bfloat16_rn(s);
      vn = mmmm::q8::quantize_row16<LPS>(vx, s);
      vsn = __float2bfloat16_rn(s);
    }
  }

  float m = mmmm::kNegInf;
  float l = 0.f;  // this thread's share of the exps' sum
  float acc[16];
#pragma unroll
  for (int e = 0; e < 16; ++e) acc[e] = 0.f;

  for (int c = 0; c < ring.n_chunks; ++c) {
    const int ik = 2 * c, iv = ik + 1;
    const int cnt = ring.count(ik);
    const int tc = t - c * C;  // the new row's slot in this chunk, if it holds it
    // ---- 1. logits of the chunk, and its max ---------------------------------------
    ring.wait(ik);
    {
      const int8_t* rows = ring.rows(ik);
      const __nv_bfloat16* sc = ring.scales(ik);
      float mx = mmmm::kNegInf;
      for (int base = warp * G; base < cnt; base += 2 * kWarps * G) {
        const int j[2] = {base + g, base + kWarps * G + g};
        float s[2] = {0.f, 0.f};
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (j[u] < cnt && n > 0) {
            float kf[16];
            int4 kr = mmmm::q8::load_row16<VEC>(rows + (size_t)j[u] * D, d0, D);
            if (APPEND && j[u] == tc) kr = kn;
            mmmm::q8::i8x16_to_f32(kr, kf);
            float x0 = 0.f, x1 = 0.f;
#pragma unroll
            for (int e = 0; e < 16; e += 2) {
              if constexpr (BF16) {  // the products are exact in fp32, then rounded
                const float2 r = bf16r2(qv[e] * kf[e], qv[e + 1] * kf[e + 1]);
                x0 += r.x;
                x1 += r.y;
              } else {
                x0 = fmaf(qv[e], kf[e], x0);
                x1 = fmaf(qv[e + 1], kf[e + 1], x1);
              }
            }
            s[u] = x0 + x1;
          }
#pragma unroll
        for (int off = LPS / 2; off > 0; off >>= 1)
#pragma unroll
          for (int u = 0; u < 2; ++u) s[u] += __shfl_xor_sync(0xffffffffu, s[u], off);
#pragma unroll
        for (int u = 0; u < 2; ++u)
          if (j[u] < cnt) {
            const float x =
                s[u] * __bfloat162float(APPEND && j[u] == tc ? ksn : sc[j[u]]) * scale;
            mx = fmaxf(mx, x);
            if (lane % LPS == 0) lg[j[u]] = x;
          }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      if (lane == 0) red_m[warp] = mx;
    }
    __syncthreads();
    ring.release(ik);
    // ---- 2. exps against the running max; one rescale a chunk ------------------------
    float mc = red_m[0];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) mc = fmaxf(mc, red_m[w]);
    const float m_new = fmaxf(m, mc);
    const float alpha = expf(m - m_new);
    float ls = 0.f;
    for (int jj = tid; jj < cnt; jj += kThreads) {
      const float p = expf(lg[jj] - m_new);
      pw[jj] = p;
      ls += p;
    }
    l = l * alpha + ls;
    m = m_new;
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] *= alpha;
    __syncthreads();
    // ---- 3. the weighted value rows -------------------------------------------------
    ring.wait(iv);
    {
      const int8_t* rows = ring.rows(iv);
      const __nv_bfloat16* sc = ring.scales(iv);
      for (int jj = warp * G + g; jj < cnt; jj += kWarps * G) {
        if (n <= 0) break;
        const bool fresh = APPEND && jj == tc;
        float w = pw[jj] * __bfloat162float(fresh ? vsn : sc[jj]);
        float vf[16];
        int4 vr = mmmm::q8::load_row16<VEC>(rows + (size_t)jj * D, d0, D);
        if (fresh) vr = vn;
        mmmm::q8::i8x16_to_f32(vr, vf);
        if constexpr (BF16) {
          w = bf16r2(w, 0.f).x;
#pragma unroll
          for (int e = 0; e < 16; e += 2) {
            const float2 r = bf16r2(w * vf[e], w * vf[e + 1]);
            acc[e] += r.x;
            acc[e + 1] += r.y;
          }
        } else {
#pragma unroll
          for (int e = 0; e < 16; ++e) acc[e] = fmaf(w, vf[e], acc[e]);
        }
      }
    }
    __syncthreads();
    ring.release(iv);
  }
  // ---- the fused form's append, after every read of the block (the barrier above) ----
  if constexpr (APPEND)
    mmmm::q8::write_new_rows<LPS, VEC>(const_cast<int8_t*>(kq), const_cast<__nv_bfloat16*>(ks),
                                       const_cast<int8_t*>(vq), const_cast<__nv_bfloat16*>(vs),
                                       row0 + t, D, owner, kn, vn, ksn, vsn);

  // ---- merge: the G lane groups of a warp (same head dims), then the warps -----------
#pragma unroll
  for (int off = LPS; off < 32; off <<= 1)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[e] += __shfl_xor_sync(0xffffffffu, acc[e], off);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) l += __shfl_xor_sync(0xffffffffu, l, off);
  if (g == 0) {
#pragma unroll
    for (int e = 0; e < 16; ++e) acc_s[warp][d0 + e] = acc[e];
  }
  if (lane == 0) red_l[warp] = l;
  __syncthreads();
  for (int d = tid; d < D; d += kThreads) {
    float o = 0.f, lt = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      o += acc_s[w][d];
      lt += red_l[w];
    }
    out[(size_t)bh * D + d] = mmmm::from_f<T>(lt > 0.f ? o / lt : 0.f);
  }
}

// Dynamic shared memory of a launch: the stages, then the chunk's logits
// and exps (fp32).
size_t k9_smem(int C, int NS, int D) {
  return (size_t)NS * mmmm::q8::stage_bytes(C, D) + (size_t)8 * C;
}

struct Args {
  const void *q, *kq, *ks, *vq, *vs;
  const int* lens;
  void* out;
  int B, H, Smax, D;
  float scale;
  int C, NS;
  const void *kn, *vn;  // the fused form's new rows, else null
  const int* widx;
  int ksb, ksh, vsb, vsh;
  bool bf16_cast;
  cudaStream_t st;
};

template <typename T, int LPS, bool VEC, bool APPEND, bool BF16>
int launch_form(const Args& a) {
  auto* kern = decode_q8_kernel<T, LPS, VEC, APPEND, BF16>;
  const size_t smem = k9_smem(a.C, a.NS, a.D);
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
      static_cast<const __nv_bfloat16*>(a.vs), a.lens, static_cast<T*>(a.out), a.H, a.Smax, a.D,
      a.scale, a.C, a.NS, nr);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int LPS, bool BF16>
int launch_cast(bool vec, const Args& a) {
  if (a.kn != nullptr)
    return vec ? launch_form<T, LPS, true, true, BF16>(a)
               : launch_form<T, LPS, false, true, BF16>(a);
  return vec ? launch_form<T, LPS, true, false, BF16>(a)
             : launch_form<T, LPS, false, false, BF16>(a);
}

template <typename T, int LPS>
int launch_lps(bool vec, const Args& a) {
  return a.bf16_cast ? launch_cast<T, LPS, true>(vec, a) : launch_cast<T, LPS, false>(vec, a);
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
// (B, H, Smax, 1) bf16; kv_len (B,) int32. 0 < D <= 128. chunk, stages: the
// staged read's plan (ops/decode_kernel.py q8_stage_plan): stages of chunk
// slots (a multiple of 16), 2 to 4 of them. k_new, v_new, write_index: all
// null for the read alone, or the fused form's new rows ((B, 1, H, D) in
// q's dtype, strides k_sb, k_sh, v_sb, v_sh elements over b and h, unit
// stride over D) and (B,) int32 slots, quantized and appended first.
// bf16_cast: the products in bf16 (the reference's cast="bf16"), else fp32.
extern "C" int mmmm_decode_attention_q8(const void* q, const void* kq, const void* ks,
                                        const void* vq, const void* vs, const void* kv_len,
                                        void* out, int B, int H, int Smax, int D, float scale,
                                        int is_bf16, int chunk, int stages, const void* k_new,
                                        const void* v_new, const void* write_index, int k_sb,
                                        int k_sh, int v_sb, int v_sh, int bf16_cast,
                                        void* stream) {
  const bool fused = k_new != nullptr;
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128 || chunk < 16 || chunk % 16 ||
      stages < 2 || stages > mmmm::q8::kMaxStages || fused != (v_new != nullptr) ||
      fused != (write_index != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const Args a{q, kq, ks, vq, vs, static_cast<const int*>(kv_len), out, B, H, Smax, D, scale,
               chunk, stages, k_new, v_new, static_cast<const int*>(write_index), k_sb, k_sh,
               v_sb, v_sh, bf16_cast != 0, static_cast<cudaStream_t>(stream)};
  return is_bf16 ? launch<__nv_bfloat16>(a) : launch<float>(a);
}

// The dynamic shared memory K9 asks for under a plan.
extern "C" int mmmm_decode_q8_smem(int chunk, int stages, int D) {
  return static_cast<int>(k9_smem(chunk, stages, D));
}
