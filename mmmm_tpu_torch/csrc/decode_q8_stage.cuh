// The staged read of a KV cache, shared by K9 (decode_q8.cu), K10
// (decode_q8_mxu.cu) and K1 (decode_attn.cu). A block reads a run of len
// valid slots of one head from (B, H, Smax, D) K and V rows of RB bytes
// each (int8: RB = D, with (B, H, Smax, 1) bf16 scales beside them; K1's
// bf16 or fp32 rows: RB = 2D or 4D, no scales). A run's rows are one
// contiguous slab of len * RB bytes, its scales one of len * 2 bytes. K9
// and K10 read a head's slots [0, len), len = clamp(kv_len[b], 0, Smax),
// with one block of 8 warps; K1 splits them over the blocks of a cluster.
//
// The slots go in chunks of C (K9, K10: a multiple of 16). An item is one
// chunk of K rows (and K scales), or of V rows (and V scales); items pass
// through NS stages of shared memory, each with an mbarrier. Warp 0 fills a
// stage: its first lane arms the barrier with the bytes to come and issues
// 1-D bulk copies (cp.async.bulk, no tensor map) of each slab's
// 16-byte-aligned body; a bulk copy needs a 16-byte-aligned source,
// destination and size, so the lanes load the head and tail bytes (at most
// 15 each) with ordinary loads, store them, and all 32 lanes arrive (the
// barrier waits for 33 arrivals and the body's bytes). In its stage a slab
// keeps its address modulo 16 (that many bytes of slack in front), so its
// body lands aligned; nothing past a slab is read.
//
// The plan (ops/decode_kernel.py q8_stage_plan, decode_stage_plan) takes
// the whole read where two stages of a run's slots fit beside the kernel's
// own shared memory (at the flagship, Smax 320 and D = 128: K9 83 KB; K1
// 20 KB a split of 40 slots): NS = 2, C >= len, and the K item and the V
// item are both requested as the block starts, so every byte of the call
// is in flight at once and the logits start while V still arrives.
// Otherwise a ring of 4 stages: once every thread has consumed item i (a
// __syncthreads), warp 0 refills its stage with item i + NS; items come in
// the kernel's order (K9, K1: K0 V0 K1 V1 ..., K10: K0 K1 ... V0 V1 ...).
// Measured slower on the H100 at the flagship: a barrier for each 32- to
// 128-slot chunk (more copies and waits on the block's critical path), and
// int8 mma.sync on these stages (a 1-D copy cannot swizzle, so ldmatrix
// over rows 128 bytes apart conflicts 8 ways).
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace mmmm {
namespace q8 {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kMaxStages = 4;
constexpr int kArrivals = 33;  // lane 0's arrive.expect_tx and the 32 lanes of warp 0

__host__ __device__ inline size_t round16(size_t x) { return (x + 15) / 16 * 16; }
__host__ __device__ inline size_t rows_bytes(int c, int rb) { return round16((size_t)c * rb + 15); }
__host__ __device__ inline size_t scales_bytes(int c) { return round16((size_t)2 * c + 15); }
__host__ __device__ inline size_t stage_bytes(int c, int rb) {
  return rows_bytes(c, rb) + scales_bytes(c);
}

__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes,
                                          uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(hop::smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(hop::smem_u32(bar))
      : "memory");
}

// Orders this thread's earlier generic-proxy accesses to shared memory
// before the bulk copies it issues next (a stage's head and tail bytes were
// stored by ordinary stores in its previous use).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ int mis(const void* p) {
  return static_cast<int>(reinterpret_cast<uintptr_t>(p) & 15);
}

// A slab of n bytes at p: `head` bytes up to the first 16-byte boundary (at
// most n), a `body` of whole 16-byte pieces, and the `tail` after it.
struct Split {
  int head, body, tail;
};
__device__ __forceinline__ Split split(const void* p, int n) {
  const int pad = (16 - mis(p)) & 15;
  const int head = pad < n ? pad : n;
  const int body = (n - head) & ~15;
  return {head, body, n - head - body};
}

// The head and tail bytes of a slab, one a lane (lanes 0-14 the head, 16-30
// the tail).
__device__ __forceinline__ void copy_edges(unsigned char* dst, const unsigned char* src, Split s,
                                           int lane) {
  if (lane < s.head) dst[lane] = src[lane];
  const int t = lane - 16;
  if (t >= 0 && t < s.tail) dst[s.head + s.body + t] = src[s.head + s.body + t];
}

// SCALES: int8 rows with their bf16 scales (K9, K10: Ring); else rows
// alone (K1: RowRing). A compile-time choice, so K9 and K10 carry no
// branch for K1's form.
template <bool SCALES>
struct RingT {
  unsigned char* smem;  // NS stages from a 16-byte-aligned base
  uint64_t* bar;        // NS barriers
  const void* kq;       // the run's first K row and V row, rows of RB bytes
  const void* vq;
  const __nv_bfloat16* ks;  // their scales (SCALES only)
  const __nv_bfloat16* vs;
  int C, NS, RB, len, n_chunks;
  bool interleaved;  // K9's and K1's order; else K10's

  __device__ int items() const { return 2 * n_chunks; }
  __device__ bool is_v(int i) const { return interleaved ? (i & 1) : i >= n_chunks; }
  __device__ int chunk(int i) const {
    return interleaved ? i >> 1 : (i >= n_chunks ? i - n_chunks : i);
  }
  __device__ int count(int i) const {
    const int left = len - chunk(i) * C;
    return left < C ? left : C;
  }
  __device__ unsigned char* stage(int i) const {
    return smem + (size_t)(i % NS) * (SCALES ? stage_bytes(C, RB) : rows_bytes(C, RB));
  }
  __device__ const unsigned char* rows_src(int i) const {
    return static_cast<const unsigned char*>(is_v(i) ? vq : kq) + (size_t)chunk(i) * C * RB;
  }
  __device__ const unsigned char* scales_src(int i) const {
    return reinterpret_cast<const unsigned char*>((is_v(i) ? vs : ks) + (size_t)chunk(i) * C);
  }
  // Where item i's slot 0 lies in its stage.
  template <typename E = int8_t>
  __device__ const E* rows(int i) const {
    return reinterpret_cast<const E*>(stage(i) + mis(rows_src(i)));
  }
  __device__ const __nv_bfloat16* scales(int i) const {
    return reinterpret_cast<const __nv_bfloat16*>(stage(i) + rows_bytes(C, RB) +
                                                  mis(scales_src(i)));
  }

  // Requests item i into its stage; all 32 lanes of one warp call it.
  __device__ void issue(int i, int lane) const {
    const int n = count(i);
    const unsigned char* r = rows_src(i);
    unsigned char* rd = stage(i) + mis(r);
    const Split rs = split(r, n * RB);
    uint64_t* b = bar + i % NS;
    if constexpr (SCALES) {
      const unsigned char* s = scales_src(i);
      unsigned char* sd = stage(i) + rows_bytes(C, RB) + mis(s);
      const Split ss = split(s, 2 * n);
      if (lane == 0) {
        fence_proxy_async();
        hop::mbar_expect_tx(b, static_cast<uint32_t>(rs.body + ss.body));
        if (rs.body) bulk_load(rd + rs.head, r + rs.head, rs.body, b);
        if (ss.body) bulk_load(sd + ss.head, s + ss.head, ss.body, b);
      }
      copy_edges(rd, r, rs, lane);
      copy_edges(sd, s, ss, lane);
    } else {
      if (lane == 0) {
        fence_proxy_async();
        hop::mbar_expect_tx(b, static_cast<uint32_t>(rs.body));
        if (rs.body) bulk_load(rd + rs.head, r + rs.head, rs.body, b);
      }
      copy_edges(rd, r, rs, lane);
    }
    hop::mbar_arrive(b);
  }
  __device__ void wait(int i) const { hop::mbar_wait(bar + i % NS, (i / NS) & 1); }

  // The whole block: arm the barriers, then warp 0 requests the first NS items.
  __device__ void start() const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < NS; ++s) hop::mbar_init(bar + s, kArrivals);
      hop::fence_barrier_init();
    }
    __syncthreads();
    if (threadIdx.x < 32)
      for (int i = 0; i < NS && i < items(); ++i) issue(i, threadIdx.x);
  }
  // After a __syncthreads that ends every thread's use of item i: warp 0
  // refills its stage with item i + NS.
  __device__ void release(int i) const {
    if (threadIdx.x < 32 && i + NS < items()) issue(i + NS, threadIdx.x);
  }
};
using Ring = RingT<true>;
using RowRing = RingT<false>;

// ---- loads of a row's 16 values at head dim d0 ----------------------------------------
// 16 values of q from p (its first n in the row): 16-byte loads where VEC
// (D % 16 == 0, so n >= 16 or n <= 0), else scalar loads, zero past the row.
template <bool VEC>
__device__ __forceinline__ void load_q16(const __nv_bfloat16* p, int n, float out[16]) {
  if (VEC) {
    if (n <= 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) out[e] = 0.f;
      return;
    }
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
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = e < n ? __bfloat162float(p[e]) : 0.f;
}
template <bool VEC>
__device__ __forceinline__ void load_q16(const float* p, int n, float out[16]) {
  if (VEC) {
    if (n <= 0) {
#pragma unroll
      for (int e = 0; e < 16; ++e) out[e] = 0.f;
      return;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const float4 raw = *reinterpret_cast<const float4*>(p + 4 * c);
      out[4 * c] = raw.x;
      out[4 * c + 1] = raw.y;
      out[4 * c + 2] = raw.z;
      out[4 * c + 3] = raw.w;
    }
    return;
  }
#pragma unroll
  for (int e = 0; e < 16; ++e) out[e] = e < n ? p[e] : 0.f;
}

// 16 bytes of an int8 row from head dim d0, zero past D: one 16-byte load
// where rows are 16-byte aligned (VEC), else byte loads.
template <bool VEC>
__device__ __forceinline__ int4 load_row16(const int8_t* row, int d0, int D) {
  if (d0 >= D) return make_int4(0, 0, 0, 0);
  if (VEC) return *reinterpret_cast<const int4*>(row + d0);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (d0 + e < D)
      w[e >> 2] |= static_cast<unsigned>(static_cast<uint8_t>(row[d0 + e])) << (8 * (e & 3));
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

// ---- the fused forms' new row (K8's append and quantize_kv inside K9's and K10's launch)
// The step's new K and V rows, (B, 1, H, D) in q's dtype with any strides
// over b and h (elements; unit stride over D): all null for the read alone.
template <typename T>
struct NewRows {
  const T* k;
  const T* v;
  const int* write_index;  // (B,) int32
  int ksb, ksh, vsb, vsh;
};

// Whether the fused form's new rows (bases and strides over b and h, in
// elements of esz bytes) start every row on 16 bytes. The wrapper
// (ops/decode_kernel.py _q8_read) copies them into such a layout wherever
// D % 16 == 0, so a launch that reads by 16-byte pieces only asserts it.
inline bool rows_aligned16(const void* k, const void* v, long long esz, int ksb, int ksh,
                           int vsb, int vsh) {
  return ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) & 15) == 0 &&
         ((ksb * esz) | (ksh * esz) | (vsb * esz) | (vsh * esz)) % 16 == 0;
}

// quantize_kv (ops/quant.py) of a new row, by a group of LPS lanes that
// holds the whole row (16 LPS >= D), each lane its 16 head dims x (zero
// past the row; load_q16): amax of |x| in fp32 by shuffles in the group;
// the scale s = max(amax, 1e-8) * (1 / 127), as PyTorch's CUDA division by
// a Python number computes it (it multiplies by the fp32 reciprocal; the
// quotient amax / 127 rounds some scales, and so some int8 values,
// differently); the 16 bytes rint(x / s) by IEEE division, round half to
// even. `s` is the fp32 scale; the cache holds it rounded to bf16.
template <int LPS>
__device__ __forceinline__ int4 quantize_row16(const float x[16], float& s) {
  float amax = 0.f;
#pragma unroll
  for (int e = 0; e < 16; ++e) amax = fmaxf(amax, fabsf(x[e]));
#pragma unroll
  for (int off = LPS / 2; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  s = fmaxf(amax, 1e-8f) * (1.f / 127.f);
  unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    w[e >> 2] |= static_cast<unsigned>(__float2int_rn(x[e] / s) & 0xFF) << (8 * (e & 3));
  return make_int4(static_cast<int>(w[0]), static_cast<int>(w[1]), static_cast<int>(w[2]),
                   static_cast<int>(w[3]));
}

// The lane's 16 bytes of a new int8 row at head dim d0 into the cache row
// `row` (one 16-byte store where VEC), none past D.
template <bool VEC>
__device__ __forceinline__ void store_row16(int8_t* row, int d0, int D, const int4& r) {
  if (d0 >= D) return;
  if (VEC) {
    *reinterpret_cast<int4*>(row + d0) = r;
    return;
  }
  const unsigned w[4] = {static_cast<unsigned>(r.x), static_cast<unsigned>(r.y),
                         static_cast<unsigned>(r.z), static_cast<unsigned>(r.w)};
#pragma unroll
  for (int e = 0; e < 16; ++e)
    if (d0 + e < D) row[d0 + e] = static_cast<int8_t>((w[e >> 2] >> (8 * (e & 3))) & 0xFF);
}

// The warp that quantizes the fused forms' new rows: the one whose lane
// group takes slot t (chunk-local t % C) in K9's and K10's K pass (and K9's
// V pass), where a slot goes to warp (j % (8 G)) / G, G = 32 / LPS slots a
// warp at once; warp 0 where no pass reads t (t >= len). Quantizing in one
// warp, not eight, spares the SM's conversion and reciprocal units.
__device__ __forceinline__ int append_warp(int t, int len, int C, int G) {
  return t < len ? (t % C) % (kWarps * G) / G : 0;
}

// The fused forms' one writer of slot `slot` (b h Smax + t) of the four
// leaves: the first lane group of warp `owner` (which holds the whole
// quantized rows) stores the K and V rows, its lane 0 their bf16 scales,
// once every read of the block is done. The fence orders the bulk copies
// (async proxy) that read the caches before these generic stores.
template <int LPS, bool VEC>
__device__ __forceinline__ void write_new_rows(int8_t* kq, __nv_bfloat16* ks, int8_t* vq,
                                               __nv_bfloat16* vs, size_t slot, int D, int owner,
                                               const int4& kr, const int4& vr,
                                               __nv_bfloat16 ksc, __nv_bfloat16 vsc) {
  const int lane = threadIdx.x & 31;
  if ((threadIdx.x >> 5) != owner || lane >= LPS) return;
  asm volatile("fence.proxy.async.global;\n" ::: "memory");
  store_row16<VEC>(kq + slot * D, 16 * lane, D, kr);
  store_row16<VEC>(vq + slot * D, 16 * lane, D, vr);
  if (lane == 0) {
    ks[slot] = ksc;
    vs[slot] = vsc;
  }
}

// The 16 int8 values of r as floats, exactly and without the conversion
// unit (int-to-float runs at an eighth of the FMA rate on this SM): byte
// b ^ 0x80 = b + 128 becomes the low mantissa byte of 2^23, and 2^23 + 128
// is subtracted.
__device__ __forceinline__ void i8x16_to_f32(const int4& r, float out[16]) {
  const unsigned w[4] = {static_cast<unsigned>(r.x) ^ 0x80808080u,
                         static_cast<unsigned>(r.y) ^ 0x80808080u,
                         static_cast<unsigned>(r.z) ^ 0x80808080u,
                         static_cast<unsigned>(r.w) ^ 0x80808080u};
#pragma unroll
  for (int i = 0; i < 16; ++i)
    out[i] = __uint_as_float(__byte_perm(w[i >> 2], 0x4B000000u, 0x7650 + (i & 3))) - 8388736.f;
}

}  // namespace q8
}  // namespace mmmm
