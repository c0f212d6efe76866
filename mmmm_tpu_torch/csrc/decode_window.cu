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
// Two forms, picked by the wrapper (ops/decode_kernel.py window_mma_takes)
// by dtype and head dim alone:
//
// decode_window_mma_kernel (bf16, D % 8 == 0; the serving path). The
// products run on the tensor cores (mma.sync m16n8k16), transposed so that
// the window's (up to) 8 queries are the n8 of the product: S^T = K Q^T
// over a warp's tile of 32 keys, then O^T += V^T P^T, with P, rounded to
// bf16 where the reference rounds its probabilities, turned into the B
// operand in registers by movmatrix. The online softmax runs once per tile
// on the accumulator fragment (exp2 domain, a query's 8 lanes reduce by
// three shuffles). Bytes in flight: one block per (sample, head) with a
// warp for each 32-slot tile of the cache (11 warps over run (b)'s 328
// slots; 6 warps with a cp.async double buffer each where 12 tiles would
// not cover the cache), every warp copying its whole tile of K and V (16 KB
// at D = 128) with cp.async before it waits: at B = 4, H = 32 the 128
// blocks ask for the whole window's cache at once. Rows past the window's
// end and lanes past D are zero-filled. The warps' partial (m, l, O)
// states merge in shared memory in warp order (two runs give the same
// bits); a warp with no valid slot has m = -1e30 and l = 0 and adds
// nothing. (A form that split each (sample, head) over the blocks of a
// thread-block cluster, merged through distributed shared memory, was
// slower at run (b)'s shape.)
//
// decode_window_kernel (fp32, and bf16 at D % 8 != 0, whose rows are not
// 16-byte aligned): one block per (sample, head), 8 warps; warp w walks the
// slots w, w + 8, ... two at a time, below write_index + NQ. A lane holds 4
// head-dim values of every query and of the K/V row (scalar loads when D %
// 4 != 0), so each K row feeds all NQ dot products (NQ butterfly
// reductions per slot) and each V row all NQ accumulators. Each warp keeps
// NQ online-softmax states in fp32; the 8 partial states of each query are
// merged through shared memory.
//
// In both, masked slots never enter a sum, so a query with no valid slot
// gives zeros, as the TPU kernel does.
//
// The fused forms (APPEND; ops/decode_kernel.py
// decode_attention_window_append) also do K5's append
// (kv_append_pallas_multi, `_kv_append_multi_kernel`) in this launch: the
// window's new rows r < NQ ((B, NQ, H, D), read with their strides) land
// at slots tw + r, tw = clamp(wrap(write_index[b]), 0, Smax - NQ) (a
// window that would pass Smax shifts back whole), while the mask keeps the
// raw write_index (query j sees the slots < write_index[b] + j + 1), as K5
// then K6 give. The tensor-core form copies a new row, not the stale one,
// into the tile that holds its slot (cp.async from the new row), so
// ldmatrix reads it in the padded layout; the CUDA-core form reads a new
// row in place of the cache's for a slot in the window. So no read takes
// the cache's window slots, and the block stores the NQ rows there as it
// starts (rows whose slots no warp loads, at or past the window's end as
// under a negative write_index, too). Each row is written once; the output
// and the caches are K5's then K6's to the bit.
#include "decode_common.cuh"
#include "hopper.cuh"

namespace hop = mmmm::hop;

namespace {

constexpr int kWarps = 8;
constexpr int kUnroll = 2;

// The fused forms' new rows, (B, NQ, H, D) with strides (elements) over b,
// the window's row r and h, unit stride over D: null for the read alone.
template <typename T>
struct WindowRows {
  const T* k;
  const T* v;
  int ksb, ksr, ksh, vsb, vsr, vsh;
};

// VEC: D % 4 == 0, the rows (and new rows) are read with vector loads.
// APPEND: the fused form; the stores of the append go through the cache
// pointers (slots that no read of the block takes).
template <typename T, int NQ, bool VEC, bool APPEND>
__global__ void __launch_bounds__(kWarps * 32)
decode_window_kernel(const T* __restrict__ q, const T* __restrict__ kc,
                     const T* __restrict__ vc, const int* __restrict__ write_index,
                     T* __restrict__ out, int H, int Smax, int D, float scale,
                     WindowRows<T> nr) {
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
  // the fused form: the window's first slot and (b, h)'s new rows
  const int tw = APPEND ? mmmm::append_slot(t, Smax, NQ) : 0;
  const T* kn = APPEND ? nr.k + (size_t)b * nr.ksb + (size_t)h * nr.ksh : nullptr;
  const T* vn = APPEND ? nr.v + (size_t)b * nr.vsb + (size_t)h * nr.vsh : nullptr;

  if constexpr (APPEND) {  // the window's rows to the caches: no read below takes those slots
    T* kw = const_cast<T*>(kb) + (size_t)tw * D;
    T* vw = const_cast<T*>(vb) + (size_t)tw * D;
    for (int i = threadIdx.x; i < NQ * D; i += kWarps * 32) {
      const int r = i / D;
      const int d = i - r * D;
      kw[(size_t)r * D + d] = kn[(size_t)r * nr.ksr + d];
      vw[(size_t)r * D + d] = vn[(size_t)r * nr.vsr + d];
    }
  }

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
        const T* kp = kb + (size_t)s * D;
        const T* vp = vb + (size_t)s * D;
        if constexpr (APPEND) {
          const int r = s - tw;  // a slot of the window takes its new row
          if (r >= 0 && r < NQ) {
            kp = kn + (size_t)r * nr.ksr;
            vp = vn + (size_t)r * nr.vsr;
          }
        }
        mmmm::load4(kp + d0, D - d0, VEC, kr[u]);
        mmmm::load4(vp + d0, D - d0, VEC, vr[u]);
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

template <typename T, bool APPEND>
int launch(const void* q, const void* k_cache, const void* v_cache, const int* widx,
           void* out, int B, int NQ, int H, int Smax, int D, float scale,
           const WindowRows<T>& nr, bool vec, cudaStream_t st) {
  const T* qp = static_cast<const T*>(q);
  const T* kp = static_cast<const T*>(k_cache);
  const T* vp = static_cast<const T*>(v_cache);
  T* op = static_cast<T*>(out);
  const dim3 grid(B * H), block(kWarps * 32);
  switch (NQ) {
#define MMMM_WINDOW_CASE(N)                                                                 \
  case N:                                                                                   \
    if (vec)                                                                                \
      decode_window_kernel<T, N, true, APPEND><<<grid, block, 0, st>>>(                     \
          qp, kp, vp, widx, op, H, Smax, D, scale, nr);                                     \
    else                                                                                    \
      decode_window_kernel<T, N, false, APPEND><<<grid, block, 0, st>>>(                    \
          qp, kp, vp, widx, op, H, Smax, D, scale, nr);                                     \
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

// ---- the tensor-core form ----------------------------------------------------------
constexpr int kTileKeys = 32;  // keys a warp's tile
constexpr int kMaxWarps = 16;

// DP: D rounded up to the mma's k16. A tile row holds DP + 8 bf16, so that
// ldmatrix's 8 rows fall in distinct banks.
template <int DP>
struct WinCfg {
  static constexpr int kRow = DP + 8;
  static constexpr int kTile = kTileKeys * kRow;   // K or V, elements
  static constexpr int kWarpStage = 2 * kTile * 2;  // bytes of a warp's K and V tiles
};

// grid (B * H), W = blockDim.x / 32 warps, min(per, 2) * W *
// WinCfg<DP>::kWarpStage bytes of dynamic shared memory. Warp w reads the
// 32-key tiles w, w + W, ..., `per` of them. scale2 = scale * log2(e).
//
// The products run transposed, so that the window's 8 queries are the n8
// of m16n8k16 and no lane is padding: S^T = K Q^T (K by ldmatrix as A, Q^T
// as B straight from global memory), then O^T += V^T P^T (V by
// ldmatrix.trans as A; P^T as B, the S^T fragment rounded to bf16 and
// turned by movmatrix.trans). A lane holds the online-softmax state of
// queries 2q and 2q + 1; a query's 32 keys lie over the 8 lanes of one q.
//
// APPEND: the fused form. load_tile copies a slot of the window [tw, tw + NQ)
// from its new row (16-byte aligned rows, as the wrapper requires) in a
// short loop of its own, so the cache's window slots are never read: the
// block stores the new rows there as it starts.
template <int DP, bool APPEND>
__global__ void __launch_bounds__(kMaxWarps * 32)
decode_window_mma_kernel(const __nv_bfloat16* __restrict__ q,
                         const __nv_bfloat16* __restrict__ kc,
                         const __nv_bfloat16* __restrict__ vc,
                         const int* __restrict__ write_index, __nv_bfloat16* __restrict__ out,
                         int NQ, int H, int Smax, int D, int per, float scale2,
                         WindowRows<__nv_bfloat16> nr) {
  using C = WinCfg<DP>;
  constexpr int KS = DP / 16;   // k16 steps of K Q^T; m16 tiles of O^T
  constexpr int CH = DP / 8;    // 16-byte chunks of a tile row
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float fac[kMaxWarps][8];

  const int nwarps = blockDim.x >> 5;
  const int bh = blockIdx.x;
  const int b = bh / H;
  const int h = bh - b * H;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int qd = lane & 3;
  const int t = write_index[b];
  int len_end = t + NQ;  // query j sees slots < min(t + j + 1, Smax)
  len_end = len_end < 0 ? 0 : (len_end > Smax ? Smax : len_end);
  const __nv_bfloat16* kb = kc + (size_t)bh * Smax * D;
  const __nv_bfloat16* vb = vc + (size_t)bh * Smax * D;
  // the fused form: the window's first slot and (b, h)'s new rows
  const int tw = APPEND ? mmmm::append_slot(t, Smax, NQ) : 0;
  const __nv_bfloat16* kn = APPEND ? nr.k + (size_t)b * nr.ksb + (size_t)h * nr.ksh : nullptr;
  const __nv_bfloat16* vn = APPEND ? nr.v + (size_t)b * nr.vsb + (size_t)h * nr.vsh : nullptr;
  auto ktile = [&](int stage, int w) {
    return reinterpret_cast<__nv_bfloat16*>(smem + (size_t)(stage * nwarps + w) * C::kWarpStage);
  };

  // this warp's tiles below the window's end
  const int key_step = nwarps * kTileKeys;
  const int key_base = warp * kTileKeys;
  int ntiles = 0;
  while (ntiles < per && key_base + ntiles * key_step < len_end) ++ntiles;

  auto load_tile = [&](int i) {
    const int key0 = key_base + i * key_step;
    __nv_bfloat16* kt = ktile(i & 1, warp);
    __nv_bfloat16* vt = kt + C::kTile;
#pragma unroll
    for (int c = lane; c < kTileKeys * CH; c += 32) {
      const int r = c / CH;
      const int d = 8 * (c - r * CH);
      const bool ok = key0 + r < len_end && d < D;
      const size_t off = ok ? (size_t)(key0 + r) * D + d : 0;
      // the fused form copies the window's rows below, from the new rows
      if (APPEND && ok && static_cast<unsigned>(key0 + r - tw) < static_cast<unsigned>(NQ))
        continue;
      hop::cp_async16(kt + r * C::kRow + d, kb + off, ok ? 16 : 0);
      hop::cp_async16(vt + r * C::kRow + d, vb + off, ok ? 16 : 0);
    }
    if constexpr (APPEND) {  // the window's rows in this tile, from its new rows
      const int hi = min(min(tw + NQ, key0 + kTileKeys), len_end);
      for (int sl = max(tw, key0); sl < hi; ++sl)
        for (int d = 8 * lane; d < D; d += 8 * 32) {
          hop::cp_async16(kt + (sl - key0) * C::kRow + d, kn + (size_t)(sl - tw) * nr.ksr + d, 16);
          hop::cp_async16(vt + (sl - key0) * C::kRow + d, vn + (size_t)(sl - tw) * nr.vsr + d, 16);
        }
    }
    hop::cp_async_commit();
  };
  if (ntiles > 0) load_tile(0);

  // Q^T as B fragments: (head dims 16 kk + 2 qd, + 1 (+ 8), query g)
  uint32_t qb[KS][2];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int d = 16 * kk + 8 * hf + 2 * qd;
      qb[kk][hf] = g < NQ && d < D ? *reinterpret_cast<const uint32_t*>(
                                         q + (((size_t)b * NQ + g) * H + h) * D + d)
                                   : 0u;
    }
  }

  // the fused form: the window's rows go to the caches now, 16 bytes a
  // thread; no tile reads those slots of the cache (load_tile takes them
  // from the new rows), so nothing orders these stores after a read
  if constexpr (APPEND) {
    const int chd = D / 8;
    for (int c = threadIdx.x; c < NQ * chd; c += blockDim.x) {
      const int r = c / chd;
      const int d = 8 * (c - r * chd);
      const size_t dst = (size_t)(tw + r) * D + d;
      *reinterpret_cast<uint4*>(const_cast<__nv_bfloat16*>(kb) + dst) =
          *reinterpret_cast<const uint4*>(kn + (size_t)r * nr.ksr + d);
      *reinterpret_cast<uint4*>(const_cast<__nv_bfloat16*>(vb) + dst) =
          *reinterpret_cast<const uint4*>(vn + (size_t)r * nr.vsr + d);
    }
  }

  // queries 2 qd + e: running max, sum; O^T (head dims 16 md + g (+ 8), those queries)
  float m[2] = {mmmm::kNegInf, mmmm::kNegInf}, l[2] = {0.f, 0.f};
  float o[KS][4];
#pragma unroll
  for (int md = 0; md < KS; ++md) o[md][0] = o[md][1] = o[md][2] = o[md][3] = 0.f;

  for (int i = 0; i < ntiles; ++i) {
    if (i + 1 < ntiles) {
      load_tile(i + 1);
      hop::cp_async_wait<1>();
    } else {
      hop::cp_async_wait<0>();
    }
    __syncwarp();
    const __nv_bfloat16* kt = ktile(i & 1, warp);
    const uint32_t kaddr = hop::smem_u32(kt);
    const uint32_t vaddr = hop::smem_u32(kt + C::kTile);
    const int key0 = key_base + i * key_step;
    const int mi = lane >> 3;

    // S^T = K Q^T: 2 m16 tiles of keys
    float s[2][4];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt) {
      s[mt][0] = s[mt][1] = s[mt][2] = s[mt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
        uint32_t a[4];
        const int key = 16 * mt + 8 * (mi & 1) + (lane & 7);
        hop::ldsm_x4(a, kaddr + 2 * (key * C::kRow + 16 * kk + 8 * (mi >> 1)));
        hop::mma_16816(s[mt], a[0], a[1], a[2], a[3], qb[kk][0], qb[kk][1]);
      }
    }

    // online softmax of queries 2 qd, 2 qd + 1 over the tile (exp2 domain)
    float mx[2] = {mmmm::kNegInf, mmmm::kNegInf};
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = key0 + 16 * mt + g + 8 * (e >> 1);
        const int j = 2 * qd + (e & 1);
        const bool ok = j < NQ && key < len_end && key < t + j + 1;
        s[mt][e] = ok ? s[mt][e] * scale2 : mmmm::kNegInf;
        mx[e & 1] = fmaxf(mx[e & 1], s[mt][e]);
      }
    float alpha[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
#pragma unroll
      for (int off = 4; off < 32; off <<= 1)
        mx[e] = fmaxf(mx[e], __shfl_xor_sync(0xffffffffu, mx[e], off));
      const float m_new = fmaxf(m[e], mx[e]);
      alpha[e] = exp2f(m[e] - m_new);
      m[e] = m_new;
      l[e] *= alpha[e];
    }
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[mt][e] = s[mt][e] > 0.5f * mmmm::kNegInf ? exp2f(s[mt][e] - m[e & 1]) : 0.f;
        l[e & 1] += s[mt][e];
      }
#pragma unroll
    for (int md = 0; md < KS; ++md)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[md][e] *= alpha[e & 1];

    // O^T += V^T P^T over the tile's 2 k16 steps of keys
#pragma unroll
    for (int ks = 0; ks < 2; ++ks) {
      const uint32_t b0 = hop::movmatrix_trans(hop::pack2(s[ks][0], s[ks][1]));
      const uint32_t b1 = hop::movmatrix_trans(hop::pack2(s[ks][2], s[ks][3]));
      const int key = 16 * ks + 8 * (mi >> 1) + (lane & 7);
#pragma unroll
      for (int md = 0; md < KS; ++md) {
        uint32_t a[4];
        hop::ldsm_x4_trans(a, vaddr + 2 * (key * C::kRow + 16 * md + 8 * (mi & 1)));
        hop::mma_16816(o[md], a[0], a[1], a[2], a[3], b0, b1);
      }
    }
    __syncwarp();  // the next load may overwrite this stage
  }

  // the warp's partial over its own stage-0 K tile: m[8], l[8], O[8][DP]
#pragma unroll
  for (int e = 0; e < 2; ++e)
#pragma unroll
    for (int off = 4; off < 32; off <<= 1) l[e] += __shfl_xor_sync(0xffffffffu, l[e], off);
  float* part = reinterpret_cast<float*>(ktile(0, warp));
#pragma unroll
  for (int e = 0; e < 2; ++e) {
    const int j = 2 * qd + e;
    if (j < NQ) {
      if (g == 0) {
        part[j] = m[e];
        part[8 + j] = l[e];
      }
#pragma unroll
      for (int md = 0; md < KS; ++md) {
        part[16 + j * DP + 16 * md + g] = o[md][e];
        part[16 + j * DP + 16 * md + g + 8] = o[md][2 + e];
      }
    }
  }
  __syncthreads();

  // the warps' partials merged in warp order
  auto wpart = [&](int w) { return reinterpret_cast<const float*>(ktile(0, w)); };
  if (threadIdx.x < NQ) {
    const int j = threadIdx.x;
    float mall = mmmm::kNegInf;
    for (int w = 0; w < nwarps; ++w) mall = fmaxf(mall, wpart(w)[j]);
    float lall = 0.f;
    for (int w = 0; w < nwarps; ++w) {
      fac[w][j] = exp2f(wpart(w)[j] - mall);
      lall += wpart(w)[8 + j] * fac[w][j];
    }
    for (int w = 0; w < nwarps; ++w) fac[w][j] = lall > 0.f ? fac[w][j] / lall : 0.f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < NQ * D; e += blockDim.x) {
    const int j = e / D;
    const int d = e - j * D;
    float acc = 0.f;
    for (int w = 0; w < nwarps; ++w) acc += fac[w][j] * wpart(w)[16 + j * DP + d];
    out[(((size_t)b * NQ + j) * H + h) * D + d] = __float2bfloat16(acc);
  }
}

template <int DP, bool APPEND>
int launch_mma(const void* q, const void* kc, const void* vc, const int* widx, void* out,
               int B, int NQ, int H, int Smax, int D, float scale, int warps, int per,
               const WindowRows<__nv_bfloat16>& nr, cudaStream_t st) {
  const size_t smem = (size_t)(per > 1 ? 2 : 1) * warps * WinCfg<DP>::kWarpStage;
  auto* kern = decode_window_mma_kernel<DP, APPEND>;
  const cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                               static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<B * H, warps * 32, smem, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(kc),
      static_cast<const __nv_bfloat16*>(vc), widx, static_cast<__nv_bfloat16*>(out), NQ, H, Smax,
      D, per, scale * mmmm::kLog2e, nr);
  return static_cast<int>(cudaGetLastError());
}

template <int DP>
int launch_mma(const void* q, const void* kc, const void* vc, const int* widx, void* out,
               int B, int NQ, int H, int Smax, int D, float scale, int warps, int per,
               const WindowRows<__nv_bfloat16>& nr, cudaStream_t st) {
  if (nr.k != nullptr)
    return launch_mma<DP, true>(q, kc, vc, widx, out, B, NQ, H, Smax, D, scale, warps, per, nr,
                                st);
  return launch_mma<DP, false>(q, kc, vc, widx, out, B, NQ, H, Smax, D, scale, warps, per, nr,
                               st);
}

int launch_window_mma(const void* q, const void* kc, const void* vc, const int* widx, void* out,
                      int B, int NQ, int H, int Smax, int D, float scale, int warps, int per,
                      const WindowRows<__nv_bfloat16>& nr, cudaStream_t st) {
  if (D % 8 || warps < 1 || warps > kMaxWarps || per < 1 ||
      (long long)warps * per * kTileKeys < Smax)
    return static_cast<int>(cudaErrorInvalidValue);
  switch ((D + 15) / 16) {
#define MMMM_WINDOW_MMA(KS)                                                                  \
  case KS:                                                                                   \
    return launch_mma<16 * KS>(q, kc, vc, widx, out, B, NQ, H, Smax, D, scale, warps, per, nr, \
                               st);
    MMMM_WINDOW_MMA(1)
    MMMM_WINDOW_MMA(2)
    MMMM_WINDOW_MMA(3)
    MMMM_WINDOW_MMA(4)
    MMMM_WINDOW_MMA(5)
    MMMM_WINDOW_MMA(6)
    MMMM_WINDOW_MMA(7)
    MMMM_WINDOW_MMA(8)
#undef MMMM_WINDOW_MMA
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned(const void* p, int bytes) { return reinterpret_cast<uintptr_t>(p) % bytes == 0; }

}  // namespace

// q, out: (B, NQ, H, D); k_cache, v_cache: (B, H, Smax, D); write_index (B,)
// int32. 1 <= NQ <= 8, D <= 128. warps > 0 takes the tensor-core form (bf16,
// D % 8 == 0) with blocks of `warps` warps that read `per` 32-slot tiles
// each (ops/decode_kernel.py window_warps); warps = 0 the CUDA-core form.
// k_new, v_new: null for the read alone, or the fused form's window rows
// ((B, NQ, H, D) in the caches' dtype, strides k_sb, k_sr, k_sh, v_sb, v_sr,
// v_sh elements over b, the row and h, unit stride over D), appended first;
// the tensor-core form needs them 16-byte aligned (rows and strides).
extern "C" int mmmm_decode_attention_window(const void* q, const void* k_cache,
                                            const void* v_cache, const void* write_index,
                                            void* out, int B, int NQ, int H, int Smax, int D,
                                            float scale, int is_bf16, int warps, int per,
                                            const void* k_new, const void* v_new, int k_sb,
                                            int k_sr, int k_sh, int v_sb, int v_sr, int v_sh,
                                            void* stream) {
  const bool fused = k_new != nullptr;
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || D > 128 || NQ < 1 || NQ > 8 ||
      fused != (v_new != nullptr) || (fused && NQ > Smax))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* widx = static_cast<const int*>(write_index);
  const int esz = is_bf16 ? 2 : 4;
  // the strides of the new rows, in elements, keep a row's vector loads aligned
  const auto rows_aligned = [&](int bytes) {
    const int n = bytes / esz;
    return !fused || (aligned(k_new, bytes) && aligned(v_new, bytes) && k_sb % n == 0 &&
                      k_sr % n == 0 && k_sh % n == 0 && v_sb % n == 0 && v_sr % n == 0 &&
                      v_sh % n == 0);
  };
  if (warps > 0) {
    if (!is_bf16 || !rows_aligned(16)) return static_cast<int>(cudaErrorInvalidValue);
    const WindowRows<__nv_bfloat16> nr{static_cast<const __nv_bfloat16*>(k_new),
                                       static_cast<const __nv_bfloat16*>(v_new), k_sb, k_sr,
                                       k_sh, v_sb, v_sr, v_sh};
    return launch_window_mma(q, k_cache, v_cache, widx, out, B, NQ, H, Smax, D, scale, warps,
                             per, nr, st);
  }
  const bool vec = D % 4 == 0 && rows_aligned(4 * esz);
  if (is_bf16) {
    const WindowRows<__nv_bfloat16> nr{static_cast<const __nv_bfloat16*>(k_new),
                                       static_cast<const __nv_bfloat16*>(v_new), k_sb, k_sr,
                                       k_sh, v_sb, v_sr, v_sh};
    return fused ? launch<__nv_bfloat16, true>(q, k_cache, v_cache, widx, out, B, NQ, H, Smax, D,
                                               scale, nr, vec, st)
                 : launch<__nv_bfloat16, false>(q, k_cache, v_cache, widx, out, B, NQ, H, Smax,
                                                D, scale, nr, vec, st);
  }
  const WindowRows<float> nr{static_cast<const float*>(k_new), static_cast<const float*>(v_new),
                             k_sb, k_sr, k_sh, v_sb, v_sr, v_sh};
  return fused ? launch<float, true>(q, k_cache, v_cache, widx, out, B, NQ, H, Smax, D, scale, nr,
                                     vec, st)
               : launch<float, false>(q, k_cache, v_cache, widx, out, B, NQ, H, Smax, D, scale,
                                      nr, vec, st);
}

// Dynamic shared memory (bytes) of a K6 tensor-core launch at head dim DP (a
// multiple of 16) with `warps` warps of `per` tiles each.
extern "C" int mmmm_decode_window_smem(int dp, int warps, int per) {
  return (per > 1 ? 2 : 1) * warps * 2 * kTileKeys * (dp + 8) * 2;
}
