// K7: the segment-id flash attention backward, as two kernels, and the
// rowsum that feeds them.
//
// Replaces: mmmm_tpu/ops/flash.py _flash_bwd_impl, whose two pallas_calls
// run `_dq_kernel` (K7dq) and `_dkv_kernel` (K7dkv); `delta` (K7delta) is the
// rowsum the reference computes in XLA before them. The sites are every
// attention of the training step under attn_impl="pallas": the LLM's causal
// attention (B, 1024, 32, 128) bf16, the EVA ViT (B, 577, 16, 112) in fp32
// (bf16 over a bf16 image) and the SAM encoder (B, 512, 12, 64) fp32.
//
// Both kernels recompute the probabilities from the forward's logsumexp:
//   p  = mask ? exp(scale q.k - lse) : 0     (lse = 0 on rows with no key)
//   dp = dO.v,  ds = p (dp - delta)          (delta = rowsum(dO O), fp32)
//   dq = scale ds k;  dv = p^T dO;  dk = scale ds^T q
// with p and ds rounded to the operand dtype before their products, as the
// reference rounds them, and every product summed in fp32. The reference's
// split needs no atomics, so results repeat bit for bit run to run: a block
// owns its rows (queries in K7dq, keys in K7dkv) for the whole walk over the
// other side's tiles. Masks come from int32 segment ids and absolute
// positions; causal tiles are skipped at both ends (K7dq stops at the
// block's last query, K7dkv starts at the tile of its first key). Rows past
// S and head lanes past D load as zero, so nothing is padded in memory.
//
// What bounds it on an H100: at the LLM site the five products are ~86
// GFLOP against ~0.3 GB, so operations (~0.12 ms at 989 TFLOP/s bf16); the
// fp32 sites run on CUDA cores (TF32 stays off, the reference's fp32
// policy), bound at 67 TFLOP/s.
//
// bf16 (Hopper, warp-specialized): a block is 3 warpgroups. Two consumer
// warpgroups own 64 rows each of the block's 128; one producer warp keeps a
// 3-stage ring of the streamed 64-row tiles in flight with TMA (4-d tensor
// maps over (B, S, H, D), 128-byte swizzle, whose out-of-range fill gives
// the zero rows past S and zero lanes past D) and loads the streamed rows'
// segment ids and scalars beside them. Every product is a wgmma: S (or
// S^T) and dP (dP^T) read both operands from shared memory, contracting
// over D in k16 slices up to D; p and ds go from the accumulator fragment
// straight into the register A operand of dQ += dS K, dV += P^T dO and
// dK += dS^T Q, whose B (K, dO, Q) is read MN-major from the same tiles.
// Output products run over DP = 64 or 128 columns (a head dim of 112 pays
// 128). The producer gives its registers to the consumers (setmaxnreg).
//
// fp32 (CUDA cores): a block of 256 threads owns 64 rows and streams
// 32-row tiles through a 3-stage cp.async ring (16-byte copies that fill
// zeros past S and D) into shared rows padded by 4 floats, so the reads
// below do not conflict. Thread (ty, tx) of a 16 x 16 grid computes a 4 x 2
// micro-tile of S and dP (rows ty + 16 i, streamed rows tx + 16 j) with
// 16-byte shared loads along D, writes p / ds to shared memory, and then a
// 4 x (DP / 16) micro-tile of each output product (columns tx + 16 j), so
// the dK and dV accumulators of D = 112 take 2 x 28 registers a thread.
#include "attn_mma.cuh"
#include "hopper.cuh"

namespace mmmm {
namespace {

// segment sentinels: a padded key and an invalid query never match
constexpr int kNoKey = INT_MIN;
constexpr int kNoQuery = INT_MIN + 1;

__device__ __forceinline__ int key_seg(const int* seg, int row, int S) {
  if (row >= S) return kNoKey;
  const int v = seg[row];
  return v != 0 ? v : kNoKey;
}
__device__ __forceinline__ int query_seg(const int* seg, int row, int S) {
  if (row >= S) return kNoQuery;
  const int v = seg[row];
  return v != 0 ? v : kNoQuery;
}

// ---------------------------------------------------------------------------
// bf16, wgmma
// ---------------------------------------------------------------------------

constexpr int kOwn = 128;     // rows a block owns (2 consumer warpgroups)
constexpr int kStream = 64;   // rows of a streamed tile
constexpr int kStages = 3;
constexpr int kWgThreads = 384;

// A tile of R rows x DP head lanes: DP / 64 column blocks of R 128-byte
// rows (swizzled), each block loaded by one TMA box.
template <int R, int DP>
constexpr uint32_t tile_bytes() {
  return R * DP * 2;
}

// TMA of rows [r0, r0 + R) of head h of sample b into a tile.
template <int R, int DP>
__device__ __forceinline__ void load_tile(unsigned char* dst, const CUtensorMap* map,
                                          uint64_t* bar, int r0, int h, int b) {
#pragma unroll
  for (int c = 0; c < DP / 64; ++c) hop::tma_load_4d(dst + c * R * 128, map, bar, 64 * c, h, r0, b);
}

// K-major descriptor of rows [row, row + 64) of a tile, k16 slice ks of D.
template <int R>
__device__ __forceinline__ uint64_t kmajor(const unsigned char* tile, int row, int ks) {
  return hop::desc_sw128(tile + (ks >> 2) * R * 128 + row * 128 + 32 * (ks & 3), 16, 1024);
}
// MN-major descriptor of a tile as B over its rows (the contraction), k16
// slice ks of the rows, all DP columns.
template <int R>
__device__ __forceinline__ uint64_t mnmajor(const unsigned char* tile, int ks) {
  return hop::desc_sw128(tile + ks * 2048, R * 128, 1024);
}

// bf16 stores of a 64 x DP accumulator (times mul) into rows of a (B, S, H,
// D) tensor: a 4 x 4 exchange in each quad makes 8 consecutive columns a
// thread, one 16-byte store (D % 8 == 0).
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], float mul,
                                           __nv_bfloat16* base, size_t ld, int row0, int S,
                                           int D) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int qd = lane & 3;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + 16 * warp + g + 8 * rh;
#pragma unroll
    for (int a = 0; a < DP / 32; ++a) {
      uint32_t v[4], o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = hop::pack2(acc[4 * (4 * a + i) + 2 * rh] * mul,
                          acc[4 * (4 * a + i) + 2 * rh + 1] * mul);
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int want = (qd - r) & 3;
        const uint32_t send = want == 0 ? v[0] : (want == 1 ? v[1] : (want == 2 ? v[2] : v[3]));
        const uint32_t got = __shfl_sync(0xffffffffu, send, (lane & ~3) | ((qd + r) & 3));
        const int slot = (qd + r) & 3;
        o[0] = slot == 0 ? got : o[0];
        o[1] = slot == 1 ? got : o[1];
        o[2] = slot == 2 ? got : o[2];
        o[3] = slot == 3 ? got : o[3];
      }
      const int col = 8 * (4 * a + qd);
      if (row < S && col < D)
        *reinterpret_cast<uint4*>(base + (size_t)row * ld + col) = make_uint4(o[0], o[1], o[2], o[3]);
    }
  }
}

template <int DP>
struct DqSmem {
  static constexpr uint32_t kOwnTile = tile_bytes<kOwn, DP>();
  static constexpr uint32_t kStreamTile = tile_bytes<kStream, DP>();
  static constexpr size_t kBytes = 2 * kOwnTile + kStages * 2 * kStreamTile +
                                   kStages * kStream * sizeof(int) +
                                   (1 + 2 * kStages) * sizeof(uint64_t) + 1024;
};

// K7dq, bf16: dq for one (b, h, 128-query tile); consumer warpgroup w owns
// queries q0 + 64 w ..; the producer streams 64-key tiles of K and V.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                   const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                   const int* __restrict__ qseg, const int* __restrict__ kseg,
                   const float* __restrict__ lse, const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int D, float scale,
                   int causal) {
  using L = DqSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Qs = smem;
  unsigned char* Os = Qs + L::kOwnTile;
  unsigned char* Ks = Os + L::kOwnTile;                   // [stage]
  unsigned char* Vs = Ks + kStages * L::kStreamTile;      // [stage]
  int* kseg_s = reinterpret_cast<int*>(Vs + kStages * L::kStreamTile);  // [stage][kStream]
  uint64_t* full_q = reinterpret_cast<uint64_t*>(kseg_s + kStages * kStream);
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kOwn;
  const int k_end = causal ? min(Skv, q0 + kOwn) : Skv;
  const int tiles = (k_end + kStream - 1) / kStream;
  const int warp_all = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hop::mbar_init(full_q, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1 + 32);  // TMA bytes, then the warp's segment ids
      hop::mbar_init(&empty[s], 8);      // the 8 consumer warps
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp_all >= 8) {
    hop::reg_dealloc<40>();
    if (warp_all == 8) {
      const int* ksb = kseg + (size_t)b * Skv;
      if (lane == 0) {
        hop::mbar_expect_tx(full_q, 2 * L::kOwnTile);
        load_tile<kOwn, DP>(Qs, &qmap, full_q, q0, h, b);
        load_tile<kOwn, DP>(Os, &omap, full_q, q0, h, b);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        const int k0 = it * kStream;
        if (it >= kStages) hop::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        if (lane == 0) {
          hop::mbar_expect_tx(&full[s], 2 * L::kStreamTile);
          load_tile<kStream, DP>(Ks + s * L::kStreamTile, &kmap, &full[s], k0, h, b);
          load_tile<kStream, DP>(Vs + s * L::kStreamTile, &vmap, &full[s], k0, h, b);
        }
        kseg_s[s * kStream + lane] = key_seg(ksb, k0 + lane, Skv);
        kseg_s[s * kStream + lane + 32] = key_seg(ksb, k0 + lane + 32, Skv);
        hop::mbar_arrive(&full[s]);
      }
    }
  } else {
    hop::reg_alloc<232>();
    const int wg = warp_all >> 2;
    const int g = lane >> 2;
    const int qd = lane & 3;
    const int row0 = q0 + 64 * wg;  // the warpgroup's first query
    int qs[2];
    float lse2[2], dl[2];
    int rows[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      rows[rh] = row0 + 16 * (warp_all & 3) + g + 8 * rh;
      const bool in = rows[rh] < Sq;
      const size_t i = ((size_t)b * H + h) * Sq + rows[rh];
      qs[rh] = query_seg(qseg + (size_t)b * Sq, rows[rh], Sq);
      lse2[rh] = in ? lse[i] * kLog2e : 0.f;
      dl[rh] = in ? delta[i] : 0.f;
    }
    const float scale_log2 = scale * kLog2e;
    const int ksl = (D + 15) / 16;  // k16 slices of the head dim
    float acc[DP / 2];
    hop::zero(acc);
    hop::mbar_wait(full_q, 0);
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      const int k0 = it * kStream;
      hop::mbar_wait(&full[s], (it / kStages) & 1);
      // causal: a tile past the warpgroup's last query holds no key it sees
      if (!causal || k0 <= row0 + 63) {
        const unsigned char* kt = Ks + s * L::kStreamTile;
        const unsigned char* vt = Vs + s * L::kStreamTile;
        float sc[32], dp[32];
        hop::zero(sc);
        hop::zero(dp);
        hop::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          if (ks < ksl) {
            hop::wgmma_ss_n64<0, 0>(sc, kmajor<kOwn>(Qs, 64 * wg, ks), kmajor<kStream>(kt, 0, ks), 1);
            hop::wgmma_ss_n64<0, 0>(dp, kmajor<kOwn>(Os, 64 * wg, ks), kmajor<kStream>(vt, 0, ks), 1);
          }
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(sc);
        hop::fence_regs(dp);
        const int* ksg = kseg_s + s * kStream;
        // ds = p (dp - delta); element 4 j + e: row rows[e / 2], key k0 + 8 j + 2 qd + e % 2
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int2 kv = *reinterpret_cast<const int2*>(ksg + 8 * j + 2 * qd);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rh = e >> 1;
            const int kj = k0 + 8 * j + 2 * qd + (e & 1);
            const bool ok = ((e & 1) ? kv.y : kv.x) == qs[rh] && (!causal || rows[rh] >= kj);
            const float p = ok ? exp2f(sc[4 * j + e] * scale_log2 - lse2[rh]) : 0.f;
            sc[4 * j + e] = p * (dp[4 * j + e] - dl[rh]);
          }
        }
        // dq += ds K (ds rounded to bf16)
        hop::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kStream / 16; ++ks) {
          uint32_t a[4];
          hop::acc_to_a(sc, ks, a);
          hop::wgmma_rs<DP, 1>(acc, a, mnmajor<kStream>(kt, ks), 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(acc);
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
    store_rows<DP>(acc, scale, dq + ((size_t)b * Sq * H + h) * D, (size_t)H * D, row0, Sq, D);
  }
}

template <int DP>
struct DkvSmem {
  static constexpr uint32_t kOwnTile = tile_bytes<kOwn, DP>();
  static constexpr uint32_t kStreamTile = tile_bytes<kStream, DP>();
  static constexpr size_t kBytes = 2 * kOwnTile + kStages * 2 * kStreamTile +
                                   kStages * 3 * kStream * sizeof(float) +
                                   (1 + 2 * kStages) * sizeof(uint64_t) + 1024;
};

// K7dkv, bf16: dk, dv for one (b, h, 128-key tile); consumer warpgroup w
// owns keys k0 + 64 w ..; the producer streams 64-query tiles of Q and dO
// with their segment ids, lse (log2 domain) and delta.
template <int DP>
__global__ void __launch_bounds__(kWgThreads, 1)
flash_bwd_dkv_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap omap,
                    const int* __restrict__ qseg, const int* __restrict__ kseg,
                    const float* __restrict__ lse, const float* __restrict__ delta,
                    __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                    int Skv, int H, int D, float scale, int causal) {
  using L = DkvSmem<DP>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Ks = smem;
  unsigned char* Vs = Ks + L::kOwnTile;
  unsigned char* Qs = Vs + L::kOwnTile;                   // [stage]
  unsigned char* Os = Qs + kStages * L::kStreamTile;      // [stage]
  int* qseg_s = reinterpret_cast<int*>(Os + kStages * L::kStreamTile);  // [stage][kStream]
  float* lse_s = reinterpret_cast<float*>(qseg_s + kStages * kStream);
  float* delta_s = lse_s + kStages * kStream;
  uint64_t* full_kv = reinterpret_cast<uint64_t*>(delta_s + kStages * kStream);
  uint64_t* full = full_kv + 1;
  uint64_t* empty = full + kStages;

  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kOwn;
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? (k0 / kStream) * kStream : 0;
  const int tiles = (Sq - q_begin + kStream - 1) / kStream;
  const int warp_all = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    hop::mbar_init(full_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      hop::mbar_init(&full[s], 1 + 32);
      hop::mbar_init(&empty[s], 8);
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (warp_all >= 8) {
    hop::reg_dealloc<40>();
    if (warp_all == 8) {
      const int* qsb = qseg + (size_t)b * Sq;
      const size_t bhs = ((size_t)b * H + h) * Sq;
      if (lane == 0) {
        hop::mbar_expect_tx(full_kv, 2 * L::kOwnTile);
        load_tile<kOwn, DP>(Ks, &kmap, full_kv, k0, h, b);
        load_tile<kOwn, DP>(Vs, &vmap, full_kv, k0, h, b);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        const int q0 = q_begin + it * kStream;
        if (it >= kStages) hop::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        if (lane == 0) {
          hop::mbar_expect_tx(&full[s], 2 * L::kStreamTile);
          load_tile<kStream, DP>(Qs + s * L::kStreamTile, &qmap, &full[s], q0, h, b);
          load_tile<kStream, DP>(Os + s * L::kStreamTile, &omap, &full[s], q0, h, b);
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = lane + 32 * i;
          const int qi = q0 + r;
          const bool in = qi < Sq;
          qseg_s[s * kStream + r] = query_seg(qsb, qi, Sq);
          lse_s[s * kStream + r] = in ? lse[bhs + qi] * kLog2e : 0.f;
          delta_s[s * kStream + r] = in ? delta[bhs + qi] : 0.f;
        }
        hop::mbar_arrive(&full[s]);
      }
    }
  } else {
    hop::reg_alloc<232>();
    const int wg = warp_all >> 2;
    const int g = lane >> 2;
    const int qd = lane & 3;
    const int key0 = k0 + 64 * wg;  // the warpgroup's first key
    const int* ksb = kseg + (size_t)b * Skv;
    int ks_[2], keys[2];
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      keys[rh] = key0 + 16 * (warp_all & 3) + g + 8 * rh;
      ks_[rh] = key_seg(ksb, keys[rh], Skv);
    }
    const float scale_log2 = scale * kLog2e;
    const int ksl = (D + 15) / 16;
    float accK[DP / 2], accV[DP / 2];
    hop::zero(accK);
    hop::zero(accV);
    hop::mbar_wait(full_kv, 0);
    for (int it = 0; it < tiles; ++it) {
      const int s = it % kStages;
      const int q0 = q_begin + it * kStream;
      hop::mbar_wait(&full[s], (it / kStages) & 1);
      // causal: a tile whose last query precedes the warpgroup's first key
      if (!causal || q0 + kStream - 1 >= key0) {
        const unsigned char* qt = Qs + s * L::kStreamTile;
        const unsigned char* ot = Os + s * L::kStreamTile;
        float st[32], dpt[32];
        hop::zero(st);
        hop::zero(dpt);
        hop::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < DP / 16; ++ks) {
          if (ks < ksl) {
            hop::wgmma_ss_n64<0, 0>(st, kmajor<kOwn>(Ks, 64 * wg, ks), kmajor<kStream>(qt, 0, ks), 1);
            hop::wgmma_ss_n64<0, 0>(dpt, kmajor<kOwn>(Vs, 64 * wg, ks), kmajor<kStream>(ot, 0, ks), 1);
          }
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(st);
        hop::fence_regs(dpt);
        const int* qsg = qseg_s + s * kStream;
        const float* ls = lse_s + s * kStream;
        const float* dls = delta_s + s * kStream;
        // element 4 j + e: key keys[e / 2], query q0 + 8 j + 2 qd + e % 2;
        // st keeps p, dpt becomes ds
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * qd;
          const int2 sg = *reinterpret_cast<const int2*>(qsg + c);
          const float2 l2 = *reinterpret_cast<const float2*>(ls + c);
          const float2 d2 = *reinterpret_cast<const float2*>(dls + c);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int rh = e >> 1;
            const int qi = q0 + c + (e & 1);
            const bool ok = ((e & 1) ? sg.y : sg.x) == ks_[rh] && (!causal || qi >= keys[rh]);
            const float p = ok ? exp2f(st[4 * j + e] * scale_log2 - ((e & 1) ? l2.y : l2.x)) : 0.f;
            st[4 * j + e] = p;
            dpt[4 * j + e] = p * (dpt[4 * j + e] - ((e & 1) ? d2.y : d2.x));
          }
        }
        // dv += P^T dO, dk += dS^T Q (P, dS rounded to bf16)
        hop::wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < kStream / 16; ++ks) {
          uint32_t a[4];
          hop::acc_to_a(st, ks, a);
          hop::wgmma_rs<DP, 1>(accV, a, mnmajor<kStream>(ot, ks), 1);
          hop::acc_to_a(dpt, ks, a);
          hop::wgmma_rs<DP, 1>(accK, a, mnmajor<kStream>(qt, ks), 1);
        }
        hop::wgmma_commit();
        hop::wgmma_wait<0>();
        hop::fence_regs(accV);
        hop::fence_regs(accK);
      }
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
    const size_t off = ((size_t)b * Skv * H + h) * D;
    store_rows<DP>(accK, scale, dk + off, (size_t)H * D, key0, Skv, D);
    store_rows<DP>(accV, 1.f, dv + off, (size_t)H * D, key0, Skv, D);
  }
}

// ---------------------------------------------------------------------------
// fp32, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Own = 64;     // rows a block owns
constexpr int kF32Stream = 32;  // rows of a streamed tile
constexpr int kF32Stages = 3;
constexpr int kF32Threads = 256;

// Rows [r0, r0 + R) of one head of a (B, S, H, D) fp32 tensor into a tile of
// R rows of DP + 4 floats, as 16-byte cp.async copies that fill zeros past S
// and past D (D % 4 == 0). Every thread of the block takes part.
template <int R, int DP>
__device__ __forceinline__ void copy_rows_f32(float* dst, const float* __restrict__ src, int r0,
                                              int S, int H, int D) {
  constexpr int kChunks = DP / 4;
  for (int idx = threadIdx.x; idx < R * kChunks; idx += kF32Threads) {
    const int rr = idx / kChunks;
    const int c = idx - rr * kChunks;
    const int row = r0 + rr;
    const bool in = row < S && 4 * c < D;
    hop::cp_async16(dst + rr * (DP + 4) + 4 * c, in ? src + (size_t)row * H * D + 4 * c : src,
                    in ? 16 : 0);
  }
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// acc[i][j] += A[ty + 16 i] . B[tx + 16 j] over DP (rows of two padded tiles)
// Blocks an SM runs of the fp32 kernels: two up to D = 64 (128 registers
// a thread, no spill with dot_tile's loop rolled; 107 KB of shared memory
// each), one above.
constexpr int f32_blocks(int nj) { return nj <= 4 ? 2 : 1; }

template <int DP>
__device__ __forceinline__ void dot_tile(float (&acc)[4][2], const float* A, const float* B,
                                         int ty, int tx) {
#pragma unroll (DP <= 64 ? 1 : 4)
  for (int d = 0; d < DP; d += 4) {
    float4 a[4], bb[2];
#pragma unroll
    for (int i = 0; i < 4; ++i) a[i] = *reinterpret_cast<const float4*>(A + (ty + 16 * i) * (DP + 4) + d);
#pragma unroll
    for (int j = 0; j < 2; ++j) bb[j] = *reinterpret_cast<const float4*>(B + (tx + 16 * j) * (DP + 4) + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 2; ++j)
        acc[i][j] += a[i].x * bb[j].x + a[i].y * bb[j].y + a[i].z * bb[j].z + a[i].w * bb[j].w;
  }
}

// acc[i][j] += sum_r P[ty + 16 i][r] X[r][tx + 16 j] over the kF32Stream rows
// of a streamed tile X (P: kF32Own x (kF32Stream + 4) floats)
template <int NJ>
__device__ __forceinline__ void axpy_tile(float (&acc)[4][NJ], const float* P, const float* X,
                                          int ty, int tx) {
  constexpr int DP = 16 * NJ;
#pragma unroll 2
  for (int r = 0; r < kF32Stream; r += 4) {
    float4 p[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) p[i] = *reinterpret_cast<const float4*>(P + (ty + 16 * i) * (kF32Stream + 4) + r);
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      float x[NJ];
#pragma unroll
      for (int j = 0; j < NJ; ++j) x[j] = X[(r + rr) * (DP + 4) + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float pv = rr == 0 ? p[i].x : (rr == 1 ? p[i].y : (rr == 2 ? p[i].z : p[i].w));
#pragma unroll
        for (int j = 0; j < NJ; ++j) acc[i][j] = fmaf(pv, x[j], acc[i][j]);
      }
    }
  }
}

template <int NJ>
__device__ __forceinline__ void store_tile_f32(float* __restrict__ base, size_t ld,
                                               const float (&acc)[4][NJ], float mul, int row0,
                                               int S, int D, int ty, int tx) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = row0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) base[(size_t)row * ld + col] = acc[i][j] * mul;
    }
  }
}

template <int NJ>
constexpr size_t f32_smem() {
  constexpr int DP = 16 * NJ;
  return sizeof(float) * (2 * kF32Own * (DP + 4) + kF32Stages * 2 * kF32Stream * (DP + 4) +
                          kF32Stages * 3 * kF32Stream + 2 * kF32Own * (kF32Stream + 4));
}

// K7dq, fp32: dq for one (b, h, 64-query tile); 32-key tiles of K and V
// stream through the ring.
template <int NJ>
__global__ void __launch_bounds__(kF32Threads, f32_blocks(NJ))
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Sq, int Skv, int H, int D, float scale,
                 int causal) {
  constexpr int DP = 16 * NJ;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Os = Qs + kF32Own * LD;
  float* Ks = Os + kF32Own * LD;                       // [stage]
  float* Vs = Ks + kF32Stages * kF32Stream * LD;       // [stage]
  int* kseg_s = reinterpret_cast<int*>(Vs + kF32Stages * kF32Stream * LD);  // [stage]
  float* dS = reinterpret_cast<float*>(kseg_s + kF32Stages * 3 * kF32Stream);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kF32Own;
  const size_t hd = (size_t)h * D;
  const float* qb = q + (size_t)b * Sq * H * D + hd;
  const float* ob = dout + (size_t)b * Sq * H * D + hd;
  const float* kb = k + (size_t)b * Skv * H * D + hd;
  const float* vb = v + (size_t)b * Skv * H * D + hd;
  const int* ksb = kseg + (size_t)b * Skv;
  const int k_end = causal ? min(Skv, q0 + kF32Own) : Skv;
  const int tiles = (k_end + kF32Stream - 1) / kF32Stream;

  auto stage_in = [&](int it) {
    const int s = it % kF32Stages;
    const int r0 = it * kF32Stream;
    copy_rows_f32<kF32Stream, DP>(Ks + s * kF32Stream * LD, kb, r0, Skv, H, D);
    copy_rows_f32<kF32Stream, DP>(Vs + s * kF32Stream * LD, vb, r0, Skv, H, D);
    if (threadIdx.x < kF32Stream) kseg_s[s * kF32Stream + threadIdx.x] = key_seg(ksb, r0 + threadIdx.x, Skv);
  };
  copy_rows_f32<kF32Own, DP>(Qs, qb, q0, Sq, H, D);
  copy_rows_f32<kF32Own, DP>(Os, ob, q0, Sq, H, D);
  stage_in(0);
  cp_async_commit();
  if (tiles > 1) stage_in(1);
  cp_async_commit();

  int qs[4];
  float l[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    const bool in = row < Sq;
    const size_t idx = ((size_t)b * H + h) * Sq + row;
    qs[i] = query_seg(qseg + (size_t)b * Sq, row, Sq);
    l[i] = in ? lse[idx] : 0.f;
    dl[i] = in ? delta[idx] : 0.f;
  }
  float acc[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kF32Stages;
    const int k0 = it * kF32Stream;
    if (it + 2 < tiles) stage_in(it + 2);
    cp_async_commit();
    cp_async_wait<2>();  // this tile's copies have landed (two younger groups may fly)
    __syncthreads();
    const float* kt = Ks + s * kF32Stream * LD;
    const float* vt = Vs + s * kF32Stream * LD;
    float sc[4][2] = {}, dp[4][2] = {};
    dot_tile<DP>(sc, Qs, kt, ty, tx);
    dot_tile<DP>(dp, Os, vt, ty, tx);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kk = tx + 16 * j;
      const int kj = k0 + kk;
      const int ksg = kseg_s[s * kF32Stream + kk];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = ksg == qs[i] && (!causal || q0 + ty + 16 * i >= kj);
        const float p = ok ? expf(sc[i][j] * scale - l[i]) : 0.f;
        dS[(ty + 16 * i) * (kF32Stream + 4) + kk] = p * (dp[i][j] - dl[i]);
      }
    }
    __syncthreads();
    axpy_tile<NJ>(acc, dS, kt, ty, tx);
    __syncthreads();  // the slot and dS are free for the next copies
  }
  store_tile_f32<NJ>(dq + (size_t)b * Sq * H * D + hd, (size_t)H * D, acc, scale, q0, Sq, D, ty,
                     tx);
}

// K7dkv, fp32: dk, dv for one (b, h, 64-key tile); 32-query tiles of Q and
// dO with their scalars stream through the ring.
template <int NJ>
__global__ void __launch_bounds__(kF32Threads, f32_blocks(NJ))
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const int* __restrict__ qseg, const int* __restrict__ kseg,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
                  int D, float scale, int causal) {
  constexpr int DP = 16 * NJ;
  constexpr int LD = DP + 4;
  extern __shared__ __align__(16) float fsm[];
  float* Ks = fsm;
  float* Vs = Ks + kF32Own * LD;
  float* Qs = Vs + kF32Own * LD;                       // [stage]
  float* Os = Qs + kF32Stages * kF32Stream * LD;       // [stage]
  int* qseg_s = reinterpret_cast<int*>(Os + kF32Stages * kF32Stream * LD);  // [stage]
  float* lse_s = reinterpret_cast<float*>(qseg_s + kF32Stages * kF32Stream);
  float* delta_s = lse_s + kF32Stages * kF32Stream;
  float* P = delta_s + kF32Stages * kF32Stream;        // kF32Own x (kF32Stream + 4)
  float* dS = P + kF32Own * (kF32Stream + 4);

  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kF32Own;
  const size_t hd = (size_t)h * D;
  const float* qb = q + (size_t)b * Sq * H * D + hd;
  const float* ob = dout + (size_t)b * Sq * H * D + hd;
  const float* kb = k + (size_t)b * Skv * H * D + hd;
  const float* vb = v + (size_t)b * Skv * H * D + hd;
  const int* qsb = qseg + (size_t)b * Sq;
  const size_t bhs = ((size_t)b * H + h) * Sq;
  const int q_begin = causal ? (k0 / kF32Stream) * kF32Stream : 0;
  const int tiles = (Sq - q_begin + kF32Stream - 1) / kF32Stream;

  auto stage_in = [&](int it) {
    const int s = it % kF32Stages;
    const int r0 = q_begin + it * kF32Stream;
    copy_rows_f32<kF32Stream, DP>(Qs + s * kF32Stream * LD, qb, r0, Sq, H, D);
    copy_rows_f32<kF32Stream, DP>(Os + s * kF32Stream * LD, ob, r0, Sq, H, D);
    if (threadIdx.x < kF32Stream) {
      const int qi = r0 + threadIdx.x;
      const bool in = qi < Sq;
      qseg_s[s * kF32Stream + threadIdx.x] = query_seg(qsb, qi, Sq);
      lse_s[s * kF32Stream + threadIdx.x] = in ? lse[bhs + qi] : 0.f;
      delta_s[s * kF32Stream + threadIdx.x] = in ? delta[bhs + qi] : 0.f;
    }
  };
  copy_rows_f32<kF32Own, DP>(Ks, kb, k0, Skv, H, D);
  copy_rows_f32<kF32Own, DP>(Vs, vb, k0, Skv, H, D);
  stage_in(0);
  cp_async_commit();
  if (tiles > 1) stage_in(1);
  cp_async_commit();

  int ks[4], keys[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    keys[i] = k0 + ty + 16 * i;
    ks[i] = key_seg(kseg + (size_t)b * Skv, keys[i], Skv);
  }
  float accK[4][NJ], accV[4][NJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < NJ; ++j) accK[i][j] = accV[i][j] = 0.f;

  for (int it = 0; it < tiles; ++it) {
    const int s = it % kF32Stages;
    const int q0 = q_begin + it * kF32Stream;
    if (it + 2 < tiles) stage_in(it + 2);
    cp_async_commit();
    cp_async_wait<2>();
    __syncthreads();
    const float* qt = Qs + s * kF32Stream * LD;
    const float* ot = Os + s * kF32Stream * LD;
    float st[4][2] = {}, dpt[4][2] = {};
    dot_tile<DP>(st, Ks, qt, ty, tx);
    dot_tile<DP>(dpt, Vs, ot, ty, tx);
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int qq = tx + 16 * j;
      const int qi = q0 + qq;
      const int qsg = qseg_s[s * kF32Stream + qq];
      const float lq = lse_s[s * kF32Stream + qq];
      const float dq_ = delta_s[s * kF32Stream + qq];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = qsg == ks[i] && (!causal || qi >= keys[i]);
        const float p = ok ? expf(st[i][j] * scale - lq) : 0.f;
        P[(ty + 16 * i) * (kF32Stream + 4) + qq] = p;
        dS[(ty + 16 * i) * (kF32Stream + 4) + qq] = p * (dpt[i][j] - dq_);
      }
    }
    __syncthreads();
    axpy_tile<NJ>(accV, P, ot, ty, tx);
    axpy_tile<NJ>(accK, dS, qt, ty, tx);
    __syncthreads();
  }
  const size_t off = (size_t)b * Skv * H * D + hd;
  store_tile_f32<NJ>(dk + off, (size_t)H * D, accK, scale, k0, Skv, D, ty, tx);
  store_tile_f32<NJ>(dv + off, (size_t)H * D, accV, 1.f, k0, Skv, D, ty, tx);
}

// ---------------------------------------------------------------------------
// delta = rowsum(dO * O) in fp32, (B, H, S); one warp a (b, s, h) row
// ---------------------------------------------------------------------------

__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, float) {
  const float4* fa = reinterpret_cast<const float4*>(&a);
  const float4* fb = reinterpret_cast<const float4*>(&b);
  return fa->x * fb->x + fa->y * fb->y + fa->z * fb->z + fa->w * fb->w;
}
__device__ __forceinline__ float dot16(const uint4& a, const uint4& b, __nv_bfloat16) {
  const __nv_bfloat162* pa = reinterpret_cast<const __nv_bfloat162*>(&a);
  const __nv_bfloat162* pb = reinterpret_cast<const __nv_bfloat162*>(&b);
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 x = __bfloat1622float2(pa[i]);
    const float2 y = __bfloat1622float2(pb[i]);
    s += x.x * y.x + x.y * y.y;
  }
  return s;
}

template <typename T>
__global__ void __launch_bounds__(256)
flash_bwd_delta(const T* __restrict__ out, const T* __restrict__ g, float* __restrict__ delta,
                int rows, int S, int H, int D) {
  constexpr int kVec = 16 / sizeof(T);
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;
  const uint4* o = reinterpret_cast<const uint4*>(out + (size_t)row * D);
  const uint4* gg = reinterpret_cast<const uint4*>(g + (size_t)row * D);
  float s = 0.f;
  for (int c = lane; c < D / kVec; c += 32) s += dot16(o[c], gg[c], T());
#pragma unroll
  for (int m = 16; m > 0; m >>= 1) s += __shfl_xor_sync(0xffffffffu, s, m);
  if (lane == 0) {
    const int h = row % H;
    const int bs = row / H;  // b * S + s
    delta[((size_t)(bs / S) * H + h) * S + bs % S] = s;
  }
}

struct BwdArgs {
  const void *q, *k, *v, *dout;
  const int *qseg, *kseg;
  const float *lse, *delta;
  int B, Sq, Skv, H, D;
  float scale;
  int causal;
};

// A 4-d tensor map over a (B, S, H, D) bf16 tensor, boxes of 64 lanes x
// `rows` rows, 128-byte swizzle.
bool bshd_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hop::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// q and dout tiles of `qrows` rows, k and v tiles of `krows`
bool bwd_maps(const BwdArgs& a, CUtensorMap (&m)[4], int qrows, int krows) {
  return bshd_map(&m[0], a.q, a.B, a.Sq, a.H, a.D, qrows) &&
         bshd_map(&m[1], a.k, a.B, a.Skv, a.H, a.D, krows) &&
         bshd_map(&m[2], a.v, a.B, a.Skv, a.H, a.D, krows) &&
         bshd_map(&m[3], a.dout, a.B, a.Sq, a.H, a.D, qrows);
}

template <int DP>
cudaError_t dq_wgmma(const BwdArgs& a, void* dq, cudaStream_t st) {
  CUtensorMap m[4];
  if (!bwd_maps(a, m, kOwn, kStream)) return cudaErrorInvalidValue;
  constexpr size_t smem = DqSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kOwn - 1) / kOwn, a.H, a.B);
  flash_bwd_dq_wgmma<DP><<<grid, kWgThreads, smem, st>>>(
      m[0], m[1], m[2], m[3], a.qseg, a.kseg, a.lse, a.delta, static_cast<__nv_bfloat16*>(dq),
      a.Sq, a.Skv, a.H, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_wgmma(const BwdArgs& a, void* dk, void* dv, cudaStream_t st) {
  CUtensorMap m[4];
  if (!bwd_maps(a, m, kStream, kOwn)) return cudaErrorInvalidValue;
  constexpr size_t smem = DkvSmem<DP>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_wgmma<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + kOwn - 1) / kOwn, a.H, a.B);
  flash_bwd_dkv_wgmma<DP><<<grid, kWgThreads, smem, st>>>(
      m[0], m[1], m[2], m[3], a.qseg, a.kseg, a.lse, a.delta, static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), a.Sq, a.Skv, a.H, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t dq_f32(const BwdArgs& a, void* dq, cudaStream_t st) {
  constexpr size_t smem = f32_smem<NJ>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_f32<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Sq + kF32Own - 1) / kF32Own, a.H, a.B);
  flash_bwd_dq_f32<NJ><<<grid, kF32Threads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.qseg, a.kseg,
      a.lse, a.delta, static_cast<float*>(dq), a.Sq, a.Skv, a.H, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t dkv_f32(const BwdArgs& a, void* dk, void* dv, cudaStream_t st) {
  constexpr size_t smem = f32_smem<NJ>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_f32<NJ>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((a.Skv + kF32Own - 1) / kF32Own, a.H, a.B);
  flash_bwd_dkv_f32<NJ><<<grid, kF32Threads, smem, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.qseg, a.kseg,
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.Sq, a.Skv, a.H,
      a.D, a.scale, a.causal);
  return cudaGetLastError();
}

// The shapes the kernels take (ops/flash.py bwd_takes): D <= 128, D % 8
// == 0 in bf16 (TMA rows are 16-byte multiples), D % 4 == 0 in fp32.
bool valid(const BwdArgs& a, int is_bf16) {
  return a.B > 0 && a.Sq > 0 && a.Skv > 0 && a.H > 0 && a.D > 0 && a.D <= 128 &&
         a.D % (is_bf16 ? 8 : 4) == 0;
}

}  // namespace
}  // namespace mmmm

// q, dout: (B, Sq, H, D); k, v: (B, Skv, H, D), all bf16 (is_bf16) or fp32,
// contiguous, 16-byte aligned; q_segments (B, Sq), kv_segments (B, Skv)
// int32; lse, delta (B, H, Sq) fp32 (lse of the scaled logits, 0 on rows
// with no valid key; delta = rowsum(dout * out)). Writes dq (B, Sq, H, D)
// in q's dtype.
extern "C" int mmmm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* q_segments,
                                 const void* kv_segments, const void* lse, const void* delta,
                                 void* dq, int B, int Sq, int Skv, int H, int D, float scale,
                                 int causal, int is_bf16, void* stream) {
  using namespace mmmm;
  const BwdArgs a{q, k, v, dout, static_cast<const int*>(q_segments),
                  static_cast<const int*>(kv_segments), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), B, Sq, Skv, H, D, scale, causal};
  if (!valid(a, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    err = D <= 64 ? dq_wgmma<64>(a, dq, st) : dq_wgmma<128>(a, dq, st);
  } else {
    switch ((D + 15) / 16) {
      case 1: err = dq_f32<1>(a, dq, st); break;
      case 2: err = dq_f32<2>(a, dq, st); break;
      case 3: err = dq_f32<3>(a, dq, st); break;
      case 4: err = dq_f32<4>(a, dq, st); break;
      case 5: err = dq_f32<5>(a, dq, st); break;
      case 6: err = dq_f32<6>(a, dq, st); break;
      case 7: err = dq_f32<7>(a, dq, st); break;
      case 8: err = dq_f32<8>(a, dq, st); break;
    }
  }
  return static_cast<int>(err);
}

// The same operands; writes dk, dv (B, Skv, H, D) in k's dtype.
extern "C" int mmmm_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                  const void* dout, const void* q_segments,
                                  const void* kv_segments, const void* lse, const void* delta,
                                  void* dk, void* dv, int B, int Sq, int Skv, int H, int D,
                                  float scale, int causal, int is_bf16, void* stream) {
  using namespace mmmm;
  const BwdArgs a{q, k, v, dout, static_cast<const int*>(q_segments),
                  static_cast<const int*>(kv_segments), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), B, Sq, Skv, H, D, scale, causal};
  if (!valid(a, is_bf16)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    err = D <= 64 ? dkv_wgmma<64>(a, dk, dv, st) : dkv_wgmma<128>(a, dk, dv, st);
  } else {
    switch ((D + 15) / 16) {
      case 1: err = dkv_f32<1>(a, dk, dv, st); break;
      case 2: err = dkv_f32<2>(a, dk, dv, st); break;
      case 3: err = dkv_f32<3>(a, dk, dv, st); break;
      case 4: err = dkv_f32<4>(a, dk, dv, st); break;
      case 5: err = dkv_f32<5>(a, dk, dv, st); break;
      case 6: err = dkv_f32<6>(a, dk, dv, st); break;
      case 7: err = dkv_f32<7>(a, dk, dv, st); break;
      case 8: err = dkv_f32<8>(a, dk, dv, st); break;
    }
  }
  return static_cast<int>(err);
}

// out, dout: (B, S, H, D) bf16 (is_bf16) or fp32, contiguous, 16-byte
// aligned, D % (16 / element size) == 0; writes delta (B, H, S) fp32.
extern "C" int mmmm_flash_bwd_delta(const void* out, const void* dout, void* delta, int B, int S,
                                    int H, int D, int is_bf16, void* stream) {
  using namespace mmmm;
  if (B <= 0 || S <= 0 || H <= 0 || D <= 0 || D % (is_bf16 ? 8 : 4))
    return static_cast<int>(cudaErrorInvalidValue);
  const int rows = B * S * H;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((rows + 7) / 8);
  if (is_bf16)
    flash_bwd_delta<__nv_bfloat16><<<grid, 256, 0, st>>>(
        static_cast<const __nv_bfloat16*>(out), static_cast<const __nv_bfloat16*>(dout),
        static_cast<float*>(delta), rows, S, H, D);
  else
    flash_bwd_delta<float><<<grid, 256, 0, st>>>(static_cast<const float*>(out),
                                                 static_cast<const float*>(dout),
                                                 static_cast<float*>(delta), rows, S, H, D);
  return static_cast<int>(cudaGetLastError());
}

// Dynamic shared memory (bytes) of the K7dq (dkv = 0) or K7dkv kernel a
// launch at head dim D takes; 0 for a D it does not take.
extern "C" int mmmm_flash_bwd_smem(int is_bf16, int D, int dkv) {
  using namespace mmmm;
  if (D <= 0 || D > 128) return 0;
  if (is_bf16) {
    if (D <= 64) return static_cast<int>(dkv ? DkvSmem<64>::kBytes : DqSmem<64>::kBytes);
    return static_cast<int>(dkv ? DkvSmem<128>::kBytes : DqSmem<128>::kBytes);
  }
  switch ((D + 15) / 16) {
    case 1: return static_cast<int>(f32_smem<1>());
    case 2: return static_cast<int>(f32_smem<2>());
    case 3: return static_cast<int>(f32_smem<3>());
    case 4: return static_cast<int>(f32_smem<4>());
    case 5: return static_cast<int>(f32_smem<5>());
    case 6: return static_cast<int>(f32_smem<6>());
    case 7: return static_cast<int>(f32_smem<7>());
    default: return static_cast<int>(f32_smem<8>());
  }
}
