// The forward attention kernels behind K3 (flash forward, flash_fwd.cu), K4
// (dense attention, dense_attn.cu; K12 and probe P1 run the same kernel):
// a block owns a run of query rows of one (sample, head) and streams K and
// V tiles through a ring in shared memory with an online softmax, the walk
// of the flash backward's K7dq (flash_bwd.cu) with one product fewer.
//
// What they compute (the reference's _flash_fwd_impl and _dense_fwd_bhsd):
// fp32 logits scaled by `scale`, an fp32 online softmax (row max and sum),
// probabilities rounded to the value dtype before the PV product, fp32 sums;
// out = PV / sum, and lse = max + log(sum) of the scaled logits (K3). In
// fp32 every product is full fp32 on CUDA cores (no TF32). MASKED (K3): key
// j is valid for query i iff qseg[i] == kseg[j] != 0 and, when `causal`,
// i >= j; a row with no valid key gives out = 0 and lse = 0. Unmasked (K4):
// every key < Skv is valid. NOSM (P1, bf16 only) replaces the softmax by one
// multiply, P = (S * scale) * 1e-4 with keys past Skv at 0, and writes the
// unnormalized PV. FAST (K4 only; the reference's MMMM_DENSE_FAST_SOFTMAX=1,
// `_softmax_rows(fast=True)`) takes p = bf16(exp(bf16(s - m))) and sums the
// bf16 p; m is the running max here where the reference subtracts the row's
// (ops/dense_attn.py dense_attention_plain says how far that moves p).
//
// bf16 (Hopper, warp-specialized; attn_fwd_wgmma): a block is 3 warpgroups
// and owns 128 query rows, 64 to each of two consumer warpgroups. One
// producer warp loads Q once by TMA and keeps a ring of K and V tiles in
// flight with full and empty mbarriers (4 stages of 64 keys, or 2 of 128
// where Skv >= 512), with the keys' segment ids and whether the tile's keys
// share one segment. S = Q K^T is a `wgmma` (m64n64 or m64n128) with both
// operands K-major in shared memory, over all DP / 16 k16 slices (lanes
// past D are zero; a runtime bound on the slices made ptxas fence every
// wgmma); the online softmax (exp2 domain) runs on the accumulator
// fragment; P goes from the fragment straight into the register A operand
// of O += P V, whose B is V read MN-major from the tile already in shared
// memory. Every write to a wgmma's registers happens with no wgmma in
// flight and before the wgmma.fence, so ptxas keeps the products
// asynchronous. The head block is DP = 64 or 128 (112 pays 128). The
// producer gives its registers to the consumers (setmaxnreg). Masks cost
// only where needed: K4 masks the ragged last tile alone; K3 masks by
// element only the tiles that cross the diagonal or whose keys' segments
// are not all the rows' segment, and never loads a tile above the
// diagonal. Causal blocks run heaviest first (the q-tile index reversed).
// The epilogue scales each row by 1 / sum and writes 16-byte stores.
//
// fp32 (CUDA cores; attn_fwd_f32): 256 threads own 64 query rows; 32-key
// tiles of K and V stream through a cp.async ring (attn_tiles.cuh) of 3
// stages up to D = 64 and 2 above, so that two blocks share an SM at every
// head dim. Thread (ty, tx) computes a 4 x 2 micro-tile of S with 16-byte
// shared loads along D; each row's max and sum are reduced across its 16
// threads; p goes to shared memory and each thread accumulates a 4 x (DP /
// 16) micro-tile of O += P V.
//
// Head dims: D % 8 == 0 in bf16 (TMA rows are 16-byte multiples), D % 4 ==
// 0 in fp32 (16-byte cp.async rows), D <= 128; the wrappers pad any other
// D <= 128 with zero lanes (ops/attention.py kernel_head_dim).
#pragma once

#include "attn_tiles.cuh"

namespace mmmm {

// bf16: a streamed K/V tile holds KT keys, 128 where the keys fill at
// least four such tiles (an m64n128 S product), else 64 (shorter sequences,
// where more, smaller tiles keep the SMs busy); the ring holds as many as
// shared memory allows.
template <int KT>
constexpr int fwd_stages() { return KT == 128 ? 2 : 4; }

// FAST's probabilities of two natural-log logits less the max, t <= 0:
// bf16(exp(bf16(t))), as the reference's bf16 exp of a bf16 operand; each
// rounding one packed conversion for the pair.
__device__ __forceinline__ float2 fast_exp2(float t0, float t1) {
  const float2 tb = bf16r2(t0, t1);
  return bf16r2(exp2f(tb.x * kLog2e), exp2f(tb.y * kLog2e));
}
inline bool fwd_long_keys(int Skv) { return Skv >= 512; }

template <int DP, int KT>
struct FwdSmem {
  static constexpr int kStages = fwd_stages<KT>();
  static constexpr uint32_t kQTile = tile_bytes<kOwn, DP>();
  static constexpr uint32_t kKvTile = tile_bytes<KT, DP>();
  static constexpr size_t kBytes = kQTile + kStages * 2 * kKvTile +
                                   kStages * (KT + 2) * sizeof(int) +
                                   (1 + 2 * kStages) * sizeof(uint64_t) + 1024;
};

// q, out: (B, Sq, H, D); k, v: (B, Skv, H, D), bf16 through the tensor maps
// (q tiles of kOwn rows, k and v of KT); `scale_log2` = scale * log2(e) (the
// plain scale under NOSM).
template <bool MASKED, int DP, int KT, bool NOSM, bool FAST>
__global__ void __launch_bounds__(kWgThreads, 1)
attn_fwd_wgmma(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
               const __grid_constant__ CUtensorMap vmap, const int* __restrict__ qseg,
               const int* __restrict__ kseg, __nv_bfloat16* __restrict__ out,
               float* __restrict__ lse, int Sq, int Skv, int H, int D, float scale_log2,
               int causal) {
  using L = FwdSmem<DP, KT>;
  constexpr int kStages = L::kStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  unsigned char* Qs = smem;
  unsigned char* Ks = Qs + L::kQTile;                     // [stage]
  unsigned char* Vs = Ks + kStages * L::kKvTile;          // [stage]
  int* kseg_s = reinterpret_cast<int*>(Vs + kStages * L::kKvTile);  // [stage][KT]
  int* tile_seg = kseg_s + kStages * KT;  // [stage]: the keys' one segment, or kNoKey
  uint64_t* full_q = reinterpret_cast<uint64_t*>(kseg_s + kStages * (KT + 2));
  uint64_t* full = full_q + 1;
  uint64_t* empty = full + kStages;

  const bool causal_ = MASKED && causal;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = (causal_ ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kOwn;
  const int k_end = causal_ ? min(Skv, q0 + kOwn) : Skv;
  const int tiles = (k_end + KT - 1) / KT;
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
      if (lane == 0) {
        hop::mbar_expect_tx(full_q, L::kQTile);
        load_tile<kOwn, DP>(Qs, &qmap, full_q, q0, h, b);
      }
      for (int it = 0; it < tiles; ++it) {
        const int s = it % kStages;
        const int k0 = it * KT;
        if (it >= kStages) hop::mbar_wait(&empty[s], ((it / kStages) - 1) & 1);
        if (lane == 0) {
          hop::mbar_expect_tx(&full[s], 2 * L::kKvTile);
          load_tile<KT, DP>(Ks + s * L::kKvTile, &kmap, &full[s], k0, h, b);
          load_tile<KT, DP>(Vs + s * L::kKvTile, &vmap, &full[s], k0, h, b);
        }
        if (MASKED) {
          const int* ksb = kseg + (size_t)b * Skv;
          const int first = key_seg(ksb, k0, Skv);
          bool one = true;
#pragma unroll
          for (int i = lane; i < KT; i += 32) {
            const int sg = key_seg(ksb, k0 + i, Skv);
            kseg_s[s * KT + i] = sg;
            one = one && sg == first;
          }
          one = __all_sync(0xffffffffu, one);
          if (lane == 0) tile_seg[s] = one ? first : kNoKey;
        }
        hop::mbar_arrive(&full[s]);
      }
    }
  } else {
    hop::reg_alloc<232>();
    const int wg = warp_all >> 2;
    const int g = lane >> 2;
    const int qd = lane & 3;
    const int row0 = q0 + 64 * wg;  // the warpgroup's first query
    int rows[2], qs[2] = {0, 0};
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) {
      rows[rh] = row0 + 16 * (warp_all & 3) + g + 8 * rh;
      if (MASKED) qs[rh] = query_seg(qseg + (size_t)b * Sq, rows[rh], Sq);
    }
    // causal: tiles past the warpgroup's last query hold no key it sees;
    // they are the last ones, and the warpgroup only hands them back
    const int live = causal_ ? min(tiles, (row0 + 63) / KT + 1) : tiles;
    float acc[DP / 2];
    hop::zero(acc);
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};
    hop::mbar_wait(full_q, 0);
    for (int it = 0; it < live; ++it) {
      const int s = it % kStages;
      const int k0 = it * KT;
      hop::mbar_wait(&full[s], (it / kStages) & 1);
      const unsigned char* kt = Ks + s * L::kKvTile;
      const unsigned char* vt = Vs + s * L::kKvTile;
      // S = Q K^T for the warpgroup's 64 rows x KT keys
      float sc[KT / 2];
      hop::zero(sc);
      hop::fence_regs(sc);  // the zeros are written before the fence
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks)  // lanes past D are zero
        hop::wgmma_ss<KT, 0, 0>(sc, kmajor<kOwn>(Qs, 64 * wg, ks), kmajor<KT>(kt, 0, ks), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(sc);
      // element 4 j + e: row rows[e / 2], key k0 + 8 j + 2 qd + e % 2
      float alpha[2] = {1.f, 1.f};
      if constexpr (NOSM) {
#pragma unroll
        for (int j = 0; j < KT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[4 * j + e] = k0 + 8 * j + 2 * qd + (e & 1) < Skv
                                ? (sc[4 * j + e] * scale_log2) * 1e-4f : 0.f;
      } else {
        bool masked;  // warp-uniform: some element of the warp's 16 rows is masked
        if (MASKED) {
          const int ts = tile_seg[s];
          masked = !__all_sync(0xffffffffu, ts == qs[0] && ts == qs[1] &&
                                                (!causal_ || k0 + KT - 1 <= rows[0]));
        } else {
          masked = k0 + KT > Skv;
        }
        if (masked) {
          const int* ksg = kseg_s + s * KT;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j) {
            int2 kv = make_int2(0, 0);
            if (MASKED) kv = *reinterpret_cast<const int2*>(ksg + 8 * j + 2 * qd);
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int rh = e >> 1;
              const int kj = k0 + 8 * j + 2 * qd + (e & 1);
              const bool ok = MASKED ? ((e & 1) ? kv.y : kv.x) == qs[rh] &&
                                           (!causal_ || rows[rh] >= kj)
                                     : kj < Skv;
              sc[4 * j + e] = ok ? sc[4 * j + e] * scale_log2 : kNegInf;
            }
          }
        } else {
#pragma unroll
          for (int i = 0; i < KT / 2; ++i) sc[i] *= scale_log2;
        }
#pragma unroll
        for (int rh = 0; rh < 2; ++rh) {
          float mx = kNegInf;
#pragma unroll
          for (int j = 0; j < KT / 8; ++j)
            mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * rh], sc[4 * j + 2 * rh + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float m_new = fmaxf(m[rh], mx);
          alpha[rh] = exp2f(m[rh] - m_new);
          m[rh] = m_new;
          float p_sum = 0.f;
          if constexpr (FAST) {
#pragma unroll
            for (int j = 0; j < KT / 8; ++j) {  // the row's pair of keys together
              const int e = 4 * j + 2 * rh;
              float2 p = fast_exp2((sc[e] - m_new) * kLn2, (sc[e + 1] - m_new) * kLn2);
              if (masked && !(sc[e] > 0.5f * kNegInf)) p.x = 0.f;
              if (masked && !(sc[e + 1] > 0.5f * kNegInf)) p.y = 0.f;
              sc[e] = p.x;
              sc[e + 1] = p.y;
              p_sum += p.x;
              p_sum += p.y;
            }
          } else {
#pragma unroll
            for (int j = 0; j < KT / 8; ++j) {
#pragma unroll
              for (int e = 2 * rh; e < 2 * rh + 2; ++e) {
                // masked logits are exactly kNegInf; valid ones are far above it
                const float x = sc[4 * j + e];
                const float p = (!masked || x > 0.5f * kNegInf) ? exp2f(x - m_new) : 0.f;
                sc[4 * j + e] = p;
                p_sum += p;
              }
            }
          }
          l[rh] = l[rh] * alpha[rh] + p_sum;  // this thread's share of the row sum
        }
      }
      // O = alpha O + P V (P rounded to bf16); the operands are written
      // before the fence, with no wgmma in flight
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        acc[4 * j] *= alpha[0];
        acc[4 * j + 1] *= alpha[0];
        acc[4 * j + 2] *= alpha[1];
        acc[4 * j + 3] *= alpha[1];
      }
      uint32_t pa[KT / 16][4];
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) hop::acc_to_a(sc, ks, pa[ks]);
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      hop::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < KT / 16; ++ks) hop::wgmma_rs<DP, 1>(acc, pa[ks], mnmajor<KT>(vt, ks), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::fence_regs(pa);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
    for (int it = live; it < tiles; ++it) {
      const int s = it % kStages;
      hop::mbar_wait(&full[s], (it / kStages) & 1);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }
    float inv[2] = {1.f, 1.f};
    if constexpr (!NOSM) {
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float lt = l[rh];
        lt += __shfl_xor_sync(0xffffffffu, lt, 1);
        lt += __shfl_xor_sync(0xffffffffu, lt, 2);
        inv[rh] = lt > 0.f ? 1.f / lt : 0.f;
        if (lse != nullptr && qd == 0 && rows[rh] < Sq)
          lse[((size_t)b * H + h) * Sq + rows[rh]] = lt > 0.f ? m[rh] * kLn2 + logf(lt) : 0.f;
      }
    }
    store_rows<DP>(acc, inv[0], inv[1], out + ((size_t)b * Sq * H + h) * D, (size_t)H * D, row0,
                   Sq, D);
  }
}

template <int NJ, int STAGES>
constexpr size_t fwd_f32_smem() {
  constexpr int DP = 16 * NJ;
  return sizeof(float) * (kF32Own * (DP + 4) + STAGES * 2 * kF32Stream * (DP + 4) +
                          kF32Own * (kF32Stream + 4)) +
         STAGES * kF32Stream * sizeof(int);
}
// The fp32 ring: 3 stages up to D = 64, where two blocks an SM fit anyway;
// above, 2 stages, so that two blocks (16 warps) still fit an SM.
constexpr int fwd_f32_stages(int nj) { return nj <= 4 ? 3 : 2; }
// two blocks an SM where their shared memory fits
template <int NJ, int STAGES>
constexpr int fwd_f32_blocks() {
  return 2 * (fwd_f32_smem<NJ, STAGES>() + 1024) <= 228 * 1024 ? 2 : 1;
}

// q, k, v, out (B, S, H, D) fp32 as attn_fwd_wgmma's; full fp32.
template <bool MASKED, int NJ, int STAGES, bool FAST>
__global__ void __launch_bounds__(kF32Threads, (fwd_f32_blocks<NJ, STAGES>()))
attn_fwd_f32(const float* __restrict__ q, const float* __restrict__ k,
             const float* __restrict__ v, const int* __restrict__ qseg,
             const int* __restrict__ kseg, float* __restrict__ out, float* __restrict__ lse,
             int Sq, int Skv, int H, int D, float scale, int causal) {
  constexpr int DP = 16 * NJ;
  constexpr int LD = DP + 4;
  constexpr int LP = kF32Stream + 4;
  extern __shared__ __align__(16) float fsm[];
  float* Qs = fsm;
  float* Ks = Qs + kF32Own * LD;                       // [stage]
  float* Vs = Ks + STAGES * kF32Stream * LD;           // [stage]
  float* P = Vs + STAGES * kF32Stream * LD;            // kF32Own x LP
  int* kseg_s = reinterpret_cast<int*>(P + kF32Own * LP);  // [stage]

  const bool causal_ = MASKED && causal;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = (causal_ ? gridDim.x - 1 - blockIdx.x : blockIdx.x) * kF32Own;
  const size_t hd = (size_t)h * D;
  const float* kb = k + (size_t)b * Skv * H * D + hd;
  const float* vb = v + (size_t)b * Skv * H * D + hd;
  const int k_end = causal_ ? min(Skv, q0 + kF32Own) : Skv;
  const int tiles = (k_end + kF32Stream - 1) / kF32Stream;

  auto stage_in = [&](int it) {
    const int s = it % STAGES;
    const int r0 = it * kF32Stream;
    copy_rows_f32<kF32Stream, DP>(Ks + s * kF32Stream * LD, kb, r0, Skv, H, D);
    copy_rows_f32<kF32Stream, DP>(Vs + s * kF32Stream * LD, vb, r0, Skv, H, D);
    if (MASKED && threadIdx.x < kF32Stream)
      kseg_s[s * kF32Stream + threadIdx.x] = key_seg(kseg + (size_t)b * Skv, r0 + threadIdx.x, Skv);
  };
  copy_rows_f32<kF32Own, DP>(Qs, q + (size_t)b * Sq * H * D + hd, q0, Sq, H, D);
#pragma unroll
  for (int i = 0; i < STAGES - 1; ++i) {
    if (i < tiles) stage_in(i);
    cp_async_commit();
  }

  int qs[4] = {0, 0, 0, 0};
  if (MASKED) {
#pragma unroll
    for (int i = 0; i < 4; ++i) qs[i] = query_seg(qseg + (size_t)b * Sq, q0 + ty + 16 * i, Sq);
  }
  float acc[4][NJ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < NJ; ++j) acc[i][j] = 0.f;
  }

  for (int it = 0; it < tiles; ++it) {
    const int s = it % STAGES;
    const int k0 = it * kF32Stream;
    if (it + STAGES - 1 < tiles) stage_in(it + STAGES - 1);
    cp_async_commit();
    cp_async_wait<STAGES - 1>();  // this tile's copies have landed (younger groups may fly)
    __syncthreads();
    const float* vt = Vs + s * kF32Stream * LD;
    float sc[4][2] = {};
    dot_tile<DP>(sc, Qs, Ks + s * kF32Stream * LD, ty, tx);
    // element (i, j): query q0 + ty + 16 i, key k0 + tx + 16 j
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int kj = k0 + tx + 16 * j;
      const int ksg = MASKED ? kseg_s[s * kF32Stream + tx + 16 * j] : 0;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool ok = MASKED ? ksg == qs[i] && (!causal_ || q0 + ty + 16 * i >= kj) : kj < Skv;
        sc[i][j] = ok ? sc[i][j] * scale : kNegInf;
      }
    }
    // the row's 16 threads (one half-warp) share its max and sum
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float mx = fmaxf(sc[i][0], sc[i][1]);
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float alpha = expf(m[i] - m_new);
      m[i] = m_new;
      float ps = 0.f;
      if constexpr (FAST) {  // the row's two keys together
        const float2 f = fast_exp2(sc[i][0] - m_new, sc[i][1] - m_new);
        const float p[2] = {sc[i][0] > 0.5f * kNegInf ? f.x : 0.f,
                            sc[i][1] > 0.5f * kNegInf ? f.y : 0.f};
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          P[(ty + 16 * i) * LP + tx + 16 * j] = p[j];
          ps += p[j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const float p = sc[i][j] > 0.5f * kNegInf ? expf(sc[i][j] - m_new) : 0.f;
          P[(ty + 16 * i) * LP + tx + 16 * j] = p;
          ps += p;
        }
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1) ps += __shfl_xor_sync(0xffffffffu, ps, o);
      l[i] = l[i] * alpha + ps;
#pragma unroll
      for (int j = 0; j < NJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();
    axpy_tile<NJ>(acc, P, vt, ty, tx);
    __syncthreads();  // the slot and P are free for the next copies
  }
  float* ob = out + (size_t)b * Sq * H * D + hd;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty + 16 * i;
    if (row >= Sq) continue;
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const int col = tx + 16 * j;
      if (col < D) ob[(size_t)row * H * D + col] = l[i] > 0.f ? acc[i][j] / l[i] : 0.f;
    }
    if (lse != nullptr && tx == 0)
      lse[((size_t)b * H + h) * Sq + row] = l[i] > 0.f ? m[i] + logf(l[i]) : 0.f;
  }
}


// The head dims the kernels take (ops/attention.py kernel_head_dim).
inline bool fwd_takes(int D, int is_bf16) { return D > 0 && D <= 128 && D % (is_bf16 ? 8 : 4) == 0; }

// Dynamic shared memory (bytes) a forward launch at head dim D over Skv keys
// asks for; 0 for a D it does not take.
inline size_t fwd_smem(int is_bf16, int D, int Skv) {
  if (!fwd_takes(D, is_bf16)) return 0;
  if (is_bf16) {
    const bool lk = fwd_long_keys(Skv);
    if (D <= 64) return lk ? FwdSmem<64, 128>::kBytes : FwdSmem<64, 64>::kBytes;
    return lk ? FwdSmem<128, 128>::kBytes : FwdSmem<128, 64>::kBytes;
  }
  switch ((D + 15) / 16) {
    case 1: return fwd_f32_smem<1, fwd_f32_stages(1)>();
    case 2: return fwd_f32_smem<2, fwd_f32_stages(2)>();
    case 3: return fwd_f32_smem<3, fwd_f32_stages(3)>();
    case 4: return fwd_f32_smem<4, fwd_f32_stages(4)>();
    case 5: return fwd_f32_smem<5, fwd_f32_stages(5)>();
    case 6: return fwd_f32_smem<6, fwd_f32_stages(6)>();
    case 7: return fwd_f32_smem<7, fwd_f32_stages(7)>();
    default: return fwd_f32_smem<8, fwd_f32_stages(8)>();
  }
}

template <bool MASKED, int DP, int KT, bool NOSM, bool FAST>
cudaError_t fwd_wgmma_run(const void* q, const void* k, const void* v, const int* qseg,
                          const int* kseg, void* out, float* lse, int B, int Sq, int Skv, int H,
                          int D, float scale_log2, int causal, cudaStream_t st) {
  CUtensorMap m[3];
  if (!(bshd_map(&m[0], q, B, Sq, H, D, kOwn) && bshd_map(&m[1], k, B, Skv, H, D, KT) &&
        bshd_map(&m[2], v, B, Skv, H, D, KT)))
    return cudaErrorInvalidValue;
  constexpr size_t smem = FwdSmem<DP, KT>::kBytes;
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_wgmma<MASKED, DP, KT, NOSM, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kOwn - 1) / kOwn, H, B);
  attn_fwd_wgmma<MASKED, DP, KT, NOSM, FAST><<<grid, kWgThreads, smem, st>>>(
      m[0], m[1], m[2], qseg, kseg, static_cast<__nv_bfloat16*>(out), lse, Sq, Skv, H, D,
      scale_log2, causal);
  return cudaGetLastError();
}
template <bool MASKED, int DP, bool NOSM, bool FAST>
cudaError_t fwd_wgmma_dp(const void* q, const void* k, const void* v, const int* qseg,
                         const int* kseg, void* out, float* lse, int B, int Sq, int Skv, int H,
                         int D, float scale_log2, int causal, cudaStream_t st) {
  if (fwd_long_keys(Skv))
    return fwd_wgmma_run<MASKED, DP, 128, NOSM, FAST>(q, k, v, qseg, kseg, out, lse, B, Sq, Skv,
                                                      H, D, scale_log2, causal, st);
  return fwd_wgmma_run<MASKED, DP, 64, NOSM, FAST>(q, k, v, qseg, kseg, out, lse, B, Sq, Skv, H,
                                                   D, scale_log2, causal, st);
}

// bf16 forward: q (B, Sq, H, D), k, v (B, Skv, H, D), out like q, lse (B, H,
// Sq) fp32 or null; segment ids (B, Sq), (B, Skv) int32 when MASKED.
template <bool MASKED, bool NOSM = false, bool FAST = false>
cudaError_t launch_fwd_wgmma(const void* q, const void* k, const void* v, void* out, float* lse,
                             const int* qseg, const int* kseg, int B, int Sq, int Skv, int H,
                             int D, float scale, int causal, cudaStream_t st) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || !fwd_takes(D, 1)) return cudaErrorInvalidValue;
  const float sl2 = NOSM ? scale : scale * kLog2e;
  if (D <= 64)
    return fwd_wgmma_dp<MASKED, 64, NOSM, FAST>(q, k, v, qseg, kseg, out, lse, B, Sq, Skv, H, D,
                                                sl2, causal, st);
  return fwd_wgmma_dp<MASKED, 128, NOSM, FAST>(q, k, v, qseg, kseg, out, lse, B, Sq, Skv, H, D,
                                               sl2, causal, st);
}

template <bool MASKED, int NJ, int STAGES, bool FAST>
cudaError_t fwd_f32_run(const void* q, const void* k, const void* v, void* out, float* lse,
                        const int* qseg, const int* kseg, int B, int Sq, int Skv, int H, int D,
                        float scale, int causal, cudaStream_t st) {
  constexpr size_t smem = fwd_f32_smem<NJ, STAGES>();
  cudaError_t err = cudaFuncSetAttribute(attn_fwd_f32<MASKED, NJ, STAGES, FAST>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + kF32Own - 1) / kF32Own, H, B);
  attn_fwd_f32<MASKED, NJ, STAGES, FAST><<<grid, kF32Threads, smem, st>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      qseg, kseg, static_cast<float*>(out), lse, Sq, Skv, H, D, scale, causal);
  return cudaGetLastError();
}
template <bool MASKED, int NJ, bool FAST>
cudaError_t fwd_f32_nj(const void* q, const void* k, const void* v, void* out, float* lse,
                       const int* qseg, const int* kseg, int B, int Sq, int Skv, int H, int D,
                       float scale, int causal, cudaStream_t st) {
  return fwd_f32_run<MASKED, NJ, fwd_f32_stages(NJ), FAST>(q, k, v, out, lse, qseg, kseg, B, Sq,
                                                            Skv, H, D, scale, causal, st);
}

// fp32 forward, the operands of launch_fwd_wgmma in fp32.
template <bool MASKED, bool FAST = false>
cudaError_t launch_fwd_f32(const void* q, const void* k, const void* v, void* out, float* lse,
                           const int* qseg, const int* kseg, int B, int Sq, int Skv, int H, int D,
                           float scale, int causal, cudaStream_t st) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || !fwd_takes(D, 0)) return cudaErrorInvalidValue;
#define MMMM_FWD_F32_CASE(NJ_)                                                               \
  case NJ_:                                                                                  \
    return fwd_f32_nj<MASKED, NJ_, FAST>(q, k, v, out, lse, qseg, kseg, B, Sq, Skv, H, D,      \
                                         scale, causal, st);
  switch ((D + 15) / 16) {
    MMMM_FWD_F32_CASE(1)
    MMMM_FWD_F32_CASE(2)
    MMMM_FWD_F32_CASE(3)
    MMMM_FWD_F32_CASE(4)
    MMMM_FWD_F32_CASE(5)
    MMMM_FWD_F32_CASE(6)
    MMMM_FWD_F32_CASE(7)
    MMMM_FWD_F32_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef MMMM_FWD_F32_CASE
}

}  // namespace mmmm
