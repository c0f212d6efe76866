// bf16 body of the two prefill-style attention kernels (K3 flash forward, K4
// dense attention) on the tensor cores: one block per (sample, head, 64-query
// tile), 4 warps of 16 query rows each, streaming 64-key K/V tiles through
// shared memory with an online (flash) softmax.
//
// Both products are warp-level `mma.sync.m16n8k16` (bf16 in, fp32 sums):
//   S = Q K^T : A = the warp's Q rows (registers, loaded once), B = K tile
//               (`ldmatrix` from shared memory);
//   O += P V  : A = P, taken straight from S's accumulator registers (the
//               m16n8 C layout of two key tiles is the A layout of one
//               16-key chunk), B = V tile (`ldmatrix.trans`).
// The head dim is padded to DP (a multiple of 16); padded lanes are zero in
// Q, K and V, so any D <= DP is exact. Shared-memory rows are DP + 8 wide so
// that the 8 rows one `ldmatrix` phase reads fall in distinct banks.
// Softmax state (row max, row sum) is fp32 in the exp2 domain; P is rounded
// to bf16 for the PV product, as the plain version rounds its probabilities.
// NOSM (probe P1, K4's measurement floor) replaces the softmax by one
// multiply, P = (S * scale) * 1e-4 with keys past Skv at 0, and writes the
// unnormalized P V.
//
// This is the simple tensor-core form: no cp.async/TMA pipelining, no wgmma.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "attn_tile.cuh"

namespace mmmm {

constexpr int kMmaBQ = 64;  // query rows per block (16 per warp)
constexpr int kMmaBK = 64;  // keys per shared-memory tile
constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ void mma_bf16(float c[4], const uint32_t a[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t r[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t r[4], const void* smem) {
  const unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// Elements (row, col) and (row, col + 1) of a (rows, D) bf16 matrix with row
// stride `ld`, zero outside it, packed as one mma operand register.
__device__ __forceinline__ uint32_t load_pair(const __nv_bfloat16* base, size_t ld, int row,
                                              int rows, int col, int D) {
  if (row >= rows) return 0u;
  const __nv_bfloat16* p = base + (size_t)row * ld;
  const float lo = col < D ? __bfloat162float(p[col]) : 0.f;
  const float hi = col + 1 < D ? __bfloat162float(p[col + 1]) : 0.f;
  return pack_bf16(lo, hi);
}

// Rows [k0, k0 + kMmaBK) of one head of a (B, S, H, D) tensor into a
// (kMmaBK, DP + 8) shared tile, zero past S and past D.
template <int DP>
__device__ __forceinline__ void load_tile(__nv_bfloat16 (*dst)[DP + 8],
                                          const __nv_bfloat16* __restrict__ src, int k0,
                                          int S, int H, int D, bool vec) {
  constexpr int kChunks = DP / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kMmaBK * kChunks; idx += kMmaThreads) {
    const int kk = idx / kChunks;
    const int c = idx - kk * kChunks;
    const int key = k0 + kk;
    const int d0 = 8 * c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (key < S && d0 < D) {
      const __nv_bfloat16* row = src + (size_t)key * H * D;
      if (vec) {  // D % 8 == 0: the whole chunk is valid and 16-byte aligned
        val = *reinterpret_cast<const uint4*>(row + d0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = load_pair(row, 0, 0, 1, d0 + 2 * i, D);
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(&dst[kk][d0]) = val;
  }
}

// q: (B, Sq, H, D); k, v: (B, Skv, H, D); out: (B, Sq, H, D), bf16, contiguous.
// MASKED and `causal` as in attn_tile_kernel; `scale_log2` = scale * log2(e)
// (the plain scale under NOSM).
template <int DP, bool MASKED, bool NOSM = false>
__global__ void __launch_bounds__(kMmaThreads)
attn_mma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ out,
                float* __restrict__ lse, const int* __restrict__ qseg,
                const int* __restrict__ kseg, int Sq, int Skv, int H, int D,
                float scale_log2, int causal) {
  static_assert(DP % 16 == 0 && DP <= 128, "head block must be a multiple of 16, <= 128");
  constexpr int NKC = DP / 16;      // 16-wide chunks of the head dim (S = Q K^T depth)
  constexpr int NDT = DP / 8;       // 8-wide tiles of the head dim (O columns)
  constexpr int NST = kMmaBK / 8;   // 8-wide key tiles of S
  __shared__ __align__(16) __nv_bfloat16 Ks[kMmaBK][DP + 8];
  __shared__ __align__(16) __nv_bfloat16 Vs[kMmaBK][DP + 8];
  __shared__ int kseg_s[kMmaBK];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;  // accumulator row within the warp's 8-row half
  const int t = lane & 3;   // accumulator column pair
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kMmaBQ;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const size_t ld = (size_t)H * D;  // stride between sequence positions
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * H + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * H + h) * D;
  const bool vec = (D % 8) == 0;

  uint32_t qf[NKC][4];
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e)
      qf[kc][e] = load_pair(qb, ld, rows[e & 1], Sq, 16 * kc + 2 * t + 8 * (e >> 1), D);
  }
  int qs[2] = {1, 1};
  if (MASKED) {
#pragma unroll
    for (int rh = 0; rh < 2; ++rh) qs[rh] = rows[rh] < Sq ? qseg[b * Sq + rows[rh]] : 0;
  }

  float o[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) o[dt][0] = o[dt][1] = o[dt][2] = o[dt][3] = 0.f;
  float m[2] = {kNegInf, kNegInf};
  float l[2] = {0.f, 0.f};
  // causal: keys above the tile's last query are never valid; their tiles
  // are skipped, loads included
  int k_end = Skv;
  if (MASKED && causal) k_end = min(Skv, q0 + kMmaBQ);

  // ldmatrix row addresses: lane L feeds row (L & 7) of 8x8 matrix (L >> 3)
  const int mi = lane & 7;
  const int mj = lane >> 3;

  for (int k0 = 0; k0 < k_end; k0 += kMmaBK) {
    __syncthreads();  // the previous tile is consumed
    load_tile<DP>(Ks, kb, k0, Skv, H, D, vec);
    load_tile<DP>(Vs, vb, k0, Skv, H, D, vec);
    if (MASKED && threadIdx.x < kMmaBK) {
      const int kj = k0 + threadIdx.x;
      kseg_s[threadIdx.x] = kj < Skv ? kseg[b * Skv + kj] : 0;
    }
    __syncthreads();

    // S = Q K^T for the warp's 16 rows x 64 keys
    float s[NST][4];
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t kf[4];  // B operands of key tiles 2np and 2np + 1
        ldmatrix_x4(kf, &Ks[16 * np + 8 * (mj >> 1) + mi][16 * kc + 8 * (mj & 1)]);
        mma_bf16(s[2 * np], qf[kc], kf[0], kf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], kf[2], kf[3]);
      }
    }

    if constexpr (NOSM) {
#pragma unroll
      for (int nt = 0; nt < NST; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = k0 + 8 * nt + 2 * t + (e & 1) < Skv ? (s[nt][e] * scale_log2) * 1e-4f : 0.f;
    } else {
      // mask, scale, online softmax (element e: row rows[e >> 1], key ... + (e & 1))
#pragma unroll
      for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kk = 8 * nt + 2 * t + (e & 1);
          const int kj = k0 + kk;
          bool ok = kj < Skv;
          if (MASKED) {
            const int rh = e >> 1;
            ok = ok && qs[rh] != 0 && kseg_s[kk] == qs[rh] && (!causal || rows[rh] >= kj);
          }
          s[nt][e] = ok ? s[nt][e] * scale_log2 : kNegInf;
        }
      }
#pragma unroll
      for (int rh = 0; rh < 2; ++rh) {
        float mx = kNegInf;
#pragma unroll
        for (int nt = 0; nt < NST; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * rh], s[nt][2 * rh + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[rh], mx);
        const float alpha = exp2f(m[rh] - m_new);
        m[rh] = m_new;
        float p_sum = 0.f;
#pragma unroll
        for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
          for (int e = 2 * rh; e < 2 * rh + 2; ++e) {
            // masked logits are exactly kNegInf; valid ones are far above it
            const float p = s[nt][e] > 0.5f * kNegInf ? exp2f(s[nt][e] - m_new) : 0.f;
            s[nt][e] = p;
            p_sum += p;
          }
        }
        l[rh] = l[rh] * alpha + p_sum;  // this thread's share of the row sum
#pragma unroll
        for (int dt = 0; dt < NDT; ++dt) {
          o[dt][2 * rh] *= alpha;
          o[dt][2 * rh + 1] *= alpha;
        }
      }
    }

    // O += P V
#pragma unroll
    for (int kc = 0; kc < kMmaBK / 16; ++kc) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp = 0; dp < NDT / 2; ++dp) {
        uint32_t vf[4];  // B operands of head-dim tiles 2dp and 2dp + 1
        ldmatrix_x4_trans(vf, &Vs[16 * kc + 8 * (mj & 1) + mi][16 * dp + 8 * (mj >> 1)]);
        mma_bf16(o[2 * dp], pf, vf[0], vf[1]);
        mma_bf16(o[2 * dp + 1], pf, vf[2], vf[3]);
      }
    }
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    float lt = l[rh];
    lt += __shfl_xor_sync(0xffffffffu, lt, 1);
    lt += __shfl_xor_sync(0xffffffffu, lt, 2);
    const int row = rows[rh];
    if (row >= Sq) continue;
    const float inv = NOSM ? 1.f : (lt > 0.f ? 1.f / lt : 0.f);
    __nv_bfloat16* orow = out + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      const int col = 8 * dt + 2 * t;
      if (col < D) orow[col] = __float2bfloat16(o[dt][2 * rh] * inv);
      if (col + 1 < D) orow[col + 1] = __float2bfloat16(o[dt][2 * rh + 1] * inv);
    }
    if (lse != nullptr && t == 0)
      lse[((size_t)b * H + h) * Sq + row] = lt > 0.f ? m[rh] * kLn2 + logf(lt) : 0.f;
  }
}

// Smallest compiled head block (multiple of 16) that holds D (D <= 128).
inline int pick_dp(int D) {
  if (D <= 16) return 16;
  if (D <= 32) return 32;
  if (D <= 64) return 64;
  if (D <= 96) return 96;
  if (D <= 112) return 112;
  if (D <= 128) return 128;
  return 0;
}

template <bool MASKED, bool NOSM = false>
cudaError_t launch_attn_mma(const void* q, const void* k, const void* v, void* out,
                            float* lse, const int* qseg, const int* kseg, int B, int Sq,
                            int Skv, int H, int D, float scale, int causal,
                            cudaStream_t stream) {
  if (B <= 0 || Sq <= 0 || Skv <= 0 || H <= 0 || D <= 0) return cudaErrorInvalidValue;
  const dim3 grid((Sq + kMmaBQ - 1) / kMmaBQ, H, B);
  const auto* qp = static_cast<const __nv_bfloat16*>(q);
  const auto* kp = static_cast<const __nv_bfloat16*>(k);
  const auto* vp = static_cast<const __nv_bfloat16*>(v);
  auto* op = static_cast<__nv_bfloat16*>(out);
  const float sl2 = NOSM ? scale : scale * kLog2e;
#define MMMM_MMA_CASE(DP_)                                                          \
  case DP_:                                                                         \
    attn_mma_kernel<DP_, MASKED, NOSM><<<grid, kMmaThreads, 0, stream>>>(           \
        qp, kp, vp, op, lse, qseg, kseg, Sq, Skv, H, D, sl2, causal);               \
    break;
  switch (pick_dp(D)) {
    MMMM_MMA_CASE(16)
    MMMM_MMA_CASE(32)
    MMMM_MMA_CASE(64)
    MMMM_MMA_CASE(96)
    MMMM_MMA_CASE(112)
    MMMM_MMA_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef MMMM_MMA_CASE
  return cudaGetLastError();
}

}  // namespace mmmm
