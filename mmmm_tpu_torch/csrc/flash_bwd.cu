// K7: the segment-id flash attention backward, as two kernels.
//
// Replaces: mmmm_tpu/ops/flash.py _flash_bwd_impl, whose two pallas_calls
// run `_dq_kernel` (K7dq) and `_dkv_kernel` (K7dkv). The sites are every
// attention of the training step under attn_impl="pallas": the LLM's causal
// attention (B, 1024, 32, 128) bf16, the EVA ViT (B, 577, 16, 112) bf16 and
// the SAM encoder (B, 512, 12, 64) fp32.
//
// Both kernels recompute the probabilities from the forward's logsumexp:
//   p  = mask ? exp(scale q.k - lse) : 0     (lse = 0 on rows with no key)
//   dp = dO.v,  ds = p (dp - delta)          (delta = rowsum(dO O), fp32,
//                                             computed by the wrapper)
//   dq = scale ds k;  dv = p^T dO;  dk = scale ds^T q
// with p and ds rounded to the operand dtype before their products, as the
// reference rounds them, and every product summed in fp32.
//
// What bounds it on an H100: at the LLM site the five products are ~86
// GFLOP against ~0.3 GB of q, k, v, O, dO, dq, dk, dv, so operations bound
// it (~0.09 ms at 989 TFLOP/s bf16); the fp32 SAM site runs on CUDA cores
// (TF32 stays off, as the reference's fp32 policy), bound at 67 TFLOP/s.
//
// Design: the reference's split, which needs no atomics, so results repeat
// run to run. K7dq: one block per (sample, head, 64-query tile) walks the
// key tiles and stops at the tile's last query on a causal site. K7dkv: one
// block per (sample, head, 64-key tile) walks the query tiles and starts at
// the first tile that can see the block on a causal site. Masks come from
// int32 segment ids and absolute positions, so no operand is padded in
// memory: rows past S and head lanes past D load as zero.
//
// bf16 runs every product on the tensor cores with warp-level mma.sync
// (attn_mma.cuh's m16n8k16 tiles and ldmatrix): 4 warps of 16 rows; the
// operand tiles of the inner loop go through shared memory, and p and ds
// reach their second product straight from the accumulator registers.
// fp32 runs on CUDA cores with attn_tile.cuh's layout (a thread pair owns a
// row, each thread half of the head dim). This is the simple form: no
// cp.async/TMA ring, no wgmma.
#include "attn_mma.cuh"
#include "attn_tile.cuh"

namespace mmmm {
namespace {

constexpr int kBwdRows = 64;     // rows a block owns (queries in K7dq, keys in K7dkv)
constexpr int kBwdInner = 32;    // rows of the streamed tile (keys in K7dq, queries in K7dkv)
constexpr int kBwdThreads = 128;

// Rows [r0, r0 + ROWS) of one head of a (B, S, H, D) bf16 tensor into a
// (ROWS, DP + 8) shared tile, zero past S and past D.
template <int ROWS, int DP>
__device__ __forceinline__ void load_rows(__nv_bfloat16 (*dst)[DP + 8],
                                          const __nv_bfloat16* __restrict__ src, int r0,
                                          int S, int H, int D, bool vec) {
  constexpr int kChunks = DP / 8;
  for (int idx = threadIdx.x; idx < ROWS * kChunks; idx += kBwdThreads) {
    const int rr = idx / kChunks;
    const int c = idx - rr * kChunks;
    const int row = r0 + rr;
    const int d0 = 8 * c;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row < S && d0 < D) {
      const __nv_bfloat16* p = src + (size_t)row * H * D;
      if (vec) {
        val = *reinterpret_cast<const uint4*>(p + d0);
      } else {
        uint32_t w[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) w[i] = load_pair(p, 0, 0, 1, d0 + 2 * i, D);
        val = make_uint4(w[0], w[1], w[2], w[3]);
      }
    }
    *reinterpret_cast<uint4*>(&dst[rr][d0]) = val;
  }
}

// Per-query scalars of K7dkv's streamed tile: segment ids (0 past S), lse
// (log2 domain) and delta.
__device__ __forceinline__ void load_row_scalars(int* seg_s, float* lse_s, float* delta_s,
                                                 const int* __restrict__ seg,
                                                 const float* __restrict__ lse,
                                                 const float* __restrict__ delta, int r0,
                                                 int S, size_t bs, size_t bhs) {
  for (int i = threadIdx.x; i < kBwdInner; i += kBwdThreads) {
    const int row = r0 + i;
    const bool in = row < S;
    seg_s[i] = in ? seg[bs + row] : 0;
    lse_s[i] = in ? lse[bhs + row] * kLog2e : 0.f;
    delta_s[i] = in ? delta[bhs + row] : 0.f;
  }
}

// ---------------------------------------------------------------------------
// bf16, tensor cores
// ---------------------------------------------------------------------------

// K7dq: dq for one (b, h, 64-query tile). Warp w owns query rows
// q0 + 16 w + {g, g + 8}; Q and dO stay in registers as mma A operands.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, int Sq, int Skv, int H, int D, float scale,
                 int causal) {
  constexpr int NKC = DP / 16;
  constexpr int NDT = DP / 8;
  constexpr int NST = kBwdInner / 8;
  __shared__ __align__(16) __nv_bfloat16 Ks[kBwdInner][DP + 8];
  __shared__ __align__(16) __nv_bfloat16 Vs[kBwdInner][DP + 8];
  __shared__ int kseg_s[kBwdInner];

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane & 7;
  const int mj = lane >> 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBwdRows;
  const int rows[2] = {q0 + warp * 16 + g, q0 + warp * 16 + g + 8};
  const size_t ld = (size_t)H * D;
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* ob = dout + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * H + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * H + h) * D;
  const bool vec = (D % 8) == 0;
  const float scale_log2 = scale * kLog2e;

  uint32_t qf[NKC][4], of[NKC][4];
#pragma unroll
  for (int kc = 0; kc < NKC; ++kc) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = 16 * kc + 2 * t + 8 * (e >> 1);
      qf[kc][e] = load_pair(qb, ld, rows[e & 1], Sq, col, D);
      of[kc][e] = load_pair(ob, ld, rows[e & 1], Sq, col, D);
    }
  }
  int qs[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const bool in = rows[rh] < Sq;
    const size_t i = ((size_t)b * H + h) * Sq + rows[rh];
    qs[rh] = in ? qseg[b * Sq + rows[rh]] : 0;
    lse2[rh] = in ? lse[i] * kLog2e : 0.f;
    dl[rh] = in ? delta[i] : 0.f;
  }

  float acc[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) acc[dt][0] = acc[dt][1] = acc[dt][2] = acc[dt][3] = 0.f;
  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kBwdRows);

  for (int k0 = 0; k0 < k_end; k0 += kBwdInner) {
    __syncthreads();
    load_rows<kBwdInner, DP>(Ks, kb, k0, Skv, H, D, vec);
    load_rows<kBwdInner, DP>(Vs, vb, k0, Skv, H, D, vec);
    if (threadIdx.x < kBwdInner) {
      const int kj = k0 + threadIdx.x;
      kseg_s[threadIdx.x] = kj < Skv ? kseg[b * Skv + kj] : 0;
    }
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 32 keys
    float s[NST][4], dp[NST][4];
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, &Ks[16 * np + 8 * (mj >> 1) + mi][16 * kc + 8 * (mj & 1)]);
        mma_bf16(s[2 * np], qf[kc], bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], qf[kc], bf[2], bf[3]);
        ldmatrix_x4(bf, &Vs[16 * np + 8 * (mj >> 1) + mi][16 * kc + 8 * (mj & 1)]);
        mma_bf16(dp[2 * np], of[kc], bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], of[kc], bf[2], bf[3]);
      }
    }
    // ds = p (dp - delta), p recomputed from lse (element e: row rows[e >> 1],
    // key k0 + 8 nt + 2 t + (e & 1))
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1;
        const int kk = 8 * nt + 2 * t + (e & 1);
        const int kj = k0 + kk;
        const bool ok = kj < Skv && qs[rh] != 0 && kseg_s[kk] == qs[rh] &&
                        (!causal || rows[rh] >= kj);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse2[rh]) : 0.f;
        s[nt][e] = p * (dp[nt][e] - dl[rh]);
      }
    }
    // dq += ds K (ds rounded to bf16)
#pragma unroll
    for (int kc = 0; kc < kBwdInner / 16; ++kc) {
      const uint32_t af[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < NDT / 2; ++dp2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &Ks[16 * kc + 8 * (mj & 1) + mi][16 * dp2 + 8 * (mj >> 1)]);
        mma_bf16(acc[2 * dp2], af, bf[0], bf[1]);
        mma_bf16(acc[2 * dp2 + 1], af, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = rows[rh];
    if (row >= Sq) continue;
    __nv_bfloat16* orow = dq + ((size_t)(b * Sq + row) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      const int col = 8 * dt + 2 * t;
      if (col < D) orow[col] = __float2bfloat16(acc[dt][2 * rh] * scale);
      if (col + 1 < D) orow[col + 1] = __float2bfloat16(acc[dt][2 * rh + 1] * scale);
    }
  }
}

// Shared memory of flash_bwd_dkv_mma: K and V tiles of the block's 64 keys,
// Q and dO tiles of 32 streamed queries, and the queries' scalars.
template <int DP>
constexpr size_t dkv_mma_smem() {
  return (size_t)(2 * kBwdRows + 2 * kBwdInner) * (DP + 8) * sizeof(__nv_bfloat16) +
         3 * kBwdInner * sizeof(float);
}

// K7dkv: dk, dv for one (b, h, 64-key tile). Warp w owns key rows
// k0 + 16 w + {g, g + 8}; its K and V rows are mma A operands read from
// shared memory (ldmatrix), which keeps the two (16, DP) fp32 accumulators
// in registers.
template <int DP>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_mma(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                  const int* __restrict__ qseg, const int* __restrict__ kseg,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int Sq,
                  int Skv, int H, int D, float scale, int causal) {
  constexpr int NKC = DP / 16;
  constexpr int NDT = DP / 8;
  constexpr int NST = kBwdInner / 8;
  using Row = __nv_bfloat16[DP + 8];
  extern __shared__ __align__(16) unsigned char smem[];
  Row* Ks = reinterpret_cast<Row*>(smem);
  Row* Vs = Ks + kBwdRows;
  Row* Qs = Vs + kBwdRows;
  Row* Os = Qs + kBwdInner;
  float* lse_s = reinterpret_cast<float*>(Os + kBwdInner);
  float* delta_s = lse_s + kBwdInner;
  int* qseg_s = reinterpret_cast<int*>(delta_s + kBwdInner);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane & 7;
  const int mj = lane >> 3;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kBwdRows;
  const int keys[2] = {k0 + warp * 16 + g, k0 + warp * 16 + g + 8};
  const __nv_bfloat16* qb = q + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* ob = dout + ((size_t)b * Sq * H + h) * D;
  const __nv_bfloat16* kb = k + ((size_t)b * Skv * H + h) * D;
  const __nv_bfloat16* vb = v + ((size_t)b * Skv * H + h) * D;
  const bool vec = (D % 8) == 0;
  const float scale_log2 = scale * kLog2e;
  const size_t bhs = ((size_t)b * H + h) * Sq;

  load_rows<kBwdRows, DP>(Ks, kb, k0, Skv, H, D, vec);
  load_rows<kBwdRows, DP>(Vs, vb, k0, Skv, H, D, vec);
  int ks[2];
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) ks[rh] = keys[rh] < Skv ? kseg[b * Skv + keys[rh]] : 0;

  float accK[NDT][4], accV[NDT][4];
#pragma unroll
  for (int dt = 0; dt < NDT; ++dt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[dt][e] = accV[dt][e] = 0.f;
  }
  // causal: queries before the block's first key see none of its keys
  const int q_begin = causal ? (k0 / kBwdInner) * kBwdInner : 0;
  const int arow = warp * 16 + 8 * (mj & 1) + mi;  // this lane's ldmatrix row of K/V

  for (int q0 = q_begin; q0 < Sq; q0 += kBwdInner) {
    __syncthreads();
    load_rows<kBwdInner, DP>(Qs, qb, q0, Sq, H, D, vec);
    load_rows<kBwdInner, DP>(Os, ob, q0, Sq, H, D, vec);
    load_row_scalars(qseg_s, lse_s, delta_s, qseg, lse, delta, q0, Sq, (size_t)b * Sq, bhs);
    __syncthreads();

    // S^T = K Q^T and dP^T = V dO^T for the warp's 16 keys x 32 queries
    float s[NST][4], dp[NST][4];
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) s[nt][e] = dp[nt][e] = 0.f;
    }
#pragma unroll
    for (int kc = 0; kc < NKC; ++kc) {
      uint32_t kf[4], vf[4];
      ldmatrix_x4(kf, &Ks[arow][16 * kc + 8 * (mj >> 1)]);
      ldmatrix_x4(vf, &Vs[arow][16 * kc + 8 * (mj >> 1)]);
#pragma unroll
      for (int np = 0; np < NST / 2; ++np) {
        uint32_t bf[4];
        ldmatrix_x4(bf, &Qs[16 * np + 8 * (mj >> 1) + mi][16 * kc + 8 * (mj & 1)]);
        mma_bf16(s[2 * np], kf, bf[0], bf[1]);
        mma_bf16(s[2 * np + 1], kf, bf[2], bf[3]);
        ldmatrix_x4(bf, &Os[16 * np + 8 * (mj >> 1) + mi][16 * kc + 8 * (mj & 1)]);
        mma_bf16(dp[2 * np], vf, bf[0], bf[1]);
        mma_bf16(dp[2 * np + 1], vf, bf[2], bf[3]);
      }
    }
    // element e: key keys[e >> 1], query q0 + 8 nt + 2 t + (e & 1); s keeps
    // p, dp becomes ds
#pragma unroll
    for (int nt = 0; nt < NST; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int rh = e >> 1;
        const int qq = 8 * nt + 2 * t + (e & 1);
        const int qi = q0 + qq;
        const bool ok = qi < Sq && ks[rh] != 0 && qseg_s[qq] == ks[rh] &&
                        (!causal || qi >= keys[rh]);
        const float p = ok ? exp2f(s[nt][e] * scale_log2 - lse_s[qq]) : 0.f;
        s[nt][e] = p;
        dp[nt][e] = p * (dp[nt][e] - delta_s[qq]);
      }
    }
    // dv += P^T dO and dk += dS^T Q (P and dS rounded to bf16)
#pragma unroll
    for (int kc = 0; kc < kBwdInner / 16; ++kc) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kc][0], s[2 * kc][1]),
                              pack_bf16(s[2 * kc][2], s[2 * kc][3]),
                              pack_bf16(s[2 * kc + 1][0], s[2 * kc + 1][1]),
                              pack_bf16(s[2 * kc + 1][2], s[2 * kc + 1][3])};
      const uint32_t sf[4] = {pack_bf16(dp[2 * kc][0], dp[2 * kc][1]),
                              pack_bf16(dp[2 * kc][2], dp[2 * kc][3]),
                              pack_bf16(dp[2 * kc + 1][0], dp[2 * kc + 1][1]),
                              pack_bf16(dp[2 * kc + 1][2], dp[2 * kc + 1][3])};
#pragma unroll
      for (int dp2 = 0; dp2 < NDT / 2; ++dp2) {
        uint32_t bf[4];
        ldmatrix_x4_trans(bf, &Os[16 * kc + 8 * (mj & 1) + mi][16 * dp2 + 8 * (mj >> 1)]);
        mma_bf16(accV[2 * dp2], pf, bf[0], bf[1]);
        mma_bf16(accV[2 * dp2 + 1], pf, bf[2], bf[3]);
        ldmatrix_x4_trans(bf, &Qs[16 * kc + 8 * (mj & 1) + mi][16 * dp2 + 8 * (mj >> 1)]);
        mma_bf16(accK[2 * dp2], sf, bf[0], bf[1]);
        mma_bf16(accK[2 * dp2 + 1], sf, bf[2], bf[3]);
      }
    }
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int key = keys[rh];
    if (key >= Skv) continue;
    const size_t off = ((size_t)(b * Skv + key) * H + h) * D;
#pragma unroll
    for (int dt = 0; dt < NDT; ++dt) {
      const int col = 8 * dt + 2 * t;
      if (col < D) {
        dk[off + col] = __float2bfloat16(accK[dt][2 * rh] * scale);
        dv[off + col] = __float2bfloat16(accV[dt][2 * rh]);
      }
      if (col + 1 < D) {
        dk[off + col + 1] = __float2bfloat16(accK[dt][2 * rh + 1] * scale);
        dv[off + col + 1] = __float2bfloat16(accV[dt][2 * rh + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// fp32, CUDA cores
// ---------------------------------------------------------------------------

// Row `row` (or zeros past S) of one head into this thread's half of the
// padded head dim: x[j][e] = src[8 j + 4 half + e].
template <int NJ>
__device__ __forceinline__ void load_half_row(float (&x)[NJ][4], const float* __restrict__ src,
                                              size_t off, bool in, int half, int D) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * j + 4 * half + e;
      x[j][e] = (in && d < D) ? src[off + d] : 0.f;
    }
  }
}

template <int NJ>
__device__ __forceinline__ float half_dot(const float (&x)[NJ][4], const float* __restrict__ row,
                                          int half) {
  float part = 0.f;
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 y = *reinterpret_cast<const float4*>(&row[8 * j + 4 * half]);
    part += x[j][0] * y.x + x[j][1] * y.y + x[j][2] * y.z + x[j][3] * y.w;
  }
  return part + __shfl_xor_sync(0xffffffffu, part, 1);
}

template <int NJ>
__device__ __forceinline__ void axpy_half(float (&acc)[NJ][4], float a,
                                          const float* __restrict__ row, int half) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
    const float4 y = *reinterpret_cast<const float4*>(&row[8 * j + 4 * half]);
    acc[j][0] += a * y.x;
    acc[j][1] += a * y.y;
    acc[j][2] += a * y.z;
    acc[j][3] += a * y.w;
  }
}

// kBwdInner rows [r0, r0 + kBwdInner) of one head of a (B, S, H, D) fp32
// tensor into a (kBwdInner, DP) shared tile, zero past S and past D.
template <int DP>
__device__ __forceinline__ void load_rows_f32(float (*dst)[DP], const float* __restrict__ src,
                                              int r0, int S, int H, int D) {
  for (int idx = threadIdx.x; idx < kBwdInner * DP; idx += kBwdThreads) {
    const int rr = idx / DP;
    const int d = idx - rr * DP;
    const int row = r0 + rr;
    dst[rr][d] = (row < S && d < D) ? src[(size_t)row * H * D + d] : 0.f;
  }
}

template <int NJ>
__device__ __forceinline__ void store_half_row(float* __restrict__ dst, size_t off,
                                               const float (&x)[NJ][4], float mul, int half,
                                               int D) {
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int d = 8 * j + 4 * half + e;
      if (d < D) dst[off + d] = x[j][e] * mul;
    }
  }
}

// K7dq, fp32: the thread pair (2r, 2r+1) owns query q0 + r.
template <int NJ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_f32(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v, const float* __restrict__ dout,
                 const int* __restrict__ qseg, const int* __restrict__ kseg,
                 const float* __restrict__ lse, const float* __restrict__ delta,
                 float* __restrict__ dq, int Sq, int Skv, int H, int D, float scale,
                 int causal) {
  constexpr int DP = 8 * NJ;
  __shared__ __align__(16) float Ks[kBwdInner][DP];
  __shared__ __align__(16) float Vs[kBwdInner][DP];
  __shared__ int kseg_s[kBwdInner];

  const int half = threadIdx.x & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int q0 = blockIdx.x * kBwdRows;
  const int qi = q0 + (threadIdx.x >> 1);
  const bool q_ok = qi < Sq;
  const size_t q_off = ((size_t)(b * Sq + (q_ok ? qi : 0)) * H + h) * D;
  const size_t kv_base = (size_t)b * Skv * H * D + (size_t)h * D;

  float qr[NJ][4], dor[NJ][4], acc[NJ][4];
  load_half_row<NJ>(qr, q, q_off, q_ok, half, D);
  load_half_row<NJ>(dor, dout, q_off, q_ok, half, D);
#pragma unroll
  for (int j = 0; j < NJ; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  const size_t i = ((size_t)b * H + h) * Sq + qi;
  const int qs = q_ok ? qseg[b * Sq + qi] : 0;
  const float l = q_ok ? lse[i] : 0.f;
  const float dl = q_ok ? delta[i] : 0.f;
  int k_end = Skv;
  if (causal) k_end = min(Skv, q0 + kBwdRows);

  for (int k0 = 0; k0 < k_end; k0 += kBwdInner) {
    __syncthreads();
    load_rows_f32<DP>(Ks, k + kv_base, k0, Skv, H, D);
    load_rows_f32<DP>(Vs, v + kv_base, k0, Skv, H, D);
    if (threadIdx.x < kBwdInner) {
      const int kj = k0 + threadIdx.x;
      kseg_s[threadIdx.x] = kj < Skv ? kseg[b * Skv + kj] : 0;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBwdInner; ++kk) {
      const float s = half_dot<NJ>(qr, Ks[kk], half);
      const float dp = half_dot<NJ>(dor, Vs[kk], half);
      const int kj = k0 + kk;
      const bool ok = kj < Skv && qs != 0 && kseg_s[kk] == qs && (!causal || qi >= kj);
      const float p = ok ? expf(s * scale - l) : 0.f;
      axpy_half<NJ>(acc, p * (dp - dl), Ks[kk], half);
    }
  }
  if (q_ok) store_half_row<NJ>(dq, q_off, acc, scale, half, D);
}

// K7dkv, fp32: the thread pair (2r, 2r+1) owns key k0 + r.
template <int NJ>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkv_f32(const float* __restrict__ q, const float* __restrict__ k,
                  const float* __restrict__ v, const float* __restrict__ dout,
                  const int* __restrict__ qseg, const int* __restrict__ kseg,
                  const float* __restrict__ lse, const float* __restrict__ delta,
                  float* __restrict__ dk, float* __restrict__ dv, int Sq, int Skv, int H,
                  int D, float scale, int causal) {
  constexpr int DP = 8 * NJ;
  __shared__ __align__(16) float Qs[kBwdInner][DP];
  __shared__ __align__(16) float Os[kBwdInner][DP];
  __shared__ float lse_s[kBwdInner];
  __shared__ float delta_s[kBwdInner];
  __shared__ int qseg_s[kBwdInner];

  const int half = threadIdx.x & 1;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int k0 = blockIdx.x * kBwdRows;
  const int kj = k0 + (threadIdx.x >> 1);
  const bool k_ok = kj < Skv;
  const size_t k_off = ((size_t)(b * Skv + (k_ok ? kj : 0)) * H + h) * D;
  const size_t q_base = (size_t)b * Sq * H * D + (size_t)h * D;
  const size_t bhs = ((size_t)b * H + h) * Sq;

  float kr[NJ][4], vr[NJ][4], accK[NJ][4], accV[NJ][4];
  load_half_row<NJ>(kr, k, k_off, k_ok, half, D);
  load_half_row<NJ>(vr, v, k_off, k_ok, half, D);
#pragma unroll
  for (int j = 0; j < NJ; ++j) {
#pragma unroll
    for (int e = 0; e < 4; ++e) accK[j][e] = accV[j][e] = 0.f;
  }
  const int ks = k_ok ? kseg[b * Skv + kj] : 0;
  const int q_begin = causal ? (k0 / kBwdInner) * kBwdInner : 0;

  for (int q0 = q_begin; q0 < Sq; q0 += kBwdInner) {
    __syncthreads();
    load_rows_f32<DP>(Qs, q + q_base, q0, Sq, H, D);
    load_rows_f32<DP>(Os, dout + q_base, q0, Sq, H, D);
    load_row_scalars(qseg_s, lse_s, delta_s, qseg, lse, delta, q0, Sq, (size_t)b * Sq, bhs);
    __syncthreads();
#pragma unroll 4
    for (int qq = 0; qq < kBwdInner; ++qq) {
      const float s = half_dot<NJ>(kr, Qs[qq], half);
      const float dp = half_dot<NJ>(vr, Os[qq], half);
      const int qi = q0 + qq;
      const bool ok = qi < Sq && ks != 0 && qseg_s[qq] == ks && (!causal || qi >= kj);
      // lse_s holds lse * log2(e)
      const float p = ok ? exp2f(s * scale * kLog2e - lse_s[qq]) : 0.f;
      axpy_half<NJ>(accV, p, Os[qq], half);
      axpy_half<NJ>(accK, p * (dp - delta_s[qq]), Qs[qq], half);
    }
  }
  if (k_ok) {
    store_half_row<NJ>(dk, k_off, accK, scale, half, D);
    store_half_row<NJ>(dv, k_off, accV, 1.f, half, D);
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

template <int DP>
cudaError_t dq_mma(const BwdArgs& a, void* dq, cudaStream_t st) {
  const dim3 grid((a.Sq + kBwdRows - 1) / kBwdRows, a.H, a.B);
  using T = __nv_bfloat16;
  flash_bwd_dq_mma<DP><<<grid, kBwdThreads, 0, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.qseg, a.kseg, a.lse, a.delta, static_cast<T*>(dq),
      a.Sq, a.Skv, a.H, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <int DP>
cudaError_t dkv_mma(const BwdArgs& a, void* dk, void* dv, cudaStream_t st) {
  const dim3 grid((a.Skv + kBwdRows - 1) / kBwdRows, a.H, a.B);
  constexpr size_t smem = dkv_mma_smem<DP>();
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_mma<DP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  using T = __nv_bfloat16;
  flash_bwd_dkv_mma<DP><<<grid, kBwdThreads, smem, st>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      static_cast<const T*>(a.dout), a.qseg, a.kseg, a.lse, a.delta, static_cast<T*>(dk),
      static_cast<T*>(dv), a.Sq, a.Skv, a.H, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t dq_f32(const BwdArgs& a, void* dq, cudaStream_t st) {
  const dim3 grid((a.Sq + kBwdRows - 1) / kBwdRows, a.H, a.B);
  flash_bwd_dq_f32<NJ><<<grid, kBwdThreads, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.qseg, a.kseg,
      a.lse, a.delta, static_cast<float*>(dq), a.Sq, a.Skv, a.H, a.D, a.scale, a.causal);
  return cudaGetLastError();
}

template <int NJ>
cudaError_t dkv_f32(const BwdArgs& a, void* dk, void* dv, cudaStream_t st) {
  const dim3 grid((a.Skv + kBwdRows - 1) / kBwdRows, a.H, a.B);
  flash_bwd_dkv_f32<NJ><<<grid, kBwdThreads, 0, st>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), static_cast<const float*>(a.dout), a.qseg, a.kseg,
      a.lse, a.delta, static_cast<float*>(dk), static_cast<float*>(dv), a.Sq, a.Skv, a.H,
      a.D, a.scale, a.causal);
  return cudaGetLastError();
}

bool valid(const BwdArgs& a) {
  return a.B > 0 && a.Sq > 0 && a.Skv > 0 && a.H > 0 && a.D > 0 && a.D <= 128;
}

}  // namespace
}  // namespace mmmm

// q, dout: (B, Sq, H, D); k, v: (B, Skv, H, D), all bf16 (is_bf16) or fp32,
// contiguous; q_segments (B, Sq), kv_segments (B, Skv) int32; lse, delta
// (B, H, Sq) fp32 (lse of the scaled logits, 0 on rows with no valid key;
// delta = rowsum(dout * out)). Writes dq (B, Sq, H, D) in q's dtype.
extern "C" int mmmm_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* q_segments,
                                 const void* kv_segments, const void* lse, const void* delta,
                                 void* dq, int B, int Sq, int Skv, int H, int D, float scale,
                                 int causal, int is_bf16, void* stream) {
  using namespace mmmm;
  const BwdArgs a{q, k, v, dout, static_cast<const int*>(q_segments),
                  static_cast<const int*>(kv_segments), static_cast<const float*>(lse),
                  static_cast<const float*>(delta), B, Sq, Skv, H, D, scale, causal};
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    switch (pick_dp(D)) {
      case 16: err = dq_mma<16>(a, dq, st); break;
      case 32: err = dq_mma<32>(a, dq, st); break;
      case 64: err = dq_mma<64>(a, dq, st); break;
      case 96: err = dq_mma<96>(a, dq, st); break;
      case 112: err = dq_mma<112>(a, dq, st); break;
      case 128: err = dq_mma<128>(a, dq, st); break;
    }
  } else {
    switch (pick_nj(D)) {
      case 2: err = dq_f32<2>(a, dq, st); break;
      case 4: err = dq_f32<4>(a, dq, st); break;
      case 8: err = dq_f32<8>(a, dq, st); break;
      case 11: err = dq_f32<11>(a, dq, st); break;
      case 14: err = dq_f32<14>(a, dq, st); break;
      case 16: err = dq_f32<16>(a, dq, st); break;
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
  if (!valid(a)) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  if (is_bf16) {
    switch (pick_dp(D)) {
      case 16: err = dkv_mma<16>(a, dk, dv, st); break;
      case 32: err = dkv_mma<32>(a, dk, dv, st); break;
      case 64: err = dkv_mma<64>(a, dk, dv, st); break;
      case 96: err = dkv_mma<96>(a, dk, dv, st); break;
      case 112: err = dkv_mma<112>(a, dk, dv, st); break;
      case 128: err = dkv_mma<128>(a, dk, dv, st); break;
    }
  } else {
    switch (pick_nj(D)) {
      case 2: err = dkv_f32<2>(a, dk, dv, st); break;
      case 4: err = dkv_f32<4>(a, dk, dv, st); break;
      case 8: err = dkv_f32<8>(a, dk, dv, st); break;
      case 11: err = dkv_f32<11>(a, dk, dv, st); break;
      case 14: err = dkv_f32<14>(a, dk, dv, st); break;
      case 16: err = dkv_f32<16>(a, dk, dv, st); break;
    }
  }
  return static_cast<int>(err);
}
