// Tiles shared by the attention kernels that walk (B, S, H, D) operands:
// the flash forward K3 and dense attention K4 (attn_fwd.cuh) and the flash
// backward K7 (flash_bwd.cu). A block owns a run of rows of one (sample,
// head) and streams the other side's rows through a ring in shared memory.
//
// bf16 (wgmma): 4-d TMA tensor maps over (B, S, H, D), boxes of 64 head
// lanes x R rows with the 128-byte swizzle, whose out-of-range fill gives
// the zero rows past S and zero lanes past D; a tile of R rows x DP lanes is
// DP / 64 such boxes. Rows are read by `wgmma` as K-major operands (the
// head dim contracted) or MN-major ones (the rows contracted).
//
// fp32 (CUDA cores): 256 threads own 64 rows; streamed tiles of 32 rows
// arrive through 16-byte cp.async copies that fill zeros past S and D, into
// rows padded by 4 floats so that the micro-tile reads below do not
// conflict. Thread (ty, tx) of a 16 x 16 grid owns rows ty + 16 i and
// streamed rows (or head lanes) tx + 16 j.
#pragma once

#include "common.cuh"
#include "hopper.cuh"

namespace mmmm {

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

// bf16 stores of a 64 x DP accumulator into rows of a (B, S, H, D) tensor,
// the thread's two rows times mul_lo and mul_hi: a 4 x 4 exchange in each
// quad makes 8 consecutive columns a thread, one 16-byte store (D % 8 == 0).
template <int DP>
__device__ __forceinline__ void store_rows(const float (&acc)[DP / 2], float mul_lo, float mul_hi,
                                           __nv_bfloat16* base, size_t ld, int row0, int S,
                                           int D) {
  const int lane = threadIdx.x & 31;
  const int warp = (threadIdx.x >> 5) & 3;
  const int g = lane >> 2;
  const int qd = lane & 3;
#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = row0 + 16 * warp + g + 8 * rh;
    const float mul = rh ? mul_hi : mul_lo;
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

// A 4-d tensor map over a (B, S, H, D) bf16 tensor, boxes of 64 lanes x
// `rows` rows, 128-byte swizzle.
inline bool bshd_map(CUtensorMap* map, const void* base, int B, int S, int H, int D, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)S, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2,
                                 (cuuint64_t)S * H * D * 2};
  const cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  return hop::make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, base, dims, strides, box,
                       CU_TENSOR_MAP_SWIZZLE_128B);
}

// ---------------------------------------------------------------------------
// fp32, CUDA cores
// ---------------------------------------------------------------------------

constexpr int kF32Own = 64;     // rows a block owns
constexpr int kF32Stream = 32;  // rows of a streamed tile
constexpr int kF32Stages = 3;
constexpr int kF32Threads = 256;

// Blocks an SM runs of the fp32 kernels: two up to D = 64 (128 registers
// a thread, at most 113 KB of shared memory each), one above.
constexpr int f32_blocks(int nj) { return nj <= 4 ? 2 : 1; }

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

}  // namespace mmmm
