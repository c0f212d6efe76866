// K11: the W4A16 product y = x @ W over int4-packed weights with one fp32
// scale per (group of input rows, output column).
//
// Replaces: mmmm_tpu/ops/w4_matmul.py w4_matmul (Pallas body `_w4_kernel`).
// Layout ("split halves"): packed byte q4[i, n] holds row i of W in its low
// nibble and row K/2 + i in its high nibble. Both kernels compute what the
// reference runs off the TPU (`w4_matmul_xla`): W[k, n] = nibble * scale,
// rounded to x's dtype (the TPU kernel rounds to bf16 whatever x's dtype),
// products summed in fp32, the result written in x's dtype.
//
// What bounds it on an H100: at decode rows (M = 4) bytes, the packed
// weight and its scales read once (23 MB on 4096 x 11008: ~7 us at
// 3.35 TB/s); at prefill rows (M = 290, 584) operations on the tensor cores.
//
// Design. The dequantization happens after the read, in registers, which
// is the point of the TPU kernel too.
//  - mmmm_w4_gemv, bf16 x, M <= 16 (the decode rows; w4_gemv_mma_kernel):
//    the transposed product y^T = W^T x^T on the tensor cores (mma.sync
//    m16n8k16), one launch. Each warp stages an iteration's packed bytes
//    (32 packed rows x 64 columns) and the matching columns of x in shared
//    memory with cp.async, the next iteration's in flight while this one
//    computes. A lane reads 8 packed bytes (8 weight columns) of two
//    consecutive packed rows for each of the iteration's 4 k-steps (8
//    packed rows each); a byte_perm pairs the two rows' bytes of 2
//    columns, so each of the 4 n-tiles of a k-step gets its A fragment (2
//    columns x 4 k: both rows' low and high nibbles) with no shuffle. The
//    weight is dequantized exactly as w4_matmul_xla does (nibble * scale
//    in fp32, rounded to bf16 by the pair convert: dequant_pair, which
//    K11mma shares); x rows
//    are the mma's columns (B). The dequantization's issue, not the bytes,
//    sets the pace, so the kernel is built for many warps: at most 80
//    registers, three blocks of 8 warps an SM. A warp owns 64 columns and a
//    balanced share of the K steps; the 8 warps of a block and the 2
//    blocks of a thread-block cluster (ops/w4_matmul.py gemv_cluster)
//    split K, and their fp32 partials are summed in a fixed order, the
//    warps' in shared memory, the two blocks' through distributed shared
//    memory, and written in bf16. No workspace; two runs give the same
//    bits.
//  - mmmm_w4_gemv, fp32 x (w4_gemv_kernel, CUDA cores, any M): a block of 8
//    warps owns 512 columns and one scale group of packed rows; each lane
//    reads 16 packed bytes (16 columns) of a row with one 16-byte load,
//    sign-extends both nibbles, scales them with the two scales it loaded
//    once and feeds every x row of the block (kRows) from shared memory.
//    The 8 warps' sums meet in shared memory; each group's partial product
//    goes to a workspace and a second kernel sums the groups in a fixed
//    order (two launches).
//  - mmmm_w4_mma (K11mma; bf16 x, M > 16): warp-specialized wgmma on
//    the transposed product. A producer warp keeps a TMA ring of the x
//    tiles and the packed tiles in flight; two consumer warpgroups load
//    packed bytes with ldmatrix, dequantize them in registers into wgmma's
//    A operand (weight columns as rows), run wgmma m64n128k16 against the
//    x tile in shared memory, and store bf16 with 16-byte stores. Scales
//    are read once per scale group.
#include <cooperative_groups.h>

#include "common.cuh"
#include "hopper.cuh"

namespace cg = cooperative_groups;
namespace hop = mmmm::hop;

namespace {

constexpr int kRows = 4;      // x rows per GEMV block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 512;    // columns per GEMV block (32 lanes x 16)

// the signed low and high nibbles of byte e (0..15) of a 16-byte load
__device__ __forceinline__ void nibbles(const uint4& raw, int e, int& lo, int& hi) {
  const unsigned w = e < 4 ? raw.x : (e < 8 ? raw.y : (e < 12 ? raw.z : raw.w));
  const int byte = static_cast<int>(static_cast<signed char>(w >> (8 * (e & 3))));
  lo = static_cast<int>(static_cast<unsigned>(byte) << 28) >> 28;
  hi = byte >> 4;  // arithmetic shift of the sign-extended byte
}

__device__ __forceinline__ void load16f(const float* p, float out[16]) {
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float4 v = *reinterpret_cast<const float4*>(p + 4 * c);
    out[4 * c] = v.x;
    out[4 * c + 1] = v.y;
    out[4 * c + 2] = v.z;
    out[4 * c + 3] = v.w;
  }
}

// grid (ceil(N / kCols), K / 2 / group, ceil(M / kRows)); dynamic shared
// memory (kRows * 2 * group + kWarps * kCols) floats.
// part: (K / 2 / group, M, N) fp32, the partial product of each group.
__global__ void __launch_bounds__(kThreads)
w4_gemv_kernel(const float* __restrict__ x, const uint8_t* __restrict__ q4,
               const float* __restrict__ s4, float* __restrict__ part, int M, int K, int N,
               int group) {
  extern __shared__ __align__(16) float smem[];
  float* xs = smem;                        // [kRows][2][group]: lo, hi columns
  float* red = smem + kRows * 2 * group;   // [kWarps][kCols]
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int grp = blockIdx.y;
  const int m0 = blockIdx.z * kRows;
  const int half = K / 2;
  const int p0 = grp * group;  // first packed row of the group
  const int n0 = blockIdx.x * kCols + lane * 16;

  for (int i = threadIdx.x; i < kRows * 2 * group; i += kThreads) {
    const int m = i / (2 * group);
    const int r = i - m * 2 * group;
    const int col = r < group ? p0 + r : half + p0 + (r - group);
    xs[i] = m0 + m < M ? x[(size_t)(m0 + m) * K + col] : 0.f;
  }
  __syncthreads();

  float acc[kRows][16];
#pragma unroll
  for (int m = 0; m < kRows; ++m)
#pragma unroll
    for (int e = 0; e < 16; ++e) acc[m][e] = 0.f;
  if (n0 < N) {
    float slo[16], shi[16];
    load16f(s4 + (size_t)grp * N + n0, slo);
    load16f(s4 + (size_t)(half / group + grp) * N + n0, shi);
    for (int r = warp; r < group; r += kWarps) {
      const uint4 raw = *reinterpret_cast<const uint4*>(q4 + (size_t)(p0 + r) * N + n0);
      float xl[kRows], xh[kRows];
#pragma unroll
      for (int m = 0; m < kRows; ++m) {
        xl[m] = xs[(2 * m) * group + r];
        xh[m] = xs[(2 * m + 1) * group + r];
      }
#pragma unroll
      for (int e = 0; e < 16; ++e) {
        int lo, hi;
        nibbles(raw, e, lo, hi);
        const float wl = static_cast<float>(lo) * slo[e];
        const float wh = static_cast<float>(hi) * shi[e];
#pragma unroll
        for (int m = 0; m < kRows; ++m) acc[m][e] = fmaf(xh[m], wh, fmaf(xl[m], wl, acc[m][e]));
      }
    }
  }

#pragma unroll
  for (int m = 0; m < kRows; ++m) {
    if (m0 + m < M) {  // uniform across the block
      float4* dst = reinterpret_cast<float4*>(red + warp * kCols + lane * 16);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        dst[c] = make_float4(acc[m][4 * c], acc[m][4 * c + 1], acc[m][4 * c + 2],
                             acc[m][4 * c + 3]);
      __syncthreads();
      for (int c = threadIdx.x; c < kCols; c += kThreads) {
        const int n = blockIdx.x * kCols + c;
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[w * kCols + c];
        if (n < N) part[((size_t)grp * M + m0 + m) * N + n] = sum;
      }
      __syncthreads();
    }
  }
}

__global__ void w4_sum_groups_kernel(const float* __restrict__ part, float* __restrict__ out,
                                     int groups, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += part[(size_t)g * MN + i];
  out[i] = s;
}

int launch_gemv_f32(const void* x, const void* q4, const void* s4, void* out, void* part, int M,
                    int K, int N, int group, cudaStream_t st) {
  const int groups = K / 2 / group;
  const size_t smem = sizeof(float) * (kRows * 2 * group + kWarps * kCols);
  const dim3 grid((N + kCols - 1) / kCols, groups, (M + kRows - 1) / kRows);
  auto* kern = w4_gemv_kernel;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, kThreads, smem, st>>>(static_cast<const float*>(x), static_cast<const uint8_t*>(q4),
                                     static_cast<const float*>(s4), static_cast<float*>(part),
                                     M, K, N, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = M * N;
  w4_sum_groups_kernel<<<(mn + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                         static_cast<float*>(out), groups, mn);
  return static_cast<int>(cudaGetLastError());
}

// ---- K11's decode rows: mma.sync over weights dequantized in registers ------------
constexpr int kGvWarps = 8;
constexpr int kGvThreads = kGvWarps * 32;
constexpr int kGvIter = 32;    // packed rows an iteration: 4 k-steps of 8

constexpr int kGvLane = 8;     // weight columns of a lane (8 bytes of a packed row)
constexpr int kGvCols = 8 * kGvLane;  // weight columns of a warp and of a block

// A register of packed bytes (k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1)
// -> the A fragment's two registers (rows n and n + 1, k and k + 1) of half
// hf: W = nibble * scale in fp32, rounded to bf16 once. A nibble becomes a
// float exactly through its bits: 0x4B0000xx is 2^23 + xx.
__device__ __forceinline__ void dequant_pair(uint32_t r, int hf, float se, float so, uint32_t& a_e,
                                             uint32_t& a_o) {
  const uint32_t nib = ((r >> (4 * hf)) & 0x0F0F0F0Fu) ^ 0x08080808u;  // nibble + 8, a byte each
  float f[4];
#pragma unroll
  for (int b = 0; b < 4; ++b)
    f[b] = (__uint_as_float(__byte_perm(nib, 0x4B000000u, 0x7540u | b)) - 8388616.f) *
           ((b & 1) ? so : se);
  a_e = hop::pack2(f[0], f[2]);
  a_o = hop::pack2(f[1], f[3]);
}

// Each warp stages its iterations' packed bytes (32 rows x 64 columns) and
// x's matching columns in shared memory with cp.async, two iterations in
// flight, so that the next iteration's loads overlap this one's
// dequantization. Staged rows are padded to 80 bytes, so that the lanes'
// 8-byte (and x's 4-byte) reads fall in distinct banks. After the loop a
// warp's fp32 partial takes the place of its ring.
constexpr int kRgRow = 80;                  // bytes of a staged row (64 used)
constexpr int kRgW = kGvIter * kRgRow;      // the packed tile of an iteration
template <int MT>
struct RingCfg {
  static constexpr int kSlot = kRgW + 2 * 8 * MT * kRgRow;  // + x rows (2 halves each)
  static constexpr int kStages = 2;
  static constexpr size_t kSmem =
      (size_t)kGvWarps * kStages * kSlot + sizeof(float) * 8 * MT * kGvCols;  // + block sum
};

// grid (cluster, ceil(N / 64)), clusters of `cluster` blocks along x, 256
// threads, RingCfg<MT>::kSmem bytes. MT n8 blocks of x rows: M <= 8 MT. At
// M <= 8 at most 80 registers: three blocks (24 warps) an SM.
template <int MT>
__global__ void __launch_bounds__(kGvThreads, MT == 1 ? 3 : 2)
w4_gemv_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
                    const float* __restrict__ s4, __nv_bfloat16* __restrict__ out, int M, int K,
                    int N, int group) {
  using C = RingCfg<MT>;
  constexpr int LC = kGvLane;
  constexpr int COLS = kGvCols;
  constexpr int TT = LC / 2;
  static_assert(8 * MT * COLS * sizeof(float) <= C::kStages * C::kSlot, "partial fits the ring");
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char rsm[];
  const int rank = blockIdx.x;
  const int nclu = gridDim.x;
  const int n0 = blockIdx.y * COLS;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int qd = lane & 3;
  unsigned char* ring = rsm + (size_t)warp * C::kStages * C::kSlot;
  float* bsum = reinterpret_cast<float*>(rsm + (size_t)kGvWarps * C::kStages * C::kSlot);
  const int half = K / 2;
  const int iters = half / kGvIter;
  const int wi = rank * kGvWarps + warp;
  const int nw = nclu * kGvWarps;
  const int it0 = (int)((long long)iters * wi / nw);
  const int nit = (int)((long long)iters * (wi + 1) / nw) - it0;
  const int col = n0 + LC * g;
  const bool col_ok = col < N;

  // iteration i into slot i % 2: 128 16-byte pieces of packed rows (4 a lane),
  // then 8 pieces of each x row m < M (both halves' 32 columns)
  auto prefetch = [&](int i) {
    if (i < nit) {
      const int p = (it0 + i) * kGvIter;
      unsigned char* slot = ring + (i % C::kStages) * C::kSlot;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = lane + 32 * j;  // piece c: row c / 4, 16-byte chunk c % 4
        const int r = c >> 2, ch = c & 3;
        const bool ok = n0 + 16 * ch < N;
        hop::cp_async16(slot + r * kRgRow + 16 * ch,
                        ok ? q4 + (size_t)(p + r) * N + n0 + 16 * ch : q4, ok ? 16 : 0);
      }
      for (int c = lane; c < 8 * M; c += 32) {
        const int m = c >> 3, hf = (c >> 2) & 1, ch = c & 3;
        hop::cp_async16(slot + kRgW + (2 * m + hf) * kRgRow + 16 * ch,
                        x + (size_t)m * K + hf * half + p + 8 * ch, 16);
      }
    }
    hop::cp_async_commit();  // an empty group past the end keeps the count
  };
  prefetch(0);
  prefetch(1);

  float acc[MT][TT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tt = 0; tt < TT; ++tt)
      acc[mt][tt][0] = acc[mt][tt][1] = acc[mt][tt][2] = acc[mt][tt][3] = 0.f;
  float sl[LC], sh[LC];
  int cur_grp = -1;

  for (int i = 0; i < nit; ++i) {
    const int p = (it0 + i) * kGvIter;
    const int grp = p / group;  // group % 32 == 0: an iteration lies in one group
    if (grp != cur_grp) {       // issued before the wait, so the two overlap
      cur_grp = grp;
#pragma unroll
      for (int c = 0; c < LC / 4; ++c) {
        const float4 a = col_ok ? *reinterpret_cast<const float4*>(s4 + (size_t)grp * N + col + 4 * c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        const float4 z = col_ok ? *reinterpret_cast<const float4*>(
                                      s4 + (size_t)(half / group + grp) * N + col + 4 * c)
                                : make_float4(0.f, 0.f, 0.f, 0.f);
        sl[4 * c] = a.x; sl[4 * c + 1] = a.y; sl[4 * c + 2] = a.z; sl[4 * c + 3] = a.w;
        sh[4 * c] = z.x; sh[4 * c + 1] = z.y; sh[4 * c + 2] = z.z; sh[4 * c + 3] = z.w;
      }
    }
    hop::cp_async_wait<C::kStages - 1>();
    __syncwarp();  // the pieces other lanes copied
    const unsigned char* slot = ring + (i % C::kStages) * C::kSlot;
#pragma unroll
    for (int st = 0; st < 4; ++st) {
      const int r = 8 * st + 2 * qd;  // row of the slot
      uint32_t xb[MT][2];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = 8 * mt + g;
        const unsigned char* xr = slot + kRgW + 2 * m * kRgRow + 2 * r;
        xb[mt][0] = m < M ? *reinterpret_cast<const uint32_t*>(xr) : 0u;
        xb[mt][1] = m < M ? *reinterpret_cast<const uint32_t*>(xr + kRgRow) : 0u;
      }
      const uint2 r0 = *reinterpret_cast<const uint2*>(slot + r * kRgRow + 8 * g);
      const uint2 r1 = *reinterpret_cast<const uint2*>(slot + (r + 1) * kRgRow + 8 * g);
      const uint32_t w0[2] = {r0.x, r0.y};
      const uint32_t w1[2] = {r1.x, r1.y};
#pragma unroll
      for (int tt = 0; tt < TT; ++tt) {
        // bytes (k, n), (k, n + 1), (k + 1, n), (k + 1, n + 1), n = 2 tt of the lane's 8
        const uint32_t v = __byte_perm(w0[tt >> 1], w1[tt >> 1], (tt & 1) ? 0x7632u : 0x5410u);
        uint32_t a0, a1, a2, a3;
        dequant_pair(v, 0, sl[2 * tt], sl[2 * tt + 1], a0, a1);
        dequant_pair(v, 1, sh[2 * tt], sh[2 * tt + 1], a2, a3);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
          hop::mma_16816(acc[mt][tt], a0, a1, a2, a3, xb[mt][0], xb[mt][1]);
      }
    }
    __syncwarp();  // every lane has read the slot before it is refilled
    prefetch(i + C::kStages);
  }
  hop::cp_async_wait<0>();
  __syncwarp();

  float* red = reinterpret_cast<float*>(ring);  // this warp's [8 MT][64] partial
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int tt = 0; tt < TT; ++tt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        red[(8 * mt + 2 * qd + (e & 1)) * COLS + LC * g + 2 * tt + (e >> 1)] = acc[mt][tt][e];
  __syncthreads();
  for (int i = threadIdx.x; i < 8 * MT * COLS; i += kGvThreads) {
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kGvWarps; ++w)
      sum += reinterpret_cast<const float*>(rsm + (size_t)w * C::kStages * C::kSlot)[i];
    bsum[i] = sum;
  }
  cluster.sync();
  for (int i = rank * kGvThreads + threadIdx.x; i < M * COLS; i += nclu * kGvThreads) {
    const int m = i / COLS;
    const int c = i - m * COLS;
    float sum = 0.f;
#pragma unroll
    for (int r = 0; r < 2; ++r)
      if (r < nclu) sum += cluster.map_shared_rank(bsum, r)[i];
    if (n0 + c < N) out[(size_t)m * N + n0 + c] = __float2bfloat16(sum);
  }
  cluster.sync();  // no block leaves while another reads its shared memory
}

template <int MT>
int launch_gemv_mma(const void* x, const void* q4, const void* s4, void* out, int M, int K,
                    int N, int group, int cluster, cudaStream_t st) {
  constexpr size_t smem = RingCfg<MT>::kSmem;
  auto* kern = w4_gemv_mma_kernel<MT>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  err = hop::launch_cluster(kern, dim3(cluster, (N + kGvCols - 1) / kGvCols), dim3(kGvThreads),
                            smem, st, cluster, static_cast<const __nv_bfloat16*>(x),
                            static_cast<const uint8_t*>(q4), static_cast<const float*>(s4),
                            static_cast<__nv_bfloat16*>(out), M, K, N, group);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// ---- K11mma: wgmma over a TMA ring, the weight dequantized in registers ----
//
// The product runs transposed, y^T = W^T x^T, so that the int4 weight is
// wgmma's register operand A: each consumer warp loads packed bytes from
// shared memory with ldmatrix.trans (byte pairs as b16, so a register holds
// 2 rows x 2 columns of W), dequantizes them in registers and hands them to
// wgmma m64n128k16 as A; the x tile (128 rows of the block) is B, K-major
// from shared memory as TMA wrote it. Nothing dequantized is written back
// to shared memory, and no barrier joins the consumers. The fragment's row
// r of a warp's 16 stands for weight column 2 (r % 8) + r / 8 of them.
//
// Block: 2 consumer warpgroups, each owning TPW tiles of 64 weight columns
// (BN = 128 TPW columns a block), and one producer warp that keeps a ring
// of the x tiles (both halves' 64 columns of the step, 128-byte swizzle)
// and the packed tile (128-byte swizzle, so ldmatrix's 8 rows fall in
// distinct banks) in flight. A k-step covers 64 packed rows, i.e. W rows
// [p0, p0 + 64) (low nibbles) and [K/2 + p0, ...) (high nibbles): one scale
// group of each half, so scales are read once a group, the next group's
// while this one is in use. Each row tile dequantizes the weight again;
// TPW = 2 halves how often each x tile is read.
//
// Grid: the row tile varies fastest, so the blocks that read one weight
// column tile run together and share it through L2. The caller picks TPW
// (ops/w4_matmul.py mma_tpw): 2 (BN = 256) where its blocks take half as
// many waves over the 132 SMs as BN = 128's (M = 290 on 4096x11008: 129
// blocks in 1 wave against 258 in 2), else 1 (M = 92 there: 43 blocks
// would leave 89 SMs idle).
constexpr int kBM = 128;    // x rows a block (wgmma N)
constexpr int kBK = 64;     // packed rows a step
constexpr int kMmaThreads = 384;

template <int TPW>
struct MmaCfg {
  static constexpr int kBN = 128 * TPW;
  static constexpr int kStages = TPW == 1 ? 5 : 4;
  static constexpr uint32_t kXHalfBytes = kBM * kBK * 2;  // one half's x tile
  static constexpr uint32_t kQBytes = kBK * kBN;          // packed tile: kBN / 128 boxes
  static constexpr uint32_t kTx = 2 * kXHalfBytes + kQBytes;
  static constexpr size_t kSmem = kStages * kTx + 2 * kStages * sizeof(uint64_t) + 1024;
};

__device__ __forceinline__ uint32_t pick4(uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3,
                                          int i) {
  return i == 0 ? v0 : (i == 1 ? v1 : (i == 2 ? v2 : v3));
}

// grid (ceil(M / kBM), N / BN), kMmaThreads threads, MmaCfg<TPW>::kSmem bytes.
// xmap: x (M, K) bf16, boxes of kBM rows x 64 columns, 128-byte swizzle;
// qmap: q4 (K/2, N) bytes, boxes of kBK rows x 128 columns, 128-byte swizzle.
template <int TPW>
__global__ void __launch_bounds__(kMmaThreads, 1)
w4_mma_kernel(const __grid_constant__ CUtensorMap xmap, const __grid_constant__ CUtensorMap qmap,
              const float* __restrict__ s4, __nv_bfloat16* __restrict__ out, int M, int K, int N,
              int group) {
  using C = MmaCfg<TPW>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~static_cast<uintptr_t>(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + C::kStages * C::kTx);
  uint64_t* empty = full + C::kStages;
  // stage s: x low half, x high half, then the packed tile
  auto xtile = [&](int s, int hf) { return smem + s * C::kTx + hf * C::kXHalfBytes; };
  auto qtile = [&](int s) { return smem + s * C::kTx + 2 * C::kXHalfBytes; };

  const int tid = threadIdx.x;
  const int wg = tid >> 7;
  const int lane = tid & 31;
  const int m0 = blockIdx.x * kBM;
  const int n0 = blockIdx.y * C::kBN;
  const int half = K / 2;
  const int steps = half / kBK;
  if (tid == 0) {
    for (int s = 0; s < C::kStages; ++s) {
      hop::mbar_init(&full[s], 1);
      hop::mbar_init(&empty[s], 8);  // the 8 consumer warps
    }
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (wg == 2) {
    // ---- producer: one thread keeps the ring full ------------------------------
    hop::reg_dealloc<40>();
    if (tid == 256) {
      for (int step = 0; step < steps; ++step) {
        const int s = step % C::kStages;
        if (step >= C::kStages) hop::mbar_wait(&empty[s], ((step / C::kStages) - 1) & 1);
        hop::mbar_expect_tx(&full[s], C::kTx);
        hop::tma_load_2d(xtile(s, 0), &xmap, &full[s], step * kBK, m0);
        hop::tma_load_2d(xtile(s, 1), &xmap, &full[s], half + step * kBK, m0);
#pragma unroll
        for (int cb = 0; cb < TPW; ++cb)
          hop::tma_load_2d(qtile(s) + cb * (kBK * 128), &qmap, &full[s], n0 + 128 * cb,
                           step * kBK);
      }
    }
  } else {
    // ---- consumers ------------------------------------------------------------------
    hop::reg_alloc<232>();
    const int wp = (tid >> 5) & 3;
    const int g = lane >> 2;
    const int qd = lane & 3;
    // weight columns of tile t, warp wp: col(t) + 2g, + 1
    auto col = [&](int t) { return 64 * (TPW * wg + t) + 16 * wp; };
    float se[TPW][2], so[TPW][2], ne[TPW][2], no[TPW][2];  // [tile][half]
    auto load_scales = [&](int grp, float (&e)[TPW][2], float (&o)[TPW][2]) {
#pragma unroll
      for (int t = 0; t < TPW; ++t)
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          const float2 v = *reinterpret_cast<const float2*>(
              s4 + (size_t)(hf * (half / group) + grp) * N + n0 + col(t) + 2 * g);
          e[t][hf] = v.x;
          o[t][hf] = v.y;
        }
    };
    load_scales(0, se, so);
    if (group < half) load_scales(1, ne, no);
    float acc[TPW][64];
#pragma unroll
    for (int t = 0; t < TPW; ++t) hop::zero(acc[t]);

    for (int step = 0; step < steps; ++step) {
      const int s = step % C::kStages;
      const int grp = step * kBK / group;
      if (step > 0 && grp != (step - 1) * kBK / group) {  // a new scale group
#pragma unroll
        for (int t = 0; t < TPW; ++t)
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            se[t][hf] = ne[t][hf];
            so[t][hf] = no[t][hf];
          }
        if ((grp + 1) * group < half) load_scales(grp + 1, ne, no);
      }
      hop::mbar_wait(&full[s], (step / C::kStages) & 1);
      // A operands: [tile][half * 4 + k16 slice][4]
      uint32_t a[TPW][8][4];
#pragma unroll
      for (int t = 0; t < TPW; ++t) {
        const int c = col(t);
        const uint32_t qbase = hop::smem_u32(qtile(s) + (c >> 7) * (kBK * 128));
        const int chunk = (c & 127) >> 4;
#pragma unroll
        for (int pass = 0; pass < 2; ++pass) {  // packed rows 32 pass .. + 31
          const int k = 32 * pass + 8 * (lane >> 3) + (lane & 7);
          uint32_t r[4];  // r[j]: rows 32 pass + 8 j + 2 qd, + 1; columns 2g, 2g + 1
          hop::ldsm_x4_trans(r, qbase + hop::sw128(k, chunk));
#pragma unroll
          for (int sp = 0; sp < 2; ++sp) {
            const int kk = 2 * pass + sp;
#pragma unroll
            for (int hf = 0; hf < 2; ++hf) {
              dequant_pair(r[2 * sp], hf, se[t][hf], so[t][hf], a[t][4 * hf + kk][0],
                           a[t][4 * hf + kk][1]);
              dequant_pair(r[2 * sp + 1], hf, se[t][hf], so[t][hf], a[t][4 * hf + kk][2],
                           a[t][4 * hf + kk][3]);
            }
          }
        }
      }
      hop::wgmma_fence();
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
#pragma unroll
        for (int kk = 0; kk < 4; ++kk) {
          const uint64_t db = hop::desc_sw128(xtile(s, hf) + 32 * kk, 16, 1024);
#pragma unroll
          for (int t = 0; t < TPW; ++t) hop::wgmma_rs<128, 0>(acc[t], a[t][4 * hf + kk], db, 1);
        }
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
#pragma unroll
      for (int t = 0; t < TPW; ++t) hop::fence_regs(acc[t]);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(&empty[s]);
    }

    // epilogue: d[4 j + e] is x row 8 j + 2 qd + e % 2, weight column col(t) +
    // 2 g + e / 2. A 4 x 4 exchange among the lanes of one qd and g / 4 turns
    // column pairs into 8 consecutive columns of one row: a 16-byte store.
    const int u = g & 3;
#pragma unroll
    for (int t = 0; t < TPW; ++t) {
      const int cbase = n0 + col(t) + 8 * (g >> 2);
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
#pragma unroll
        for (int ag = 0; ag < 4; ++ag) {
          uint32_t v[4], o[4] = {0u, 0u, 0u, 0u};
#pragma unroll
          for (int i = 0; i < 4; ++i)
            v[i] = hop::pack2(acc[t][4 * (4 * ag + i) + e2], acc[t][4 * (4 * ag + i) + 2 + e2]);
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const uint32_t got =
                __shfl_sync(0xffffffffu, pick4(v[0], v[1], v[2], v[3], (u - r) & 3),
                            (lane & ~12) | (((u + r) & 3) << 2));
            const int slot = (u + r) & 3;
            o[0] = slot == 0 ? got : o[0];
            o[1] = slot == 1 ? got : o[1];
            o[2] = slot == 2 ? got : o[2];
            o[3] = slot == 3 ? got : o[3];
          }
          const int row = m0 + 8 * (4 * ag + u) + 2 * qd + e2;
          if (row < M)
            *reinterpret_cast<uint4*>(out + (size_t)row * N + cbase) =
                make_uint4(o[0], o[1], o[2], o[3]);
        }
      }
    }
  }
}

template <int TPW>
int launch_mma(const void* x, const void* q4, const void* s4, void* out, int M, int K, int N,
               int group, cudaStream_t st) {
  using C = MmaCfg<TPW>;
  CUtensorMap xmap, qmap;
  const cuuint64_t xdims[2] = {(cuuint64_t)K, (cuuint64_t)M};
  const cuuint64_t xstrides[1] = {(cuuint64_t)K * 2};
  const cuuint32_t xbox[2] = {kBK, kBM};
  const cuuint64_t qdims[2] = {(cuuint64_t)N, (cuuint64_t)(K / 2)};
  const cuuint64_t qstrides[1] = {(cuuint64_t)N};
  const cuuint32_t qbox[2] = {128, kBK};
  if (!hop::make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstrides, xbox,
                     CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hop::make_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q4, qdims, qstrides, qbox,
                     CU_TENSOR_MAP_SWIZZLE_128B))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(w4_mma_kernel<TPW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(C::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((M + kBM - 1) / kBM, N / C::kBN);
  w4_mma_kernel<TPW><<<grid, kMmaThreads, C::kSmem, st>>>(
      xmap, qmap, static_cast<const float*>(s4), static_cast<__nv_bfloat16*>(out), M, K, N,
      group);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (M, K) bf16 or fp32; q4 (K/2, N) int8; s4 (K/group, N) fp32; out (M, N)
// in x's dtype. group % 32 == 0, group <= 512, N % 16 == 0. bf16: M <= 16,
// `cluster` (1 or 2: ops/w4_matmul.py gemv_cluster) blocks split K,
// part unused; fp32: part is (K/2/group, M, N) fp32 scratch.
extern "C" int mmmm_w4_gemv(const void* x, const void* q4, const void* s4, void* out,
                            void* part, int M, int K, int N, int group, int is_bf16,
                            int cluster, void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || group <= 0 || group % 32 || (K / 2) % group || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (!is_bf16) return launch_gemv_f32(x, q4, s4, out, part, M, K, N, group, st);
  if (M > 16 || (cluster != 1 && cluster != 2))
    return static_cast<int>(cudaErrorInvalidValue);
  return M <= 8 ? launch_gemv_mma<1>(x, q4, s4, out, M, K, N, group, cluster, st)
                : launch_gemv_mma<2>(x, q4, s4, out, M, K, N, group, cluster, st);
}

// Dynamic shared memory (bytes) of a K11 decode-row launch at M rows.
extern "C" int mmmm_w4_gemv_smem(int m) {
  return static_cast<int>(m <= 8 ? RingCfg<1>::kSmem : RingCfg<2>::kSmem);
}

// x (M, K) bf16; q4 (K/2, N) int8; s4 (K/group, N) fp32; out (M, N) bf16.
// K % 128 == 0, N % 128 == 0, group % 64 == 0, (K/2) % group == 0; x, q4,
// s4 and out 16-byte aligned (ops/w4_matmul.py mma_takes). tpw: 64-column
// tiles a consumer warpgroup, 1 (BN 128) or 2 (BN 256, N % 256 == 0),
// chosen by ops/w4_matmul.py mma_tpw.
extern "C" int mmmm_w4_mma(const void* x, const void* q4, const void* s4, void* out, int M,
                           int K, int N, int group, int tpw, void* stream) {
  if (M <= 0 || K <= 0 || K % (2 * kBK) || N <= 0 || N % 128 || group <= 0 || group % kBK ||
      (K / 2) % group || (tpw != 1 && tpw != 2) || N % (128 * tpw))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return tpw == 2 ? launch_mma<2>(x, q4, s4, out, M, K, N, group, st)
                  : launch_mma<1>(x, q4, s4, out, M, K, N, group, st);
}

// Dynamic shared memory (bytes) of a K11mma launch with TPW tiles a
// warpgroup.
extern "C" int mmmm_w4_mma_smem(int tpw) {
  return static_cast<int>(tpw == 2 ? MmaCfg<2>::kSmem : MmaCfg<1>::kSmem);
}
