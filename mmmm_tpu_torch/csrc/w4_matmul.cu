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
//  - mmmm_w4_gemv (CUDA cores, any M, bf16 or fp32 x): a block of 8 warps
//    owns 512 columns and one scale group of packed rows; each lane reads
//    16 packed bytes (16 columns) of a row with one 16-byte load,
//    sign-extends both nibbles, scales them with the two scales it loaded
//    once and feeds every x row of the block (kRows) from shared memory.
//    The 8
//    warps' sums meet in shared memory; each group's partial product goes
//    to a workspace and a second kernel sums the groups in a fixed order.
//  - mmmm_w4_mma (bf16 x, M > 16): a 64 x 64 output tile per block of 4
//    warps; each step dequantizes 32 packed rows (64 rows of W) into two
//    bf16 tiles in shared memory and stages the matching x columns, then
//    runs mma.sync m16n8k16 as attn_mma.cuh does (ldmatrix for x,
//    ldmatrix.trans for W). No cp.async or wgmma yet.
#include "attn_mma.cuh"

namespace {

constexpr int kRows = 4;      // x rows per GEMV block
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kCols = 512;    // columns per GEMV block (32 lanes x 16)

__device__ __forceinline__ float weight_as(float w, float) { return w; }
__device__ __forceinline__ float weight_as(float w, __nv_bfloat16) {
  return __bfloat162float(__float2bfloat16(w));
}

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
template <typename T>
__global__ void __launch_bounds__(kThreads)
w4_gemv_kernel(const T* __restrict__ x, const uint8_t* __restrict__ q4,
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
    xs[i] = m0 + m < M ? mmmm::to_f(x[(size_t)(m0 + m) * K + col]) : 0.f;
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
        const float wl = weight_as(static_cast<float>(lo) * slo[e], T());
        const float wh = weight_as(static_cast<float>(hi) * shi[e], T());
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

template <typename T>
__global__ void w4_sum_groups_kernel(const float* __restrict__ part, T* __restrict__ out,
                                     int groups, int MN) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float s = 0.f;
  for (int g = 0; g < groups; ++g) s += part[(size_t)g * MN + i];
  out[i] = mmmm::from_f<T>(s);
}

template <typename T>
int launch_gemv(const void* x, const void* q4, const void* s4, void* out, void* part, int M,
                int K, int N, int group, cudaStream_t st) {
  const int groups = K / 2 / group;
  const size_t smem = sizeof(float) * (kRows * 2 * group + kWarps * kCols);
  const dim3 grid((N + kCols - 1) / kCols, groups, (M + kRows - 1) / kRows);
  auto* kern = w4_gemv_kernel<T>;
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  kern<<<grid, kThreads, smem, st>>>(static_cast<const T*>(x), static_cast<const uint8_t*>(q4),
                                     static_cast<const float*>(s4), static_cast<float*>(part),
                                     M, K, N, group);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const int mn = M * N;
  w4_sum_groups_kernel<T><<<(mn + 255) / 256, 256, 0, st>>>(static_cast<const float*>(part),
                                                            static_cast<T*>(out), groups, mn);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kTM = 64;   // output rows per tile (16 per warp)
constexpr int kTN = 64;   // output columns per tile
constexpr int kTK = 32;   // packed rows per step: 32 rows of W in each half
constexpr int kMmaThreads = 128;

// grid (N / kTN, ceil(M / kTM)); N % 64 == 0, group % kTK == 0, K % 16 == 0.
__global__ void __launch_bounds__(kMmaThreads)
w4_mma_kernel(const __nv_bfloat16* __restrict__ x, const uint8_t* __restrict__ q4,
              const float* __restrict__ s4, __nv_bfloat16* __restrict__ out, int M, int K,
              int N, int group) {
  __shared__ __align__(16) __nv_bfloat16 Ws[2][kTK][kTN + 8];  // [lo/hi][k][n]
  __shared__ __align__(16) __nv_bfloat16 Xs[2][kTM][kTK + 8];  // [lo/hi][m][k]
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int mi = lane & 7;
  const int mj = lane >> 3;
  const int n_blk = blockIdx.x * kTN;
  const int m_blk = blockIdx.y * kTM;
  const int half = K / 2;
  const int ghalf = half / group;
  // weight loader: packed row lr, columns lc .. lc + 15 of the tile
  const int lr = tid >> 2;
  const int lc = (tid & 3) * 16;

  float acc[kTN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kTN / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int p0 = 0; p0 < half; p0 += kTK) {
    const int grp = p0 / group;
    {
      const uint4 raw =
          *reinterpret_cast<const uint4*>(q4 + (size_t)(p0 + lr) * N + n_blk + lc);
      float slo[16], shi[16];
      load16f(s4 + (size_t)grp * N + n_blk + lc, slo);
      load16f(s4 + (size_t)(ghalf + grp) * N + n_blk + lc, shi);
      uint32_t wl[8], wh[8];
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        int l0, h0, l1, h1;
        nibbles(raw, e, l0, h0);
        nibbles(raw, e + 1, l1, h1);
        wl[e / 2] = mmmm::pack_bf16(static_cast<float>(l0) * slo[e],
                                    static_cast<float>(l1) * slo[e + 1]);
        wh[e / 2] = mmmm::pack_bf16(static_cast<float>(h0) * shi[e],
                                    static_cast<float>(h1) * shi[e + 1]);
      }
      uint4* dl = reinterpret_cast<uint4*>(&Ws[0][lr][lc]);
      uint4* dh = reinterpret_cast<uint4*>(&Ws[1][lr][lc]);
      dl[0] = make_uint4(wl[0], wl[1], wl[2], wl[3]);
      dl[1] = make_uint4(wl[4], wl[5], wl[6], wl[7]);
      dh[0] = make_uint4(wh[0], wh[1], wh[2], wh[3]);
      dh[1] = make_uint4(wh[4], wh[5], wh[6], wh[7]);
    }
    // x columns [p0, p0 + kTK) and [half + p0, ...) of the tile's rows
    for (int i = tid; i < 2 * kTM * (kTK / 8); i += kMmaThreads) {
      const int part = i / (kTM * (kTK / 8));
      const int r = (i / (kTK / 8)) % kTM;
      const int c = (i % (kTK / 8)) * 8;
      const int row = m_blk + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row < M)
        v = *reinterpret_cast<const uint4*>(x + (size_t)row * K + part * half + p0 + c);
      *reinterpret_cast<uint4*>(&Xs[part][r][c]) = v;
    }
    __syncthreads();

#pragma unroll
    for (int part = 0; part < 2; ++part) {
#pragma unroll
      for (int kc = 0; kc < kTK / 16; ++kc) {
        uint32_t a[4];
        mmmm::ldmatrix_x4(a, &Xs[part][warp * 16 + 8 * (mj & 1) + mi][16 * kc + 8 * (mj >> 1)]);
#pragma unroll
        for (int dp = 0; dp < kTN / 16; ++dp) {
          uint32_t b[4];
          mmmm::ldmatrix_x4_trans(b, &Ws[part][16 * kc + 8 * (mj & 1) + mi][16 * dp + 8 * (mj >> 1)]);
          mmmm::mma_bf16(acc[2 * dp], a, b[0], b[1]);
          mmmm::mma_bf16(acc[2 * dp + 1], a, b[2], b[3]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int rh = 0; rh < 2; ++rh) {
    const int row = m_blk + warp * 16 + g + 8 * rh;
    if (row >= M) continue;
#pragma unroll
    for (int nt = 0; nt < kTN / 8; ++nt) {
      const int col = n_blk + 8 * nt + 2 * t;
      *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) =
          mmmm::pack_bf16(acc[nt][2 * rh], acc[nt][2 * rh + 1]);
    }
  }
}

}  // namespace

// x (M, K) bf16 or fp32; q4 (K/2, N) int8; s4 (K/group, N) fp32; out (M, N)
// in x's dtype; part (K/2/group, M, N) fp32 scratch. group % 32 == 0,
// group <= 512, N % 16 == 0.
extern "C" int mmmm_w4_gemv(const void* x, const void* q4, const void* s4, void* out,
                            void* part, int M, int K, int N, int group, int is_bf16,
                            void* stream) {
  if (M <= 0 || K <= 0 || N <= 0 || group <= 0 || (K / 2) % group || N % 16)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16) return launch_gemv<__nv_bfloat16>(x, q4, s4, out, part, M, K, N, group, st);
  return launch_gemv<float>(x, q4, s4, out, part, M, K, N, group, st);
}

// x (M, K) bf16; q4 (K/2, N) int8; s4 (K/group, N) fp32; out (M, N) bf16.
// N % 64 == 0, group % 32 == 0.
extern "C" int mmmm_w4_mma(const void* x, const void* q4, const void* s4, void* out, int M,
                           int K, int N, int group, void* stream) {
  if (M <= 0 || K <= 0 || N % kTN || group <= 0 || group % kTK || (K / 2) % group)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(N / kTN, (M + kTM - 1) / kTM);
  w4_mma_kernel<<<grid, kMmaThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(x), static_cast<const uint8_t*>(q4),
      static_cast<const float*>(s4), static_cast<__nv_bfloat16*>(out), M, K, N, group);
  return static_cast<int>(cudaGetLastError());
}
