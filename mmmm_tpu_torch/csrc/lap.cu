// LAP: exact rectangular linear-sum assignment of a batch of (K, Q) fp32
// cost matrices (K <= Q), one thread block per problem, every problem in
// one launch.
//
// Replaces no Pallas kernel: the JAX package leaves mmmm_tpu/ops/hungarian.py
// lap_rectangular (:44) to XLA as lax.while_loops inside jit, vmapped over
// the detector's images and heads, with no host sync. Its plain PyTorch
// version needs a host sync at every Dijkstra step of every problem (the
// detector's loss: 32 problems of up to K(K+1)/2 = 300 steps a step), so
// this kernel was added for that one XLA-side function.
//
// What bounds it on an H100: the dependent chain of Dijkstra steps, not
// bytes (a (32, 24, 100) batch is 0.3 MB) and not operations. Each step of
// a problem is one pass over its Q columns, a block-wide argmin and a
// scalar update by thread 0, two block barriers; a problem's steps cannot
// overlap, so the time is about (steps of the longest problem) x (one step's
// latency), with the problems spread over the SMs.
//
// Design: the Jonker-Volgenant shortest augmenting path of the reference,
// in its order (scipy's _lsap): for each row, Dijkstra over the reduced
// costs ((min_val + c[i][j]) - u[i]) - v[j] until an unassigned column is
// reached; the dual updates u[cur] += min_val, then u[r] += min_val -
// shortest[col4row[r]] for the other scanned rows (col4row read before the
// augment) and v[j] += shortest[j] - min_val for the scanned columns; then
// the augment walk back along path. u, v, shortest, path, col4row, row4col
// and the scanned flags live in shared memory; the columns are spread over
// the block's threads. The argmin takes the first minimum (lowest column),
// as jnp.argmin, through (value, index) pairs. There are only adds and
// compares, no products to contract into FMAs, so the result is bit-equal
// to the plain version's.
#include <cfloat>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

__device__ __forceinline__ bool before(float a, int ia, float b, int ib) {
  return a < b || (a == b && ia < ib);
}

__global__ void __launch_bounds__(kThreads) lap_kernel(const float* __restrict__ cost,
                                                       int* __restrict__ out, int K, int Q) {
  extern __shared__ float smem[];
  float* v = smem;                                          // Q
  float* shortest = v + Q;                                  // Q
  int* path = reinterpret_cast<int*>(shortest + Q);         // Q
  int* row4col = path + Q;                                  // Q
  float* u = reinterpret_cast<float*>(row4col + Q);         // K
  int* col4row = reinterpret_cast<int*>(u + K);             // K
  unsigned char* sc = reinterpret_cast<unsigned char*>(col4row + K);  // Q
  unsigned char* sr = sc + Q;                               // K
  __shared__ float red_v[kWarps];
  __shared__ int red_j[kWarps];
  __shared__ float s_min;
  __shared__ int s_i, s_sink;

  const float* C = cost + (size_t)blockIdx.x * K * Q;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const float big = FLT_MAX;
  for (int j = tid; j < Q; j += kThreads) {
    v[j] = 0.f;
    row4col[j] = -1;
  }
  for (int r = tid; r < K; r += kThreads) {
    u[r] = 0.f;
    col4row[r] = -1;
  }
  for (int cur = 0; cur < K; ++cur) {
    for (int j = tid; j < Q; j += kThreads) {
      shortest[j] = big;
      path[j] = -1;
      sc[j] = 0;
    }
    for (int r = tid; r < K; r += kThreads) sr[r] = 0;
    if (tid == 0) {
      s_min = 0.f;
      s_i = cur;
      s_sink = -1;
    }
    __syncthreads();
    // Dijkstra from row cur until an unassigned column is reached
    while (true) {
      const int i = s_i;
      const float min_val = s_min;
      const float ui = u[i];
      const float* Ci = C + (size_t)i * Q;
      float bv = big;
      int bj = Q;
      for (int j = tid; j < Q; j += kThreads) {
        float sh = shortest[j];
        const bool scanned = sc[j];
        if (!scanned) {
          const float reduced = ((min_val + Ci[j]) - ui) - v[j];
          if (reduced < sh) {
            sh = reduced;
            shortest[j] = reduced;
            path[j] = i;
          }
        }
        const float m = scanned ? big : sh;
        if (before(m, j, bv, bj)) {
          bv = m;
          bj = j;
        }
      }
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, bv, off);
        const int oj = __shfl_down_sync(0xffffffffu, bj, off);
        if (before(ov, oj, bv, bj)) {
          bv = ov;
          bj = oj;
        }
      }
      if (lane == 0) {
        red_v[warp] = bv;
        red_j[warp] = bj;
      }
      __syncthreads();
      if (tid == 0) {
        bv = red_v[0];
        bj = red_j[0];
        for (int w = 1; w < kWarps; ++w)
          if (before(red_v[w], red_j[w], bv, bj)) {
            bv = red_v[w];
            bj = red_j[w];
          }
        sr[i] = 1;
        sc[bj] = 1;
        s_min = bv;
        const int nxt = row4col[bj];
        s_sink = nxt < 0 ? bj : -1;
        s_i = nxt < 0 ? 0 : nxt;
      }
      __syncthreads();
      if (s_sink >= 0) break;
    }
    // dual updates (scipy's _lsap order; col4row as before the augment)
    const float min_val = s_min;
    for (int r = tid; r < K; r += kThreads) {
      if (r == cur) {
        u[r] = (u[r] + min_val) + 0.f;
      } else {
        const int c = col4row[r] < 0 ? 0 : col4row[r];
        u[r] = u[r] + (sr[r] ? min_val - shortest[c] : 0.f);
      }
    }
    for (int j = tid; j < Q; j += kThreads) v[j] = v[j] + (sc[j] ? shortest[j] - min_val : 0.f);
    __syncthreads();
    // augment: walk the predecessors back from the sink
    if (tid == 0) {
      int j = s_sink;
      while (true) {
        const int i = path[j];
        row4col[j] = i;
        const int jn = col4row[i];
        col4row[i] = j;
        if (i == cur) break;
        j = jn;
      }
    }
    __syncthreads();
  }
  for (int r = tid; r < K; r += kThreads) out[(size_t)blockIdx.x * K + r] = col4row[r];
}

}  // namespace

// cost: (N, K, Q) fp32, contiguous; col4row: (N, K) int32.
extern "C" int mmmm_lap(const void* cost, void* col4row, int N, int K, int Q, void* stream) {
  if (N <= 0 || K <= 0 || Q <= 0 || K > Q) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = (size_t)Q * (4 * sizeof(float) + 1) + (size_t)K * (2 * sizeof(float) + 1);
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lap_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  lap_kernel<<<N, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(cost), static_cast<int*>(col4row), K, Q);
  return static_cast<int>(cudaGetLastError());
}
