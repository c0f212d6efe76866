// K2, K5 and K8: in-place KV-cache appends, K and V in one launch.
//
// Replaces, in mmmm_tpu/ops/decode_kernel.py:
//   K2 kv_append_pallas (Pallas body `_kv_append_kernel`): one row per sample;
//   K5 kv_append_pallas_multi (`_kv_append_multi_kernel`): the K <= 8 rows of
//      a speculative verify window, slots [t, t + K);
//   K8 kv_append_pallas_q8 (`_kv_append_q8_kernel`): one int8 row per sample
//      plus its bf16 scale, into the four leaves of an int8 cache.
// Their reference semantics are the vmapped dynamic_update_slice: a negative
// start counts from the end once, then it is clamped so the whole window
// lands in [0, Smax - K] (it shifts, it is never cut); these kernels do the
// same.
//
// What bounds them on an H100: launch latency. A call moves 2 * B*H*K*D
// elements in and out (about 1 MB at B=4, H=32, K=8, D=128 in bf16), which
// the memory system moves in well under a microsecond.
//
// Design: the TPU kernels had to rewrite aligned 8- or 32-slot windows
// because the TPU's sublane tiling forbade a one-slot store. Here one block
// per (sample, head) copies its rows straight into their slots, in place.
// The K rows of a window are contiguous in both the new rows and the cache,
// so K5 copies them as one run of 16-byte words where sizes and addresses
// allow. Elements move as raw words, so every copy is bit-exact.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename E>
__global__ void kv_append_kernel(E* __restrict__ kc, E* __restrict__ vc,
                                 const E* __restrict__ k_new, const E* __restrict__ v_new,
                                 const int* __restrict__ write_index, int H, int Smax,
                                 int D) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  int t = write_index[b];
  if (t < 0) t += Smax;
  t = t < 0 ? 0 : (t > Smax - 1 ? Smax - 1 : t);
  const size_t dst = ((size_t)bh * Smax + t) * D;
  const size_t src = (size_t)bh * D;
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    kc[dst + d] = k_new[src + d];
    vc[dst + d] = v_new[src + d];
  }
}

}  // namespace

extern "C" int mmmm_kv_append(void* k_cache, void* v_cache, const void* k_new,
                              const void* v_new, const void* write_index, int B, int H,
                              int Smax, int D, int elem_bytes, void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* widx = static_cast<const int*>(write_index);
  const int threads = D < 128 ? 32 * ((D + 31) / 32) : 128;
  if (elem_bytes == 2) {
    kv_append_kernel<uint16_t><<<B * H, threads, 0, st>>>(
        static_cast<uint16_t*>(k_cache), static_cast<uint16_t*>(v_cache),
        static_cast<const uint16_t*>(k_new), static_cast<const uint16_t*>(v_new), widx, H,
        Smax, D);
  } else if (elem_bytes == 4) {
    kv_append_kernel<uint32_t><<<B * H, threads, 0, st>>>(
        static_cast<uint32_t*>(k_cache), static_cast<uint32_t*>(v_cache),
        static_cast<const uint32_t*>(k_new), static_cast<const uint32_t*>(v_new), widx, H,
        Smax, D);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

namespace {

// K5: rows [0, K) of (b, h) go to slots [t, t + K), as `n` words of type W.
template <typename W>
__global__ void kv_append_multi_kernel(W* __restrict__ kc, W* __restrict__ vc,
                                       const W* __restrict__ k_new,
                                       const W* __restrict__ v_new,
                                       const int* __restrict__ write_index, int H,
                                       int Smax, int K, int row_words) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  int t = write_index[b];
  if (t < 0) t += Smax;
  t = t < 0 ? 0 : (t > Smax - K ? Smax - K : t);
  const size_t dst = ((size_t)bh * Smax + t) * row_words;
  const size_t src = (size_t)bh * K * row_words;
  const int n = K * row_words;
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    kc[dst + i] = k_new[src + i];
    vc[dst + i] = v_new[src + i];
  }
}

template <typename W>
void launch_multi(void* kc, void* vc, const void* kn, const void* vn, const int* widx, int B,
                  int H, int Smax, int K, int row_bytes, cudaStream_t st) {
  const int row_words = row_bytes / static_cast<int>(sizeof(W));
  const int n = K * row_words;
  const int threads = n < 256 ? 32 * ((n + 31) / 32) : 256;
  kv_append_multi_kernel<W><<<B * H, threads, 0, st>>>(
      static_cast<W*>(kc), static_cast<W*>(vc), static_cast<const W*>(kn),
      static_cast<const W*>(vn), widx, H, Smax, K, row_words);
}

bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// K8: the D int8 values of (b, h) and its two bf16 scales go to slot t.
__global__ void kv_append_q8_kernel(int8_t* __restrict__ kq, uint16_t* __restrict__ ks,
                                    int8_t* __restrict__ vq, uint16_t* __restrict__ vs,
                                    const int8_t* __restrict__ kq_new,
                                    const uint16_t* __restrict__ ks_new,
                                    const int8_t* __restrict__ vq_new,
                                    const uint16_t* __restrict__ vs_new,
                                    const int* __restrict__ write_index, int H, int Smax,
                                    int D) {
  const int bh = blockIdx.x;
  const int b = bh / H;
  int t = write_index[b];
  if (t < 0) t += Smax;
  t = t < 0 ? 0 : (t > Smax - 1 ? Smax - 1 : t);
  const size_t slot = (size_t)bh * Smax + t;
  if (D % 4 == 0) {
    uint32_t* kd = reinterpret_cast<uint32_t*>(kq + slot * D);
    uint32_t* vd = reinterpret_cast<uint32_t*>(vq + slot * D);
    const uint32_t* kn = reinterpret_cast<const uint32_t*>(kq_new + (size_t)bh * D);
    const uint32_t* vn = reinterpret_cast<const uint32_t*>(vq_new + (size_t)bh * D);
    for (int i = threadIdx.x; i < D / 4; i += blockDim.x) {
      kd[i] = kn[i];
      vd[i] = vn[i];
    }
  } else {
    for (int i = threadIdx.x; i < D; i += blockDim.x) {
      kq[slot * D + i] = kq_new[(size_t)bh * D + i];
      vq[slot * D + i] = vq_new[(size_t)bh * D + i];
    }
  }
  if (threadIdx.x == 0) {
    ks[slot] = ks_new[bh];
    vs[slot] = vs_new[bh];
  }
}

}  // namespace

// k_cache, v_cache: (B, H, Smax, D); k_new, v_new: (B, H, K, D), one dtype of
// elem_bytes (2 or 4); write_index (B,) int32; 1 <= K <= Smax.
extern "C" int mmmm_kv_append_multi(void* k_cache, void* v_cache, const void* k_new,
                                    const void* v_new, const void* write_index, int B, int H,
                                    int Smax, int K, int D, int elem_bytes, void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0 || K <= 0 || K > Smax ||
      (elem_bytes != 2 && elem_bytes != 4))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* widx = static_cast<const int*>(write_index);
  const int row_bytes = D * elem_bytes;
  if (row_bytes % 16 == 0 && aligned16(k_cache) && aligned16(v_cache) && aligned16(k_new) &&
      aligned16(v_new)) {
    launch_multi<uint4>(k_cache, v_cache, k_new, v_new, widx, B, H, Smax, K, row_bytes, st);
  } else if (row_bytes % 4 == 0) {
    launch_multi<uint32_t>(k_cache, v_cache, k_new, v_new, widx, B, H, Smax, K, row_bytes, st);
  } else {
    launch_multi<uint16_t>(k_cache, v_cache, k_new, v_new, widx, B, H, Smax, K, row_bytes, st);
  }
  return static_cast<int>(cudaGetLastError());
}

// kq, vq: (B, H, Smax, D) int8; ks, vs: (B, H, Smax, 1) bf16; the new rows
// (B, H, 1, D) int8 and their scales (B, H, 1, 1) bf16; write_index (B,) int32.
extern "C" int mmmm_kv_append_q8(void* kq, void* ks, void* vq, void* vs, const void* kq_new,
                                 const void* ks_new, const void* vq_new, const void* vs_new,
                                 const void* write_index, int B, int H, int Smax, int D,
                                 void* stream) {
  if (B <= 0 || H <= 0 || Smax <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  kv_append_q8_kernel<<<B * H, 32, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int8_t*>(kq), static_cast<uint16_t*>(ks), static_cast<int8_t*>(vq),
      static_cast<uint16_t*>(vs), static_cast<const int8_t*>(kq_new),
      static_cast<const uint16_t*>(ks_new), static_cast<const int8_t*>(vq_new),
      static_cast<const uint16_t*>(vs_new), static_cast<const int*>(write_index), H, Smax, D);
  return static_cast<int>(cudaGetLastError());
}
