// K2: in-place single-token KV-cache append, K and V in one launch.
//
// Replaces: mmmm_tpu/ops/decode_kernel.py kv_append_pallas (Pallas body
// `_kv_append_kernel`). Its reference semantics are the vmapped
// dynamic_update_slice: a negative index counts from the end, then the start
// is clamped so the row lands in [0, Smax - 1]; this kernel does the same.
//
// What bounds it on an H100: launch latency. Each call moves 2 * B*H*D
// elements in and out (about 130 KB at B=4, H=32, D=128 in bf16), which the
// memory system moves in well under a microsecond.
//
// Design: the TPU kernel had to rewrite an aligned 8-slot window because
// bf16 sublane tiling forbade a one-slot store. Here one block per (sample,
// head) copies its D elements straight into the slot, in place; elements are
// moved as raw 2- or 4-byte words, so the copy is bit-exact.
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
