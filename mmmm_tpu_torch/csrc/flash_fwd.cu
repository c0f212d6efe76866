// K3: segment-id (optionally causal) flash attention forward with logsumexp.
//
// Replaces: mmmm_tpu/ops/flash.py flash_segment_attention -> _flash_fwd_impl
// (Pallas body `_fwd_kernel`), the LLM prefill attention: (B, 192, 32, 128)
// bf16, causal, one right-padded segment per row.
//
// What bounds it on an H100: at the prefill shape the work is small (about
// 1.2 GFLOP after the causal half is skipped, 25 MB of q/k/v/out), so the
// least time is set by bytes (~7.5 us at 3.35 TB/s); in practice a kernel of
// this size is bound by latency: 384 blocks of a few 64-key tiles each on 132
// SMs.
//
// Design: the TPU kernel walked every K block and skipped only the compute
// of blocks above the diagonal, their DMA still streamed. Here the block's
// key loop ends at the tile's last query, so those tiles are never loaded.
// Masks are built from int32 segment ids and absolute positions; a query
// row with no valid key returns out = 0 and lse = 0 (the reference's zero
// rows, where SDPA would give NaN). lse (B, H, Sq) is fp32, for the backward
// of a later slice. bf16 runs on the tensor cores (mma.sync, attn_mma.cuh),
// fp32 on CUDA cores (attn_tile.cuh).
#include "attn_mma.cuh"
#include "attn_tile.cuh"

extern "C" int mmmm_flash_fwd(const void* q, const void* k, const void* v,
                              const void* q_segments, const void* kv_segments,
                              void* out, void* lse, int B, int Sq, int Skv, int H,
                              int D, float scale, int causal, int is_bf16,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int* qs = static_cast<const int*>(q_segments);
  const int* ks = static_cast<const int*>(kv_segments);
  float* lp = static_cast<float*>(lse);
  cudaError_t err;
  if (is_bf16) {
    err = mmmm::launch_attn_mma<true>(q, k, v, out, lp, qs, ks, B, Sq, Skv, H, D, scale,
                                      causal, st);
  } else {
    err = mmmm::launch_attn_tile<float, true>(q, k, v, out, lp, qs, ks, B, Sq, Skv, H,
                                              D, scale, causal, st);
  }
  return static_cast<int>(err);
}
