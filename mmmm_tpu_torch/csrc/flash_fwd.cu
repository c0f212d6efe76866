// K3: segment-id (optionally causal) flash attention forward with logsumexp.
//
// Replaces: mmmm_tpu/ops/flash.py flash_segment_attention -> _flash_fwd_impl
// (Pallas body `_fwd_kernel`). Sites: the LLM prefill attention (B, 192, 32,
// 128) bf16, causal, one right-padded segment per row; and in the training
// step every flash site: the LLM (B, 1024, 32, 128) bf16 causal, the EVA ViT
// (B, 577, 16, 112) in fp32 (bf16 over a bf16 image) and the SAM encoder
// (B, 512, 12, 64) fp32.
//
// What bounds it on an H100: the prefill call is small (about 1.2 GFLOP
// after the causal half is skipped, 25 MB of q/k/v/out), so bytes (~7.5 us
// at 3.35 TB/s) and in practice latency; the training sites are 2-17 GFLOP,
// bound by operations (989 TFLOP/s bf16, 67 TFLOP/s fp32 with TF32 off) or,
// at the LLM's causal half, by bytes.
//
// Design: attn_fwd.cuh (bf16 on wgmma with a TMA ring, fp32 register-
// blocked CUDA-core tiles over a cp.async ring). The TPU kernel walked
// every K block and skipped only the compute of blocks above the diagonal;
// here a block's key loop ends at its last query, so those tiles are never
// loaded, and causal blocks run heaviest first. Masks are built from int32
// segment ids and absolute positions, by element only on tiles that need
// them; a query row with no valid key returns out = 0 and lse = 0 (the
// reference's zero rows, where SDPA would give NaN). lse (B, H, Sq) fp32
// feeds the backward K7.
#include "attn_fwd.cuh"

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
    err = mmmm::launch_fwd_wgmma<true>(q, k, v, out, lp, qs, ks, B, Sq, Skv, H, D, scale,
                                       causal, st);
  } else {
    err = mmmm::launch_fwd_f32<true>(q, k, v, out, lp, qs, ks, B, Sq, Skv, H, D, scale, causal,
                                     st);
  }
  return static_cast<int>(err);
}

// Dynamic shared memory (bytes) of the K3/K4 kernel a launch at head dim D
// over Skv keys takes; 0 for a D it does not take.
extern "C" int mmmm_attn_fwd_smem(int is_bf16, int D, int Skv) {
  return static_cast<int>(mmmm::fwd_smem(is_bf16, D, Skv));
}
