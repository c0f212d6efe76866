// K4: all-valid bidirectional attention, (B, S, H, D) -> (B, S, H, D).
//
// Replaces: mmmm_tpu/ops/dense_attn.py dense_attention -> _dense_fwd_bhsd
// (Pallas body `_kernel`), used by the EVA ViT (bf16, S=1153, H=16, D=112
// at the flagship width) and the SegVol SAM encoder (fp32, S=512, H=12, D=64).
//
// What bounds it on an H100: operations. The ViT call is 4*B*H*S^2*D = 38
// GFLOP against 66 MB of q/k/v/out, far above the card's ~295 FLOP/byte
// ridge; the SAM call is fp32 and must stay off TF32, so its ceiling is the
// 67 TFLOP/s fp32 CUDA-core rate.
//
// Design: the TPU kernel held a sample-head's whole K/V in 16 MB of VMEM and
// took one full-row softmax. At S=1153, D=112 that K/V is ~516 KB in bf16,
// more than a block's 227 KB of shared memory, so this kernel streams K/V
// tiles with an online softmax (attn_fwd.cuh: bf16 on wgmma with a TMA ring,
// fp32 register-blocked CUDA-core tiles over a cp.async ring); only the
// ragged last tile past S is masked.
//
// K12 (mmmm_tpu/ops/dense_attn.py _dense_fwd_bshd, Pallas body
// `_kernel_bshd`) computes K4's function on (B, S, H, D) blocks; this
// kernel reads that layout natively, so it is K12's counterpart too.
//
// The fast softmax (mmmm_tpu/ops/dense_attn.py _softmax_rows(fast=True),
// selected by MMMM_DENSE_FAST_SOFTMAX in both Pallas bodies) is the FAST
// form of the same kernels, bf16 and fp32.
//
// P1 (scripts/tpu_probes.py nosm_fwd, Pallas body `_kernel_nosm`) is K4 with
// the softmax replaced by one multiply, a floor for K4's time:
// mmmm_dense_attention_nosm runs the same bf16 kernel with NOSM.
#include "attn_fwd.cuh"

// fast: the reference's fast softmax (MMMM_DENSE_FAST_SOFTMAX=1), a
// compile-time variant of the same kernel (attn_fwd.cuh FAST).
extern "C" int mmmm_dense_attention(const void* q, const void* k, const void* v,
                                    void* out, int B, int S, int H, int D,
                                    float scale, int is_bf16, int fast, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err;
  if (is_bf16) {
    err = fast ? mmmm::launch_fwd_wgmma<false, false, true>(q, k, v, out, nullptr, nullptr,
                                                             nullptr, B, S, S, H, D, scale, 0, st)
               : mmmm::launch_fwd_wgmma<false>(q, k, v, out, nullptr, nullptr, nullptr, B, S, S,
                                               H, D, scale, 0, st);
  } else {
    err = fast ? mmmm::launch_fwd_f32<false, true>(q, k, v, out, nullptr, nullptr, nullptr, B, S,
                                                    S, H, D, scale, 0, st)
               : mmmm::launch_fwd_f32<false>(q, k, v, out, nullptr, nullptr, nullptr, B, S, S,
                                             H, D, scale, 0, st);
  }
  return static_cast<int>(err);
}

// P1: q, k, v, out (B, S, H, D) bf16; out = ((q k^T * scale) * 1e-4) v, keys
// past S contributing 0, probabilities rounded to bf16 as K4's are.
extern "C" int mmmm_dense_attention_nosm(const void* q, const void* k, const void* v,
                                         void* out, int B, int S, int H, int D, float scale,
                                         void* stream) {
  return static_cast<int>(mmmm::launch_fwd_wgmma<false, true>(
      q, k, v, out, nullptr, nullptr, nullptr, B, S, S, H, D, scale, 0,
      static_cast<cudaStream_t>(stream)));
}
