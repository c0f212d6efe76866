"""Tensor ops of the port: plain PyTorch math and the CUDA kernel wrappers
(``dense_attn`` K4, ``flash`` K3 and K7, ``decode_kernel`` K1, K2, K5, K6,
K8-K10, ``w4_matmul`` K11), and the training step's ops (``fused_ce``,
``hungarian``, ``remat``)."""
