"""Tensor ops of the port: plain PyTorch math and the CUDA kernel wrappers
(``dense_attn`` K4, ``flash`` K3, ``decode_kernel`` K1/K2)."""
