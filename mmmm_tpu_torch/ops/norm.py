"""Normalization, the port of ``mmmm_tpu/ops/norm.py``: RMSNorm with fp32
variance and fp32-accumulated LayerNorm, both cast back to the input dtype."""
from __future__ import annotations

import torch


def rms_norm(x: torch.Tensor, weight: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    """LLaMA-style RMSNorm: fp32 variance, scale, cast back to input dtype."""
    xf = x.float()
    variance = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(variance + eps)
    return (weight * xf).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor | None = None,
               bias: torch.Tensor | None = None, eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last axis with optional affine params."""
    xf = x.float()
    mean = xf.mean(dim=-1, keepdim=True)
    var = (xf - mean).square().mean(dim=-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight
    if bias is not None:
        out = out + bias
    return out.to(x.dtype)
