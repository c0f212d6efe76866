"""Rotary position embeddings indexed by position id, the port of
``mmmm_tpu/ops/rope.py`` (LLaMA convention: ``rotate_half``, table
``cat([freqs, freqs], -1)``)."""
from __future__ import annotations

import torch


def rope_cos_sin(max_pos: int, head_dim: int, base: float = 10000.0,
                 device: torch.device | str = "cpu"):
    """The (max_pos, head_dim) fp32 cos/sin tables."""
    inv_freq = 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                            device=device) / head_dim))
    t = torch.arange(max_pos, dtype=torch.float32, device=device)
    emb = torch.cat([torch.outer(t, inv_freq)] * 2, dim=-1)
    return emb.cos(), emb.sin()


def _rotate_half(x: torch.Tensor) -> torch.Tensor:
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([-x2, x1], dim=-1)


def apply_rope(q, k, cos, sin, position_ids):
    """Rotate q/k of shape (B, S, H, D) by per-token positions (B, S)."""
    cos_g = cos[position_ids][:, :, None, :].to(q.dtype)
    sin_g = sin[position_ids][:, :, None, :].to(q.dtype)
    return q * cos_g + _rotate_half(q) * sin_g, k * cos_g + _rotate_half(k) * sin_g
