"""Segment-id attention semantics in plain PyTorch, the port of
``mmmm_tpu/ops/attention.py`` (``_build_mask``, ``_xla_attention``,
``segment_attention`` and ``decode_attention_bhsd``).

Tokens attend to each other iff they carry the same nonzero segment id
(0 marks padding); ``causal`` adds the lower-triangular constraint by
absolute position. Softmax is fp32 and a query row with no valid key gives
exactly zero. These functions are the references the kernels' plain
versions follow; the model code calls the kernel wrappers
(``dense_attn``, ``flash``, ``decode_kernel``) directly.
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def build_mask(q_segments: torch.Tensor, kv_segments: torch.Tensor, causal: bool,
               q_offset: int = 0) -> torch.Tensor:
    """(B, Sq, Skv) bool validity mask."""
    qs = q_segments[:, :, None]
    ks = kv_segments[:, None, :]
    valid = (qs == ks) & (qs != 0) & (ks != 0)
    if causal:
        sq, skv = q_segments.shape[1], kv_segments.shape[1]
        q_pos = torch.arange(sq, device=valid.device)[:, None] + q_offset
        kv_pos = torch.arange(skv, device=valid.device)[None, :]
        valid = valid & (q_pos >= kv_pos)
    return valid


def masked_attention(q, k, v, mask, scale: float):
    """(B, Sq, H, D) attention under a (B, Sq, Skv) mask; returns
    ``(out in v's dtype, lse (B, H, Sq) fp32)`` with zero rows (and lse 0)
    where no key is valid."""
    mask = mask[:, None]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    unnorm = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    lse = torch.where(denom > 0, m + torch.log(denom.clamp_min(1e-30)), 0.0)[..., 0]
    return out, lse


def segment_attention(q, k, v, q_segments, kv_segments=None, *, causal: bool = False,
                      scale: float | None = None) -> torch.Tensor:
    """Block-diagonal (optionally causal) attention with segment-id masking.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D); segments (B, Sq) / (B, Skv),
    ``kv_segments`` defaulting to ``q_segments``. Returns (B, Sq, H, D) in
    v's dtype; masked rows are zero."""
    if kv_segments is None:
        kv_segments = q_segments
    if scale is None:
        scale = q.shape[-1] ** -0.5
    return masked_attention(q, k, v, build_mask(q_segments, kv_segments, causal), scale)[0]


def decode_attention_bhsd(q, k_cache, v_cache, kv_valid, *, scale: float | None = None):
    """Attention of (B, Sq, H, D) queries over a (B, H, Smax, D) cache;
    ``kv_valid`` is (B, Smax), or (B, Sq, Smax) per query. Invalid slots get
    NEG_INF logits (a row with none valid averages the cache, as the
    reference does)."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    qh = q.transpose(1, 2)  # (B, H, Sq, D)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), k_cache.float()) * scale
    mask = kv_valid[:, None, None, :] if kv_valid.dim() == 2 else kv_valid[:, None, :, :]
    logits = torch.where(mask, logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs.to(v_cache.dtype), v_cache)
    return out.transpose(1, 2)
