"""Segment-id attention in plain PyTorch and its dispatch, the port of
``mmmm_tpu/ops/attention.py`` (``_build_mask``, ``_xla_attention``,
``segment_attention`` and ``decode_attention_bhsd``).

Tokens attend to each other iff they carry the same nonzero segment id
(0 marks padding); ``causal`` adds the lower-triangular constraint by
absolute position. Softmax is fp32 (float64 for float64 operands) and a
query row with no valid key gives exactly zero. ``segment_attention``
dispatches as the reference does: ``"pallas"`` to the flash site (K3
forward, K7 backward), ``"xla"`` to the plain masked attention, ``"auto"``
on the card to the dense kernel K4 for all-valid encoder sites and to flash
for causal sites or 128-multiple head dims, and to the plain attention on
the CPU (the reference's ``"auto"`` off the TPU).
"""
from __future__ import annotations

import torch

NEG_INF = -1e30


def compute_dtype(dtype: torch.dtype) -> torch.dtype:
    """fp32 for bf16/fp32 operands, float64 for float64 ones."""
    return torch.promote_types(dtype, torch.float32)


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
    where no key is valid. The row max is detached, as the reference's
    ``stop_gradient``: the gradient through it cancels."""
    ct = compute_dtype(q.dtype)
    mask = mask[:, None]
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct)) * scale
    logits = torch.where(mask, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True).detach()
    unnorm = torch.where(mask, torch.exp(logits - m), 0.0)
    denom = unnorm.sum(dim=-1, keepdim=True)
    probs = unnorm / denom.clamp_min(1e-30)
    out = torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    lse = torch.where(denom > 0, m + torch.log(denom.clamp_min(1e-30)), 0.0)[..., 0]
    return out, lse


def segment_attention(q, k, v, q_segments, kv_segments=None, *, causal: bool = False,
                      scale: float | None = None, impl: str = "auto",
                      all_valid: bool = False) -> torch.Tensor:
    """Block-diagonal (optionally causal) attention with segment-id masking.

    q: (B, Sq, H, D); k, v: (B, Skv, H, D); segments (B, Sq) / (B, Skv),
    ``kv_segments`` defaulting to ``q_segments``. ``impl`` is ``"auto"``,
    ``"xla"`` or ``"pallas"`` (``"ring"`` waits for the parallel slice);
    ``all_valid`` declares every position a real token of one segment (the
    encoders), which lets ``"xla"`` skip the mask and ``"auto"`` take K4.
    Returns (B, Sq, H, D) in v's dtype; masked rows are zero. Every route
    is differentiable."""
    if kv_segments is None:
        kv_segments = q_segments
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if impl == "ring":
        raise NotImplementedError("impl='ring' (sequence-parallel ring attention) waits for "
                                  "the parallel slice of the port (ROADMAP Queue 1)")
    if impl == "auto":
        if q.is_cuda and all_valid and not causal:
            from .dense_attn import dense_attention_site, fits_dense_kernel

            if fits_dense_kernel(q.shape[1], q.shape[-1]):
                return dense_attention_site(q, k, v, scale)
        impl = "pallas" if q.is_cuda and (causal or q.shape[-1] % 128 == 0) else "xla"
    if impl == "pallas":
        from .flash import flash_attention

        seg = q_segments.to(torch.int32).contiguous()
        kseg = seg if kv_segments is q_segments else kv_segments.to(torch.int32).contiguous()
        return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(), seg, kseg,
                               causal=causal, scale=scale)
    if impl != "xla":
        raise ValueError(f"unknown attention impl {impl!r}")
    if all_valid and not causal:
        from .dense_attn import dense_attention_plain

        return dense_attention_plain(q, k, v, scale)
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
