"""K3: segment-id flash attention forward, the port of ``mmmm_tpu/ops/flash.py
flash_segment_attention`` (forward only; the backward is a later slice).

Contract (``mmmm_tpu/ops/attention.py segment_attention``): query i attends
key j iff both carry the same nonzero segment id and, when causal, i >= j by
absolute position. A query row with no valid key gives output 0 and
logsumexp 0. Returns ``(out (B, Sq, H, D) in the value dtype, lse (B, H, Sq)
fp32)``; lse is of the scaled logits.

``flash_segment_attention`` takes the plain version for CPU tensors and
launches ``csrc/flash_fwd.cu`` for CUDA tensors.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import build_mask, masked_attention

K3 = _cuda.register(_cuda.Kernel(
    "K3", "mmmm_flash_fwd",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
     _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.I, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/flash_fwd.cu",
    replaces="mmmm_tpu/ops/flash.py:378 flash_segment_attention (pallas_call :249)",
))


def flash_segment_attention_plain(q, k, v, q_segments, kv_segments, *, causal: bool,
                                  scale: float):
    """Plain version: the masked fp32 softmax of ``_xla_attention`` plus its
    logsumexp."""
    return masked_attention(q, k, v, build_mask(q_segments, kv_segments, causal), scale)


def flash_segment_attention(q, k, v, q_segments, kv_segments, *, causal: bool,
                            scale: float):
    """Segment-id (optionally causal) attention; returns ``(out, lse)``."""
    if _cuda.on_cpu("flash_segment_attention", q):
        return flash_segment_attention_plain(
            q, k, v, q_segments, kv_segments, causal=causal, scale=scale)
    _cuda.check_cuda("flash_segment_attention", q, k, v,
                     dtypes=(torch.bfloat16, torch.float32))
    _cuda.check_cuda("flash_segment_attention", q_segments, kv_segments,
                     dtypes=(torch.int32,), align=4)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if not (k.shape == v.shape == (b, skv, h, d) and q.dtype == k.dtype == v.dtype):
        raise ValueError(f"flash_segment_attention: mismatched q/k/v {q.shape} {k.shape}")
    if q_segments.shape != (b, sq) or kv_segments.shape != (b, skv):
        raise ValueError("flash_segment_attention: segment ids must be (B, Sq) and (B, Skv)")
    if d > 128:
        raise ValueError(f"flash_segment_attention: head dim {d} > 128")
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    K3(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segments.data_ptr(),
       kv_segments.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, skv, h, d,
       float(scale), int(causal), int(q.dtype == torch.bfloat16), _cuda.stream_of(q))
    return out, lse
