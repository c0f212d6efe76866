"""Fused (blockwise) cross-entropy over the vocabulary projection, the port of
``mmmm_tpu/ops/fused_ce.py`` (``fused_ce`` with its custom VJP and
``fused_weighted_ce_loss``).

Per-token CE is computed from the hidden states and the ``lm_head`` in
vocabulary blocks of ``block_v`` with a running ``(max, sumexp)``, so no
(T, V) logits are ever stored; the backward rebuilds each block's logits
and produces ``dh`` and ``d(lm_head)`` blockwise. Logits are fp32: bf16
operands are multiplied in fp32 (the reference's
``preferred_element_type=float32``; TF32 stays off). The last block holds
the vocabulary's remaining columns; the reference pads it to ``block_v``
with ``NEG_INF`` logits, which add nothing to the max or the sum. The
reference leaves these products to XLA, so ``torch.matmul`` computes them
here, on both devices.
"""
from __future__ import annotations

import torch

from .attention import compute_dtype

NEG_INF = -1e30


def _logits(hidden, w_blk):
    ct = compute_dtype(hidden.dtype)
    return hidden.to(ct) @ w_blk.to(ct)


class FusedCE(torch.autograd.Function):
    """Per-token CE of ``softmax(hidden @ lm_head)`` against ``labels``."""

    @staticmethod
    def forward(ctx, hidden, lm_head, labels, block_v: int):
        t = hidden.shape[0]
        v = lm_head.shape[1]
        ct = compute_dtype(hidden.dtype)
        m = torch.full((t,), NEG_INF, dtype=ct, device=hidden.device)
        s = torch.zeros((t,), dtype=ct, device=hidden.device)
        tgt = torch.zeros((t,), dtype=ct, device=hidden.device)
        for off in range(0, v, block_v):
            logits = _logits(hidden, lm_head[:, off:off + block_v])
            m_new = torch.maximum(m, logits.amax(dim=-1))
            s = s * torch.exp(m - m_new) + torch.exp(logits - m_new[:, None]).sum(-1)
            local = labels - off
            in_blk = (local >= 0) & (local < block_v)
            picked = logits.gather(1, local.clamp(0, logits.shape[1] - 1)[:, None])[:, 0]
            tgt = torch.where(in_blk, picked, tgt)
            m = m_new
        ctx.save_for_backward(hidden, lm_head, labels, m, s)
        ctx.block_v = block_v
        return m + torch.log(s.clamp_min(1e-30)) - tgt

    @staticmethod
    def backward(ctx, g):
        hidden, lm_head, labels, m, s = ctx.saved_tensors
        block_v = ctx.block_v
        ct = compute_dtype(hidden.dtype)
        inv_s = 1.0 / s.clamp_min(1e-30)
        dh = torch.zeros(hidden.shape, dtype=ct, device=hidden.device)
        dw = torch.empty_like(lm_head)
        hc = hidden.to(ct)
        for off in range(0, lm_head.shape[1], block_v):
            w_blk = lm_head[:, off:off + block_v]
            logits = _logits(hidden, w_blk)
            p = torch.exp(logits - m[:, None]) * inv_s[:, None]
            col = off + torch.arange(logits.shape[1], device=hidden.device)
            onehot = (col[None, :] == labels[:, None]).to(ct)
            gtok = ((p - onehot) * g[:, None]).to(hidden.dtype).to(ct)
            dh += gtok @ w_blk.to(ct).T
            dw[:, off:off + block_v] = (hc.T @ gtok).to(lm_head.dtype)
        return dh.to(hidden.dtype), dw, None, None


def fused_ce(hidden: torch.Tensor, lm_head: torch.Tensor, labels: torch.Tensor,
             block_v: int = 4096) -> torch.Tensor:
    """hidden (T, C), lm_head (C, V), labels (T,) int -> CE (T,) fp32.
    Out-of-range labels give garbage CE that the caller masks."""
    return FusedCE.apply(hidden, lm_head, labels, block_v)


def fused_weighted_ce_loss(hidden: torch.Tensor, lm_head: torch.Tensor,
                           labels: torch.Tensor, weight: torch.Tensor | None = None, *,
                           ignore_index: int = -100, block_v: int = 4096,
                           denom: torch.Tensor | None = None) -> torch.Tensor:
    """``weighted_ce_loss`` fed hidden states (B, S, C) instead of logits:
    the weighted sum of per-token CE over non-ignored tokens, normalized by
    the COUNT of non-ignored tokens (``denom`` where given, e.g. a larger
    batch's count)."""
    b, s, c = hidden.shape
    mask = labels != ignore_index
    safe = torch.where(mask, labels, 0)
    ce = fused_ce(hidden.reshape(b * s, c), lm_head, safe.reshape(-1), block_v).reshape(b, s)
    ce = torch.where(mask, ce, 0.0)
    denom = (mask.sum() if denom is None else denom).clamp_min(1)
    if weight is None:
        return ce.sum() / denom
    return (ce * weight.to(ce.dtype)).sum() / denom
