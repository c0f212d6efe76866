"""Segment-id flash attention, forward K3 and backward K7, the port of
``mmmm_tpu/ops/flash.py`` (``flash_segment_attention``, ``_flash_bwd_impl``
and their ``jax.custom_vjp``).

Contract (``mmmm_tpu/ops/attention.py segment_attention``): query i attends
key j iff both carry the same nonzero segment id and, when causal, i >= j by
absolute position. A query row with no valid key gives output 0 and
logsumexp 0. The forward returns ``(out (B, Sq, H, D) in the value dtype,
lse (B, H, Sq) fp32)``; lse is of the scaled logits.

The backward recomputes the probabilities from lse (``p = exp(s - lse)``
on valid pairs), with ``delta = rowsum(dO * O)`` in fp32 (the reference
computes it in XLA; here kernel ``K7delta`` on the card, ``_delta`` on the
CPU); ``p`` and ``ds = p (dO v^T - delta)`` are rounded to the operand dtype
before their products. It runs as two kernels, ``K7dq`` (dq) and ``K7dkv``
(dk, dv), the reference's split: ``wgmma`` with a TMA ring in bf16,
register-blocked CUDA-core tiles with a ``cp.async`` ring in fp32.

``flash_segment_attention`` and ``flash_segment_attention_bwd`` take the
plain version for CPU tensors and launch ``csrc/flash_fwd.cu`` and
``csrc/flash_bwd.cu`` for CUDA tensors, at the head dim
``attention.kernel_head_dim`` gives (a head dim the kernels cannot take
directly is padded with zero lanes, and the outputs sliced back; above 128
they raise). ``flash_attention`` is the differentiable site, the operator
``mmmm::flash_attention`` that the dispatcher (and so a selective
rematerialization policy) sees: K3 forward, K7 backward.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import (build_mask, compute_dtype, kernel_head_dim, masked_attention,
                        with_padded_head)

K3 = _cuda.register(_cuda.Kernel(
    "K3", "mmmm_flash_fwd",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P,
     _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.I, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/flash_fwd.cu",
    replaces="mmmm_tpu/ops/flash.py:378 flash_segment_attention (pallas_call :249)",
))
_BWD_ARGS = [_cuda.P] * 8  # q, k, v, dout, q_segments, kv_segments, lse, delta
K7DQ = _cuda.register(_cuda.Kernel(
    "K7dq", "mmmm_flash_bwd_dq",
    [*_BWD_ARGS, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.I,
     _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/flash_bwd.cu",
    replaces="mmmm_tpu/ops/flash.py:280 _flash_bwd_impl (pallas_call :305, _dq_kernel :113)",
))
K7DKV = _cuda.register(_cuda.Kernel(
    "K7dkv", "mmmm_flash_bwd_dkv",
    [*_BWD_ARGS, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F,
     _cuda.I, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/flash_bwd.cu",
    replaces="mmmm_tpu/ops/flash.py:280 _flash_bwd_impl (pallas_call :329, _dkv_kernel :161)",
))

K7DELTA = _cuda.register(_cuda.Kernel(
    "K7delta", "mmmm_flash_bwd_delta",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/flash_bwd.cu",
    replaces="mmmm_tpu/ops/flash.py:292 delta in _flash_bwd_impl (XLA, before pallas_call :305)",
))


def flash_segment_attention_plain(q, k, v, q_segments, kv_segments, *, causal: bool,
                                  scale: float):
    """Plain version: the masked fp32 softmax of ``_xla_attention`` plus its
    logsumexp."""
    return masked_attention(q, k, v, build_mask(q_segments, kv_segments, causal), scale)


def _check(name, q, k, v, q_segments, kv_segments, *more):
    _cuda.check_cuda(name, q, k, v, *more, dtypes=(torch.bfloat16, torch.float32))
    _cuda.check_cuda(name, q_segments, kv_segments, dtypes=(torch.int32,), align=4)
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if not (k.shape == v.shape == (b, skv, h, d) and q.dtype == k.dtype == v.dtype):
        raise ValueError(f"{name}: mismatched q/k/v {q.shape} {k.shape} {v.shape}")
    if any(t.shape != q.shape or t.dtype != q.dtype for t in more):
        raise ValueError(f"{name}: out and its gradient must match q")
    if q_segments.shape != (b, sq) or kv_segments.shape != (b, skv):
        raise ValueError(f"{name}: segment ids must be (B, Sq) and (B, Skv)")
    if kernel_head_dim(d, q.dtype) is None:
        raise ValueError(f"{name}: no kernel takes head dim {d} in {q.dtype}")
    return b, sq, skv, h, d


def flash_segment_attention(q, k, v, q_segments, kv_segments, *, causal: bool,
                            scale: float):
    """Segment-id (optionally causal) attention; returns ``(out, lse)``."""
    if _cuda.on_cpu("flash_segment_attention", q):
        return flash_segment_attention_plain(
            q, k, v, q_segments, kv_segments, causal=causal, scale=scale)
    b, sq, skv, h, d = _check("flash_segment_attention", q, k, v, q_segments, kv_segments)
    dp = kernel_head_dim(d, q.dtype)
    if dp != d:
        return with_padded_head(dp, lambda *t: flash_segment_attention(
            *t, q_segments, kv_segments, causal=causal, scale=scale), q, k, v)
    out = torch.empty_like(q)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    K3(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_segments.data_ptr(),
       kv_segments.data_ptr(), out.data_ptr(), lse.data_ptr(), b, sq, skv, h, d,
       float(scale), int(causal), int(q.dtype == torch.bfloat16), _cuda.stream_of(q))
    return out, lse


def _delta(out, g):
    """rowsum(dO * O) in fp32 (float64 for float64 operands), (B, H, Sq):
    the plain version of K7delta."""
    ct = compute_dtype(out.dtype)
    return (g.to(ct) * out.to(ct)).sum(-1).transpose(1, 2).contiguous()


def flash_segment_attention_bwd_plain(q, k, v, q_segments, kv_segments, out, lse, g, *,
                                      causal: bool, scale: float):
    """Plain version of K7 (``_dq_kernel`` and ``_dkv_kernel`` written out):
    returns ``(dq, dk, dv)`` in the operands' dtypes."""
    ct = compute_dtype(q.dtype)
    mask = build_mask(q_segments, kv_segments, causal)[:, None]  # (B, 1, Sq, Skv)
    delta = _delta(out, g)[..., None]
    qc, kc, vc, gc = (t.to(ct) for t in (q, k, v, g))
    s = torch.einsum("bqhd,bkhd->bhqk", qc, kc) * scale
    p = torch.where(mask, torch.exp(s - lse.to(ct)[..., None]), 0.0)
    dv = torch.einsum("bhqk,bqhd->bkhd", p.to(g.dtype).to(ct), gc)
    ds = p * (torch.einsum("bqhd,bkhd->bhqk", gc, vc) - delta)
    dq = scale * torch.einsum("bhqk,bkhd->bqhd", ds.to(k.dtype).to(ct), kc)
    dk = scale * torch.einsum("bhqk,bqhd->bkhd", ds.to(q.dtype).to(ct), qc)
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def flash_segment_attention_bwd(q, k, v, q_segments, kv_segments, out, lse, g, *,
                                causal: bool, scale: float):
    """The backward of :func:`flash_segment_attention` from its ``out`` and
    ``lse`` and the output gradient ``g``; returns ``(dq, dk, dv)``."""
    if _cuda.on_cpu("flash_segment_attention_bwd", q):
        return flash_segment_attention_bwd_plain(q, k, v, q_segments, kv_segments, out, lse,
                                                 g, causal=causal, scale=scale)
    b, sq, skv, h, d = _check("flash_segment_attention_bwd", q, k, v, q_segments,
                              kv_segments, out, g)
    _cuda.check_cuda("flash_segment_attention_bwd", lse, dtypes=(torch.float32,), align=4)
    if lse.shape != (b, h, sq):
        raise ValueError(f"flash_segment_attention_bwd: lse must be (B, H, Sq), got {lse.shape}")
    dp = kernel_head_dim(d, q.dtype)
    if dp != d:
        return with_padded_head(dp, lambda q_, k_, v_, o_, g_: flash_segment_attention_bwd(
            q_, k_, v_, q_segments, kv_segments, o_, lse, g_, causal=causal, scale=scale),
            q, k, v, out, g)
    bf16 = int(q.dtype == torch.bfloat16)
    stream = _cuda.stream_of(q)
    delta = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    K7DELTA(out.data_ptr(), g.data_ptr(), delta.data_ptr(), b, sq, h, d, bf16, stream)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    ptrs = [t.data_ptr() for t in (q, k, v, g, q_segments, kv_segments, lse, delta)]
    tail = (b, sq, skv, h, d, float(scale), int(causal), bf16, stream)
    K7DQ(*ptrs, dq.data_ptr(), *tail)
    K7DKV(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail)
    return dq, dk, dv


@torch.library.custom_op("mmmm::flash_attention", mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, q_segments: torch.Tensor,
              kv_segments: torch.Tensor, causal: bool, scale: float,
              name: str) -> tuple[torch.Tensor, torch.Tensor]:
    return flash_segment_attention(q, k, v, q_segments, kv_segments, causal=causal,
                                   scale=scale)


def _flash_setup(ctx, inputs, output):
    q, k, v, q_segments, kv_segments, causal, scale, _ = inputs
    ctx.save_for_backward(q, k, v, q_segments, kv_segments, *output)
    ctx.causal, ctx.scale = causal, scale


def _flash_backward(ctx, g, g_lse):
    q, k, v, q_segments, kv_segments, out, lse = ctx.saved_tensors
    dq, dk, dv = flash_segment_attention_bwd(q, k, v, q_segments, kv_segments, out, lse,
                                             g.contiguous(), causal=ctx.causal,
                                             scale=ctx.scale)
    return dq, dk, dv, None, None, None, None, None


torch.library.register_autograd("mmmm::flash_attention", _flash_backward,
                                setup_context=_flash_setup)


def flash_attention(q, k, v, q_segments, kv_segments, *, causal: bool, scale: float,
                    name: str = ""):
    """Differentiable :func:`flash_segment_attention` output: the operator
    ``mmmm::flash_attention`` (K3 forward, saving ``out`` and ``lse``; K7
    backward; the segment ids get no gradient). ``name`` tags its outputs
    for a selective rematerialization policy (``ops/remat.py``: ``"attn"``
    keeps the ones named ``"attn_out"``, so that K3 is not launched again
    in the backward)."""
    # a head dim K7 cannot take raises here, before any work of the step
    if (not _cuda.on_cpu("flash_attention", q) and torch.is_grad_enabled()
            and any(t.requires_grad for t in (q, k, v))
            and kernel_head_dim(q.shape[-1], q.dtype) is None):
        raise ValueError(f"flash_attention: K7 does not take head dim {q.shape[-1]} in "
                         f"{q.dtype}, so this site cannot be differentiated on the card")
    return _flash_op(q, k, v, q_segments, kv_segments, causal, float(scale), name)[0]
