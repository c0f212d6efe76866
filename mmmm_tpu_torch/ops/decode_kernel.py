"""K1 and K2: the decode-step kernels over a (B, H, Smax, D) KV cache, the port
of ``mmmm_tpu/ops/decode_kernel.py`` ``decode_attention_pallas`` (both its
full and ragged forms) and ``kv_append_pallas``.

Each wrapper takes its plain version for CPU tensors and launches the CUDA
kernel (``csrc/decode_attn.cu``, ``csrc/kv_append.cu``) for CUDA tensors.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF

K1 = _cuda.register(_cuda.Kernel(
    "K1", "mmmm_decode_attention",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
     _cuda.F, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/decode_attn.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:853 decode_attention_pallas "
             "(pallas_call :886; ragged :828)",
))
K2 = _cuda.register(_cuda.Kernel(
    "K2", "mmmm_kv_append",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
     _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/kv_append.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:48 kv_append_pallas (pallas_call :75)",
))


def kv_append_plain(k_cache, v_cache, k_new, v_new, write_index):
    """Plain version: row ``[b, :, 0]`` of the new K/V goes to slot
    ``write_index[b]``, in place. At the edges it does what the reference's
    ``dynamic_update_slice`` does: a negative index counts from the end, then
    the slot is clamped to ``[0, Smax - 1]``."""
    smax = k_cache.shape[2]
    slot = write_index.long()
    slot = torch.where(slot < 0, slot + smax, slot).clamp(0, smax - 1)
    rows = torch.arange(k_cache.shape[0], device=k_cache.device)
    k_cache[rows, :, slot] = k_new[:, :, 0]
    v_cache[rows, :, slot] = v_new[:, :, 0]
    return k_cache, v_cache


def kv_append(k_cache, v_cache, k_new, v_new, write_index):
    """Append one K/V row per sample into the caches IN PLACE; returns the
    (same) caches. ``k_new``/``v_new``: (B, H, 1, D); ``write_index``: (B,)."""
    if _cuda.on_cpu("kv_append", k_cache):
        return kv_append_plain(k_cache, v_cache, k_new, v_new, write_index)
    _cuda.check_cuda("kv_append", k_cache, v_cache, k_new, v_new,
                     dtypes=(torch.bfloat16, torch.float32), align=4)
    _cuda.check_cuda("kv_append", write_index, dtypes=(torch.int32,), align=4)
    b, h, smax, d = k_cache.shape
    if v_cache.shape != k_cache.shape or k_new.shape != (b, h, 1, d) or v_new.shape != (b, h, 1, d):
        raise ValueError(f"kv_append: cache {k_cache.shape} vs new rows {k_new.shape}")
    if len({k_cache.dtype, v_cache.dtype, k_new.dtype, v_new.dtype}) != 1:
        raise ValueError("kv_append: caches and new rows must share one dtype")
    if write_index.shape != (b,):
        raise ValueError(f"kv_append: write_index must be ({b},), got {tuple(write_index.shape)}")
    K2(k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
       write_index.data_ptr(), b, h, smax, d, k_cache.element_size(),
       _cuda.stream_of(k_cache))
    return k_cache, v_cache


def decode_attention_plain(q, k_cache, v_cache, kv_len, scale: float | None = None):
    """Plain version, all fp32 as the TPU kernel is: slots ``< kv_len[b]``
    are valid; a sample with no valid slot gets zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    smax = k_cache.shape[2]
    valid = (torch.arange(smax, device=q.device)[None, :] < kv_len[:, None].long())
    valid = valid[:, None, None, :]  # (B, 1, 1, Smax)
    qh = q.float().transpose(1, 2)  # (B, H, 1, D)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, k_cache.float()) * scale
    logits = torch.where(valid, logits, NEG_INF)
    m = logits.amax(dim=-1, keepdim=True)
    p = torch.where(valid, torch.exp(logits - m), 0.0)
    p = p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v_cache.float())
    return out.transpose(1, 2).to(q.dtype)  # (B, 1, H, D)


def decode_attention(q, k_cache, v_cache, kv_len, scale: float | None = None):
    """One query token per sample against the cache: q (B, 1, H, D), caches
    (B, H, Smax, D), kv_len (B,) -> (B, 1, H, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _cuda.on_cpu("decode_attention", q):
        return decode_attention_plain(q, k_cache, v_cache, kv_len, scale)
    _cuda.check_cuda("decode_attention", q, k_cache, v_cache,
                     dtypes=(torch.bfloat16, torch.float32))
    _cuda.check_cuda("decode_attention", kv_len, dtypes=(torch.int32,), align=4)
    b, h, smax, d = k_cache.shape
    if q.shape != (b, 1, h, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"decode_attention: q {q.shape} vs cache {k_cache.shape}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError("decode_attention: q and caches must share one dtype")
    if kv_len.shape != (b,):
        raise ValueError(f"decode_attention: kv_len must be ({b},), got {tuple(kv_len.shape)}")
    if d > 128 or d % 4:
        raise ValueError(f"decode_attention: head dim {d} must be <= 128 and a multiple of 4")
    out = torch.empty_like(q)
    K1(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(),
       out.data_ptr(), b, h, smax, d, float(scale), int(q.dtype == torch.bfloat16),
       _cuda.stream_of(q))
    return out
