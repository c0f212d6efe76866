"""K4: all-valid bidirectional attention for the encoder sites (EVA ViT, SAM
encoder), the port of ``mmmm_tpu/ops/dense_attn.py dense_attention``.

``dense_attention`` takes the plain version for CPU tensors and launches the
CUDA kernel (``csrc/dense_attn.cu``) for CUDA tensors; there is no other
route. Layout is (B, S, H, D) in and out, in the input's dtype (bf16 for the
ViT, fp32 for the SAM encoder). The kernel reads that layout natively, so it
is also the counterpart of the reference's layout-native variant K12
(``_dense_fwd_bshd``), which computes the same function.

``dense_attention_site`` is the differentiable encoder site of the training
step (the reference's ``jax.custom_vjp``): K4 forward, and a backward that
recomputes through the plain dense attention (``_vjp_bwd``), which adds no
kernel. ``fits_dense_kernel`` is the reference's gate for ``"auto"``.

``dense_attention_nosm`` is probe P1 (``scripts/tpu_probes.py nosm_fwd``):
K4 with the softmax replaced by one multiply, a floor for K4's time that
only ``chip_smoke.py`` runs.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import compute_dtype

K4 = _cuda.register(_cuda.Kernel(
    "K4", "mmmm_dense_attention",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
     _cuda.F, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/dense_attn.cu",
    replaces="mmmm_tpu/ops/dense_attn.py:217 dense_attention (pallas_call :103)",
))
P1 = _cuda.register(_cuda.Kernel(
    "P1", "mmmm_dense_attention_nosm",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.P],
    source="mmmm_tpu_torch/csrc/dense_attn.cu",
    replaces="scripts/tpu_probes.py:667 nosm_fwd (pallas_call :669, _kernel_nosm :649)",
))


_VMEM_BUDGET = 12 * 1024 * 1024  # the reference's gate, kept for "auto"


def fits_dense_kernel(s: int, d: int) -> bool:
    """``dense_attn.py fits_dense_kernel``: some q tile of the padded
    sequence fits the reference kernel's VMEM budget."""
    s_pad = -(-s // 128) * 128
    return any(s_pad % bq == 0 and 2 * s_pad * d * 2 + bq * d * 2 + bq * s_pad * 6
               + bq * d * 4 <= _VMEM_BUDGET for bq in (640, 512, 384, 256, 128))


def dense_attention_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: float) -> torch.Tensor:
    """Plain version: fp32 logits, full-row softmax, probabilities cast to
    the value dtype for the PV product (``attention.py _xla_attention_dense``)."""
    ct = compute_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))
    probs = torch.softmax(logits * scale, dim=-1)
    return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float) -> torch.Tensor:
    """All-valid bidirectional attention, (B, S, H, D) -> (B, S, H, D)."""
    if _cuda.on_cpu("dense_attention", q):
        return dense_attention_plain(q, k, v, scale)
    _cuda.check_cuda("dense_attention", q, k, v, dtypes=(torch.bfloat16, torch.float32))
    if not (q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype and q.dim() == 4):
        raise ValueError(f"dense_attention: mismatched q/k/v {q.shape} {k.shape} {v.shape}")
    b, s, h, d = q.shape
    if d > 128:
        raise ValueError(f"dense_attention: head dim {d} > 128")
    out = torch.empty_like(q)
    K4(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
       float(scale), int(q.dtype == torch.bfloat16), _cuda.stream_of(q))
    return out


class DenseAttention(torch.autograd.Function):
    """K4 forward; the backward recomputes through the plain version."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return dense_attention(q, k, v, scale)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = dense_attention_plain(q, k, v, ctx.scale)
        return (*torch.autograd.grad(out, (q, k, v), g), None)


def dense_attention_site(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """Differentiable :func:`dense_attention` (K4 forward)."""
    return DenseAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale)


def dense_attention_nosm_plain(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """Plain version of P1 (``_kernel_nosm``): ``p = (scale * q k^T) *
    1e-4`` in fp32, cast to the value dtype, ``p v`` with fp32 sums."""
    p = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale * 1e-4
    return torch.einsum("bhqk,bkhd->bqhd", p.to(v.dtype), v)


def dense_attention_nosm(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float) -> torch.Tensor:
    """P1 on (B, S, H, D) bf16 operands (the tensor-core kernel only)."""
    if _cuda.on_cpu("dense_attention_nosm", q):
        return dense_attention_nosm_plain(q, k, v, scale)
    _cuda.check_cuda("dense_attention_nosm", q, k, v, dtypes=(torch.bfloat16,))
    if not (q.shape == k.shape == v.shape and q.dim() == 4):
        raise ValueError(f"dense_attention_nosm: mismatched q/k/v {q.shape} {k.shape} {v.shape}")
    b, s, h, d = q.shape
    if d > 128:
        raise ValueError(f"dense_attention_nosm: head dim {d} > 128")
    out = torch.empty_like(q)
    P1(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, float(scale),
       _cuda.stream_of(q))
    return out
