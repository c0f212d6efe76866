"""K4: all-valid bidirectional attention for the encoder sites (EVA ViT, SAM
encoder), the port of ``mmmm_tpu/ops/dense_attn.py dense_attention``.

``dense_attention`` takes the plain version for CPU tensors and launches the
CUDA kernel (``csrc/dense_attn.cu``) for CUDA tensors; there is no other
route. ``fast_softmax=True`` is the reference's ``MMMM_DENSE_FAST_SOFTMAX=1``
body (``_softmax_rows(fast=True)``): ``exp`` of the bf16-rounded ``s - m``,
the bf16 ``p`` summed in fp32, and the normalization after ``p v``; the
kernel's compile-time variant (counted under its form ``"fast"``) subtracts
its running max where the reference subtracts the row's, so the two round
``s - m`` at other points (see ``dense_attention_plain``);
``dense_attention_fast_tiles`` computes the fast form in the kernel's order
of key tiles, to hold the kernel to. Layout is (B, S,
H, D) in and out, in the input's dtype (bf16 for the ViT, fp32 for the SAM
encoder); a head dim the kernel cannot take directly is padded with zero
lanes and the output sliced back
(``attention.kernel_head_dim``). The kernel reads that layout natively, so it
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
from .attention import compute_dtype, kernel_head_dim, with_padded_head

K4 = _cuda.register(_cuda.Kernel(
    "K4", "mmmm_dense_attention",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
     _cuda.F, _cuda.I, _cuda.I, _cuda.P],
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
                          scale: float, *, fast_softmax: bool = False) -> torch.Tensor:
    """Plain version: fp32 logits, full-row softmax, probabilities cast to
    the value dtype for the PV product (``attention.py _xla_attention_dense``).

    ``fast_softmax``: the reference kernel's fast form: with ``m`` the full
    row's max, ``p = bf16(exp(bf16(s - m)))``, its row sum in fp32, ``p v``
    with fp32 sums, then divided by the sum. The kernel (an online softmax)
    subtracts a running max and rescales by ``exp(m_old - m_new)``; the
    bf16 rounding of ``s - m`` then falls elsewhere: each ``p`` may move by
    up to ``2^-8 |s - m| p`` (at most 2^-8 / e absolute), against the
    reference's own 2^-9 rounding of the same quantity."""
    ct = compute_dtype(q.dtype)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.to(ct), k.to(ct))
    if not fast_softmax:
        probs = torch.softmax(logits * scale, dim=-1)
        return torch.einsum("bhqk,bkhd->bqhd", probs.to(v.dtype), v)
    s = logits * scale
    m = s.amax(dim=-1, keepdim=True)
    p = torch.exp((s - m).to(torch.bfloat16).to(ct)).to(torch.bfloat16).to(ct)
    denom = p.sum(dim=-1)  # (B, H, Sq)
    o = torch.einsum("bhqk,bkhd->bqhd", p, v.to(ct))
    return (o / denom.transpose(1, 2)[..., None]).to(v.dtype)


def fast_softmax_key_tile(s: int, dtype: torch.dtype) -> int:
    """The keys K4 takes a step at a time (``attn_fwd.cuh``): 128 for the
    bf16 kernel from 512 keys on (``fwd_long_keys``), else 64; the fp32
    kernel's ``kF32Stream``, 32."""
    if dtype == torch.bfloat16:
        return 128 if s >= 512 else 64
    return 32


def dense_attention_fast_tiles(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                               scale: float) -> torch.Tensor:
    """The fast form in the kernel's own order, which the kernel is held
    to: over key tiles of :func:`fast_softmax_key_tile`, ``m`` the running
    max, ``p = bf16(exp(bf16(s - m)))``, the row sum and ``p v`` rescaled
    by ``exp(m_old - m_new)`` at each tile, divided at the end. With one
    tile it is :func:`dense_attention_plain`'s fast form."""
    ct = compute_dtype(q.dtype)
    b, s, h, d = q.shape
    tile = fast_softmax_key_tile(k.shape[1], q.dtype)
    qc = q.to(ct)
    m = torch.full((b, h, s, 1), float("-inf"), dtype=ct, device=q.device)
    l = torch.zeros((b, h, s, 1), dtype=ct, device=q.device)
    acc = torch.zeros((b, h, s, d), dtype=ct, device=q.device)
    for k0 in range(0, k.shape[1], tile):
        st = torch.einsum("bqhd,bkhd->bhqk", qc, k[:, k0:k0 + tile].to(ct)) * scale
        m_new = torch.maximum(m, st.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        p = torch.exp((st - m_new).to(torch.bfloat16).to(ct)).to(torch.bfloat16).to(ct)
        l = l * alpha + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.einsum("bhqk,bkhd->bhqd", p, v[:, k0:k0 + tile].to(ct))
        m = m_new
    return (acc / l).transpose(1, 2).to(v.dtype)


def dense_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    scale: float, *, fast_softmax: bool = False) -> torch.Tensor:
    """All-valid bidirectional attention, (B, S, H, D) -> (B, S, H, D)."""
    if _cuda.on_cpu("dense_attention", q):
        return dense_attention_plain(q, k, v, scale, fast_softmax=fast_softmax)
    _cuda.check_cuda("dense_attention", q, k, v, dtypes=(torch.bfloat16, torch.float32))
    if not (q.shape == k.shape == v.shape and q.dtype == k.dtype == v.dtype and q.dim() == 4):
        raise ValueError(f"dense_attention: mismatched q/k/v {q.shape} {k.shape} {v.shape}")
    b, s, h, d = q.shape
    dp = kernel_head_dim(d, q.dtype)
    if dp is None:
        raise ValueError(f"dense_attention: no kernel takes head dim {d} in {q.dtype}")
    if dp != d:
        return with_padded_head(dp, lambda *t: dense_attention(
            *t, scale, fast_softmax=fast_softmax), q, k, v)
    out = torch.empty_like(q)
    K4(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d,
       float(scale), int(q.dtype == torch.bfloat16), int(fast_softmax), _cuda.stream_of(q),
       form="fast" if fast_softmax else None)
    return out


class DenseAttention(torch.autograd.Function):
    """K4 forward; the backward recomputes through the plain version (the
    exact softmax, as the reference's ``_vjp_bwd``)."""

    @staticmethod
    def forward(ctx, q, k, v, scale: float, fast_softmax: bool):
        ctx.save_for_backward(q, k, v)
        ctx.scale = scale
        return dense_attention(q, k, v, scale, fast_softmax=fast_softmax)

    @staticmethod
    def backward(ctx, g):
        q, k, v = (t.detach().requires_grad_() for t in ctx.saved_tensors)
        with torch.enable_grad():
            out = dense_attention_plain(q, k, v, ctx.scale)
        return (*torch.autograd.grad(out, (q, k, v), g), None, None)


def dense_attention_site(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                         scale: float, *, fast_softmax: bool = False) -> torch.Tensor:
    """Differentiable :func:`dense_attention` (K4 forward)."""
    return DenseAttention.apply(q.contiguous(), k.contiguous(), v.contiguous(), scale,
                                fast_softmax)


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
    dp = kernel_head_dim(d, q.dtype)
    if dp is None:
        raise ValueError(f"dense_attention_nosm: no kernel takes head dim {d}")
    if dp != d:
        return with_padded_head(dp, lambda *t: dense_attention_nosm(*t, scale), q, k, v)
    out = torch.empty_like(q)
    P1(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), b, s, h, d, float(scale),
       _cuda.stream_of(q))
    return out
