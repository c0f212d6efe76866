"""K11: the W4A16 product over int4-packed weights, the port of
``mmmm_tpu/ops/w4_matmul.py`` (``pack_int4``, ``unpack_int4``, ``w4_matmul``,
``w4_matmul_xla``).

Packing ("split halves"): ``packed[i, n]`` holds original row ``i`` in its
low nibble and row ``K/2 + i`` in its high nibble, so one block of packed
rows covers one scale group in each half. Scales are one fp32 value per
(group of ``group`` input rows, output column).

``w4_matmul`` computes ``w4_matmul_xla``'s function, which is what the
reference runs off the TPU: the weight ``W[k, n] = nibble(k, n) *
s4[k // group, n]`` rounded to x's dtype, ``y = x @ W`` with fp32 sums,
the result in x's dtype. It takes the plain version for CPU tensors and
launches a kernel of ``csrc/w4_matmul.cu`` for CUDA tensors: the CUDA-core
GEMV kernel (``K11``) for fp32 x and for at most 16 rows, the tensor-core
tile kernel (``K11mma``) for more bf16 rows.
"""
from __future__ import annotations

import torch

from . import _cuda

_REPLACES = "mmmm_tpu/ops/w4_matmul.py:83 w4_matmul (pallas_call :105, _w4_kernel :59)"
K11 = _cuda.register(_cuda.Kernel(
    "K11", "mmmm_w4_gemv",
    [_cuda.P] * 5 + [_cuda.I] * 5 + [_cuda.P],
    source="mmmm_tpu_torch/csrc/w4_matmul.cu", replaces=_REPLACES,
))
K11MMA = _cuda.register(_cuda.Kernel(
    "K11mma", "mmmm_w4_mma",
    [_cuda.P] * 4 + [_cuda.I] * 4 + [_cuda.P],
    source="mmmm_tpu_torch/csrc/w4_matmul.cu", replaces=_REPLACES,
))
GEMV_MAX_ROWS = 16  # bf16 products with more rows take the tensor-core kernel


def pack_int4(q: torch.Tensor) -> torch.Tensor:
    """(K, N) int8 values in [-8, 7] -> (K/2, N) packed int8: low nibble =
    rows [0, K/2), high nibble = rows [K/2, K)."""
    k = q.shape[0]
    lo = q[: k // 2].to(torch.int32)
    hi = q[k // 2:].to(torch.int32)
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def unpack_int4(packed: torch.Tensor) -> torch.Tensor:
    """Inverse of ``pack_int4``: (K/2, N) int8 -> (K, N) int8 in [-8, 7]."""
    p = packed.to(torch.int32)
    lo = ((p & 0xF) ^ 8) - 8
    hi = p >> 4  # arithmetic shift sign-extends the high nibble
    return torch.cat([lo, hi], dim=0).to(torch.int8)


def w4_matmul_plain(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """Plain version (``w4_matmul_xla``): unpack, scale in fp32, round the
    weight to x's dtype, one matmul. x (M, K), q4 (K/2, N), s4 (K/group, N)
    -> (M, N) in x's dtype."""
    group = 2 * q4.shape[0] // s4.shape[0]
    w = unpack_int4(q4).float() * s4.float().repeat_interleave(group, dim=0)
    return (x @ w.to(x.dtype)).to(x.dtype)


def w4_matmul(x: torch.Tensor, q4: torch.Tensor, s4: torch.Tensor) -> torch.Tensor:
    """``x @ W`` for a packed int4 weight: x (M, K) bf16 or fp32, q4 (K/2, N)
    int8, s4 (K/group, N) fp32 -> (M, N) in x's dtype."""
    if _cuda.on_cpu("w4_matmul", x):
        return w4_matmul_plain(x, q4, s4)
    _cuda.check_cuda("w4_matmul", x, dtypes=(torch.bfloat16, torch.float32), align=4)
    _cuda.check_cuda("w4_matmul", q4, dtypes=(torch.int8,))
    _cuda.check_cuda("w4_matmul", s4, dtypes=(torch.float32,))
    m, k = x.shape
    k2, n = q4.shape
    if k != 2 * k2 or s4.dim() != 2 or s4.shape[1] != n or s4.shape[0] % 2 or not m:
        raise ValueError(f"w4_matmul: x {tuple(x.shape)}, q4 {tuple(q4.shape)}, "
                         f"s4 {tuple(s4.shape)}")
    group = k // s4.shape[0]
    if group * s4.shape[0] != k or group % 32 or group > 512:
        raise ValueError(f"w4_matmul: group {k}/{s4.shape[0]} must be a multiple of 32, <= 512")
    if n % 16:
        raise ValueError(f"w4_matmul: N={n} must be a multiple of 16")
    bf16 = x.dtype == torch.bfloat16
    out = torch.empty((m, n), dtype=x.dtype, device=x.device)
    stream = _cuda.stream_of(x)
    if bf16 and m > GEMV_MAX_ROWS and n % 64 == 0:
        if x.data_ptr() % 16:
            raise ValueError("w4_matmul: x must be 16-byte aligned")
        K11MMA(x.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(), m, k, n, group,
               stream)
        return out
    # one fp32 partial product per scale group of packed rows, summed in order
    part = torch.empty((k2 // group, m, n), dtype=torch.float32, device=x.device)
    K11(x.data_ptr(), q4.data_ptr(), s4.data_ptr(), out.data_ptr(), part.data_ptr(), m, k, n,
        group, int(bf16), stream)
    return out
