"""Weight quantization for serving (W8A16, W8A8, W4A16) and the int8 KV
cache, the port of ``mmmm_tpu/ops/quant.py`` (``quantize_int8``,
``quantize_int4``, ``is_quantized``, ``qdot``, ``quantize_kv``,
``dequantize_kv``, ``quantize_llm_for_serving``).

Int8 weights are quantized per output channel with an fp32 scale, over the
contraction dim (-2 of an ``(in, out)`` matrix or ``(L, in, out)`` stack);
int4 weights per group of 128 input rows and output column, packed two to a
byte (``ops/w4_matmul.py``). ``qdot`` takes, as the reference does:

  - a plain weight: ``x @ w``;
  - ``{"q", "s"}`` (W8A16): the int8 weight cast to x's dtype, the product,
    then the scale. The reference leaves this to XLA, so it stays
    ``torch.matmul``: on the card it writes and reads a cast copy of each
    weight per call;
  - ``{"q", "s"}`` with ``act_quant=True`` (W8A8): x quantized per row to
    int8, an int8 x int8 -> int32 product, then ``y32 * sx * s``. XLA did
    the product in the reference; here it is ``torch._int_mm`` on the card
    (which needs the weight transposed to K-contiguous, a copy per call)
    and an int32 matmul on the CPU;
  - ``{"q4", "s4"}`` (W4A16): kernel K11 (``w4_matmul``).
"""
from __future__ import annotations

import torch

from .w4_matmul import pack_int4, w4_matmul

LLM_QUANT_KEYS = ("lang_qkv", "lang_dense", "vis_qkv", "vis_dense")
MLP_QUANT_KEYS = ("gate", "up", "down")
INT4_GROUP = 128


def _quantize_2d(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(wf / scale).to(torch.int8), scale


def quantize_int8(w: torch.Tensor, axis: int = -2) -> dict:
    """Per-output-channel symmetric int8 over the contraction dim: returns
    ``{"q": int8, "s": fp32 scale with dim -2 of size 1}``. A stacked
    ``(L, in, out)`` weight is quantized one layer at a time into
    preallocated outputs, so the fp32 temporaries stay one layer large."""
    if axis != -2:
        raise ValueError("quantize_int8 quantizes over the contraction dim (-2)")
    if w.dim() != 3:
        q, s = _quantize_2d(w)
        return {"q": q, "s": s}
    q = torch.empty(w.shape, dtype=torch.int8, device=w.device)
    s = torch.empty((w.shape[0], 1, w.shape[2]), dtype=torch.float32, device=w.device)
    for i in range(w.shape[0]):
        q[i], s[i] = _quantize_2d(w[i])
    return {"q": q, "s": s}


def _quantize_int4_2d(w: torch.Tensor, group: int) -> tuple[torch.Tensor, torch.Tensor]:
    k, n = w.shape
    wf = w.float().reshape(k // group, group, n)
    scale = wf.abs().amax(dim=1, keepdim=True).clamp_min(1e-8) / 7.0
    q = torch.clamp(torch.round(wf / scale), -8, 7).to(torch.int8).reshape(k, n)
    return pack_int4(q), scale[:, 0]


def quantize_int4(w: torch.Tensor, group: int = INT4_GROUP) -> dict:
    """Group-wise symmetric int4 over the contraction dim: ``group`` input
    rows share one fp32 scale per output column. Returns ``{"q4": packed
    (K/2, N) int8, "s4": (K/group, N) fp32}`` (stacked ``(L, ...)`` for an
    ``(L, K, N)`` weight, one layer at a time). Needs ``2 * group | K`` and
    ``256 | N``, as the reference's kernel tiles do."""
    if w.shape[-2] % (2 * group):
        raise ValueError(f"K={w.shape[-2]} not divisible by 2*group={2 * group}")
    if w.shape[-1] % 256:
        raise ValueError(f"N={w.shape[-1]} not divisible by the 256 kernel tile")
    if w.dim() != 3:
        q4, s4 = _quantize_int4_2d(w, group)
        return {"q4": q4, "s4": s4}
    L, k, n = w.shape
    q4 = torch.empty((L, k // 2, n), dtype=torch.int8, device=w.device)
    s4 = torch.empty((L, k // group, n), dtype=torch.float32, device=w.device)
    for i in range(L):
        q4[i], s4[i] = _quantize_int4_2d(w[i], group)
    return {"q4": q4, "s4": s4}


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w) and ("s" in w or "s4" in w)


def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """Exact int8 x int8 -> int32 product of (M, K) by (K, N)."""
    if xq.device.type != "cuda":
        return xq.to(torch.int32) @ wq.to(torch.int32)
    # torch._int_mm takes more than 16 rows (padded here to a multiple of 8)
    # and, through cuBLASLt, a weight whose K is contiguous: the (K, N)
    # weight is transposed for every call
    m = xq.shape[0]
    mp = max(24, -(-m // 8) * 8)
    if mp != m:
        xq = torch.cat([xq, xq.new_zeros((mp - m, xq.shape[1]))])
    return torch._int_mm(xq, wq.t().contiguous().t())[:m]


def qdot(x: torch.Tensor, w, act_quant: bool = False) -> torch.Tensor:
    """``x @ w`` for a plain weight, a ``{"q", "s"}`` int8 weight (W8A16, or
    W8A8 with ``act_quant=True``) or a ``{"q4", "s4"}`` int4 weight (W4A16,
    kernel K11); ``act_quant`` applies to int8 weights only."""
    if not is_quantized(w):
        return x @ w
    if act_quant and "q" in w:
        x2 = x.reshape(-1, x.shape[-1])
        sx = x2.abs().float().amax(dim=1, keepdim=True).clamp_min(1e-8) / 127.0
        xq = torch.round(x2.float() / sx).to(torch.int8)
        y32 = _int8_matmul(xq, w["q"])
        y = (y32.float() * sx * w["s"].squeeze(-2)).to(x.dtype)
        return y.reshape(*x.shape[:-1], y.shape[-1])
    if "q4" in w:
        y = w4_matmul(x.reshape(-1, x.shape[-1]).contiguous(), w["q4"], w["s4"])
        return y.reshape(*x.shape[:-1], y.shape[-1])
    y = x @ w["q"].to(x.dtype)
    return y * w["s"].squeeze(-2).to(y.dtype)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-slot symmetric int8 over the head dim: (..., D) -> (int8 (..., D),
    bf16 scale (..., 1)), one scale per (batch, head, slot)."""
    xf = x.float()
    scale = xf.abs().amax(dim=-1, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(xf / scale).to(torch.int8), scale.to(torch.bfloat16)


def dequantize_kv(q: torch.Tensor, s: torch.Tensor, dtype=torch.bfloat16) -> torch.Tensor:
    return (q.float() * s.float()).to(dtype)


def quantize_llm_for_serving(params: dict, release_originals: bool = True,
                             bits: int = 8) -> dict:
    """The CogVLM tree (``{"llm", "vision"}``) with the LLM expert weights as
    ``{"q", "s"}`` int8 leaves (``bits=8``) or ``{"q4", "s4"}`` group-128
    int4 leaves (``bits=4``), and the ``lm_head`` int8 in both, which the
    decoder consumes through ``qdot``; embeddings, norms and the ViT stay as
    they are.

    ``release_originals=True`` pops each original from the input tree before
    the next one is quantized, so originals and copies never coexist (the
    input's inner dicts are mutated); ``False`` leaves ``params`` untouched."""
    if bits not in (4, 8):
        raise ValueError(f"bits must be 4 or 8, got {bits}")
    out = dict(params)
    llm = dict(params["llm"])
    src_layers = llm["layers"] if release_originals else dict(llm["layers"])
    layers = dict(src_layers)

    def convert(container, key, bits=bits):
        w = container.pop(key) if release_originals else container[key]
        return quantize_int8(w) if bits == 8 else quantize_int4(w)

    for key in LLM_QUANT_KEYS:
        layers[key] = convert(src_layers, key)
    for mlp_key in ("lang_mlp", "vis_mlp"):
        src_mlp = src_layers[mlp_key] if release_originals else dict(src_layers[mlp_key])
        mlp = dict(src_mlp)
        for k in MLP_QUANT_KEYS:
            mlp[k] = convert(src_mlp, k)
        layers[mlp_key] = mlp
    llm["layers"] = layers
    llm["lm_head"] = convert(params["llm"], "lm_head", bits=8)
    out["llm"] = llm
    return out
