"""Int8 weight-only quantization for serving (W8A16) and the int8 KV cache, the
port of ``mmmm_tpu/ops/quant.py`` (``quantize_int8``, ``is_quantized``,
``qdot``, ``quantize_kv``, ``dequantize_kv``, ``quantize_llm_for_serving``).

Weights are quantized per output channel to int8 with an fp32 scale, over the
contraction dim (-2 of an ``(in, out)`` matrix or ``(L, in, out)`` stack);
``qdot`` dequantizes, multiplies and applies the scale after the product, as
the reference does. The reference leaves that product to XLA, so it stays
``torch.matmul`` here: on the card it writes and reads a bf16 copy of each
weight per call. W8A8 activation quantization and 4-bit weights are not
ported yet (ROADMAP.md, kernel K11).
"""
from __future__ import annotations

import torch

LLM_QUANT_KEYS = ("lang_qkv", "lang_dense", "vis_qkv", "vis_dense")
MLP_QUANT_KEYS = ("gate", "up", "down")


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


def is_quantized(w) -> bool:
    return isinstance(w, dict) and ("q" in w or "q4" in w) and ("s" in w or "s4" in w)


def qdot(x: torch.Tensor, w, act_quant: bool = False) -> torch.Tensor:
    """``x @ w`` for a plain weight or a ``{"q", "s"}`` int8 weight (W8A16:
    the int8 weight is cast to x's dtype, multiplied, then scaled)."""
    if not is_quantized(w):
        return x @ w
    if act_quant or "q4" in w:
        raise NotImplementedError("W8A8 activations and 4-bit weights are not ported yet "
                                  "(ROADMAP.md Queue 2, K11)")
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
    """The CogVLM tree (``{"llm", "vision"}``) with the LLM expert weights and
    the ``lm_head`` as ``{"q", "s"}`` int8 leaves, which the decoder consumes
    through ``qdot``; embeddings, norms and the ViT stay as they are.

    ``release_originals=True`` pops each original from the input tree before
    the next one is quantized, so originals and copies never coexist (the
    input's inner dicts are mutated); ``False`` leaves ``params`` untouched."""
    if bits != 8:
        raise NotImplementedError("4-bit weights are not ported yet (ROADMAP.md Queue 2, K11)")
    out = dict(params)
    llm = dict(params["llm"])
    src_layers = llm["layers"] if release_originals else dict(llm["layers"])
    layers = dict(src_layers)

    def convert(container, key):
        w = container.pop(key) if release_originals else container[key]
        return quantize_int8(w)

    for key in LLM_QUANT_KEYS:
        layers[key] = convert(src_layers, key)
    for mlp_key in ("lang_mlp", "vis_mlp"):
        src_mlp = src_layers[mlp_key] if release_originals else dict(src_layers[mlp_key])
        mlp = dict(src_mlp)
        for k in MLP_QUANT_KEYS:
            mlp[k] = convert(src_mlp, k)
        layers[mlp_key] = mlp
    llm["layers"] = layers
    llm["lm_head"] = convert(params["llm"], "lm_head")
    out["llm"] = llm
    return out
