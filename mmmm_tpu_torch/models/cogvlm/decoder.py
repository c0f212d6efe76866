"""CogVLM visual-expert decoder, the port of
``mmmm_tpu/models/cogvlm/decoder.py`` (``vision_expert_mask``,
``llm_forward``, ``llm_prefill``, ``llm_decode_step``).

Each layer routes tokens to a vision or a language expert (QKV, dense and
SwiGLU MLP weights). Three routings are kept from the reference:

  - the dual masked path: both experts over every token, selected per token
    by ``vision_expert_mask`` (a token is vision-routed only if it AND its
    successor are vision-typed);
  - the static ``expert_span=(lo, hi)`` path: the sequence is sliced into
    language / vision / language runs, each through one expert;
  - ``lang_only`` for decode, where every token is provably language-routed.

Every projection goes through ``qdot``, so the LLM weights may be plain,
int8 ``{"q", "s"}`` or int4 ``{"q4", "s4"}`` leaves (``ops/quant.py``). Two
switches of the reference are keywords here: ``w8a8`` (``MMMM_W8A8``) runs
the decode projections as W8A8, ``w8a8_prefill`` (``MMMM_W8A8_PREFILL``)
the prefill's static-span projections; the ``lm_head`` (applied by the
callers) stays W8A16 in both.

``llm_forward`` is the training forward over a full sequence: its causal
attention goes through ``segment_attention(impl=attn_impl)`` (under
``"pallas"`` K3 forward and K7 backward); under ``remat="attn"`` its
context is tagged ``"attn_out"`` (the reference's ``checkpoint_name``,
which that policy keeps: on the flash route K3's output and logsumexp, so
the backward runs K7 without launching K3 again); each layer runs inside
``remat_call`` and merges its LoRA leaves there (``peft/lora.py``).

Prefill attention is kernel K3 (causal, segment ids). Caches are per-layer
(B, H, Smax, D) pairs in the model's dtype, or int8 dicts
``{"kq", "ks", "vq", "vs"}`` with one bf16 scale per (sample, head, slot);
decode appends to them IN PLACE. A decode step feeds one token, a
speculative verify window or a prompt suffix (the servers' prefix refill)
and dispatches as the reference's cache branch does:

  cache   tokens  append, then attention
  pair    1       K1's fused form: K2's append inside K1's launch
  pair    2-8     K6's fused form: K5's append inside K6's launch (query j
                  sees slots < write_index + j + 1)
  pair    > 8     plain: indexed write (``dus_rows``), then
                  ``decode_attention_bhsd`` masked by the caller's
                  ``kv_len``, the route the reference leaves to XLA
  int8    1       K9's fused form (K10's with ``q8_mxu=True``, the
                  reference's ``MMMM_Q8_MXU``, where its condition holds;
                  K9's products in ``ops/numerics.py``'s ``q8_cast``):
                  ``quantize_kv`` and K8's append inside the read's launch
  int8    > 1     plain: quantize, indexed write, ``dequantize_kv``, then
                  ``decode_attention_bhsd``, as the reference does outside
                  its kernels
"""
from __future__ import annotations

from functools import partial

import torch
import torch.nn.functional as F

from ...ops.attention import decode_attention_bhsd, segment_attention
from ...ops.decode_kernel import (decode_attention_append, decode_attention_q8_append,
                                  decode_attention_window_append, dus_rows)
from ...ops.flash import flash_segment_attention
from ...ops.norm import rms_norm
from ...ops.quant import dequantize_kv, qdot, quantize_kv
from ...ops.numerics import current
from ...ops.remat import ATTN_OUT, remat_call
from ...ops.rope import apply_rope, rope_cos_sin
from ...params import layer
from ...peft.lora import materialize
from .config import CogVLMConfig

VISION_TOKEN_TYPE = 1
LANGUAGE_TOKEN_TYPE = 0


def vision_expert_mask(token_type_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) bool: vision iff this token AND the next are vision-typed; the
    last position is always language."""
    tt = token_type_ids
    m = (tt[:, :-1] == VISION_TOKEN_TYPE) & (tt[:, 1:] == VISION_TOKEN_TYPE)
    return F.pad(m, (0, 1), value=False)


def _swiglu(t, mp, qd=qdot):
    return qd(F.silu(qd(t, mp["gate"])) * qd(t, mp["up"]), mp["down"])


def _routing(lp, *, vis_mask=None, expert_span=None, lang_only=False, act_quant=False):
    """(dual, mlp) callables for one layer's expert routing; ``act_quant``
    (W8A8) applies to the ``lang_only`` and ``expert_span`` routings."""
    qd = partial(qdot, act_quant=act_quant)
    if lang_only:
        return (lambda t, wv, wl: qd(t, wl)), (lambda t: _swiglu(t, lp["lang_mlp"], qd))
    if expert_span is not None:
        lo, hi = expert_span

        def dual(t, wv, wl):
            return torch.cat([qd(t[:, :lo], wl), qd(t[:, lo:hi], wv), qd(t[:, hi:], wl)], dim=1)

        def mlp(t):
            return torch.cat([_swiglu(t[:, :lo], lp["lang_mlp"], qd),
                              _swiglu(t[:, lo:hi], lp["vis_mlp"], qd),
                              _swiglu(t[:, hi:], lp["lang_mlp"], qd)], dim=1)

        return dual, mlp
    sel = vis_mask[..., None]
    return ((lambda t, wv, wl: torch.where(sel, qdot(t, wv), qdot(t, wl))),
            (lambda t: torch.where(sel, _swiglu(t, lp["vis_mlp"]), _swiglu(t, lp["lang_mlp"]))))


def _decoder_layer(x, lp, cfg: CogVLMConfig, *, position_ids, cos, sin, attend, routing):
    """One visual-expert layer; ``attend(q, k, v)`` returns the (B, S, H, D)
    attention output."""
    b, s, c = x.shape
    h, d = cfg.num_attention_heads, cfg.head_dim
    dual, mlp = routing
    residual = x
    x = rms_norm(x, lp["input_ln"], cfg.rms_norm_eps)
    qkv = dual(x, lp["vis_qkv"], lp["lang_qkv"])
    q, k, v = (t.reshape(b, s, h, d) for t in qkv.split(c, dim=-1))
    q, k = apply_rope(q, k, cos, sin, position_ids)
    ctx = attend(q.contiguous(), k.contiguous(), v.contiguous())
    x = residual + dual(ctx.reshape(b, s, c), lp["vis_dense"], lp["lang_dense"])
    return x + mlp(rms_norm(x, lp["post_ln"], cfg.rms_norm_eps))


def llm_forward(params: dict, cfg: CogVLMConfig, inputs_embeds, token_type_ids, position_ids,
                segments, *, attn_impl: str = "auto", remat=False,
                vis_span: tuple[int, int] | None = None) -> torch.Tensor:
    """Full-sequence forward, (B, S, C) -> final hidden states after the
    norm. ``vis_span=(lo, hi)`` declares every row's vision tokens are
    [lo, hi), so layers take the static span path over [lo, hi - 1) (the
    off-by-one rule); otherwise the dual masked path."""
    vis_mask = vision_expert_mask(token_type_ids)
    cos, sin = rope_cos_sin(cfg.max_position_embeddings, cfg.head_dim,
                            device=inputs_embeds.device)
    expert_span = None if vis_span is None else (vis_span[0], vis_span[1] - 1)
    seg = segments.to(torch.int32).contiguous()
    # the context is tagged "attn_out", as the reference's; only "attn" reads
    # the tag, and off the flash route the tag is a copy
    name = ATTN_OUT if remat == "attn" else ""

    def attend(q, k, v):
        return segment_attention(q, k, v, seg, causal=True, impl=attn_impl, name=name)

    def body(x, lp):
        lp = materialize(lp)
        return _decoder_layer(x, lp, cfg, position_ids=position_ids, cos=cos, sin=sin,
                              attend=attend,
                              routing=_routing(lp, vis_mask=vis_mask, expert_span=expert_span))

    x = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        x = remat_call(body, remat, x, layer(params["layers"], li))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps)


def empty_cache(b: int, h: int, smax: int, d: int, dtype, device, kv_cache_dtype: str):
    """One layer's zeroed cache of ``smax`` slots: a (k, v) pair of
    (B, H, Smax, D) in ``dtype``, or for ``kv_cache_dtype="int8"`` a dict of
    int8 rows ``kq``/``vq`` and bf16 per-slot scales ``ks``/``vs``."""
    if kv_cache_dtype == "int8":
        kq = torch.zeros((b, h, smax, d), dtype=torch.int8, device=device)
        ks = torch.zeros((b, h, smax, 1), dtype=torch.bfloat16, device=device)
        return {"kq": kq, "ks": ks, "vq": torch.zeros_like(kq), "vs": torch.zeros_like(ks)}
    kc = torch.zeros((b, h, smax, d), dtype=dtype, device=device)
    return kc, torch.zeros_like(kc)


def cache_rows(cache, lo: int, hi: int):
    """Samples [lo, hi) of a layer's cache, as views (contiguous, since the
    batch dim leads)."""
    if isinstance(cache, dict):
        return {key: t[lo:hi] for key, t in cache.items()}
    return tuple(t[lo:hi] for t in cache)


def _fill_cache(cache, k, v):
    """Write the prompt's rotated K/V (B, S, H, D) into the first S slots."""
    s = k.shape[1]
    kt, vt = k.transpose(1, 2), v.transpose(1, 2)
    if isinstance(cache, dict):
        for t, (qk, sk) in ((kt, ("kq", "ks")), (vt, ("vq", "vs"))):
            cache[qk][:, :, :s], cache[sk][:, :, :s] = quantize_kv(t)
    else:
        cache[0][:, :, :s], cache[1][:, :, :s] = kt, vt
    return cache


def llm_prefill(params: dict, cfg: CogVLMConfig, inputs_embeds, token_type_ids, position_ids,
                segments, *, smax: int, vis_span: tuple[int, int] | None = None,
                kv_cache_dtype: str = "bf16", w8a8_prefill: bool = False, caches=None):
    """Full-sequence prefill writing each layer's rotated K/V into a
    preallocated cache of ``smax`` slots: a (B, H, Smax, D) pair in the
    model's dtype, or with ``kv_cache_dtype="int8"`` a per-slot quantized
    dict (the prefill's own attention reads the unquantized K/V). ``caches``
    gives the per-layer caches to write (views of larger ones, for chunked
    prefill); by default they are allocated here.

    ``vis_span=(lo, hi)`` declares every row's vision tokens are [lo, hi),
    so layers take the static span path over [lo, hi - 1) (the off-by-one
    rule), W8A8 with ``w8a8_prefill``; otherwise the dual masked path.
    Returns (hidden (B, S, C) after the final norm, per-layer caches)."""
    if kv_cache_dtype not in ("bf16", "int8"):
        raise ValueError(f"kv_cache_dtype must be 'bf16' or 'int8', got {kv_cache_dtype!r}")
    b, d = inputs_embeds.shape[0], cfg.head_dim
    if caches is None:
        caches = [empty_cache(b, cfg.num_attention_heads, smax, d, inputs_embeds.dtype,
                              inputs_embeds.device, kv_cache_dtype)
                  for _ in range(cfg.num_hidden_layers)]
    cos, sin = rope_cos_sin(cfg.max_position_embeddings, d, device=inputs_embeds.device)
    vis_mask = vision_expert_mask(token_type_ids)
    expert_span = None if vis_span is None else (vis_span[0], vis_span[1] - 1)
    seg = segments.to(torch.int32).contiguous()
    scale = d ** -0.5
    x = inputs_embeds
    for li in range(cfg.num_hidden_layers):
        lp = layer(params["layers"], li)

        def attend(q, k, v, cache=caches[li]):
            _fill_cache(cache, k, v)
            return flash_segment_attention(q, k, v, seg, seg, causal=True, scale=scale)[0]

        x = _decoder_layer(x, lp, cfg, position_ids=position_ids, cos=cos, sin=sin,
                           attend=attend,
                           routing=_routing(lp, vis_mask=vis_mask, expert_span=expert_span,
                                            act_quant=w8a8_prefill))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps), caches


def _cached_attention(q, k, v, cache, write_index, kv_len, q8_mxu=False):
    """Append this step's K/V (B, Sq, H, D) to one layer's cache in place and
    attend to it (the dispatch table in the module docstring)."""
    sq = q.shape[1]
    if isinstance(cache, dict):
        if sq == 1:
            return decode_attention_q8_append(q, cache, k, v, write_index, kv_len,
                                              q8_mxu=q8_mxu, cast=current().q8_cast)
        (kq, ks), (vq, vs) = quantize_kv(k.transpose(1, 2)), quantize_kv(v.transpose(1, 2))
        for key, new in (("kq", kq), ("ks", ks), ("vq", vq), ("vs", vs)):
            dus_rows(cache[key], new, write_index)
        smax = cache["kq"].shape[2]
        valid = torch.arange(smax, device=q.device) < kv_len[..., None]
        return decode_attention_bhsd(q, dequantize_kv(cache["kq"], cache["ks"], k.dtype),
                                     dequantize_kv(cache["vq"], cache["vs"], v.dtype), valid)
    kc, vc = cache
    if sq == 1:
        kt, vt = k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous()
        return decode_attention_append(q, kc, vc, kt, vt, write_index, kv_len)
    if sq <= 8:
        return decode_attention_window_append(q, kc, vc, k, v, write_index)
    dus_rows(kc, k.transpose(1, 2), write_index)
    dus_rows(vc, v.transpose(1, 2), write_index)
    valid = torch.arange(kc.shape[2], device=q.device) < kv_len[..., None]
    return decode_attention_bhsd(q, kc, vc, valid)


def llm_decode_step(params: dict, cfg: CogVLMConfig, inputs_embeds, position_ids, kv_caches,
                    write_index, kv_len, *, w8a8: bool = False, q8_mxu: bool = False):
    """Decode one token per sample, or a window of Sq tokens, against the
    caches.

    inputs_embeds (B, Sq, C); position_ids (B, Sq); ``write_index`` (B,)
    int32 is the first slot the window's K/V goes to. ``kv_len`` is (B,)
    int32, the valid slots including the token, for Sq = 1, and (B, Sq) for
    a window: query j sees the slots ``< kv_len[b, j]``. On a bf16 cache a
    window of 2 to 8 tokens (K6) does not read ``kv_len``: it assumes
    ``kv_len[b, j] = write_index[b] + j + 1`` (query j sees the prefix and
    the window causally), which the verify windows pass; where a caller
    clamps ``kv_len`` past its valid positions (the servers' prefix refill),
    only those clamped positions' outputs, and their cache slots, which no
    later step reads before overwriting, differ from the reference's. Every
    other window reads ``kv_len``. The caches are updated IN PLACE and
    returned. ``w8a8`` runs the projections W8A8; ``q8_mxu`` asks for the
    split-int8 read of an int8 cache. Returns (hidden (B, Sq, C) after the
    final norm, caches)."""
    d = cfg.head_dim
    cos, sin = rope_cos_sin(cfg.max_position_embeddings, d, device=inputs_embeds.device)
    x = inputs_embeds
    for li, cache in enumerate(kv_caches):
        lp = layer(params["layers"], li)

        def attend(q, k, v, cache=cache):
            return _cached_attention(q, k, v, cache, write_index, kv_len, q8_mxu)

        x = _decoder_layer(x, lp, cfg, position_ids=position_ids, cos=cos, sin=sin,
                           attend=attend, routing=_routing(lp, lang_only=True, act_quant=w8a8))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps), kv_caches
