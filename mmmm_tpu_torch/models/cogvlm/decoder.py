"""CogVLM visual-expert decoder, the port of
``mmmm_tpu/models/cogvlm/decoder.py`` (``vision_expert_mask``,
``llm_prefill``, ``llm_decode_step``).

Each layer routes tokens to a vision or a language expert (QKV, dense and
SwiGLU MLP weights). Three routings are kept from the reference:

  - the dual masked path: both experts over every token, selected per token
    by ``vision_expert_mask`` (a token is vision-routed only if it AND its
    successor are vision-typed);
  - the static ``expert_span=(lo, hi)`` path: the sequence is sliced into
    language / vision / language runs, each through one expert;
  - ``lang_only`` for decode, where every token is provably language-routed.

Prefill attention is kernel K3 (causal, segment ids); decode appends the new
K/V row with kernel K2 and attends with kernel K1. Caches are per-layer
(B, H, Smax, D) pairs, and decode appends to them IN PLACE.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.decode_kernel import decode_attention, kv_append
from ...ops.flash import flash_segment_attention
from ...ops.norm import rms_norm
from ...ops.rope import apply_rope, rope_cos_sin
from ...params import layer
from .config import CogVLMConfig

VISION_TOKEN_TYPE = 1
LANGUAGE_TOKEN_TYPE = 0


def vision_expert_mask(token_type_ids: torch.Tensor) -> torch.Tensor:
    """(B, S) bool: vision iff this token AND the next are vision-typed; the
    last position is always language."""
    tt = token_type_ids
    m = (tt[:, :-1] == VISION_TOKEN_TYPE) & (tt[:, 1:] == VISION_TOKEN_TYPE)
    return F.pad(m, (0, 1), value=False)


def _swiglu(t, mp):
    return (F.silu(t @ mp["gate"]) * (t @ mp["up"])) @ mp["down"]


def _routing(lp, *, vis_mask=None, expert_span=None, lang_only=False):
    """(dual, mlp) callables for one layer's expert routing."""
    if lang_only:
        return (lambda t, wv, wl: t @ wl), (lambda t: _swiglu(t, lp["lang_mlp"]))
    if expert_span is not None:
        lo, hi = expert_span

        def dual(t, wv, wl):
            return torch.cat([t[:, :lo] @ wl, t[:, lo:hi] @ wv, t[:, hi:] @ wl], dim=1)

        def mlp(t):
            return torch.cat([_swiglu(t[:, :lo], lp["lang_mlp"]),
                              _swiglu(t[:, lo:hi], lp["vis_mlp"]),
                              _swiglu(t[:, hi:], lp["lang_mlp"])], dim=1)

        return dual, mlp
    sel = vis_mask[..., None]
    return ((lambda t, wv, wl: torch.where(sel, t @ wv, t @ wl)),
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


def llm_prefill(params: dict, cfg: CogVLMConfig, inputs_embeds, token_type_ids, position_ids,
                segments, *, smax: int, vis_span: tuple[int, int] | None = None):
    """Full-sequence prefill writing each layer's rotated K/V into a
    preallocated (B, H, Smax, D) cache pair.

    ``vis_span=(lo, hi)`` declares every row's vision tokens are [lo, hi),
    so layers take the static span path over [lo, hi - 1) (the off-by-one
    rule); otherwise the dual masked path. Returns (hidden (B, S, C) after
    the final norm, per-layer [(k_cache, v_cache), ...])."""
    b, s, _ = inputs_embeds.shape
    h, d = cfg.num_attention_heads, cfg.head_dim
    dev = inputs_embeds.device
    cos, sin = rope_cos_sin(cfg.max_position_embeddings, d, device=dev)
    vis_mask = vision_expert_mask(token_type_ids)
    expert_span = None if vis_span is None else (vis_span[0], vis_span[1] - 1)
    seg = segments.to(torch.int32).contiguous()
    scale = d ** -0.5
    x = inputs_embeds
    caches = []
    for li in range(cfg.num_hidden_layers):
        lp = layer(params["layers"], li)
        kc = torch.zeros((b, h, smax, d), dtype=x.dtype, device=dev)
        vc = torch.zeros_like(kc)

        def attend(q, k, v, kc=kc, vc=vc):
            kc[:, :, :s] = k.transpose(1, 2)
            vc[:, :, :s] = v.transpose(1, 2)
            return flash_segment_attention(q, k, v, seg, seg, causal=True, scale=scale)[0]

        x = _decoder_layer(x, lp, cfg, position_ids=position_ids, cos=cos, sin=sin,
                           attend=attend,
                           routing=_routing(lp, vis_mask=vis_mask, expert_span=expert_span))
        caches.append((kc, vc))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps), caches


def llm_decode_step(params: dict, cfg: CogVLMConfig, inputs_embeds, position_ids, kv_caches,
                    write_index, kv_len):
    """Decode one token per sample against the caches.

    inputs_embeds (B, 1, C); position_ids (B, 1); ``write_index`` (B,) int32
    is the slot the token's K/V goes to and ``kv_len`` (B,) int32 the valid
    slots including it. The caches are updated IN PLACE (kernel K2) and
    returned. Returns (hidden (B, 1, C) after the final norm, caches)."""
    d = cfg.head_dim
    cos, sin = rope_cos_sin(cfg.max_position_embeddings, d, device=inputs_embeds.device)
    x = inputs_embeds
    for li, (kc, vc) in enumerate(kv_caches):
        lp = layer(params["layers"], li)

        def attend(q, k, v, kc=kc, vc=vc):
            kv_append(kc, vc, k.transpose(1, 2), v.transpose(1, 2), write_index)
            return decode_attention(q, kc, vc, kv_len)

        x = _decoder_layer(x, lp, cfg, position_ids=position_ids, cos=cos, sin=sin,
                           attend=attend, routing=_routing(lp, lang_only=True))
    return rms_norm(x, params["norm"], cfg.rms_norm_eps), kv_caches
