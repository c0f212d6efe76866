"""CogVLM for causal LM, the port of ``mmmm_tpu/models/cogvlm/model.py``
(``splice_vision_embeds``, ``cogvlm_forward``, ``weighted_ce_loss``)."""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ...ops.quant import qdot
from ...peft.lora import materialize
from .config import CogVLMConfig
from .decoder import llm_forward
from .vit import vit_forward

CE_IGNORE_INDEX = -100


def splice_vision_embeds(inputs_embeds: torch.Tensor, vision_embeds: torch.Tensor) -> torch.Tensor:
    """Overwrite embeddings [1, 1 + T') with the vision features."""
    n = vision_embeds.shape[1]
    return torch.cat([inputs_embeds[:, :1], vision_embeds.to(inputs_embeds.dtype),
                      inputs_embeds[:, 1 + n:]], dim=1)


def cogvlm_forward(params: dict, cfg: CogVLMConfig, input_ids, token_type_ids, position_ids,
                   segments, image=None, patch_size=None, pool_size=None, *,
                   attn_impl: str = "auto", remat=False, return_logits: bool = True,
                   vis_span: tuple[int, int] | str | None = None):
    """Returns ``(hidden (B, S, C), logits (B, S, V) fp32 or None)`` for a
    full packed sequence. ``vis_span="auto"`` becomes ``(1, 1 + n_vis)``
    when an image is spliced (the data layer's layout) and None without
    one; ``return_logits=False`` skips the dense projection (the training
    step's fused CE takes the hidden states). Under a model group
    (``parallel/tensor.py``) the logits are this process's piece of the
    vocabulary."""
    emb = params["llm"]["embed_tokens"][input_ids.long()]
    if image is not None:
        with record_function("vit"):
            vis = vit_forward(params["vision"], cfg, image, patch_size, pool_size,
                              attn_impl=attn_impl, remat=remat)
        emb = splice_vision_embeds(emb, vis)
        if vis_span == "auto":
            vis_span = (1, 1 + vis.shape[1])
    elif vis_span == "auto":
        vis_span = None
    with record_function("llm_forward"):
        hidden = llm_forward(params["llm"], cfg, emb, token_type_ids, position_ids, segments,
                             attn_impl=attn_impl, remat=remat, vis_span=vis_span)
    logits = (qdot(hidden, materialize(params["llm"]["lm_head"])).float()
              if return_logits else None)
    return hidden, logits


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     weight: torch.Tensor | None = None) -> torch.Tensor:
    """Sample-weighted CE: the weighted sum of per-token CE over non-ignored
    tokens, normalized by the COUNT of non-ignored tokens."""
    mask = labels != CE_IGNORE_INDEX
    safe = torch.where(mask, labels, 0).long()
    logp = torch.log_softmax(logits, dim=-1)
    ce = -logp.gather(-1, safe[..., None])[..., 0]
    ce = torch.where(mask, ce, 0.0)
    denom = mask.sum().clamp_min(1)
    if weight is None:
        return ce.sum() / denom
    return (ce * weight.float()).sum() / denom
