"""Grounded report generation, the port of ``generate_grounded`` in
``mmmm_tpu/models/inference.py`` (semantic SAM).

Generate a report (greedy, or n-gram speculative with ``spec_draft_len > 0``;
bf16 or int8 KV cache; plain or W8A16 LLM weights), parse the
``<p> ... </p>`` spans on the host, project the hidden states that produced
each ``</p>`` with ``vg_proj`` and run the semantic SAM mask pass on the
grounding image.

Runs on the card unless the caller passes ``device="cpu"`` (where every
kernel wrapper takes its plain version); a missing card is an error. Not
ported yet: the instance-SAM head, chunked prefill, W8A8 activations and
4-bit weights.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..data.tokenizer import MMMMTokenizer
from ..ops._cuda import resolve_device
from .generate import greedy_generate
from .mmmm import MMMMConfig, vg_project
from .segvol.sam import sam_forward
from .speculate import ngram_speculative_generate


@dataclasses.dataclass
class GroundedResult:
    text: list[str]
    tokens: np.ndarray  # (B, max_new)
    targets: list[list[str] | None]  # parsed grounded phrases per sample
    num_generated: np.ndarray  # (B,)
    masks: torch.Tensor | None = None  # (B, N, D, H, W) fp32 logits, on the run's device
    target_valid: np.ndarray | None = None  # (B, N)
    # spec_draft_len > 0 only: {"iters": verify steps, "tokens_per_step":
    # committed tokens per row and step}
    spec_stats: dict | None = None


def _eop_positions(tokens: np.ndarray, eop_token_id: int, max_targets: int):
    b = tokens.shape[0]
    positions = np.zeros((b, max_targets), np.int64)
    valid = np.zeros((b, max_targets), bool)
    for i in range(b):
        (eops,) = np.nonzero(tokens[i] == eop_token_id)
        eops = eops[:max_targets]
        positions[i, : len(eops)] = eops
        valid[i, : len(eops)] = True
    return positions, valid


def generate_grounded(params: dict, cfg: MMMMConfig, tokenizer: MMMMTokenizer, input_ids,
                      token_type_ids, position_ids, prompt_len, image, patch_size, pool_size,
                      *, max_new_tokens: int = 256, max_targets: int = 8,
                      grounding_image=None, force_grounding: bool = False, vis_span=None,
                      kv_cache_dtype: str = "bf16", spec_draft_len: int = 0,
                      device: str | torch.device = "cuda") -> GroundedResult:
    """Generate reports for a right-padded prompt batch and ground them.

    ``params`` must already lie on ``device`` (``init_params`` /
    ``params_from_jax``; ``quantize_llm_for_serving`` for W8A16). Inputs may
    be numpy arrays or tensors; they are moved to ``device``.
    ``force_grounding`` runs the mask pass on the position-0 hidden states
    when no ``</p>`` was generated. ``kv_cache_dtype`` is "bf16" (the
    model's dtype) or "int8"; ``spec_draft_len > 0`` decodes with n-gram
    speculation, token-identical to greedy."""
    dev = resolve_device(device)
    ref = params["vg_proj"]["w1"]
    if ref.device.type != dev.type:
        raise ValueError(f"params lie on {ref.device}, the run asks for {dev}")
    to = lambda x: torch.as_tensor(x, device=dev)
    with torch.inference_mode():
        args = (params["cogvlm"], cfg.vlm, to(input_ids), to(token_type_ids), to(position_ids),
                to(prompt_len))
        kw = dict(max_new_tokens=max_new_tokens, eos_token_id=tokenizer.eos_token_id,
                  bop_token_id=tokenizer.bop_token_id, eop_token_id=tokenizer.eop_token_id,
                  image=None if image is None else to(image), patch_size=patch_size,
                  pool_size=pool_size, vis_span=None if vis_span is None else tuple(vis_span),
                  kv_cache_dtype=kv_cache_dtype)
        spec_stats = None
        if spec_draft_len > 0:
            res, spec_stats = ngram_speculative_generate(*args, draft_len=spec_draft_len,
                                                         return_stats=True, **kw)
        else:
            res = greedy_generate(*args, **kw)
        tokens = res.tokens.cpu().numpy()
        out = GroundedResult(
            text=[tokenizer.decode([int(t) for t in row if int(t) != tokenizer.eos_token_id])
                  for row in tokens],
            tokens=tokens,
            targets=tokenizer.parse_targets(tokens),
            num_generated=res.num_generated.cpu().numpy(),
            spec_stats=spec_stats,
        )
        if grounding_image is None:
            return out
        positions, valid = _eop_positions(tokens, tokenizer.eop_token_id, max_targets)
        out.target_valid = valid
        if not valid.any():
            if not force_grounding:
                return out
            valid[:, 0] = True
        with record_function("sam"):
            hidden = res.hidden.float()
            idx = to(positions)[..., None].expand(-1, -1, hidden.shape[-1])
            prompts = vg_project(params, hidden.gather(1, idx))  # (B, N, prompt_dim)
            out.masks, _ = sam_forward(params["sam"], cfg.sam, to(grounding_image).float(),
                                       tuple(patch_size), prompts)
    return out
