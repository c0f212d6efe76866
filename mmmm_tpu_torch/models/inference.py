"""Grounded report generation, the port of ``generate_grounded`` in
``mmmm_tpu/models/inference.py``.

Generate a report (greedy, or n-gram speculative with ``spec_draft_len > 0``;
bf16 or int8 KV cache; plain, W8A16 or W4A16 LLM weights; prefill whole or
in batch chunks), parse the ``<p> ... </p>`` spans on the host, project the
hidden states that produced each ``</p>`` with ``vg_proj`` and run the
semantic SAM (masks) or, with ``instance=True``, the instance SAM (boxes
and presence logits) on the grounding image.

The reference's serving switches are keywords here, with its defaults:
``w8a8`` (``MMMM_W8A8``), ``w8a8_prefill`` (``MMMM_W8A8_PREFILL``),
``q8_mxu`` (``MMMM_Q8_MXU``), ``chunk_mode`` (``MMMM_PREFILL_CHUNK_MODE``),
``sam_bf16`` (``MMMM_SAM_BF16``), and, for the length of the call
(``ops/numerics.py``), ``gelu_mode`` (``MMMM_GELU``; ``MMMM_FAST_GELU=1``
is ``"tanh"``), ``dense_fast_softmax`` (``MMMM_DENSE_FAST_SOFTMAX``: K4's
fast softmax at the ViT and SAM encoder) and ``q8_cast``
(``MMMM_Q8_CAST`` with ``MMMM_RAGGED_DECODE=1``: K9's products in bf16).

Runs on the card unless the caller passes ``device="cpu"`` (where every
kernel wrapper takes its plain version); a missing card is an error.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..data.tokenizer import MMMMTokenizer
from ..ops._cuda import resolve_device
from ..ops.numerics import numerics
from .generate import greedy_generate
from .mmmm import MMMMConfig, vg_project
from .segvol.sam import instance_sam_forward, sam_forward
from .speculate import ngram_speculative_generate


@dataclasses.dataclass
class GroundedResult:
    text: list[str]
    tokens: np.ndarray  # (B, max_new)
    targets: list[list[str] | None]  # parsed grounded phrases per sample
    num_generated: np.ndarray  # (B,)
    masks: torch.Tensor | None = None  # (B, N, D, H, W) logits, on the run's device
    boxes: torch.Tensor | None = None  # (B, N, K, 6) fp32 CenterSize in [0, 1] (instance)
    disc_logit: torch.Tensor | None = None  # (B, N, K) fp32 (instance)
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


def _ground(params, cfg: MMMMConfig, hidden, positions, g_image, patch_size, *,
            instance: bool, sam_bf16: bool):
    """vg_proj on the gathered hidden states, then the SAM head: masks, or
    (boxes of tokens 1:, presence logits) for ``instance``. ``sam_bf16``
    runs the head and its prompts in bf16 (``vg_proj`` stays fp32)."""
    hidden = hidden.float()
    idx = positions[..., None].expand(-1, -1, hidden.shape[-1])
    prompts = vg_project(params, hidden.gather(1, idx))  # (B, N, prompt_dim)
    head = params["isam" if instance else "sam"]
    cdt = torch.bfloat16 if sam_bf16 else torch.float32

    def cast(tree):
        return {k: cast(v) if isinstance(v, dict) else v.to(cdt) for k, v in tree.items()}

    if sam_bf16:
        head = cast(head)  # every SAM leaf is fp32
    g_image, prompts = g_image.to(cdt), prompts.to(cdt)
    if instance:
        o = instance_sam_forward(head, cfg.sam, g_image, patch_size, prompts,
                                 upsample_to_image=False)
        return o.boxes[:, :, 1:].float(), o.disc_logit.float()
    return (sam_forward(head, cfg.sam, g_image, patch_size, prompts)[0],)


def generate_grounded(params: dict, cfg: MMMMConfig, tokenizer: MMMMTokenizer, input_ids,
                      token_type_ids, position_ids, prompt_len, image, patch_size, pool_size,
                      *, max_new_tokens: int = 256, max_targets: int = 8,
                      grounding_image=None, instance: bool = False,
                      force_grounding: bool = False, vis_span=None,
                      kv_cache_dtype: str = "bf16", spec_draft_len: int = 0,
                      prefill_chunk: int = 0, chunk_mode: str = "all", w8a8: bool = False,
                      w8a8_prefill: bool = False, q8_mxu: bool = False,
                      sam_bf16: bool = False, gelu_mode: str = "auto",
                      dense_fast_softmax: bool = False, q8_cast: str = "f32",
                      device: str | torch.device = "cuda") -> GroundedResult:
    """Generate reports for a right-padded prompt batch and ground them.

    ``params`` must already lie on ``device`` (``init_params`` /
    ``params_from_jax``; ``quantize_llm_for_serving`` for W8A16 or W4A16).
    Inputs may be numpy arrays or tensors; they are moved to ``device``.
    ``force_grounding`` runs the SAM pass on the position-0 hidden states
    when no ``</p>`` was generated. ``kv_cache_dtype`` is "bf16" (the
    model's dtype) or "int8"; ``spec_draft_len > 0`` decodes with n-gram
    speculation, token-identical to greedy. ``prefill_chunk > 0`` runs the
    prefill and the SAM pass in batch chunks of that size (``chunk_mode``
    "all" or "vit"). ``w8a8`` and ``w8a8_prefill`` run the decode and the
    static-span prefill projections of int8 weights W8A8; ``q8_mxu`` reads
    an int8 cache with the split-int8 kernel; ``sam_bf16`` runs the SAM
    head in bf16; ``gelu_mode``, ``dense_fast_softmax`` and ``q8_cast`` as
    in the module's docstring."""
    dev = resolve_device(device)
    ref = params["vg_proj"]["w1"]
    if ref.device.type != dev.type:
        raise ValueError(f"params lie on {ref.device}, the run asks for {dev}")
    to = lambda x: torch.as_tensor(x, device=dev)
    with torch.inference_mode(), numerics(gelu_mode, dense_fast_softmax, q8_cast):
        args = (params["cogvlm"], cfg.vlm, to(input_ids), to(token_type_ids), to(position_ids),
                to(prompt_len))
        kw = dict(max_new_tokens=max_new_tokens, eos_token_id=tokenizer.eos_token_id,
                  bop_token_id=tokenizer.bop_token_id, eop_token_id=tokenizer.eop_token_id,
                  image=None if image is None else to(image), patch_size=patch_size,
                  pool_size=pool_size, vis_span=None if vis_span is None else tuple(vis_span),
                  kv_cache_dtype=kv_cache_dtype, prefill_chunk=prefill_chunk,
                  chunk_mode=chunk_mode, w8a8=w8a8, w8a8_prefill=w8a8_prefill)
        spec_stats = None
        if spec_draft_len > 0:
            res, spec_stats = ngram_speculative_generate(*args, draft_len=spec_draft_len,
                                                         return_stats=True, **kw)
        else:
            res = greedy_generate(*args, q8_mxu=q8_mxu, **kw)
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
            ground = lambda h, p, g: _ground(params, cfg, h, p, g, tuple(patch_size),
                                             instance=instance, sam_bf16=sam_bf16)
            hidden, pos, gimg = res.hidden, to(positions), to(grounding_image)
            b = hidden.shape[0]
            if 0 < prefill_chunk < b:
                # the SAM pass in chunks too: pad to whole chunks, cut back
                bp = -(-b // prefill_chunk) * prefill_chunk
                pad = lambda x: torch.cat([x, x.new_zeros((bp - b, *x.shape[1:]))])
                hidden, pos, gimg = pad(hidden), pad(pos), pad(gimg)
                parts = [ground(hidden[i:i + prefill_chunk], pos[i:i + prefill_chunk],
                                gimg[i:i + prefill_chunk]) for i in range(0, bp, prefill_chunk)]
                o = tuple(torch.cat(ts)[:b] for ts in zip(*parts))
            else:
                o = ground(hidden, pos, gimg)
        if instance:
            out.boxes, out.disc_logit = o
        else:
            out.masks = o[0]
    return out
