"""Greedy generation over preallocated KV caches, the port of
``mmmm_tpu/models/generate.py`` (``prefill_decode_state``,
``chunked_prefill_decode_state``, ``greedy_decode_from_state``,
``greedy_generate``) and of the reference's chunked greedy stage
(``mmmm_tpu/models/inference.py _chunked_generate_stage``). The caches are
pairs in the model's dtype or, with ``kv_cache_dtype="int8"``, per-slot
quantized; the ``lm_head`` may be plain or int8 (``qdot``; W8A16 also when
the other projections run W8A8).

The decode loop is a Python loop over ``max_new_tokens`` steps that stays on
the device (no host sync per step). Kept from the reference:

  - the ``<p>`` keep rule: the position id does not advance when the
    previous token is ``<p>`` or the fed token is ``</p>``;
  - done/eos masking: after eos every token is eos and is not counted;
  - hidden-state alignment: ``hidden[:, t]`` is the state that produced
    ``tokens[:, t]``, which is what SAM prompting gathers.

Under a model group (``parallel/tensor.py``) the ``lm_head`` is this
process's piece of the vocabulary and each token is the vocabulary-parallel
argmax (``vocab_argmax``): every process feeds the same tokens.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..ops.quant import qdot
from ..parallel.tensor import vocab_argmax
from .cogvlm import CogVLMConfig
from .cogvlm.decoder import cache_heads, cache_rows, empty_cache, llm_decode_step, llm_prefill
from .cogvlm.model import splice_vision_embeds
from .cogvlm.vit import vit_forward


@dataclasses.dataclass
class GenerateResult:
    tokens: torch.Tensor  # (B, max_new) generated ids (eos-padded after stop)
    hidden: torch.Tensor  # (B, max_new, C) hidden state that generated each token
    prefill_hidden: torch.Tensor  # (B, S_prompt, C)
    num_generated: torch.Tensor  # (B,) tokens before (and including) eos


def prefill_decode_state(params: dict, cfg: CogVLMConfig, input_ids, token_type_ids,
                         position_ids, prompt_len, *, smax: int, eos_token_id: int,
                         image=None, patch_size=None, pool_size=None, vis_span=None,
                         kv_cache_dtype: str = "bf16", w8a8_prefill: bool = False,
                         vis_embeds=None, caches=None):
    """Prefill the (right-padded) multimodal prompt into caches of ``smax``
    slots; returns ``(state, prefill_hidden, last_hidden)``. ``params`` is
    the CogVLM tree ``{"llm": ..., "vision": ...}``. ``vis_embeds`` (B,
    T_vis, C) stands in for the ViT's output (chunked "vit" mode);
    ``caches`` are the per-layer caches to write (``llm_prefill``)."""
    b, s_prompt = input_ids.shape
    dev = input_ids.device
    segments = (torch.arange(s_prompt, device=dev)[None, :] < prompt_len[:, None]).to(torch.int32)
    llm = params["llm"]
    emb = llm["embed_tokens"][input_ids]
    if vis_embeds is not None:
        emb = splice_vision_embeds(emb, vis_embeds)
    elif image is not None:
        with record_function("vit"):
            emb = splice_vision_embeds(emb, vit_forward(params["vision"], cfg, image,
                                                        patch_size, pool_size))
    with record_function("llm_prefill"):
        hidden, caches = llm_prefill(llm, cfg, emb, token_type_ids, position_ids, segments,
                                     smax=smax, vis_span=vis_span,
                                     kv_cache_dtype=kv_cache_dtype,
                                     w8a8_prefill=w8a8_prefill, caches=caches)
    rows = torch.arange(b, device=dev)
    last_idx = prompt_len.long() - 1
    last_hidden = hidden[rows, last_idx]  # (B, C)
    tok0 = vocab_argmax(qdot(last_hidden, llm["lm_head"]).float()).to(torch.int32)
    state = {
        "caches": caches,
        "tok": tok0,  # token to feed next
        "prev_tok": input_ids[rows, last_idx].to(torch.int32),  # token before it
        "pos": position_ids[rows, last_idx].long(),  # position of the previous token
        "write": prompt_len.to(torch.int32),  # cache slot for the fed token
        "done": tok0 == eos_token_id,
    }
    return state, hidden, last_hidden


def chunked_prefill_decode_state(params: dict, cfg: CogVLMConfig, input_ids, token_type_ids,
                                 position_ids, prompt_len, *, chunk: int,
                                 chunk_mode: str = "all", slice_to_batch: bool = False,
                                 image=None, patch_size=None, pool_size=None, **kw):
    """``prefill_decode_state`` with the prefill run over batch chunks of
    ``chunk`` samples, one after another, so that one chunk's ViT and
    prefill transients live at a time; token-identical to the unchunked
    form (prefill is batch-parallel). ``chunk <= 0`` or ``chunk >= B`` does
    not chunk.

    ``chunk_mode="all"`` pads the batch to whole chunks (pad rows: zero
    ids, ``prompt_len=1``, a zero image), prefills each chunk into its rows
    of full-batch caches and returns the padded batch; with
    ``slice_to_batch`` the state and hidden states are cut back to the true
    batch. ``chunk_mode="vit"`` chunks only the ViT and prefills the LLM
    once at the true batch. ``kw`` goes to ``prefill_decode_state``."""
    b = input_ids.shape[0]
    if chunk_mode not in ("all", "vit"):
        raise ValueError(f"chunk_mode must be 'all' or 'vit', got {chunk_mode!r}")
    if chunk <= 0 or chunk >= b:
        return prefill_decode_state(params, cfg, input_ids, token_type_ids, position_ids,
                                    prompt_len, image=image, patch_size=patch_size,
                                    pool_size=pool_size, **kw)
    bp = -(-b // chunk) * chunk

    def pad(x, fill=0):
        return x if bp == b else torch.cat([x, x.new_full((bp - b, *x.shape[1:]), fill)])

    if chunk_mode == "vit" and image is not None:
        img = pad(image)
        with record_function("vit"):
            vis = torch.cat([vit_forward(params["vision"], cfg, img[i:i + chunk], patch_size,
                                         pool_size) for i in range(0, bp, chunk)])
        return prefill_decode_state(params, cfg, input_ids, token_type_ids, position_ids,
                                    prompt_len, vis_embeds=vis[:b], **kw)

    ids, tt, pos, plen = pad(input_ids), pad(token_type_ids), pad(position_ids), pad(prompt_len, 1)
    img = None if image is None else pad(image)
    llm = params["llm"]
    caches = [empty_cache(bp, cache_heads(cfg), kw["smax"], cfg.head_dim,
                          llm["embed_tokens"].dtype, ids.device,
                          kw.get("kv_cache_dtype", "bf16"))
              for _ in range(cfg.num_hidden_layers)]
    parts = []
    for i in range(0, bp, chunk):
        rows = slice(i, i + chunk)
        parts.append(prefill_decode_state(
            params, cfg, ids[rows], tt[rows], pos[rows], plen[rows],
            image=None if img is None else img[rows], patch_size=patch_size,
            pool_size=pool_size, caches=[cache_rows(c, i, i + chunk) for c in caches], **kw))
    n = b if slice_to_batch else bp
    state = {key: torch.cat([p[0][key] for p in parts])[:n]
             for key in parts[0][0] if key != "caches"}
    state["caches"] = [cache_rows(c, 0, n) for c in caches]
    hidden = torch.cat([p[1] for p in parts])[:n]
    last_hidden = torch.cat([p[2] for p in parts])[:n]
    return state, hidden, last_hidden


def greedy_decode_from_state(params: dict, cfg: CogVLMConfig, state: dict, hidden,
                             last_hidden, *, max_new_tokens: int, eos_token_id: int,
                             bop_token_id: int, eop_token_id: int, w8a8: bool = False,
                             q8_mxu: bool = False) -> GenerateResult:
    """Run ``max_new_tokens`` greedy decode steps from a prefilled state;
    ``w8a8`` and ``q8_mxu`` as in ``llm_decode_step``."""
    llm = params["llm"]
    toks, hids, dones = [], [], []
    for _ in range(max_new_tokens):
        tok, prev = state["tok"], state["prev_tok"]
        keep = (prev == bop_token_id) | (tok == eop_token_id)
        pos = state["pos"] + 1 - keep.long()
        emb_t = llm["embed_tokens"][tok][:, None, :]
        hidden_t, caches = llm_decode_step(llm, cfg, emb_t, pos[:, None], state["caches"],
                                           state["write"], state["write"] + 1, w8a8=w8a8,
                                           q8_mxu=q8_mxu)
        hidden_t = hidden_t[:, 0]
        next_tok = vocab_argmax(qdot(hidden_t, llm["lm_head"]).float()).to(torch.int32)
        next_tok = torch.where(state["done"], eos_token_id, next_tok)
        toks.append(tok)
        hids.append(hidden_t)
        dones.append(state["done"])
        state = {
            "caches": caches,
            "tok": next_tok,
            "prev_tok": tok,
            "pos": pos,
            "write": state["write"] + 1,
            "done": state["done"] | (next_tok == eos_token_id),
        }
    tokens = torch.stack(toks, dim=1)
    step_hidden = torch.stack(hids, dim=1)
    gen_hidden = torch.cat([last_hidden[:, None], step_hidden[:, :-1]], dim=1)
    was_done = torch.stack(dones, dim=1)  # done *before* each step
    tokens = torch.where(was_done, eos_token_id, tokens)
    return GenerateResult(tokens, gen_hidden, hidden, (~was_done).sum(dim=1))


def greedy_generate(params: dict, cfg: CogVLMConfig, input_ids, token_type_ids, position_ids,
                    prompt_len, *, max_new_tokens: int, eos_token_id: int, bop_token_id: int,
                    eop_token_id: int, image=None, patch_size=None, pool_size=None,
                    vis_span=None, kv_cache_dtype: str = "bf16", prefill_chunk: int = 0,
                    chunk_mode: str = "all", w8a8: bool = False, w8a8_prefill: bool = False,
                    q8_mxu: bool = False) -> GenerateResult:
    """Prefill + greedy decode; the caches hold ``S_prompt + max_new_tokens``
    slots. ``prefill_chunk > 0`` prefills in batch chunks
    (``chunked_prefill_decode_state``); in mode "all" the decode runs at the
    chunk-padded batch and the outputs are cut to the true batch, as the
    reference's chunked stage does."""
    b = input_ids.shape[0]
    state, hidden, last_hidden = chunked_prefill_decode_state(
        params, cfg, input_ids, token_type_ids, position_ids, prompt_len,
        chunk=prefill_chunk, chunk_mode=chunk_mode, smax=input_ids.shape[1] + max_new_tokens,
        eos_token_id=eos_token_id, image=image, patch_size=patch_size, pool_size=pool_size,
        vis_span=vis_span, kv_cache_dtype=kv_cache_dtype, w8a8_prefill=w8a8_prefill,
    )
    with record_function("decode"):
        res = greedy_decode_from_state(
            params, cfg, state, hidden, last_hidden, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, bop_token_id=bop_token_id, eop_token_id=eop_token_id,
            w8a8=w8a8, q8_mxu=q8_mxu,
        )
    return GenerateResult(res.tokens[:b], res.hidden[:b], res.prefill_hidden[:b],
                          res.num_generated[:b])
