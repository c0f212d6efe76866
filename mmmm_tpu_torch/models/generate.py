"""Greedy generation over preallocated KV caches, the port of
``mmmm_tpu/models/generate.py`` (``prefill_decode_state``,
``greedy_decode_from_state``, ``greedy_generate``). The caches are pairs in
the model's dtype or, with ``kv_cache_dtype="int8"``, per-slot quantized;
the ``lm_head`` may be plain or W8A16 (``qdot``).

The decode loop is a Python loop over ``max_new_tokens`` steps that stays on
the device (no host sync per step). Kept from the reference:

  - the ``<p>`` keep rule: the position id does not advance when the
    previous token is ``<p>`` or the fed token is ``</p>``;
  - done/eos masking: after eos every token is eos and is not counted;
  - hidden-state alignment: ``hidden[:, t]`` is the state that produced
    ``tokens[:, t]``, which is what SAM prompting gathers.
"""
from __future__ import annotations

import dataclasses

import torch
from torch.profiler import record_function

from ..ops.quant import qdot
from .cogvlm import CogVLMConfig
from .cogvlm.decoder import llm_decode_step, llm_prefill
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
                         kv_cache_dtype: str = "bf16"):
    """Prefill the (right-padded) multimodal prompt into caches of ``smax``
    slots; returns ``(state, prefill_hidden, last_hidden)``. ``params`` is
    the CogVLM tree ``{"llm": ..., "vision": ...}``."""
    b, s_prompt = input_ids.shape
    dev = input_ids.device
    segments = (torch.arange(s_prompt, device=dev)[None, :] < prompt_len[:, None]).to(torch.int32)
    llm = params["llm"]
    emb = llm["embed_tokens"][input_ids]
    if image is not None:
        with record_function("vit"):
            emb = splice_vision_embeds(emb, vit_forward(params["vision"], cfg, image,
                                                        patch_size, pool_size))
    with record_function("llm_prefill"):
        hidden, caches = llm_prefill(llm, cfg, emb, token_type_ids, position_ids, segments,
                                     smax=smax, vis_span=vis_span,
                                     kv_cache_dtype=kv_cache_dtype)
    rows = torch.arange(b, device=dev)
    last_idx = prompt_len.long() - 1
    last_hidden = hidden[rows, last_idx]  # (B, C)
    tok0 = torch.argmax(qdot(last_hidden, llm["lm_head"]).float(), dim=-1).to(torch.int32)
    state = {
        "caches": caches,
        "tok": tok0,  # token to feed next
        "prev_tok": input_ids[rows, last_idx].to(torch.int32),  # token before it
        "pos": position_ids[rows, last_idx].long(),  # position of the previous token
        "write": prompt_len.to(torch.int32),  # cache slot for the fed token
        "done": tok0 == eos_token_id,
    }
    return state, hidden, last_hidden


def greedy_decode_from_state(params: dict, cfg: CogVLMConfig, state: dict, hidden,
                             last_hidden, *, max_new_tokens: int, eos_token_id: int,
                             bop_token_id: int, eop_token_id: int) -> GenerateResult:
    """Run ``max_new_tokens`` greedy decode steps from a prefilled state."""
    llm = params["llm"]
    toks, hids, dones = [], [], []
    for _ in range(max_new_tokens):
        tok, prev = state["tok"], state["prev_tok"]
        keep = (prev == bop_token_id) | (tok == eop_token_id)
        pos = state["pos"] + 1 - keep.long()
        emb_t = llm["embed_tokens"][tok][:, None, :]
        hidden_t, caches = llm_decode_step(llm, cfg, emb_t, pos[:, None], state["caches"],
                                           state["write"], state["write"] + 1)
        hidden_t = hidden_t[:, 0]
        next_tok = torch.argmax(qdot(hidden_t, llm["lm_head"]).float(), dim=-1).to(torch.int32)
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
                    vis_span=None, kv_cache_dtype: str = "bf16") -> GenerateResult:
    """Prefill + greedy decode; the caches hold ``S_prompt + max_new_tokens`` slots."""
    state, hidden, last_hidden = prefill_decode_state(
        params, cfg, input_ids, token_type_ids, position_ids, prompt_len,
        smax=input_ids.shape[1] + max_new_tokens, eos_token_id=eos_token_id,
        image=image, patch_size=patch_size, pool_size=pool_size, vis_span=vis_span,
        kv_cache_dtype=kv_cache_dtype,
    )
    with record_function("decode"):
        return greedy_decode_from_state(
            params, cfg, state, hidden, last_hidden, max_new_tokens=max_new_tokens,
            eos_token_id=eos_token_id, bop_token_id=bop_token_id, eop_token_id=eop_token_id,
        )
