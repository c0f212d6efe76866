"""N-gram speculative decoding, the port of ``mmmm_tpu/models/speculate.py``
(``ngram_draft``, ``ngram_speculative_generate``).

Each verify step drafts ``draft_len`` tokens by looking the trailing n-gram
up in the request's own history (prompt plus what was generated), feeds the
current token and the drafts as one window of ``k = draft_len + 1`` tokens
through ``llm_decode_step`` (one pass over the weights; on a bf16 cache a
window of up to 8 is K6 with K5's append inside its launch, a longer one
the decoder's plain route), and commits the longest
draft prefix that matches the model's own fp32 argmax, plus the model's
next token. The output is token-identical to greedy decoding, with the
``<p>`` position freeze applied across the window and greedy's eos and
``num_generated`` rules.

The reference runs the loop on the device in one ``lax.while_loop``; here
it is a Python loop with one host check per verify step (whether any row is
still active).
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from ..ops.quant import qdot
from ..parallel.tensor import vocab_argmax
from .cogvlm import CogVLMConfig
from .cogvlm.decoder import llm_decode_step
from .generate import GenerateResult, chunked_prefill_decode_state


def ngram_draft(hist: torch.Tensor, hist_len: torch.Tensor, *, n_draft: int,
                ngram: int = 2) -> torch.Tensor:
    """Propose ``n_draft`` tokens after the end of ``hist`` (B, L), valid up
    to ``hist_len`` (B,): the tokens that followed the most recent earlier
    occurrence of the trailing ``ngram`` tokens. Positions past the valid
    region and rows without a match repeat the newest token."""
    b, length = hist.shape
    hist_len = hist_len.long()
    idx = torch.arange(length, device=hist.device)
    ok = torch.ones((b, length), dtype=torch.bool, device=hist.device)
    for j in range(ngram):
        ctx_j = hist.gather(1, (hist_len - ngram + j).clamp_min(0)[:, None])
        # hist[p + j] for every candidate start p (the wrap of the roll is
        # masked below: candidates stop at hist_len - 1 - ngram)
        ok &= torch.roll(hist, -j, dims=1) == ctx_j
    ok &= (idx[None, :] + ngram) <= (hist_len[:, None] - 1)
    found = ok.any(dim=1)
    p_best = torch.where(ok, idx[None, :], -1).argmax(dim=1)  # the last match
    gather = (p_best[:, None] + ngram + torch.arange(n_draft, device=hist.device)[None, :])
    gather = gather.clamp(0, length - 1)
    drafts = hist.gather(1, gather)
    newest = hist.gather(1, (hist_len - 1)[:, None])
    valid = found[:, None] & (gather < hist_len[:, None])
    return torch.where(valid, drafts, newest)


def _put_rows(buf: torch.Tensor, rows: torch.Tensor, start: torch.Tensor) -> None:
    """``buf[b, t:t + k] = rows[b]`` in place, ``t`` being ``start[b]`` clamped
    to ``[0, L - k]`` as ``dynamic_update_slice`` does (starts are never
    negative here)."""
    k = rows.shape[1]
    t = start.long().clamp(0, buf.shape[1] - k)
    idx = t[:, None] + torch.arange(k, device=buf.device)
    buf[torch.arange(buf.shape[0], device=buf.device)[:, None], idx] = rows


def ngram_speculative_generate(params: dict, cfg: CogVLMConfig, input_ids, token_type_ids,
                               position_ids, prompt_len, *, max_new_tokens: int,
                               eos_token_id: int, bop_token_id: int, eop_token_id: int,
                               image=None, patch_size=None, pool_size=None, vis_span=None,
                               kv_cache_dtype: str = "bf16", draft_len: int = 7,
                               ngram: int = 2, return_stats: bool = False,
                               prefill_chunk: int = 0, chunk_mode: str = "all",
                               w8a8: bool = False, w8a8_prefill: bool = False):
    """Drop-in replacement for ``greedy_generate`` with n-gram speculation:
    the same tokens, ``num_generated`` and per-token hidden states. A window
    holds ``k = draft_len + 1`` tokens, any ``draft_len >= 1`` as in the
    reference; the caches get ``k`` slack slots so a full window always
    fits. ``prefill_chunk > 0`` prefills in batch
    chunks (``chunked_prefill_decode_state``, cut back to the true batch
    before the verify loop). ``return_stats=True`` also returns
    ``{"iters": verify steps, "tokens_per_step": committed tokens per row
    and step}``."""
    k = draft_len + 1
    if draft_len < 1:
        raise ValueError(f"draft_len must be at least 1, got {draft_len}")
    b, s_prompt = input_ids.shape
    dev = input_ids.device
    smax = s_prompt + max_new_tokens + k
    st, prefill_hidden, last_hidden = chunked_prefill_decode_state(
        params, cfg, input_ids, token_type_ids, position_ids, prompt_len, chunk=prefill_chunk,
        chunk_mode=chunk_mode, slice_to_batch=True, smax=smax, eos_token_id=eos_token_id,
        image=image, patch_size=patch_size, pool_size=pool_size, vis_span=vis_span,
        kv_cache_dtype=kv_cache_dtype, w8a8_prefill=w8a8_prefill,
    )
    llm = params["llm"]
    c = last_hidden.shape[-1]
    rows = torch.arange(b, device=dev)
    hist = torch.zeros((b, smax), dtype=torch.int32, device=dev)
    hist[:, :s_prompt] = input_ids
    hist[rows, prompt_len.long()] = st["tok"]  # the newest token is the one to feed
    hist_len = prompt_len.long() + 1
    h_prev = last_hidden  # the hidden state that produced st["tok"]
    out_tokens = torch.full((b, max_new_tokens + k), eos_token_id, dtype=torch.int32, device=dev)
    out_hidden = torch.zeros((b, max_new_tokens + k, c), dtype=last_hidden.dtype, device=dev)
    emitted = torch.zeros((b,), dtype=torch.long, device=dev)
    tok, prev, pos, write, done = st["tok"], st["prev_tok"], st["pos"], st["write"], st["done"]
    j_idx = torch.arange(k, device=dev)[None, :]
    iters = 0
    with record_function("decode"):
        while iters < max_new_tokens:
            active = ~done & (emitted < max_new_tokens)
            if not bool(active.any()):
                break
            drafts = ngram_draft(hist, hist_len, n_draft=draft_len, ngram=ngram)
            window = torch.cat([tok[:, None], drafts], dim=1)  # (B, k)
            # <p> position freeze across the window: fed token j keeps the
            # position of its predecessor when that is <p> or it is </p>
            prevs = torch.cat([prev[:, None], window[:, :-1]], dim=1)
            keep = (prevs == bop_token_id) | (window == eop_token_id)
            pos_w = pos[:, None] + torch.cumsum(1 - keep.long(), dim=1)
            kv_len = write[:, None] + torch.arange(1, k + 1, dtype=torch.int32, device=dev)
            hidden_w, _ = llm_decode_step(llm, cfg, llm["embed_tokens"][window], pos_w,
                                          st["caches"], write, kv_len, w8a8=w8a8)
            g = vocab_argmax(qdot(hidden_w, llm["lm_head"]).float()).to(torch.int32)

            # accept the longest draft prefix matching the model's own argmax;
            # commit window[j] while j <= a and no eos among window[:j + 1]
            match = (window[:, 1:] == g[:, :-1]).long()
            a = torch.cumprod(match, dim=1).sum(dim=1)  # last accepted index in [0, k-1]
            noneos = torch.cumprod((window != eos_token_id).long(), dim=1)
            commit = (j_idx <= a[:, None]) & (noneos == 1)
            n_raw = commit.sum(dim=1)
            room = (max_new_tokens - emitted).clamp_min(0)
            n = torch.where(active, torch.minimum(n_raw, room), 0)
            eos_hit = noneos.gather(1, a[:, None])[:, 0] == 0

            last = (n - 1).clamp_min(0)[:, None]  # index of the last committed token
            nxt = g.gather(1, last)[:, 0]  # the model's own token after it
            done_new = done | (active & ((eos_hit & (n == n_raw)) | (nxt == eos_token_id)))
            tok_new = torch.where(active, torch.where(done_new, eos_token_id, nxt), tok)
            prev = torch.where(active, window.gather(1, last)[:, 0], prev)
            pos = torch.where(active, pos_w.gather(1, last)[:, 0], pos)
            h_new = torch.where(active[:, None],
                                hidden_w.gather(1, last[:, :, None].expand(-1, -1, c))[:, 0],
                                h_prev)

            # full-window writes; inactive rows write into the slack region
            off_out = torch.where(active, emitted, max_new_tokens)
            _put_rows(out_tokens, window, off_out)
            _put_rows(out_hidden, torch.cat([h_prev[:, None], hidden_w[:, :k - 1]], dim=1),
                      off_out)
            # history: the committed drafts, then the new current token; the
            # rest of the window lies past hist_len and is never matched
            shifted = torch.cat([window[:, 1:], window[:, -1:]], dim=1)
            _put_rows(hist, torch.where(j_idx == last, tok_new[:, None], shifted),
                      torch.where(active, hist_len, smax - k))

            tok, done, h_prev = tok_new, done_new, h_new
            write = (write + n).to(torch.int32)
            hist_len = hist_len + n
            emitted = emitted + n
            iters += 1

    t_idx = torch.arange(max_new_tokens, device=dev)[None, :]
    tokens = torch.where(t_idx < emitted[:, None], out_tokens[:, :max_new_tokens], eos_token_id)
    result = GenerateResult(tokens, out_hidden[:, :max_new_tokens], prefill_hidden, emitted)
    if return_stats:
        stats = {"iters": iters,
                 "tokens_per_step": float(emitted.sum()) / (max(iters, 1) * b)}
        return result, stats
    return result
