"""Continuous batching over a slot pool, the port of
``mmmm_tpu/models/serving.py`` (``TextServer``, ``GroundedServer``).

A fixed pool of ``n_slots`` cache rows decodes in chunks of ``chunk`` steps
over every slot (idle slots ride along, their writes clamped to the last
slot); between chunks, finished slots are refilled: the next prompts
prefill as a sub-batch padded to a power of two, whose caches and decode
state go into the free pool rows in place (``index_copy_``). Each slot
keeps its own write index and ``kv_len``, so the decode step's K1 (with
K2's append inside its launch) reads every row to its own length.

``TextServer`` adds automatic prefix caching: the job's longest common
token prefix is prefilled once, and each request's suffix, bucketed to
``seq_quant`` tokens, runs as one decode window against ``f`` copies of
the prefix caches (``llm_decode_step``'s plain route for windows of more
than 8 tokens). Both servers can decode speculatively (``speculate=k``
drafts a step by n-gram lookup; windows of ``k + 1`` through K6 with K5's
append inside its launch), token-identical to greedy. ``GroundedServer``
keeps the hidden state of every generated token in a ring buffer on the
device and runs ``vg_proj`` and the semantic SAM over each finished
group's ``</p>`` positions before their slots are refilled.

The reference's chunk is one device program (``lax.scan``); here it is a
Python loop of ``chunk`` steps with no host sync inside it and one copy to
the host at its end. The reference's ``attn_impl`` keyword is ``device``:
the servers run on the card unless the caller passes ``device="cpu"``.
Completions equal ``greedy_generate``'s and ``generate_grounded``'s. Of
the reference's process-wide numeric switches, ``GroundedServer`` takes
``gelu_mode`` and ``dense_fast_softmax`` (its ViT and SAM read them), in
force for each ``generate`` call (``ops/numerics.py``). The pools' caches
are bf16, so ``q8_cast`` (K9's products) has nothing to act on here, and a
``TextServer`` runs no ViT or SAM: neither server takes the others.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..data.tokenizer import MMMMTokenizer
from ..ops._cuda import resolve_device
from ..ops.numerics import Numerics, numerics
from ..ops.quant import qdot
from .cogvlm import CogVLMConfig
from .cogvlm.decoder import empty_cache, llm_decode_step
from .generate import prefill_decode_state
from .inference import _eop_positions, _ground
from .mmmm import MMMMConfig
from .speculate import _put_rows, ngram_draft


def _bucket(n: int, quant: int) -> int:
    return -(-n // quant) * quant


def _pow2(n: int) -> int:
    p = 1
    while p < n:
        p *= 2
    return p


@dataclasses.dataclass
class _Request:
    rid: int
    ids: list[int]
    budget: int
    out: list[int] = dataclasses.field(default_factory=list)


def _on(params_leaf: torch.Tensor, device) -> torch.device:
    """The run's device, checked against the parameters'."""
    dev = resolve_device(device)
    if params_leaf.device.type != dev.type:
        raise ValueError(f"params lie on {params_leaf.device}, the server asks for {dev}")
    return dev


def _scatter(pool: dict, sub: dict, slots: torch.Tensor) -> None:
    """Rows ``[0, len(slots))`` of the sub-batch state go to pool rows
    ``slots``, in place (every key of ``sub``; ``"caches"`` per layer)."""
    n = slots.shape[0]
    for key, small in sub.items():
        if key == "caches":
            for big_layer, small_layer in zip(pool[key], small):
                for big, part in zip(big_layer, small_layer):
                    big.index_copy_(0, slots, part[:n])
        else:
            pool[key].index_copy_(0, slots, small[:n].to(pool[key].dtype))


def _pool_state(b: int, cfg: CogVLMConfig, smax: int, dtype, dev) -> dict:
    """An empty pool: zeroed bf16-path caches and every slot done."""
    return {
        "caches": [empty_cache(b, cfg.num_attention_heads, smax, cfg.head_dim, dtype, dev, "bf16")
                   for _ in range(cfg.num_hidden_layers)],
        "tok": torch.zeros((b,), dtype=torch.int32, device=dev),
        "prev_tok": torch.zeros((b,), dtype=torch.int32, device=dev),
        "pos": torch.zeros((b,), dtype=torch.long, device=dev),
        "write": torch.zeros((b,), dtype=torch.int32, device=dev),
        "done": torch.ones((b,), dtype=torch.bool, device=dev),
    }


def _greedy_step(llm: dict, cfg: CogVLMConfig, st: dict, smax: int, eos: int, bop: int,
                 eop: int):
    """One greedy step of every slot: (new state without its extra keys,
    the step's hidden states (B, C)); the token fed is ``st["tok"]``."""
    tok, prev = st["tok"], st["prev_tok"]
    keep = (prev == bop) | (tok == eop)
    pos = st["pos"] + 1 - keep.long()
    write = st["write"].clamp_max(smax - 1)
    hidden, _ = llm_decode_step(llm, cfg, llm["embed_tokens"][tok][:, None, :], pos[:, None],
                                st["caches"], write, write + 1)
    hidden = hidden[:, 0]
    nxt = torch.argmax(qdot(hidden, llm["lm_head"]).float(), dim=-1).to(torch.int32)
    nxt = torch.where(st["done"], eos, nxt)
    new = {"caches": st["caches"], "tok": nxt, "prev_tok": tok, "pos": pos, "write": write + 1,
           "done": st["done"] | (nxt == eos)}
    return new, hidden


def _spec_step(llm: dict, cfg: CogVLMConfig, st: dict, k: int, smax: int, room, eos: int,
               bop: int, eop: int):
    """One verify step of every slot over a window of ``k`` tokens (the
    slot's token, then ``k - 1`` n-gram drafts), committing at most
    ``room`` (B,) tokens. Returns (new state without its extra keys, the
    window (B, k), the committed counts n (B,), ``active`` (B,), the index
    of the last committed token (B, 1), the window's hidden states)."""
    dev = st["tok"].device
    j_idx = torch.arange(k, device=dev)[None, :]
    active = ~st["done"] & (room > 0)
    drafts = ngram_draft(st["hist"], st["hist_len"], n_draft=k - 1)
    window = torch.cat([st["tok"][:, None], drafts], dim=1)
    prevs = torch.cat([st["prev_tok"][:, None], window[:, :-1]], dim=1)
    keep = (prevs == bop) | (window == eop)
    pos_w = st["pos"][:, None] + torch.cumsum(1 - keep.long(), dim=1)
    write = st["write"].clamp_max(smax - k)
    kv_len = write[:, None] + torch.arange(1, k + 1, dtype=torch.int32, device=dev)
    hidden_w, _ = llm_decode_step(llm, cfg, llm["embed_tokens"][window], pos_w, st["caches"],
                                  write, kv_len)
    g = torch.argmax(qdot(hidden_w, llm["lm_head"]).float(), dim=-1).to(torch.int32)
    match = (window[:, 1:] == g[:, :-1]).long()
    a = torch.cumprod(match, dim=1).sum(dim=1)
    noneos = torch.cumprod((window != eos).long(), dim=1)
    commit = (j_idx <= a[:, None]) & (noneos == 1)
    n_raw = commit.sum(dim=1)
    n = torch.where(active, torch.minimum(n_raw, room), 0)
    eos_hit = noneos.gather(1, a[:, None])[:, 0] == 0
    last = (n - 1).clamp_min(0)[:, None]
    nxt = g.gather(1, last)[:, 0]
    done_new = st["done"] | (active & ((eos_hit & (n == n_raw)) | (nxt == eos) | (n >= room)))
    tok_new = torch.where(active, torch.where(done_new, eos, nxt), st["tok"])
    # history: the committed drafts, then the new token; inactive rows write
    # into the last k slots, past every valid history
    shifted = torch.cat([window[:, 1:], window[:, -1:]], dim=1)
    _put_rows(st["hist"], torch.where(j_idx == last, tok_new[:, None], shifted),
              torch.where(active, st["hist_len"], smax - k))
    new = {"caches": st["caches"], "tok": tok_new,
           "prev_tok": torch.where(active, window.gather(1, last)[:, 0], st["prev_tok"]),
           "pos": torch.where(active, pos_w.gather(1, last)[:, 0], st["pos"]),
           "write": (write + n).to(torch.int32), "done": done_new, "hist": st["hist"],
           "hist_len": st["hist_len"] + n}
    return new, window, n, active, last, hidden_w


def _chunk_record(window, n, done) -> torch.Tensor:
    """A verify step's (window, commits, done) as one (B, k + 2) int32 row,
    so that a chunk reaches the host in one copy."""
    return torch.cat([window, n[:, None].to(torch.int32), done[:, None].to(torch.int32)], dim=1)


class TextServer:
    """Continuous-batching greedy text generation over a slot pool.

    ``params`` is the CogVLM tree (``{"llm": ..., "vision": ...}``) on
    ``device``. ``generate(prompts)`` returns completions in input order;
    throughput scales with mean (not max) completion length because
    finished slots are refilled mid-flight."""

    def __init__(self, params: dict, cfg: CogVLMConfig, tokenizer: MMMMTokenizer, *,
                 n_slots: int = 8, max_new_tokens: int = 128, chunk: int = 16,
                 seq_quant: int = 64, max_prompt_len: int = 512, prefix_cache: bool = True,
                 min_prefix: int = 32, speculate: int = 0,
                 device: str | torch.device = "cuda"):
        self.dev = _on(params["llm"]["embed_tokens"], device)
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.n_slots = n_slots
        self.max_new = max_new_tokens
        self.chunk = chunk
        self.seq_quant = seq_quant
        self.max_prompt = max_prompt_len
        self.prefix_cache = prefix_cache
        self.min_prefix = min_prefix
        self.spec = speculate
        # pool depth: longest prompt + full generation + one chunk of
        # overshoot (+ the k-wide verify-window slack when speculating)
        self.smax = _bucket(max_prompt_len + max_new_tokens + chunk + (speculate + 1), seq_quant)
        self.stats = {
            "chunks": 0, "refills": 0, "refilled_mid_flight": 0,
            "prefix_len": 0, "prefix_tokens_saved": 0,
            "spec_steps": 0, "spec_committed": 0,
        }

    # ---- stages ------------------------------------------------------------

    def _prefill(self, ids: np.ndarray, prompt_len: np.ndarray) -> dict:
        """(f prompts padded to s) -> the sub-batch's decode state."""
        to = lambda x: torch.as_tensor(x, device=self.dev)
        f, s = ids.shape
        pos = np.tile(np.arange(s, dtype=np.int32), (f, 1))
        st, _, _ = prefill_decode_state(self.params, self.cfg, to(ids), to(np.zeros_like(ids)),
                                        to(pos), to(prompt_len), smax=self.smax,
                                        eos_token_id=self.tok.eos_token_id)
        return st

    def _prefix_refill(self, prefix_caches: list, ids: np.ndarray, suffix_len: np.ndarray,
                       p: int) -> dict:
        """Suffix-only prefill continuing from the shared-prefix KV: the (f,
        s) suffixes run as one ``llm_decode_step`` window at write index
        ``p`` over ``f`` copies of the prefix caches (which stay unwritten),
        position j seeing the prefix and the window causally; padded tail
        positions clamp their ``kv_len`` to the last real token, and their
        outputs and cache slots (``>= p + suffix_len``, overwritten before
        any read) are discarded."""
        llm, dev = self.params["llm"], self.dev
        f, s = ids.shape
        ids_t, sfx = torch.as_tensor(ids, device=dev), torch.as_tensor(suffix_len, device=dev)
        pos = p + torch.arange(s, device=dev).expand(f, s)
        caches = [tuple(t.repeat(f, 1, 1, 1) for t in layer) for layer in prefix_caches]
        write = torch.full((f,), p, dtype=torch.int32, device=dev)
        j = torch.arange(s, device=dev)[None, :]
        kv_len = (p + torch.minimum(j, sfx[:, None] - 1) + 1).to(torch.int32)
        with record_function("prefix_refill"):
            hidden, caches = llm_decode_step(llm, self.cfg, llm["embed_tokens"][ids_t], pos,
                                             caches, write, kv_len)
        rows, last = torch.arange(f, device=dev), sfx.long() - 1
        tok0 = torch.argmax(qdot(hidden[rows, last], llm["lm_head"]).float(),
                            dim=-1).to(torch.int32)
        plen = sfx.long() + p
        return {"caches": caches, "tok": tok0, "prev_tok": ids_t[rows, last], "pos": plen - 1,
                "write": plen.to(torch.int32), "done": tok0 == self.tok.eos_token_id}

    def _decode_chunk(self, st: dict):
        """``chunk`` greedy steps over every slot -> (state, (B, chunk)
        tokens fed, on the device)."""
        eos, bop, eop = self.tok.eos_token_id, self.tok.bop_token_id, self.tok.eop_token_id
        toks = []
        with record_function("decode"):
            for _ in range(self.chunk):
                toks.append(st["tok"])
                st, _ = _greedy_step(self.params["llm"], self.cfg, st, self.smax, eos, bop, eop)
        return st, torch.stack(toks, dim=1)

    def _decode_spec_chunk(self, st: dict):
        """``chunk`` verify steps over every slot, each committing the
        longest argmax-matching draft prefix within the slot's budget ->
        (state, (B, chunk, k + 2) windows, commit counts and done flags)."""
        eos, bop, eop = self.tok.eos_token_id, self.tok.bop_token_id, self.tok.eop_token_id
        k = self.spec + 1
        rec = []
        with record_function("decode"):
            for _ in range(self.chunk):
                room = (st["budget"] - st["emitted"]).clamp_min(0)
                new, window, n, _, _, _ = _spec_step(self.params["llm"], self.cfg, st, k, self.smax,
                                                     room, eos, bop, eop)
                new.update(budget=st["budget"], emitted=st["emitted"] + n)
                st = new
                rec.append(_chunk_record(window, n, st["done"]))
        return st, torch.stack(rec, dim=1)

    # ---- host scheduler ----------------------------------------------------

    def generate(self, prompts: list[str], max_new: list[int] | None = None) -> list[str]:
        """``max_new`` optionally carries a per-request token budget (defaults
        to the server's ``max_new_tokens``), as in vLLM's per-request params."""
        with torch.inference_mode():
            return self._generate(prompts, max_new)

    def _generate(self, prompts, max_new):
        tok, dev = self.tok, self.dev
        reqs = []
        for rid, p in enumerate(prompts):
            ids = [tok.bos_token_id] + tok.encode(p)
            if len(ids) > self.max_prompt:
                ids = ids[: self.max_prompt]
            budget = min(self.max_new if max_new is None else max_new[rid], self.max_new)
            reqs.append(_Request(rid, ids, budget))
        # longest-first: long prompts enter the pool early so the tail of the
        # run drains short ones
        queue = sorted(reqs, key=lambda r: -len(r.ids))
        results: dict[int, list[int]] = {}

        # automatic prefix caching: longest common token prefix of the job
        # (every request keeps >= 1 suffix token so its prefill emits a first
        # token); prefilled once, suffixes continue from its KV
        pfx_len = 0
        pfx_caches = None
        if self.prefix_cache and len(reqs) > 1:
            first = reqs[0].ids
            cap = min(len(r.ids) for r in reqs) - 1
            while pfx_len < cap and all(r.ids[pfx_len] == first[pfx_len] for r in reqs):
                pfx_len += 1
            if pfx_len < self.min_prefix:
                pfx_len = 0
        if pfx_len:
            ids = np.zeros((1, _bucket(pfx_len, self.seq_quant)), np.int32)
            ids[0, :pfx_len] = reqs[0].ids[:pfx_len]
            pfx_caches = self._prefill(ids, np.asarray([pfx_len], np.int32))["caches"]
            self.stats["prefix_len"] = pfx_len
            self.stats["prefix_tokens_saved"] = pfx_len * (len(reqs) - 1)

        b, smax = self.n_slots, self.smax
        # pool dtype follows the model's compute dtype (decode writes raw k/v)
        state = _pool_state(b, self.cfg, smax, self.params["llm"]["embed_tokens"].dtype, dev)
        if self.spec:
            state.update(hist=torch.zeros((b, smax), dtype=torch.int32, device=dev),
                         hist_len=torch.ones((b,), dtype=torch.long, device=dev),
                         budget=torch.zeros((b,), dtype=torch.long, device=dev),
                         emitted=torch.zeros((b,), dtype=torch.long, device=dev))
        slot_req: list[_Request | None] = [None] * b

        def refill():
            free = [i for i in range(b) if slot_req[i] is None]
            if not free or not queue:
                return
            self.stats["refills"] += 1
            if any(r is not None for r in slot_req):
                # the continuous-batching property: new work entered the pool
                # while other slots were mid-request
                self.stats["refilled_mid_flight"] += 1
            take = [queue.pop(0) for _ in range(min(len(free), len(queue)))]
            f = _pow2(len(take))
            if pfx_len:
                s = _bucket(max(len(r.ids) - pfx_len for r in take), self.seq_quant)
                ids = np.zeros((f, s), np.int32)
                sfx = np.ones((f,), np.int32)
                for row, r in enumerate(take):
                    suffix = r.ids[pfx_len:]
                    ids[row, : len(suffix)] = suffix
                    sfx[row] = len(suffix)
                sub = self._prefix_refill(pfx_caches, ids, sfx, pfx_len)
            else:
                s = _bucket(max(len(r.ids) for r in take), self.seq_quant)
                ids = np.zeros((f, s), np.int32)
                plen = np.ones((f,), np.int32)
                for row, r in enumerate(take):
                    ids[row, : len(r.ids)] = r.ids
                    plen[row] = len(r.ids)
                sub = self._prefill(ids, plen)
            n = len(take)
            slots = free[:n]
            if self.spec:
                # per-slot n-gram history: the full prompt (prefix included,
                # drafts may match template phrases), then the first token
                hist = np.zeros((n, smax), np.int32)
                for row, r in enumerate(take):
                    hist[row, : len(r.ids)] = r.ids
                hist = torch.as_tensor(hist, device=dev)
                lens = torch.as_tensor([len(r.ids) for r in take], device=dev)
                hist[torch.arange(n, device=dev), lens] = sub["tok"][:n]
                sub.update(hist=hist, hist_len=lens + 1,
                           budget=torch.as_tensor([r.budget for r in take], device=dev),
                           emitted=torch.zeros((n,), dtype=torch.long, device=dev))
            _scatter(state, sub, torch.as_tensor(slots, device=dev))
            for row, r in enumerate(take):
                slot_req[slots[row]] = r

        while queue or any(r is not None for r in slot_req):
            refill()
            self.stats["chunks"] += 1
            if self.spec:
                state, rec = self._decode_spec_chunk(state)
                rec = rec.cpu().numpy()  # (B, chunk, k + 2), the chunk's one copy
                k = self.spec + 1
                win, ns, dones = rec[..., :k], rec[..., k], rec[..., k + 1]
                self.stats["spec_steps"] += int((ns > 0).sum())
                self.stats["spec_committed"] += int(ns.sum())
                for i in range(b):
                    r = slot_req[i]
                    if r is None:
                        continue
                    for j in range(self.chunk):
                        r.out.extend(int(t) for t in win[i, j, : ns[i, j]])
                        if dones[i, j] or len(r.out) >= r.budget:
                            results[r.rid] = r.out[: r.budget]
                            slot_req[i] = None
                            break
                continue
            state, toks = self._decode_chunk(state)
            toks = toks.cpu().numpy()  # (B, chunk) tokens emitted this chunk
            for i in range(b):
                r = slot_req[i]
                if r is None:
                    continue
                for t in toks[i]:
                    t = int(t)
                    done = t == tok.eos_token_id
                    if not done:
                        r.out.append(t)
                    if done or len(r.out) >= r.budget:
                        results[r.rid] = r.out
                        slot_req[i] = None
                        break

        for r in reqs:  # anything still in flight when the loop exits
            if r.rid not in results:
                results[r.rid] = r.out
        return [tok.decode(results[r.rid]) for r in reqs]


class GroundedServer:
    """Continuous batching for the full grounded-report path.

    Requests are (image, prompt) pairs; a refill runs the ViT and the LLM
    prefill over the joining sub-batch and puts its caches into the pool;
    decode keeps the hidden state of each generated token in a ring buffer
    (B, max_new + slack, C) on the device; when a request finishes, its
    ``</p>`` positions are parsed on the host and the semantic SAM pass
    runs over the finished group, gathered from the ring buffer, before the
    slots are refilled. One server serves one image and prompt family
    (fixed preprocessing). ``params`` is the full MMMM tree on ``device``."""

    def __init__(self, params: dict, cfg: MMMMConfig, tokenizer: MMMMTokenizer, *,
                 patch_size, pool_size, n_vis: int, n_slots: int = 8,
                 max_new_tokens: int = 128, chunk: int = 16, seq_quant: int = 32,
                 max_prompt_len: int = 256, max_targets: int = 8, speculate: int = 0,
                 gelu_mode: str = "auto", dense_fast_softmax: bool = False,
                 device: str | torch.device = "cuda"):
        self.dev = _on(params["vg_proj"]["w1"], device)
        self.numerics = Numerics(gelu_mode, dense_fast_softmax)
        self.params = params
        self.cfg = cfg
        self.tok = tokenizer
        self.patch = tuple(patch_size)
        self.pool = tuple(pool_size)
        self.n_vis = n_vis
        self.n_slots = n_slots
        self.max_new = max_new_tokens
        self.chunk = chunk
        self.seq_quant = seq_quant
        self.max_prompt = max_prompt_len
        self.max_targets = max_targets
        # n-gram speculation, with k-wide ring-buffer writes so that SAM
        # prompting still gathers the exact hidden state of every </p>
        self.spec = speculate
        self.smax = _bucket(max_prompt_len + max_new_tokens + chunk + (speculate + 1), seq_quant)
        self.stats = {
            "chunks": 0, "refills": 0, "refilled_mid_flight": 0,
            "spec_steps": 0, "spec_committed": 0,
        }

    # ---- stages ------------------------------------------------------------

    def _decode_chunk(self, st: dict):
        """``chunk`` greedy steps; the hidden state that produced generated
        token ``cnt + 1`` goes to ring-buffer slot ``cnt + 1``, and the steps
        past ``max_new`` tokens write the slack slot ``max_new``. (The
        reference clamps to ``max_new - 1``, so there the step after the
        last kept token overwrites its hidden state, and a ``</p>`` in that
        place prompts SAM with the next token's; ``generate_grounded`` and
        the speculative server gather the right one, as here.)"""
        eos, bop, eop = self.tok.eos_token_id, self.tok.bop_token_id, self.tok.eop_token_id
        rows = torch.arange(self.n_slots, device=self.dev)
        toks = []
        with record_function("decode"):
            for _ in range(self.chunk):
                toks.append(st["tok"])
                new, hidden = _greedy_step(self.params["cogvlm"]["llm"], self.cfg.vlm, st,
                                           self.smax, eos, bop, eop)
                cnt = (st["cnt"] + 1).clamp_max(self.max_new)
                st["hbuf"][rows, cnt] = hidden.to(st["hbuf"].dtype)
                new.update(cnt=cnt, hbuf=st["hbuf"])
                st = new
        return st, torch.stack(toks, dim=1)

    def _decode_spec_chunk(self, st: dict):
        """``chunk`` verify steps; ``hbuf[emitted + j]`` holds the hidden
        state that produced generated token ``emitted + j`` (window token j
        was produced by ``h_prev`` for j = 0, else by the window's hidden
        state j - 1); inactive rows park their writes in the k-slot slack
        past ``max_new``."""
        eos, bop, eop = self.tok.eos_token_id, self.tok.bop_token_id, self.tok.eop_token_id
        k = self.spec + 1
        rec = []
        with record_function("decode"):
            for _ in range(self.chunk):
                room = (self.max_new - st["emitted"]).clamp_min(0)
                new, window, n, active, last, hidden_w = _spec_step(
                    self.params["cogvlm"]["llm"], self.cfg.vlm, st, k, self.smax, room, eos, bop,
                    eop)
                hbuf = st["hbuf"]
                _put_rows(hbuf, torch.cat([st["h_prev"][:, None], hidden_w[:, : k - 1]],
                                          dim=1).to(hbuf.dtype),
                          torch.where(active, st["emitted"], self.max_new))
                c = hidden_w.shape[-1]
                h_last = hidden_w.gather(1, last[:, :, None].expand(-1, -1, c))[:, 0]
                new.update(hbuf=hbuf, h_prev=torch.where(active[:, None], h_last, st["h_prev"]),
                           emitted=st["emitted"] + n)
                st = new
                rec.append(_chunk_record(window, n, st["done"]))
        return st, torch.stack(rec, dim=1)

    # ---- host scheduler ----------------------------------------------------

    def generate(self, requests: list[dict]) -> list[dict]:
        """``requests``: dicts with ``input_ids``, ``token_type_ids``,
        ``position_ids`` (1-D, unpadded), ``image`` (C, D, H, W) and an
        optional ``grounding_image``, as numpy arrays or tensors. Returns a
        dict a request, in order: ``text``, ``tokens``, ``targets``, and where
        a grounding image was given ``masks`` (N, D, H, W) logits on the run's
        device and ``target_valid`` (N,)."""
        with torch.inference_mode(), numerics(self.numerics.gelu_mode,
                                              self.numerics.dense_fast_softmax):
            return self._generate(requests)

    def _generate(self, requests):
        tok, dev = self.tok, self.dev
        queue = sorted(range(len(requests)), key=lambda i: -len(requests[i]["input_ids"]))
        results: list[dict | None] = [None] * len(requests)

        b, smax, c = self.n_slots, self.smax, self.cfg.vlm.hidden_size
        cdt = self.params["cogvlm"]["llm"]["embed_tokens"].dtype
        state = _pool_state(b, self.cfg.vlm, smax, cdt, dev)
        # the ring buffer's slack past max_new: greedy steps past a slot's
        # last token write one slot there, inactive speculative rows park
        # full k-token windows there
        depth = self.max_new + self.spec + 1
        state["hbuf"] = torch.zeros((b, depth, c), dtype=cdt, device=dev)
        if self.spec:
            state.update(h_prev=torch.zeros((b, c), dtype=cdt, device=dev),
                         hist=torch.zeros((b, smax), dtype=torch.int32, device=dev),
                         hist_len=torch.ones((b,), dtype=torch.long, device=dev),
                         emitted=torch.zeros((b,), dtype=torch.long, device=dev))
        else:
            state["cnt"] = torch.zeros((b,), dtype=torch.long, device=dev)
        slot_rid: list[int | None] = [None] * b
        slot_out: list[list[int]] = [[] for _ in range(b)]

        def refill():
            free = [i for i in range(b) if slot_rid[i] is None]
            if not free or not queue:
                return
            self.stats["refills"] += 1
            if any(r is not None for r in slot_rid):
                self.stats["refilled_mid_flight"] += 1
            take = [queue.pop(0) for _ in range(min(len(free), len(queue)))]
            f = _pow2(len(take))
            s = _bucket(max(len(requests[r]["input_ids"]) for r in take), self.seq_quant)
            ids, tt, pos = (np.zeros((f, s), np.int32) for _ in range(3))
            plen = np.ones((f,), np.int32)
            img_shape = tuple(requests[take[0]]["image"].shape)
            imgs = torch.zeros((f, *img_shape), dtype=torch.float32, device=dev)
            for row, r in enumerate(take):
                req = requests[r]
                n_ids = len(req["input_ids"])
                ids[row, :n_ids] = req["input_ids"]
                tt[row, :n_ids] = req["token_type_ids"]
                pos[row, :n_ids] = req["position_ids"]
                plen[row] = n_ids
                imgs[row] = torch.as_tensor(req["image"]).to(dev, torch.float32)
            to = lambda x: torch.as_tensor(x, device=dev)
            sub, _, last_hidden = prefill_decode_state(
                self.params["cogvlm"], self.cfg.vlm, to(ids), to(tt), to(pos), to(plen),
                smax=smax, eos_token_id=tok.eos_token_id, image=imgs.to(cdt),
                patch_size=self.patch, pool_size=self.pool, vis_span=(1, 1 + self.n_vis))
            n = len(take)
            hbuf = torch.zeros((n, depth, c), dtype=cdt, device=dev)
            hbuf[:, 0] = last_hidden[:n].to(cdt)
            sub["hbuf"] = hbuf
            if self.spec:
                hist = np.zeros((n, smax), np.int32)
                for row, r in enumerate(take):
                    hist[row, : len(requests[r]["input_ids"])] = requests[r]["input_ids"]
                hist = to(hist)
                lens = to(plen[:n]).long()
                hist[torch.arange(n, device=dev), lens] = sub["tok"][:n]
                sub.update(h_prev=last_hidden[:n].to(cdt), hist=hist, hist_len=lens + 1,
                           emitted=torch.zeros((n,), dtype=torch.long, device=dev))
            else:
                sub["cnt"] = torch.zeros((n,), dtype=torch.long, device=dev)
            slots = free[:n]
            _scatter(state, sub, to(slots))
            for row, r in enumerate(take):
                slot_rid[slots[row]] = r
                slot_out[slots[row]] = []

        pending_ground: list[tuple[int, int]] = []  # (rid, slot) awaiting SAM

        def flush_ground():
            if not pending_ground:
                return
            group = list(pending_ground)
            pending_ground.clear()
            fpad = _pow2(len(group))
            slots = np.zeros((fpad,), np.int64)
            g_imgs = None
            for row, (rid, slot) in enumerate(group):
                slots[row] = slot
                gi = requests[rid].get("grounding_image")
                if gi is not None:
                    gi = torch.as_tensor(gi)
                    if g_imgs is None:
                        # the caller's dtype (uint8 on disk is 4x fewer bytes
                        # to move); the SAM pass casts to fp32
                        g_imgs = torch.zeros((fpad, *gi.shape), dtype=gi.dtype, device=dev)
                    if gi.dtype != g_imgs.dtype:
                        raise ValueError("mixed grounding_image dtypes in one serving job")
                    g_imgs[row] = gi.to(dev)
            if g_imgs is None:
                return
            tokens = np.zeros((fpad, self.max_new), np.int64)
            for row, (rid, _) in enumerate(group):
                out = results[rid]["tokens"]
                tokens[row, : len(out)] = out
            positions, valid = _eop_positions(tokens, tok.eop_token_id, self.max_targets)
            to = lambda x: torch.as_tensor(x, device=dev)
            with record_function("sam"):
                (masks,) = _ground(self.params, self.cfg, state["hbuf"][to(slots)],
                                   to(positions), g_imgs, self.patch, instance=False,
                                   sam_bf16=False)
            for row, (rid, _) in enumerate(group):
                results[rid]["masks"] = masks[row]
                results[rid]["target_valid"] = valid[row]

        def finish(rid, i):
            out = np.asarray(slot_out[i][: self.max_new], np.int64)
            results[rid] = {"tokens": out, "text": tok.decode([int(x) for x in out]),
                            "targets": tok.parse_targets(out[None])[0]}
            pending_ground.append((rid, i))
            slot_rid[i] = None

        while queue or any(r is not None for r in slot_rid):
            refill()
            self.stats["chunks"] += 1
            if self.spec:
                state, rec = self._decode_spec_chunk(state)
                rec = rec.cpu().numpy()  # the chunk's one copy to the host
                k = self.spec + 1
                win, ns, dones = rec[..., :k], rec[..., k], rec[..., k + 1]
                self.stats["spec_steps"] += int((ns > 0).sum())
                self.stats["spec_committed"] += int(ns.sum())
                for i in range(b):
                    rid = slot_rid[i]
                    if rid is None:
                        continue
                    for j in range(self.chunk):
                        slot_out[i].extend(int(t) for t in win[i, j, : ns[i, j]])
                        if dones[i, j] or len(slot_out[i]) >= self.max_new:
                            finish(rid, i)
                            break
            else:
                state, toks = self._decode_chunk(state)
                toks = toks.cpu().numpy()
                for i in range(b):
                    rid = slot_rid[i]
                    if rid is None:
                        continue
                    for t in toks[i]:
                        t = int(t)
                        done = t == tok.eos_token_id
                        if not done:
                            slot_out[i].append(t)
                        if done or len(slot_out[i]) >= self.max_new:
                            finish(rid, i)
                            break
            # ground finished requests before their slots are refilled (the
            # ring buffer row is reused by the next occupant)
            flush_ground()
        return results
