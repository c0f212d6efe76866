"""Batched text-only generation, the port of ``mmmm_tpu/models/llm_batch.py``
(``make_text_generator``): the offline-LLM-job harness that runs a
CogVLM-family LM without an image through the same prefill and decode as
serving, over right-padded prompt buckets. The returned callable is the
``generate_fn`` of the reference's judge and tagging hooks.
"""
from __future__ import annotations

import numpy as np
import torch

from ..data.tokenizer import MMMMTokenizer
from .cogvlm import CogVLMConfig
from .cogvlm.decoder import LANGUAGE_TOKEN_TYPE
from .generate import greedy_generate
from .serving import TextServer, _on


def make_text_generator(params: dict, cfg: CogVLMConfig, tokenizer: MMMMTokenizer, *,
                        max_new_tokens: int = 256, batch_size: int = 16, seq_quant: int = 128,
                        continuous: bool = False, max_prompt_len: int = 1024,
                        speculate: int = 0, device: str | torch.device = "cuda"):
    """Returns ``generate(prompts: list[str]) -> list[str]``; ``params`` is
    the CogVLM tree on ``device``.

    ``continuous=True`` serves through the slot-pool scheduler
    (``serving.TextServer``, ``batch_size`` slots): finished sequences are
    replaced mid-flight, the job's shared instruction template is prefilled
    once, and ``speculate=k`` adds k-token n-gram lookahead a step. Outputs
    are identical to the static path (greedy, slot-independent), which
    generates ``batch_size`` prompts at a time, shortest first."""
    if continuous:
        server = TextServer(params, cfg, tokenizer, n_slots=batch_size,
                            max_new_tokens=max_new_tokens, seq_quant=seq_quant,
                            max_prompt_len=max_prompt_len, speculate=speculate, device=device)
        return server.generate
    dev = _on(params["llm"]["embed_tokens"], device)

    def generate(prompts):
        outputs: list[str] = [""] * len(prompts)
        order = sorted(range(len(prompts)), key=lambda i: len(prompts[i]))
        for start in range(0, len(order), batch_size):
            idxs = order[start : start + batch_size]
            encoded = [[tokenizer.bos_token_id] + tokenizer.encode(prompts[i]) for i in idxs]
            bucket = -(-max(len(e) for e in encoded) // seq_quant) * seq_quant
            b = len(encoded)
            ids = np.zeros((b, bucket), np.int32)
            pos = np.zeros((b, bucket), np.int32)
            lens = np.zeros(b, np.int32)
            for row, e in enumerate(encoded):
                ids[row, : len(e)] = e
                pos[row, : len(e)] = np.arange(len(e))
                lens[row] = len(e)
            to = lambda x: torch.as_tensor(x, device=dev)
            with torch.inference_mode():
                res = greedy_generate(
                    params, cfg, to(ids), to(np.full((b, bucket), LANGUAGE_TOKEN_TYPE, np.int32)),
                    to(pos), to(lens), max_new_tokens=max_new_tokens,
                    eos_token_id=tokenizer.eos_token_id, bop_token_id=tokenizer.bop_token_id,
                    eop_token_id=tokenizer.eop_token_id)
            tokens = res.tokens.cpu().numpy()
            for row, i in enumerate(idxs):
                outputs[i] = tokenizer.decode(
                    [int(t) for t in tokens[row] if int(t) != tokenizer.eos_token_id])
        return outputs

    return generate
