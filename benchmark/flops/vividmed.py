"""Operations and bytes of the VividMed grounded-report path, counted from
the shapes a cell fixes and from what each request was served.

Model FLOPs count every product the model's equations need once (the
ViT, the prefill with each token through one expert, every token of every
verify window of a row still decoding, the SAM head), two operations a
multiply-add, and leave out what a rematerialization or an implementation
repeats. Each attention op's work counts each input byte read once and
each output byte written once, whatever the kernel reads again, and the
operations its inputs need (a causal prefill half of the square, a decode
step the keys its rows really have).

The decode work depends on how many tokens each verify step committed,
which ``replay_verify_steps`` works out again from the request's prompt and
served tokens by the n-gram rule of the speculative decoder.
"""
from __future__ import annotations

import math


def _llm_layer_flops(vlm: dict) -> float:
    """One token through one expert of one decoder layer, projections only."""
    c, i = vlm["hidden_size"], vlm["intermediate_size"]
    return 2.0 * (3 * c * c + c * c + 3 * c * i)


def vit_flops(cfg: dict, image: list, patch: list, pool: list) -> float:
    """One volume through the ViT and the GLU projection."""
    vlm, v = cfg["vlm"], cfg["vlm"]["vision"]
    c, i = v["hidden_size"], v["intermediate_size"]
    grid = [image[1 + k] // patch[k] for k in range(3)]
    n_patch = math.prod(grid)
    t = n_patch + 1
    pooled = math.prod(g // p for g, p in zip(grid, pool))
    cl, il = vlm["hidden_size"], vlm["intermediate_size"]
    total = 2.0 * n_patch * image[0] * math.prod(patch) * c
    total += v["num_hidden_layers"] * (2.0 * t * (4 * c * c + 2 * c * i) + 4.0 * t * t * c)
    return total + 2.0 * pooled * (c * cl + 3 * cl * il)


def sam_flops(cfg: dict, image: list, patch: list, targets: int) -> float:
    """One grounding volume through the SAM encoder and ``targets`` text
    prompts through the mask decoder (its products over the image tokens;
    the few query tokens' products are left out)."""
    s = cfg["sam"]
    c = s["embed_dim"]
    grid = [image[1 + k] // patch[k] for k in range(3)]
    t = math.prod(grid)
    enc = 2.0 * t * image[0] * math.prod(patch) * c
    enc += s["encoder_num_layers"] * (2.0 * t * (4 * c * c + 2 * c * c * s["encoder_mlp_ratio"])
                                      + 4.0 * t * t * c)
    internal = c // s["attention_downsample_rate"]
    two_way = (s["decoder_depth"] * 2 + 1) * 2.0 * t * c * internal * 2
    up = 2.0 * t * c * (c // 4) * 8 + 2.0 * 8 * t * (c // 4) * (c // 8) * 8
    masks = 2.0 * 64 * t * (c // 8) * 2
    return enc + targets * (two_way + up + masks)


def prefill_flops(cfg: dict, prompt_lens: list) -> float:
    vlm = cfg["vlm"]
    c, n = vlm["hidden_size"], vlm["num_hidden_layers"]
    per = _llm_layer_flops(vlm)
    total = 0.0
    for length in prompt_lens:
        total += n * (length * per + 2.0 * length * length * c) + 2.0 * c * vlm["vocab_size"]
    return total


def decode_flops(cfg: dict, steps: list) -> float:
    """``steps``: per row, its list of (write index, tokens in the window)
    of every decode step it was active in."""
    vlm = cfg["vlm"]
    c, n = vlm["hidden_size"], vlm["num_hidden_layers"]
    per = _llm_layer_flops(vlm) * n + 2.0 * c * vlm["vocab_size"]
    total = 0.0
    for row in steps:
        for write, k in row:
            kv = sum(write + j + 1 for j in range(k))
            total += k * per + n * 4.0 * c * kv
    return total


def ngram_draft(hist: list, n_draft: int, ngram: int = 2) -> list:
    """The drafts after ``hist``: what followed the latest earlier match of
    its trailing ``ngram`` tokens, the newest token where nothing did."""
    hl = len(hist)
    ctx = [hist[max(hl - ngram + j, 0)] for j in range(ngram)]
    best = -1
    for p in range(hl - ngram - 1, -1, -1):
        if all(hist[p + j] == ctx[j] for j in range(ngram)):
            best = p
            break
    if best < 0:
        return [hist[-1]] * n_draft
    return [hist[best + ngram + j] if best + ngram + j < hl else hist[-1] for j in range(n_draft)]


def replay_verify_steps(prompt: list, served: list, max_new: int, draft: int) -> list:
    """(write index, window tokens) of each verify step of one row: the
    window holds the current token and ``draft`` drafts, and the step commits
    the drafts that equal the served continuation, plus one."""
    steps, e, n = [], 0, len(served)
    while e < min(n, max_new):
        hist = list(prompt) + list(served[:e + 1])
        drafts = ngram_draft(hist, draft)
        a = 0
        while a < draft and e + 1 + a < n and drafts[a] == served[e + 1 + a]:
            a += 1
        steps.append((len(prompt) + e, draft + 1))
        e += min(a + 1, max_new - e)
    return steps


def greedy_steps(prompt_len: int, served: int) -> list:
    return [(prompt_len + e, 1) for e in range(served)]


# ---- attention ops: (operations, bytes, rate) of each launch class ----

def vit_attn(cfg: dict, images: int, image: list, patch: list, **_) -> list:
    v = cfg["vlm"]["vision"]
    c = v["hidden_size"]
    t = math.prod(image[1 + k] // patch[k] for k in range(3)) + 1
    return [(images * v["num_hidden_layers"] * 4.0 * t * t * c,
             images * v["num_hidden_layers"] * 4.0 * t * c * 2, "bf16")]


def sam_encoder_attn(cfg: dict, images: int, g_image: list, patch: list, **_) -> list:
    s = cfg["sam"]
    c = s["embed_dim"]
    t = math.prod(g_image[1 + k] // patch[k] for k in range(3))
    return [(images * s["encoder_num_layers"] * 4.0 * t * t * c,
             images * s["encoder_num_layers"] * 4.0 * t * c * 4, "fp32")]


def prefill_attn(cfg: dict, prompt_lens: list, **_) -> list:
    vlm = cfg["vlm"]
    c, n = vlm["hidden_size"], vlm["num_hidden_layers"]
    return [(n * 2.0 * length * length * c, n * 4.0 * length * c * 2, "bf16")
            for length in prompt_lens]


def decode_window_attn(cfg: dict, steps: list, **_) -> list:
    vlm = cfg["vlm"]
    c, n = vlm["hidden_size"], vlm["num_hidden_layers"]
    out = []
    for row in steps:
        for write, k in row:
            if k < 2:
                continue
            kv = sum(write + j + 1 for j in range(k))
            # the cache up to the window's end read once; q in, the window's
            # K/V in and into the cache, the output out
            out.append((n * 4.0 * c * kv, n * 2.0 * c * (2 * (write + k) + 4 * k), "bf16"))
    return out


def decode_attn(cfg: dict, steps: list, **_) -> list:
    vlm = cfg["vlm"]
    c, n = vlm["hidden_size"], vlm["num_hidden_layers"]
    return [(n * 4.0 * c * (write + 1), n * 2.0 * c * (2 * (write + 1) + 4), "bf16")
            for row in steps for write, k in row if k == 1]
