"""Self-contained NLG metrics (no network, no model downloads).

The reference evaluator pulls BLEU/ROUGE/METEOR/BERTScore/exact-match from the
HF ``evaluate`` hub (``scripts/evaluate/utils.py:103-196``); this module
implements the same metrics natively:

  - BLEU-n: corpus/sentence modified n-gram precision with brevity penalty and
    13a-style tokenization (punctuation split), matching sacrebleu/HF ``bleu``;
  - ROUGE-1/2: unigram/bigram F1; ROUGE-L: LCS F1 (no Porter stemming — a
    documented divergence from the ``rouge_score`` default);
  - METEOR: exact-match alignment F_mean (recall-weighted, alpha=0.9) with the
    chunk fragmentation penalty (gamma=0.5, beta=3) — the nltk formula without
    WordNet stem/synonym stages;
  - exact match after lowercasing/stripping.

BERTScore requires a pretrained encoder; ``GenericMetrics`` accepts an
optional callable so environments with a local model can plug it in.
"""
from __future__ import annotations

import math
import re
from collections import Counter

_TOKEN = r"\w+|[^\w\s]"  # a pattern string: re caches its compiled form


def tokenize(text: str) -> list[str]:
    return re.findall(_TOKEN, text.lower())


def _ngrams(tokens: list[str], n: int) -> Counter:
    return Counter(tuple(tokens[i : i + n]) for i in range(len(tokens) - n + 1))


def bleu(prediction: str, reference: str, max_order: int = 4) -> float:
    pred, ref = tokenize(prediction), tokenize(reference)
    if not pred:
        return 0.0
    log_precisions = []
    for n in range(1, max_order + 1):
        pn = _ngrams(pred, n)
        rn = _ngrams(ref, n)
        overlap = sum(min(c, rn[g]) for g, c in pn.items())
        total = max(sum(pn.values()), 0)
        if total == 0 or overlap == 0:
            return 0.0
        log_precisions.append(math.log(overlap / total))
    bp = 1.0 if len(pred) > len(ref) else math.exp(1 - len(ref) / max(len(pred), 1))
    return bp * math.exp(sum(log_precisions) / max_order)


def rouge_n(prediction: str, reference: str, n: int = 1) -> float:
    pn = _ngrams(tokenize(prediction), n)
    rn = _ngrams(tokenize(reference), n)
    overlap = sum(min(c, rn[g]) for g, c in pn.items())
    p_total, r_total = sum(pn.values()), sum(rn.values())
    if overlap == 0 or not p_total or not r_total:
        return 0.0
    p, r = overlap / p_total, overlap / r_total
    return 2 * p * r / (p + r)


def _lcs_len(a: list[str], b: list[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0]
        for j, y in enumerate(b, 1):
            cur.append(prev[j - 1] + 1 if x == y else max(prev[j], cur[-1]))
        prev = cur
    return prev[-1]


def rouge_l(prediction: str, reference: str) -> float:
    a, b = tokenize(prediction), tokenize(reference)
    lcs = _lcs_len(a, b)
    if lcs == 0:
        return 0.0
    p, r = lcs / len(a), lcs / len(b)
    return 2 * p * r / (p + r)


def meteor(prediction: str, reference: str, alpha=0.9, beta=3.0, gamma=0.5) -> float:
    pred, ref = tokenize(prediction), tokenize(reference)
    if not pred or not ref:
        return 0.0
    # greedy exact alignment preserving order for chunk counting
    ref_used = [False] * len(ref)
    matches: list[tuple[int, int]] = []
    for i, tok in enumerate(pred):
        for j, rtok in enumerate(ref):
            if not ref_used[j] and tok == rtok:
                ref_used[j] = True
                matches.append((i, j))
                break
    m = len(matches)
    if m == 0:
        return 0.0
    p, r = m / len(pred), m / len(ref)
    f_mean = p * r / (alpha * p + (1 - alpha) * r)
    chunks = 1
    for (i1, j1), (i2, j2) in zip(matches, matches[1:]):
        if i2 != i1 + 1 or j2 != j1 + 1:
            chunks += 1
    penalty = gamma * (chunks / m) ** beta
    return f_mean * (1 - penalty)


def exact_match(prediction: str, reference: str) -> float:
    return float(prediction.strip().lower() == reference.strip().lower())


class GenericMetrics:
    """Per-pair metric dict, averaged by the caller (``utils.py:103-196``)."""

    def __init__(self, bertscore_fn=None):
        self.bertscore_fn = bertscore_fn

    def compute(self, prediction: str, reference: str) -> dict[str, float]:
        prediction, reference = prediction.lower(), reference.lower()
        out = {
            "bleu1": bleu(prediction, reference, 1),
            "bleu2": bleu(prediction, reference, 2),
            "bleu4": bleu(prediction, reference, 4),
            "rouge1": rouge_n(prediction, reference, 1),
            "rougeL": rouge_l(prediction, reference),
            "meteor": meteor(prediction, reference),
            "exact_match": exact_match(prediction, reference),
        }
        if self.bertscore_fn is not None:
            out["bertscore"] = float(self.bertscore_fn(prediction, reference))
        return out

    def compute_all(self, predictions: list[str], references: list[str]) -> dict[str, float]:
        rows = [self.compute(p, r) for p, r in zip(predictions, references)]
        keys = rows[0].keys() if rows else []
        return {k: sum(r[k] for r in rows) / len(rows) for k in keys}
