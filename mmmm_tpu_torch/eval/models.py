"""Model-backed report labelers/scorers (activate when checkpoints are local).

The reference's metric stack runs three finetuned language models over the
generated reports:

  - CheXbert (BERT-base + 14 per-condition heads) for CheXpert-14 labels and
    the embedding-cosine ``chexbert`` column (``scripts/evaluate/utils.py:
    311-326,450-505``);
  - a finetuned RadBERT classifier for the 18 CT-RATE conditions
    (``utils.py:566-607``);
  - BERTScore via HF ``evaluate`` (``utils.py:108,152-156``).

This module implements each natively in torch, on the card unless the caller
passes ``device="cpu"``, building the backbone from the checkpoint itself — the architecture config (hidden size, layers,
vocab) is inferred from the state-dict shapes, so no hub download is needed;
only the finetuned checkpoint file (and a local tokenizer dir) must be on
disk. Keyword labelers in ``cxr.py`` / ``ct.py`` remain the flagged fallback.
"""
from __future__ import annotations

from pathlib import Path

import numpy as np


def _bert_config_from_state(state, prefix):
    """Infer a transformers BertConfig/RobertaConfig kwargs dict from weights."""
    emb = state[f"{prefix}embeddings.word_embeddings.weight"]
    hidden = emb.shape[1]
    n_layers = 0
    while f"{prefix}encoder.layer.{n_layers}.attention.self.query.weight" in state:
        n_layers += 1
    inter = state[f"{prefix}encoder.layer.0.intermediate.dense.weight"].shape[0]
    pos = state[f"{prefix}embeddings.position_embeddings.weight"].shape[0]
    tv = state.get(f"{prefix}embeddings.token_type_embeddings.weight")
    return dict(
        vocab_size=emb.shape[0],
        hidden_size=hidden,
        num_hidden_layers=n_layers,
        num_attention_heads=max(1, hidden // 64),
        intermediate_size=inter,
        max_position_embeddings=pos,
        type_vocab_size=tv.shape[0] if tv is not None else 2,
    )


def _strip_prefix(state, prefix="module."):
    return {
        (k[len(prefix):] if k.startswith(prefix) else k): v for k, v in state.items()
    }


class ChexbertLabeler:
    """CheXbert: BERT encoder + 14 linear heads over the CLS hidden state.

    Mirrors the reference loader (``utils.py:311-326``): checkpoint keys are
    ``module.bert.* / module.linear_heads.*``; label = argmax per head, then
    {1 (positive), 3 (uncertain)} -> 1 (``utils.py:497-502``). ``embed``
    returns the CLS hidden used for the ``chexbert`` cosine column.
    """

    def __init__(self, checkpoint_path: str | Path, tokenizer=None, device: str = "cuda"):
        import torch

        ckpt = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
        from transformers import BertConfig, BertModel

        state = ckpt.get("model_state_dict", ckpt)
        state = _strip_prefix(state)
        bert_state = {
            k.removeprefix("bert."): v for k, v in state.items() if k.startswith("bert.")
        }
        cfg = BertConfig(**_bert_config_from_state(bert_state, ""))
        self.bert = BertModel(cfg)
        self.bert.load_state_dict(bert_state, strict=False)
        self.heads = []
        i = 0
        while f"linear_heads.{i}.weight" in state:
            w, b = state[f"linear_heads.{i}.weight"], state[f"linear_heads.{i}.bias"]
            head = torch.nn.Linear(w.shape[1], w.shape[0])
            head.weight.data, head.bias.data = w, b
            self.heads.append(head.to(device))
            i += 1
        self.bert = self.bert.to(device).eval()
        self.device = device
        self.tokenizer = tokenizer
        self._torch = torch

    def _encode(self, text: str):
        torch = self._torch
        ids = self.tokenizer(
            text or "", truncation=True, max_length=512, return_tensors="pt"
        )["input_ids"].to(self.device)
        mask = torch.ones_like(ids)
        with torch.no_grad():
            hidden = self.bert(ids, attention_mask=mask).last_hidden_state[:, 0, :]
        return hidden

    def embed(self, report: str) -> np.ndarray:
        return self._encode(report).squeeze(0).cpu().numpy()

    def similarity(self, prediction: str, reference: str) -> float:
        a, b = self.embed(prediction), self.embed(reference)
        denom = np.linalg.norm(a) * np.linalg.norm(b)
        return float(a @ b / denom) if denom else 0.0

    def label(self, report: str) -> np.ndarray:
        torch = self._torch
        hidden = self._encode(report)
        labels = []
        with torch.no_grad():
            for head in self.heads:
                cls = int(torch.argmax(head(hidden), dim=1).item())
                labels.append(1 if cls in (1, 3) else 0)
        return np.asarray(labels, np.int64)

    __call__ = label


class RadBertClassifier:
    """Finetuned RadBERT multi-label classifier for the 18 CT conditions.

    Mirrors CT-CLIP's ``RadBertClassifier`` as loaded by the reference
    (``utils.py:566-584``): RoBERTa backbone + one linear head over CLS;
    sigmoid > 0.5 per condition.
    """

    def __init__(self, checkpoint_path: str | Path, tokenizer=None, device: str = "cuda"):
        import torch
        from transformers import RobertaConfig, RobertaModel

        state = torch.load(checkpoint_path, map_location="cpu", weights_only=False)
        state = state.get("model_state_dict", state)
        state = _strip_prefix(state)
        backbone = {
            k.removeprefix("model."): v for k, v in state.items() if k.startswith("model.")
        }
        cfg = RobertaConfig(**_bert_config_from_state(backbone, ""))
        self.model = RobertaModel(cfg)
        self.model.load_state_dict(backbone, strict=False)
        fc_key = "fc" if "fc.weight" in state else "classifier"
        w, b = state[f"{fc_key}.weight"], state[f"{fc_key}.bias"]
        self.fc = torch.nn.Linear(w.shape[1], w.shape[0])
        self.fc.weight.data, self.fc.bias.data = w, b
        self.model = self.model.to(device).eval()
        self.fc = self.fc.to(device)
        self.tokenizer = tokenizer
        self.device = device
        self._torch = torch

    def __call__(self, report: str) -> np.ndarray:
        torch = self._torch
        ids = self.tokenizer(
            report or "", truncation=True, max_length=512, return_tensors="pt"
        )["input_ids"].to(self.device)
        with torch.no_grad():
            hidden = self.model(ids).last_hidden_state[:, 0, :]
            logits = self.fc(hidden).squeeze(0)
            return (torch.sigmoid(logits) > 0.5).long().cpu().numpy()


class BERTScorer:
    """Native BERTScore over any local encoder (greedy max-cosine F1).

    The reference pulls ``evaluate.load('bertscore')`` (``utils.py:108``),
    which defaults to roberta-large layer 17 — here the encoder is whatever
    local model the caller provides (documented divergence); no baseline
    rescaling. Special tokens are excluded from matching, following the
    bert-score reference implementation.
    """

    def __init__(self, model=None, tokenizer=None, model_dir: str | Path | None = None,
                 device: str = "cuda"):
        import torch
        from transformers import AutoModel, AutoTokenizer

        if model is None:
            if model_dir is None:
                raise ValueError("BERTScorer needs a model or a local model_dir")
            model = AutoModel.from_pretrained(str(model_dir), local_files_only=True)
            tokenizer = AutoTokenizer.from_pretrained(str(model_dir), local_files_only=True)
        self.model = model.to(device).eval()
        self.tokenizer = tokenizer
        self.device = device
        self._torch = torch

    def _embed(self, text: str):
        torch = self._torch
        enc = self.tokenizer(
            text or "", truncation=True, max_length=512, return_tensors="pt"
        ).to(self.device)
        with torch.no_grad():
            hidden = self.model(**enc).last_hidden_state.squeeze(0)
        ids = enc["input_ids"].squeeze(0).tolist()
        special = set(self.tokenizer.all_special_ids)
        keep = [i for i, t in enumerate(ids) if t not in special]
        if not keep:
            keep = list(range(len(ids)))
        hidden = hidden[keep]
        return hidden / hidden.norm(dim=-1, keepdim=True).clamp(min=1e-12)

    def __call__(self, prediction: str, reference: str) -> float:
        p, r = self._embed(prediction), self._embed(reference)
        sim = p @ r.T  # (Tp, Tr)
        precision = float(sim.max(dim=1).values.mean())
        recall = float(sim.max(dim=0).values.mean())
        if precision + recall == 0:
            return 0.0
        return 2 * precision * recall / (precision + recall)
