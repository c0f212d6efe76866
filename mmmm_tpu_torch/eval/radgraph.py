"""RadGraph report annotation: entities + relations for RadGraph-F1.

The reference scores reports with the RadGraph model (DyGIE++ entity/relation
extractor) through the ``radgraph`` wrapper
(the reference's ``scripts/evaluate/utils.py:417-430``); the reward math is
already native here (``eval.composite.radgraph_reward``). This module adds
the missing ANNOTATOR with the same resolution pattern as
``eval.models.ChexbertLabeler``:

  1. the official ``radgraph`` package, if importable (wraps the released
     model checkpoint — the exact reference behavior);
  2. precomputed annotation files (JSON list aligned with the report list —
     e.g. produced offline on a GPU box);
  3. ``HeuristicRadGraphAnnotator`` (flagged in ``.source``): taxonomy-synonym
     span matching with negation-aware OBS-DP/OBS-DA labels and
     nearest-anatomy ``located_at`` relations. Deterministic and
     dependency-free, so the RadGraph-F1 column is always computable; results
     carry the provenance flag so they are never mistaken for model scores.

Annotation format (shared contract with ``radgraph_reward``):
``{"entities": {idx: {"tokens", "label", "start_ix", "end_ix", "relations"}}}``.
"""
from __future__ import annotations

import json
import re
from pathlib import Path

from .composite import radgraph_reward

_NEGATORS = ("no", "without", "free of", "absent", "negative for", "clear of",
             "resolved", "not")


class HeuristicRadGraphAnnotator:
    source = "heuristic"

    def __init__(self, target_tax: dict | None = None, max_relation_dist: int = 8):
        if target_tax is None:
            from ..data.target_tax import get_target_tax

            target_tax = get_target_tax()
        from ..data.target_tax import ANATOMY

        entries, seen = [], set()
        for cls in target_tax.values():
            if id(cls) in seen:
                continue
            seen.add(id(cls))
            kind = "ANAT" if cls.category == ANATOMY else "OBS"
            for syn in cls.synonyms:
                entries.append((syn.lower(), kind))
        entries.sort(key=lambda e: -len(e[0]))
        self.entries = entries
        self.max_relation_dist = max_relation_dist

    def _annotate_one(self, report: str) -> dict:
        tokens = report.split()
        # char offset of each token for span mapping
        offsets, pos = [], 0
        for t in tokens:
            pos = report.index(t, pos)
            offsets.append((pos, pos + len(t)))
            pos += len(t)
        low = report.lower()
        taken: list[tuple[int, int]] = []
        found = []  # (start_tok, end_tok, text, kind)
        for syn, kind in self.entries:
            for m in re.finditer(rf"\b{re.escape(syn)}\b", low):
                s, e = m.span()
                if any(not (e <= ts or s >= te) for ts, te in taken):
                    continue
                tok_ids = [i for i, (a, b) in enumerate(offsets) if a < e and b > s]
                if not tok_ids:
                    continue
                taken.append((s, e))
                found.append((tok_ids[0], tok_ids[-1], report[s:e], kind))
        found.sort()
        entities: dict[str, dict] = {}
        for i, (s_ix, e_ix, text, kind) in enumerate(found):
            if kind == "OBS":
                window = " ".join(tokens[max(0, s_ix - 4) : s_ix]).lower()
                negated = any(n in window for n in _NEGATORS)
                label = "OBS-DA" if negated else "OBS-DP"
            else:
                label = "ANAT-DP"
            entities[str(i + 1)] = {
                "tokens": text, "label": label,
                "start_ix": s_ix, "end_ix": e_ix, "relations": [],
            }
        # located_at: each OBS relates to the nearest ANAT within the window
        for k, ent in entities.items():
            if not ent["label"].startswith("OBS"):
                continue
            best, best_d = None, self.max_relation_dist + 1
            for k2, other in entities.items():
                if k2 == k or not other["label"].startswith("ANAT"):
                    continue
                d = abs(other["start_ix"] - ent["start_ix"])
                if d < best_d:
                    best, best_d = k2, d
            if best is not None:
                ent["relations"].append(["located_at", best])
        return {"entities": entities}

    def annotate(self, reports: list[str]) -> list[dict]:
        return [self._annotate_one(r) for r in reports]


class PrecomputedRadGraphAnnotations:
    """Annotations produced offline by the real model (JSON list aligned with
    the report order, each item the per-report annotation dict)."""

    source = "precomputed"

    def __init__(self, path: str | Path):
        self.items = json.loads(Path(path).read_text())

    def annotate(self, reports: list[str]) -> list[dict]:
        assert len(reports) == len(self.items), (len(reports), len(self.items))
        return list(self.items)


def build_annotator(
    precomputed: str | Path | None = None,
    model_name: str = "radgraph",
):
    """Best available annotator: radgraph package > precomputed > heuristic."""
    try:
        from radgraph import RadGraph as _RadGraph  # optional dependency

        class _Official:
            source = "radgraph-model"

            def __init__(self):
                self.model = _RadGraph(model_type=model_name)

            def annotate(self, reports):
                out = self.model(reports)
                return [out[str(i)] for i in range(len(reports))]

        return _Official()
    except ImportError:
        pass
    if precomputed is not None and Path(precomputed).exists():
        return PrecomputedRadGraphAnnotations(precomputed)
    return HeuristicRadGraphAnnotator()


def radgraph_f1(
    predictions: list[str],
    references: list[str],
    annotator=None,
    hyp_annotations: list[dict] | None = None,
    ref_annotations: list[dict] | None = None,
) -> dict:
    """Per-pair RadGraph partial rewards + mean, with provenance flag.

    Pass ``hyp_annotations``/``ref_annotations`` to score model annotations
    produced offline (two ``PrecomputedRadGraphAnnotations`` files)."""
    if hyp_annotations is None or ref_annotations is None:
        if annotator is None:
            annotator = build_annotator()
        hyp_annotations = annotator.annotate(list(predictions))
        ref_annotations = annotator.annotate(list(references))
        source = annotator.source
    else:
        source = "precomputed"
    rewards = [radgraph_reward(h, r) for h, r in zip(hyp_annotations, ref_annotations)]
    return {
        "radgraph": rewards,
        "radgraph_mean": sum(rewards) / len(rewards) if rewards else 0.0,
        "annotator": source,
    }
