"""RadCliQ composite metrics + RadGraph reward math (checkpoint-optional).

The reference computes RadCliQ-v0/v1 by unpickling fitted ``CompositeMetric``
objects from the CXR-Report-Metric release and applying them to the per-study
``[radgraph, bertscore, chexbert, bleu2]`` columns
(``scripts/evaluate/utils.py:328-346,443-449``). The composite *math* is a
linear model over (optionally standardized) inputs with a bias column; this
module implements it natively so the composite runs from plain coefficient
arrays, and provides an unpickler that extracts those arrays from the official
pickles when they are on disk (shimming the ``CompositeMetric`` /
``StandardScaler`` classes, so neither the CXRMetric package nor CUDA is
needed).

Also here: the pure RadGraph partial-reward math
(``exact_entity_token_if_rel_exists_reward``, ``utils.py:369-415``), which
scores entity/relation annotation lists produced by any RadGraph-style
annotator (model hook — the annotations themselves need the RadGraph
checkpoint).
"""
from __future__ import annotations

import pickle
from dataclasses import dataclass
from pathlib import Path

import numpy as np

# Column order expected by the fitted composites (utils.py:446,449).
RADCLIQ_COLUMNS = ["radgraph", "bertscore", "chexbert", "bleu2"]


@dataclass
class CompositeMetric:
    """Linear composite: ``predict(X) = [scale(X), 1] @ coefs``.

    Mirrors CXR-Report-Metric's ``CompositeMetric``: v0 is applied to
    normalizer-transformed columns, v1 to raw columns; both append a bias
    column before the dot product. Lower is better.
    """

    coefs: np.ndarray  # (n_features + 1,)
    mean: np.ndarray | None = None  # standardizer params, None = identity
    scale: np.ndarray | None = None

    def predict(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        if self.mean is not None:
            x = (x - self.mean) / self.scale
        ones = np.ones((x.shape[0], 1))
        return np.concatenate([x, ones], axis=1) @ np.asarray(self.coefs).reshape(-1)


class _Shim:
    """Stand-in for any unpicklable class: keeps the attribute dict."""

    def __setstate__(self, state):
        self.__dict__.update(state if isinstance(state, dict) else {"state": state})


class _ShimUnpickler(pickle.Unpickler):
    """Unpickle fitted sklearn/CXRMetric objects as attribute bags.

    Only data is recovered (``coefs``, ``scaler``, ``mean_``, ``scale_``);
    no third-party code runs. numpy reconstructors resolve normally.
    """

    def find_class(self, module, name):
        if module.split(".")[0] in ("numpy", "pickle", "copyreg", "builtins", "collections"):
            return super().find_class(module, name)
        return _Shim


def _to_composite(obj) -> CompositeMetric:
    coefs = np.asarray(obj.coefs, np.float64).reshape(-1)
    scaler = getattr(obj, "scaler", None)
    if scaler is not None and getattr(scaler, "mean_", None) is not None:
        return CompositeMetric(coefs, np.asarray(scaler.mean_), np.asarray(scaler.scale_))
    return CompositeMetric(coefs)


def load_radcliq(
    normalizer_path: str | Path,
    v0_path: str | Path,
    v1_path: str | Path,
) -> tuple[CompositeMetric, CompositeMetric]:
    """Load the official pickles into native ``CompositeMetric`` objects.

    Returns (v0, v1). v0 gets the external normalizer folded into its own
    mean/scale (the reference applies ``normalizer.transform`` first,
    ``utils.py:444-447``); v1 is applied to raw columns.
    """
    with open(normalizer_path, "rb") as f:
        norm = _ShimUnpickler(f).load()
    with open(v0_path, "rb") as f:
        v0 = _to_composite(_ShimUnpickler(f).load())
    with open(v1_path, "rb") as f:
        v1 = _to_composite(_ShimUnpickler(f).load())
    n_mean = np.asarray(norm.mean_, np.float64)
    n_scale = np.asarray(norm.scale_, np.float64)
    if v0.mean is not None:
        # predict scales twice in the reference path: fold both into one affine
        v0 = CompositeMetric(v0.coefs, v0.mean * n_scale + n_mean, v0.scale * n_scale)
    else:
        v0 = CompositeMetric(v0.coefs, n_mean, n_scale)
    return v0, v1


def fallback_composite(x: np.ndarray) -> np.ndarray:
    """Checkpoint-free stand-in: ``1 - mean(columns)`` (lower = better).

    NOT comparable to published RadCliQ numbers — callers must flag it
    (the evaluate CLI reports it as ``radcliq_fallback``).
    """
    x = np.asarray(x, np.float64)
    return 1.0 - x.mean(axis=1)


def radcliq_scores(
    rows: dict[str, list[float]],
    checkpoint_dir: str | Path | None = None,
) -> dict[str, list[float]]:
    """Compute RadCliQ v0/v1 over per-study metric columns.

    ``rows`` must hold the four RADCLIQ_COLUMNS lists. Uses the official
    pickles under ``checkpoint_dir`` (normalizer.pkl, composite_metric_v0.pkl,
    composite_metric_v1.pkl) when present; otherwise the flagged fallback.
    """
    x = np.stack([np.asarray(rows[c], np.float64) for c in RADCLIQ_COLUMNS], axis=1)
    if checkpoint_dir is not None:
        d = Path(checkpoint_dir)
        paths = [d / "normalizer.pkl", d / "composite_metric_v0.pkl", d / "composite_metric_v1.pkl"]
        if all(p.exists() for p in paths):
            v0, v1 = load_radcliq(*paths)
            return {"radcliq-v0": list(v0.predict(x)), "radcliq-v1": list(v1.predict(x))}
    return {"radcliq_fallback": list(fallback_composite(x))}


def radgraph_reward(hyp_annotations: dict, ref_annotations: dict) -> float:
    """RadGraph partial reward: entity-token F1 with relation-existence tags.

    Pure math from the reference (``utils.py:369-415``): each entity becomes
    ``(tokens, label)`` — plus a ``True`` tag when it has any relation — and
    the two sets are scored with set-overlap F1.
    """
    candidates = []
    for ann in (hyp_annotations, ref_annotations):
        cand = set()
        for entity in ann["entities"].values():
            if entity["relations"]:
                cand.add((entity["tokens"], entity["label"], True))
            else:
                cand.add((entity["tokens"], entity["label"]))
        candidates.append(cand)
    hyp, ref = candidates
    precision = sum(1 for x in hyp if x in ref) / len(hyp) if hyp else 0.0
    recall = sum(1 for x in ref if x in hyp) / len(ref) if ref else 0.0
    if precision + recall == 0:
        return 0.0
    return 2 * precision * recall / (precision + recall)
