"""CT report metrics: 18-condition F1 over CT-RATE labels.

Equivalent of the reference's ``CTMetrics`` (``scripts/evaluate/utils.py:
566-648``), which runs a finetuned RadBERT classifier over generated reports
and scores F1 against CT-RATE's released condition labels. Here the metric
math + a keyword fallback labeler are offline; a real classifier plugs in via
the ``labeler`` hook (same pattern as ``cxr.py``).
"""
from __future__ import annotations

import re

import numpy as np

CT_CONDITIONS = [
    "Medical material", "Arterial wall calcification", "Cardiomegaly",
    "Pericardial effusion", "Coronary artery wall calcification", "Hiatal hernia",
    "Lymphadenopathy", "Emphysema", "Atelectasis", "Lung nodule", "Lung opacity",
    "Pulmonary fibrotic sequela", "Pleural effusion", "Mosaic attenuation pattern",
    "Peribronchial thickening", "Consolidation", "Bronchiectasis",
    "Interlobular septal thickening",
]

_KEYWORDS = {
    "Medical material": ["catheter", "tube", "stent", "device", "surgical material", "pacemaker"],
    "Arterial wall calcification": ["arterial wall calcification", "aortic calcification", "arterial calcification"],
    "Cardiomegaly": ["cardiomegaly", "enlarged heart", "cardiac enlargement"],
    "Pericardial effusion": ["pericardial effusion", "pericardial fluid"],
    "Coronary artery wall calcification": ["coronary artery calcification", "coronary calcification"],
    "Hiatal hernia": ["hiatal hernia", "hiatus hernia"],
    "Lymphadenopathy": ["lymphadenopathy", "enlarged lymph node"],
    "Emphysema": ["emphysema", "emphysematous"],
    "Atelectasis": ["atelectasis", "atelectatic"],
    "Lung nodule": ["nodule", "nodular"],
    "Lung opacity": ["opacity", "opacities", "ground-glass", "ground glass"],
    "Pulmonary fibrotic sequela": ["fibrosis", "fibrotic", "sequela"],
    "Pleural effusion": ["pleural effusion", "pleural fluid"],
    "Mosaic attenuation pattern": ["mosaic attenuation"],
    "Peribronchial thickening": ["peribronchial thickening", "peribronchial wall thickening"],
    "Consolidation": ["consolidation", "consolidative"],
    "Bronchiectasis": ["bronchiectasis", "bronchiectatic"],
    "Interlobular septal thickening": ["septal thickening", "interlobular septal"],
}
_NEG = ["no ", "not ", "without ", "free of ", "absence of ", "negative for ", "ruled out"]


class KeywordCTLabeler:
    source = "keyword-heuristic"  # provenance, surfaced in every summary

    def __call__(self, report: str) -> np.ndarray:
        text = report.lower()
        sents = re.split(r"[.;\n]", text)
        labels = np.zeros(len(CT_CONDITIONS), np.int64)
        for i, cond in enumerate(CT_CONDITIONS):
            for sent in sents:
                if any(k in sent for k in _KEYWORDS[cond]) and not any(n in sent for n in _NEG):
                    labels[i] = 1
                    break
        return labels


class CTMetrics:
    def __init__(self, labeler=None):
        self.labeler = labeler or KeywordCTLabeler()

    def compute(
        self,
        predictions: list[str],
        reference_labels: np.ndarray | None = None,
        references: list[str] | None = None,
    ) -> dict[str, float]:
        """Score against released condition labels (preferred) or labeled
        reference reports."""
        y_pred = np.stack([self.labeler(p) for p in predictions])
        if reference_labels is not None:
            y_true = np.asarray(reference_labels)
        else:
            y_true = np.stack([self.labeler(r) for r in references])
        per = []
        for i in range(len(CT_CONDITIONS)):
            tp = int(((y_pred[:, i] == 1) & (y_true[:, i] == 1)).sum())
            fp = int(((y_pred[:, i] == 1) & (y_true[:, i] == 0)).sum())
            fn = int(((y_pred[:, i] == 0) & (y_true[:, i] == 1)).sum())
            denom = 2 * tp + fp + fn
            per.append(2 * tp / denom if denom else 0.0)
        tp = int(((y_pred == 1) & (y_true == 1)).sum())
        fp = int(((y_pred == 1) & (y_true == 0)).sum())
        fn = int(((y_pred == 0) & (y_true == 1)).sum())
        return {
            "ct_labeler": getattr(self.labeler, "source", "radbert-model"),
            "ct_macro_f1_18": float(np.mean(per)),
            "ct_micro_f1_18": 2 * tp / (2 * tp + fp + fn) if (2 * tp + fp + fn) else 0.0,
        }
