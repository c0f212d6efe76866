"""Conversation template generators for localized (seg/det) datasets.

Same conversational *structure* as the reference (``local/template.py``):
presence questions answered as a ``Results:`` list of "name: yes/no" entries,
anomaly-listing questions, modality questions — with grounded names wrapped in
``<p> ... </p>`` (positives) / ``<np> ... </np>`` (negatives) via
``tokenizer.wrap_name``. Prompt wordings are this framework's own pools; the
machine-readable answer format (which the model is trained to emit and the
grounding parser consumes) matches the reference exactly.

The port's own copy of ``mmmm_tpu/data/templates.py``.
"""
from __future__ import annotations

import numpy as np

from .defs import ConvTurn
from .target_tax import TargetClass
from .tokenizer import MMMMTokenizer

MODALITY_PROMPTS = [
    "What is the modality of this image?",
    "Which imaging modality produced this image?",
    "Identify the imaging modality used here.",
    "What kind of scan is this image from?",
]
MODALITY_RESPONSES = [
    "The modality of this image is {}.",
]

GENERAL_PROMPTS_SINGULAR = [
    "Is {} visible in this medical image?",
    "Does this medical image contain {}?",
    "Can {} be identified in this scan?",
    "Is there a depiction of {} in this image?",
    "Does the scan show {}?",
    "Is {} present in this imaging study?",
]
GENERAL_PROMPTS_PLURAL = [
    "Are {} visible in this medical image?",
    "Does this medical image contain {}?",
    "Can {} be identified in this scan?",
    "Are there depictions of {} in this image?",
    "Does the scan show {}?",
    "Are {} present in this imaging study?",
]
GENERAL_LIST_DESC = 'List each request followed by "yes" or "no" to indicate its presence or absence.'

ANOMALY_PROMPTS = [
    "What abnormalities can be seen in this medical image?",
    "Are there any pathological findings in this scan?",
    "What anomalies are present in this imaging study?",
    "Can you identify any abnormal findings in this image?",
    "Does this scan show any signs of disease?",
]
ANOMALY_LIST_DESC = "List each anomaly separated by commas."
NO_ANOMALY_RESPONSES = [
    "No anomaly is found.",
    "There are no anomalies detected.",
    "The image shows no signs of abnormalities.",
    "No abnormalities are present.",
    "The scan reveals no anomalies.",
]


def toss(R: np.random.RandomState, prob: float) -> bool:
    return R.uniform() < prob


def sample_name(class_name: str, R, target_tax: dict[str, TargetClass]) -> str:
    target = target_tax.get(class_name)
    return class_name if target is None else R.choice(target.synonyms)


def _join_natural(names: list[str]) -> str:
    if len(names) == 1:
        return names[0]
    if len(names) == 2:
        return f"{names[0]} and {names[1]}"
    return ", ".join(names[:-1]) + f", and {names[-1]}"


def gen_modality_conv(modality: str, R) -> list[ConvTurn]:
    return [ConvTurn(R.choice(MODALITY_PROMPTS), R.choice(MODALITY_RESPONSES).format(modality))]


def gen_general_conv(
    pos_classes: list[str],
    neg_classes: list[str],
    grounding: bool,
    neg_grounding: bool,
    tokenizer: MMMMTokenizer,
    target_tax: dict[str, TargetClass],
    R,
) -> tuple[list[ConvTurn], list[str]]:
    """Presence Q/A over a shuffled mix of present/absent classes.

    Returns (conversation, grounded class names in answer order) — the
    grounded order defines the target axis the SAM labels must follow.
    """
    if not pos_classes and not neg_classes:
        return [], []
    pos_classes = list(pos_classes)
    R.shuffle(pos_classes)
    neg_classes = list(neg_classes)
    R.shuffle(neg_classes)
    total = len(pos_classes) + len(neg_classes)
    pos_mask = np.zeros(total, bool)
    pos_mask[R.choice(total, len(pos_classes), replace=False)] = True
    pos_it, neg_it = iter(pos_classes), iter(neg_classes)
    classes = [next(pos_it) if m else next(neg_it) for m in pos_mask]
    names = [sample_name(c, R, target_tax) for c in classes]

    pool = GENERAL_PROMPTS_SINGULAR if len(classes) == 1 else GENERAL_PROMPTS_PLURAL
    prompt = f"{R.choice(pool).format(_join_natural(names))} {GENERAL_LIST_DESC}"

    response = "Results:"
    grounded: list[str] = []
    for i, name in enumerate(names):
        pos = bool(pos_mask[i])
        wrap = grounding if pos else neg_grounding
        if wrap:
            response += tokenizer.wrap_name(name, pos=pos)
            grounded.append(classes[i])
        else:
            response += f" {name}"
        response += ": " + ("yes" if pos else "no")
        response += "." if i + 1 == len(names) else ","
    return [ConvTurn(prompt, response)], grounded


def gen_anomaly_detection_conv(
    anomaly_classes: list[str],
    grounding: bool,
    tokenizer: MMMMTokenizer,
    target_tax: dict[str, TargetClass],
    R,
) -> tuple[list[ConvTurn], list[str]]:
    """Open anomaly listing: every present anomaly is named (and grounded)."""
    prompt = f"{R.choice(ANOMALY_PROMPTS)} {ANOMALY_LIST_DESC}"
    if not anomaly_classes:
        return [ConvTurn(prompt, R.choice(NO_ANOMALY_RESPONSES))], []
    names = [sample_name(c, R, target_tax) for c in anomaly_classes]
    order = R.permutation(len(names))
    names = [names[i] for i in order]
    classes = [anomaly_classes[i] for i in order]
    if grounding:
        results = ",".join(tokenizer.wrap_name(n, pos=True) for n in names)
    else:
        results = ", ".join(names)
    grounded = list(classes) if grounding else []
    return [ConvTurn(prompt, "Results: " + results + ".")], grounded


def gen_anomaly_conv(
    pos_classes: list[str],
    neg_classes: list[str],
    grounding: bool,
    neg_grounding: bool,
    tokenizer: MMMMTokenizer,
    target_tax: dict[str, TargetClass],
    dataset: str,
    R,
) -> tuple[list[ConvTurn], list[str]]:
    """Anomaly conversation; BraTS-style gliomas get the open-listing form
    (``template.py:gen_brats_conv``) with the remaining subtypes as presence
    questions."""
    if dataset.startswith("BraTS") and "glioma" in pos_classes and toss(R, 0.9):
        rest = [c for c in pos_classes if c != "glioma"]
        conv1, g1 = gen_anomaly_detection_conv(["glioma"], grounding, tokenizer, target_tax, R)
        conv2, g2 = gen_general_conv(
            rest, neg_classes, grounding, neg_grounding, tokenizer, target_tax, R
        )
        return conv1 + conv2, g1 + g2
    return gen_general_conv(
        pos_classes, neg_classes, grounding, neg_grounding, tokenizer, target_tax, R
    )
