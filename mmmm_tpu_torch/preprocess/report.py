"""Radiology report sectioning + cleaning (MIMIC-CXR style).

Equivalent of the reference's vendored MIT report sectioner + impression
cleaning (``scripts/data/vl/MIMIC-CXR/MIMIC-CXR.py:9-250``): split a raw
report into FINDINGS / IMPRESSION (and other) sections by heading, normalize
heading variants (the reference folds ~40 observed typos like "impresson"
with a hand-built table; here ``difflib`` fuzzy matching against the
canonical names subsumes the table), pick the last impression > findings >
last-paragraph > comparison section, cut dictation/communication notes out of
the impression, normalize whitespace, and drop comparison-to-prior phrasing
(the reference removes the latter with a Llama-3 pass; conservative rules
keep the pipeline fully offline, and the LLM cleaner hook can replace them).

The port's own copy of ``mmmm_tpu/preprocess/report.py``.
"""
from __future__ import annotations

import difflib
import re

_SECTION_HEADS = [
    "findings", "impression", "indication", "comparison", "technique",
    "examination", "history", "clinical information", "clinical indication",
    "recommendation", "conclusion", "wet read", "reason for exam",
    "reason for examination", "final report", "notification", "addendum",
]
_HEAD_RE = (r"(?im)^\s*(" + "|".join(h.replace(" ", r"\s+") for h in _SECTION_HEADS)
            + r")\s*:")
# generic radiology heading: an ALL-CAPS run (may include ()/,- and spaces)
# followed by a colon at a line start — catches headers outside the known list
# (ref ``section_text``'s ``\n ([A-Z ()/,-]+):``)
_CAPS_HEAD_RE = r"(?m)^\s*([A-Z][A-Z ()/,\-]{2,40})\s*:"
_PRIOR_RE = (
    r"(?i)[^.]*\b(compared? (to|with)|in comparison|prior (study|exam|radiograph)|"
    r"previous (study|exam|radiograph)|interval change)\b[^.]*\."
)

# canonical section vocabulary for fuzzy normalization; view-style headings
# ("PA AND LATERAL CHEST", "TWO VIEWS") describe the whole study = findings
_CANONICAL = [
    "findings", "impression", "indication", "comparison", "technique",
    "examination", "history", "recommendations", "notification", "addendum",
    "wet read", "conclusion", "preamble",
]
_ALIASES = {
    "conclusion": "impression",
    "findings and impression": "impression",
    "findings/impression": "impression",
    "clinical information": "history",
    "clinical history": "history",
    "patient history": "history",
    "pfi": "history",
    "reason for exam": "indication",
    "reason for examination": "indication",
    "clinical indication": "indication",
    "comparisons": "comparison",
    "comparison exam": "comparison",
    "comparison film": "comparison",
    "reference exam": "comparison",
    "exam": "examination",
    "type of examination": "examination",
    "recommendation": "recommendations",
}
_VIEW_WORDS = (
    r"\b(chest|portable|pa|ap|lateral|frontal|view|views|upright|ribs|bone window)\b"
)


def normalize_section_name(raw: str) -> str:
    """Canonicalize a heading: aliases, typo folding (fuzzy), view->findings."""
    name = re.sub(r"\s+", " ", raw.lower().strip(" :"))
    if name in _ALIASES:
        return _ALIASES[name]
    if name in _CANONICAL:
        return name
    for canon in ("impression", "findings", "history", "comparison", "addendum"):
        if canon in name:
            return canon
    close = difflib.get_close_matches(name, _CANONICAL, n=1, cutoff=0.8)
    if close:
        return close[0]
    if re.search(_VIEW_WORDS, name):
        return "findings"
    return name


def split_sections(report: str) -> dict[str, str]:
    """Heading -> body; text before the first heading lands in ``preamble``.

    Repeated headings keep the LAST occurrence (the reference's
    ``list_rindex`` selection). A final multi-paragraph section also exposes
    its tail as ``last_paragraph`` when no findings/impression was found,
    matching the reference's fallback for header-less narrative reports.
    """
    sections: dict[str, str] = {}
    by_pos = {m.start(): m for m in re.finditer(_CAPS_HEAD_RE, report)}
    by_pos.update({m.start(): m for m in re.finditer(_HEAD_RE, report)})
    matches = [by_pos[pos] for pos in sorted(by_pos)]
    if not matches:
        return {"preamble": normalize_whitespace(report)}
    if matches[0].start() > 0:
        pre = report[: matches[0].start()].strip()
        if pre:
            sections["preamble"] = normalize_whitespace(pre)
    for m, nxt in zip(matches, matches[1:] + [None]):
        head = normalize_section_name(m.group(1))
        end = nxt.start() if nxt else len(report)
        body = report[m.end() : end].strip()
        if body:
            sections[head] = normalize_whitespace(body)  # last occurrence wins
    if "findings" not in sections and "impression" not in sections and matches:
        tail_raw = report[matches[-1].end():]
        paras = [p for p in re.split(r"\n\s*\n", tail_raw) if p.strip()]
        if len(paras) > 1:
            sections["last_paragraph"] = normalize_whitespace(
                " ".join(paras[1:])
            )
    return sections


def normalize_whitespace(text: str) -> str:
    return re.sub(r"\s+", " ", text).strip()


def remove_prior_references(text: str) -> str:
    """Drop sentences that only compare to prior studies (LLM-cleaner fallback,
    ``scripts/data/vl/llama3_process.py`` analog)."""
    return normalize_whitespace(re.sub(_PRIOR_RE, "", text))


# dictation / communication boilerplate that the reference cuts from the
# impression (``MIMIC-CXR.py:388-409``): everything from the first sentence
# mentioning results communication onward is dropped
_COMM_WORDS = [
    "email", "phone", "dr", "contact", "discuss", "minutes", "review",
    "dictation", "observation", "communi",
]
_COMM_RE = r"(?i)\b(" + "|".join(_COMM_WORDS) + r")"


def remove_communication_notes(text: str) -> str:
    sentences = text.split(".")
    for i, sent in enumerate(sentences):
        if re.search(_COMM_RE, sent):
            return normalize_whitespace(".".join(sentences[:i]) + ("." if i else ""))
    return text


def extract_findings_impression(report: str, clean: bool = True) -> dict[str, str | None]:
    sections = split_sections(report)
    findings = sections.get("findings")
    impression = sections.get("impression")
    if findings is None and impression is None:
        # some reports are a single unlabeled narrative
        findings = sections.get("last_paragraph") or sections.get("comparison") \
            or sections.get("preamble")
    if clean:
        if findings:
            findings = remove_prior_references(findings)
        if impression:
            impression = remove_communication_notes(impression)
            impression = remove_prior_references(impression)
    return {"findings": findings or None, "impression": impression or None}


def build_processed_report(findings: str | None, impression: str | None) -> str | None:
    parts = []
    if findings:
        parts.append(f"Findings: {findings}")
    if impression:
        parts.append(f"Impression: {impression}")
    return " ".join(parts) if parts else None
