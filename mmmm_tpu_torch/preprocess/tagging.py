"""Phrase tagging for grounded-report construction (offline VG pipeline).

Equivalent of the reference's two-pass Llama-3-70B tagger
(``scripts/data/vg/tag.py``): mark anatomical/anomaly phrase spans in a
cleaned report and emit char-offset tags consumed by ``GRGTransform``. The
LLM tagger is an interface (``Tagger``); the default implementation is a
taxonomy-driven matcher (longest-synonym-first, word-boundary, negation-
filtered to positives only — pass 2 of the reference). Environments with a
local LLM can register their own ``Tagger``.

Offsets satisfy the reference's round-trip invariant:
``report[tag["start"]:tag["end"]] == phrase``.

The port's own copy of ``mmmm_tpu/preprocess/tagging.py``.
"""
from __future__ import annotations

import re

from ..data.target_tax import TargetClass

_NEG_PAT = (
    r"(?i)\b(no|without|negative for|free of|clear of|absence of|resolved|rather than"
    r"|ruled? out)\b"
)


class Tagger:
    def tag(self, report: str) -> list[dict]:
        """Returns [{"start", "end", "phrase", "target"}] sorted by start."""
        raise NotImplementedError


class TaxonomyTagger(Tagger):
    def __init__(self, target_tax: dict[str, TargetClass], positives_only: bool = True):
        self.positives_only = positives_only
        # longest synonym first so "left lung" beats "lung"
        entries = []
        seen: set[int] = set()  # the tax dict maps synonyms too; dedupe classes
        for cls in target_tax.values():
            if id(cls) in seen:
                continue
            seen.add(id(cls))
            for syn in cls.synonyms:
                entries.append((syn.lower(), cls.name))
        entries.sort(key=lambda e: -len(e[0]))
        self.entries = entries

    def tag(self, report: str) -> list[dict]:
        low = report.lower()
        taken: list[tuple[int, int]] = []
        tags = []
        for syn, target in self.entries:
            for m in re.finditer(rf"\b{re.escape(syn)}\b", low):
                s, e = m.span()
                if any(not (e <= ts or s >= te) for ts, te in taken):
                    continue  # overlaps an earlier (longer) match
                if self.positives_only and self._negated(low, s):
                    continue
                taken.append((s, e))
                tags.append({"start": s, "end": e, "phrase": report[s:e], "target": target})
        tags.sort(key=lambda t: t["start"])
        return tags

    @staticmethod
    def _negated(text: str, start: int) -> bool:
        sent_start = max(text.rfind(".", 0, start), text.rfind(";", 0, start), 0)
        return bool(re.search(_NEG_PAT, text[sent_start:start]))


def verify_tags(report: str, tags: list[dict]) -> None:
    """The reference's offset round-trip assertion (``tag.py``)."""
    for t in tags:
        got = report[t["start"] : t["end"]]
        if got != t["phrase"]:
            raise AssertionError(f"tag offset mismatch: {got!r} != {t['phrase']!r}")


# --------------------------------------------------------------------------
# two-pass LLM tagger (ref ``vg/tag.py:92-331``: tag pass + filter pass over
# the [<phrase>](<target>) markdown-link protocol)
# --------------------------------------------------------------------------

_LINK_PATTERN = r"\[([^][()]+?)\]\(([^()]+?)\)"

_TAG_INSTRUCTIONS = """You are a radiology annotation assistant. Rewrite the \
given report EXACTLY, additionally wrapping each phrase that names one of the \
listed targets as [<phrase>](<target>), where <target> is the matching \
standard name. Only tag findings that are actually present (skip anything \
negated, absent, or uncertain). Keep laterality modifiers inside the phrase \
when they localize the structure. Do not change any other text.
Targets: {targets}"""

_FILTER_INSTRUCTIONS = """You are a radiology annotation reviewer. The given \
report contains [<phrase>](<target>) annotations. Remove the brackets from \
any annotation that is wrong — negated or uncertain findings, targets too \
vague to localize, or phrases mapped to the wrong target — keeping only the \
plain phrase text. Output the report otherwise unchanged."""


def parse_linked_report(original: str, linked: str) -> list[dict] | None:
    """``[phrase](target)`` markup -> char-offset tags against ``original``.

    Mirrors the reference's extraction (``tag.py:326-331``): strip the markup,
    require the residue to round-trip to the original text (LLMs that edited
    the prose invalidate the whole study -> None), then convert each link to
    {"start", "end", "phrase", "target"} offsets in the original string.
    """
    residue = re.sub(_LINK_PATTERN, r"\1", linked)
    if residue != original:
        return None
    tags = []
    offset = 0  # chars of markup removed so far, mapping linked -> original
    for m in re.finditer(_LINK_PATTERN, linked):
        phrase, target = m.group(1), m.group(2).strip()
        start = m.start() - offset
        tags.append({
            "start": start,
            "end": start + len(phrase),
            "phrase": phrase,
            "target": target,
        })
        offset += len(m.group(0)) - len(phrase)
    return tags


class LLMTagger(Tagger):
    """Two-pass generative tagger over a caller-supplied text LLM.

    ``generate_fn(prompts: list[str]) -> list[str]`` is any batched text
    generator — e.g. ``models.llm_batch.make_text_generator`` (the vLLM-
    equivalent harness) over a locally imported checkpoint, mirroring the
    reference's Llama-3-70B vLLM job. Pass 1 adds the markdown links; pass 2
    reviews and strips bad ones; outputs that fail the round-trip check fall
    back to the taxonomy matcher when one is provided.
    """

    def __init__(self, generate_fn, target_names: list[str],
                 examples: list[tuple[str, str]] | None = None,
                 fallback: Tagger | None = None,
                 filter_pass: bool = True):
        self.generate_fn = generate_fn
        self.target_names = list(target_names)
        self.examples = examples or []
        self.fallback = fallback
        self.filter_pass = filter_pass

    def _prompt(self, instructions: str, report: str) -> str:
        parts = [instructions]
        for src, tagged in self.examples:
            parts.append(f"Report: {src}\nAnnotated: {tagged}")
        parts.append(f"Report: {report}\nAnnotated:")
        return "\n\n".join(parts)

    def tag_batch(self, reports: list[str]) -> list[list[dict]]:
        instr = _TAG_INSTRUCTIONS.format(targets="; ".join(self.target_names))
        linked = self.generate_fn([self._prompt(instr, r) for r in reports])
        if self.filter_pass:
            linked = self.generate_fn(
                [self._prompt(_FILTER_INSTRUCTIONS, l) for l in linked]
            )
        out = []
        for report, tagged in zip(reports, linked):
            tags = parse_linked_report(report, tagged.strip())
            if tags is None:
                tags = self.fallback.tag(report) if self.fallback else []
            out.append(tags)
        return out

    def tag(self, report: str) -> list[dict]:
        return self.tag_batch([report])[0]
