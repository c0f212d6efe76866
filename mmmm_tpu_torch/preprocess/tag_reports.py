"""VG phrase tagging, the port of ``scripts/data/tag_reports.py``:
reports -> ``visual-grounding/<ds>/<split>.json``.

The end-to-end job the reference runs with vLLM Llama-3-70B
(the reference's ``scripts/data/vg/tag.py:300-380``): for every study in a
processed VL dataset, the two-pass LLM tagger (tag, then positive-filter)
marks anatomical/anomaly phrases as ``[phrase](target)`` markdown, the
round-trip validator converts them into char-offset ``tags``, and the study
lands in the VG dataset json that ``GRGTransform`` consumes (together with the
per-study image list / planes).

The LLM is the local batched harness (``models/llm_batch.py
make_text_generator`` — the vLLM equivalent; ``cli.py tag-reports
--params``); ``--taxonomy-only`` runs the deterministic synonym-matching
tagger instead (flagged in the output), which is also the per-report
fallback whenever an LLM output fails round-trip validation.
"""
from __future__ import annotations

import json
from pathlib import Path

from ..data.target_tax import get_target_tax
from .tagging import LLMTagger, TaxonomyTagger


def tag_dataset(
    dataset_dir: Path,
    split: str,
    out_dir: Path,
    generate_fn=None,
    *,
    target_tax: dict | None = None,
    batch_size: int = 64,
) -> Path:
    """Tag every study's report; returns the written json path. With
    ``generate_fn=None`` the taxonomy matcher tags directly."""
    tax = target_tax if target_tax is not None else get_target_tax()
    fallback = TaxonomyTagger(tax)
    if generate_fn is None:
        tagger, source = fallback, "taxonomy"
    else:
        seen, names = set(), []
        for cls in tax.values():
            if id(cls) in seen:
                continue
            seen.add(id(cls))
            names.append(cls.name)
        tagger = LLMTagger(generate_fn, names, fallback=fallback)
        source = "llm"

    data = json.loads((Path(dataset_dir) / f"{split}.json").read_text())
    reports = [
        d.get("processed_report")
        or "\n".join(filter(None, [d.get("findings"), d.get("impression")]))
        for d in data
    ]
    items = []
    for start in range(0, len(data), batch_size):
        chunk = data[start : start + batch_size]
        texts = reports[start : start + batch_size]
        if isinstance(tagger, LLMTagger):
            tags_batch = tagger.tag_batch(texts)
        else:
            tags_batch = [tagger.tag(t) for t in texts]
        for study, report, tags in zip(chunk, texts, tags_batch):
            if not report:
                continue
            for t in tags:  # offsets must round-trip (tag.py assertion)
                assert report[t["start"]:t["end"]] == t["phrase"], t
            item = {
                "key": study.get("key"),
                "image": study.get("image", []),
                "ref_report": report,
                "tags": [
                    {"start": t["start"], "end": t["end"], "target": t["target"]}
                    for t in tags
                ],
                "tagger": source,
            }
            if study.get("plane"):
                item["plane"] = study["plane"]
            items.append(item)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    out_path = out_dir / f"{split}.json"
    out_path.write_text(json.dumps(items, indent=1))
    n_tagged = sum(1 for i in items if i["tags"])
    print(f"{split}: {len(items)} studies, {n_tagged} with tags ({source}) -> {out_path}")
    return out_path
