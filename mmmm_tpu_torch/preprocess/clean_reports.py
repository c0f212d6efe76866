"""LLM report cleaning, the port of ``scripts/data/clean_reports.py``:
remove priors, history and technique before vision-language training.

Equivalent of the reference's vLLM Llama-3 pass
(the reference's ``scripts/data/vl/llama3_process.py:1-187``): every report in
``<dataset_dir>/<split>.json`` runs through a dataset-specific cleaning prompt
and the result lands in ``<split>-processed.json`` as ``processed_report``
(or ``processed_caption`` for caption datasets), plus a ``<split>-processed.csv``
original/processed audit table. Prompt rules per dataset (paraphrased from the
reference, same contract; the prompts are the JAX script's, byte for byte):

  - MIMIC-CXR: two passes — (1) strip imaging-technique/plane/position meta,
    (2) strip prior-comparison and patient-history content; both paraphrase to
    keep implied findings (``llama3_process.py:8-33``);
  - CT-RATE: one pass, only on reports containing prior/history trigger words
    (``llama3_process.py:104-116``);
  - OpenI: one pass incl. removing "XXXX" de-identification residue;
  - ROCOv2: caption cleaning (personal info, figure refs, study dates).

The generator is pluggable: ``cli.py clean-reports --params/--config`` runs a
local LM through ``models/llm_batch.py make_text_generator`` (the vLLM
equivalent) on the card; ``--rule-based`` uses the deterministic regex
cleaner (flagged in metadata); tests inject a stub via
``clean_dataset(generate_fn=...)``.
"""
from __future__ import annotations

import csv
import json
from pathlib import Path

# -- prompt contracts (ref llama3_process.py:8-84; condensed, same rules) ----

MIMIC_PASS1 = (
    "You are an AI assistant with expertise in radiology. Process the given "
    "radiology report and remove content that cannot be inferred from a single "
    "radiograph alone. Remove clinical meta information about imaging planes, "
    "techniques and patient position (e.g. 'AP and lateral views of the chest "
    "were provided', 'portable chest radiograph', 'on the lateral view'). If "
    "such content implies a key finding, paraphrase to keep the finding (e.g. "
    "'portable chest radiograph demonstrates a right pneumothorax' -> 'a right "
    "pneumothorax is seen'). Modify the input as little as possible.\n"
    "Input: {input}\n"
    "Your output should be exactly the processed report. Do not output anything else."
)

MIMIC_PASS2 = (
    "You are an AI assistant with expertise in radiology. Process the given "
    "radiology report and remove content that cannot be inferred from a single "
    "radiograph alone. Remove comparisons with prior examinations and interval "
    "changes ('unchanged', 'stable', 'again noted', 'new', 'previously') and "
    "the patient's medical history with judgements derived purely from it. If "
    "such content implies a current finding, paraphrase to keep it (e.g. "
    "'interval improvement in extent of interstitial pulmonary edema' -> "
    "'there is interstitial pulmonary edema'); if presence cannot be inferred, "
    "remove it entirely. Modify the input as little as possible.\n"
    "Input: {input}\n"
    "Your output should be exactly the processed report. Do not output anything else."
)

CT_RATE_PROMPT = (
    "You are an AI assistant with expertise in radiology. Process the given "
    "radiology report: remove comparisons with prior examinations and interval "
    "changes, and remove the patient's medical history. Keep the rest of the "
    "report exactly the same without any modification.\n"
    "Input: {input}\n"
    "Your output should be exactly the processed report. Do not output anything else."
)

OPENI_PROMPT = (
    "You are an AI assistant with expertise in radiology. Process the given "
    "radiology report (findings and impression): remove imaging-technique and "
    "patient-position meta information, comparisons with prior examinations, "
    "the patient's medical history, and any content de-identified with 'XXXX' "
    "(removing the whole affected clause when the loss is irreversible). "
    "Paraphrase to keep implied findings. Keep everything else exactly the "
    "same and add nothing.\n"
    "Input: {input}\n"
    "Your output should be exactly the processed report. Do not output anything else."
)

ROCO_PROMPT = (
    "You are an AI assistant with expertise in radiology. Process the given "
    "caption of a radiological image: remove the patient's personal "
    "information, comparisons with prior examinations, medical history, "
    "references to figures and cases (keep references to arrows), and study "
    "dates. Keep everything else exactly the same. If the input does not "
    "appear to be a caption of a radiological image, output exactly "
    '"The provided input text does not appear to be a caption of a '
    'radiological image.".\n'
    "Input: {input}\n"
    "Your output should be exactly the processed caption. Do not output anything else."
)

# trigger words gating the CT-RATE pass (llama3_process.py:105)
CT_RATE_TRIGGERS = ("prior", "previous", "new", "stable", "patient", "history")


def _report_text(item: dict) -> str:
    if item.get("impression"):
        return f"Findings: {item['findings']}\nImpression: {item['impression']}"
    return item.get("findings") or item.get("report") or ""


def _rule_based_fn(prompts: list[str]) -> list[str]:
    from .report import remove_prior_references

    out = []
    for p in prompts:
        # the prompt wraps the report; recover the payload after "Input: "
        payload = p.split("Input: ", 1)[-1].rsplit("\nYour output", 1)[0]
        out.append(remove_prior_references(payload))
    return out


def clean_dataset(
    dataset_dir: Path,
    dataset: str,
    split: str,
    generate_fn,
    *,
    cleaner_name: str = "llm",
) -> Path:
    """Run the dataset's cleaning prompt chain; returns the processed path."""
    dataset_dir = Path(dataset_dir)
    data = json.loads((dataset_dir / f"{split}.json").read_text())
    audit_rows = []
    if dataset == "ROCOv2":
        captions = [x.get("caption", "") for x in data]
        processed = generate_fn([ROCO_PROMPT.format(input=c) for c in captions])
        for item, orig, new in zip(data, captions, processed):
            item["processed_caption"] = new.strip()
            audit_rows.append({"original": orig, "processed": new.strip()})
    else:
        reports = [_report_text(x) for x in data]
        if dataset == "MIMIC-CXR":
            p1 = generate_fn([MIMIC_PASS1.format(input=r) for r in reports])
            p2 = generate_fn([MIMIC_PASS2.format(input=r) for r in p1])
            for item, orig, a, b in zip(data, reports, p1, p2):
                item["processed_report"] = b.strip()
                audit_rows.append({"original": orig, "processed1": a.strip(), "processed2": b.strip()})
        elif dataset == "CT-RATE":
            hit = [i for i, r in enumerate(reports)
                   if any(t in r.lower() for t in CT_RATE_TRIGGERS)]
            cleaned = generate_fn([CT_RATE_PROMPT.format(input=reports[i]) for i in hit])
            processed = list(reports)
            for i, c in zip(hit, cleaned):
                processed[i] = c.strip()
            for item, orig, new in zip(data, reports, processed):
                item["processed_report"] = new
                audit_rows.append({"original": orig, "processed": new})
        else:  # OpenI and other findings+impression datasets
            cleaned = generate_fn([OPENI_PROMPT.format(input=r) for r in reports])
            for item, orig, new in zip(data, reports, cleaned):
                item["processed_report"] = new.strip()
                audit_rows.append({"original": orig, "processed": new.strip()})
    for item in data:
        item["cleaner"] = cleaner_name
    out_path = dataset_dir / f"{split}-processed.json"
    out_path.write_text(json.dumps(data, indent=1, ensure_ascii=False))
    if audit_rows:
        with open(dataset_dir / f"{split}-processed.csv", "w", newline="") as f:
            w = csv.DictWriter(f, fieldnames=list(audit_rows[0]))
            w.writeheader()
            w.writerows(audit_rows)
    print(f"{dataset}/{split}: cleaned {len(data)} items ({cleaner_name}) -> {out_path}")
    return out_path
