"""Convert raw VQA / report datasets into the processed vision-language
JSON, the port of ``scripts/data/convert_vl.py`` (host only).

Covers the converter roles of ``scripts/data/vl/*`` (VQA-RAD, SLAKE, report
datasets): the output contract is ``<out>/<name>/{split}.json`` (VQA) or
``{split}-processed.json`` (reports), each a list of

    {"key", "image": [paths], "modality": [..], "plane": [..],
     "vqa": [{"question", "answer"}], "processed_report", "findings",
     "impression", "anomaly_pos", "anomaly_neg"}

Supported inputs:
  - ``--format vqa-json``: a JSON list with image/question/answer fields
    (VQA-RAD / SLAKE style; configurable field names);
  - ``--format report-folder``: a folder of ``<key>.txt`` raw reports +
    ``<key>.(png|jpg)`` images — sectioned with the port's report sectioner
    (``preprocess/report.py``) and labeled with the keyword CheXpert labeler
    (``eval/cxr.py``) for anomaly_pos/neg;
  - the official layouts of MIMIC-CXR, CT-RATE, OpenI, ROCOv2, PMC-OA,
    Radiopaedia (RadFM) and VQA-Med-2019, and ``label`` (CheXbert, which
    needs its checkpoint and ``transformers``, or the keyword labeler).
"""
from __future__ import annotations

import json
from collections import defaultdict
from pathlib import Path

import numpy as np

from ..eval.cxr import CHEXPERT_CONDITIONS, KeywordChexpertLabeler
from .report import build_processed_report, extract_findings_impression


def convert_vqa_json(src: Path, out_dir: Path, *, image_field: str, question_field: str,
                     answer_field: str, image_dir: Path | None, split_field: str | None):
    rows = json.loads(src.read_text())
    by_split = defaultdict(lambda: defaultdict(list))
    for row in rows:
        split = (row.get(split_field) or "train").lower() if split_field else "train"
        split = {"val": "validate", "valid": "validate"}.get(split, split)
        img = row[image_field]
        if image_dir:
            img = str(image_dir / img)
        by_split[split][img].append(
            {"question": str(row[question_field]), "answer": str(row[answer_field])}
        )
    out_dir.mkdir(parents=True, exist_ok=True)
    for split, by_img in by_split.items():
        items = [
            {"key": f"{i}", "image": [img], "modality": None, "vqa": qa}
            for i, (img, qa) in enumerate(sorted(by_img.items()))
        ]
        (out_dir / f"{split}.json").write_text(json.dumps(items, indent=1))
        print(f"{split}: {len(items)} images, {sum(len(x['vqa']) for x in items)} QA pairs")


def convert_report_folder(src: Path, out_dir: Path, split: str):
    labeler = KeywordChexpertLabeler()
    items = []
    for txt in sorted(src.glob("*.txt")):
        key = txt.stem
        image = next((p for ext in (".png", ".jpg", ".jpeg", ".pt.zst")
                      if (p := txt.with_name(key + ext)).exists()), None)
        if image is None:
            continue
        sections = extract_findings_impression(txt.read_text())
        report = build_processed_report(**sections)
        if not report:
            continue
        labels = labeler(report)
        pos = [c for c, l in zip(CHEXPERT_CONDITIONS[:-1], labels[:-1]) if l]
        neg = [c for c, l in zip(CHEXPERT_CONDITIONS[:-1], labels[:-1]) if not l]
        items.append({
            "key": key,
            "image": [str(image)],
            "modality": ["X-ray"],
            "plane": ["PA"],
            "findings": sections["findings"],
            "impression": sections["impression"],
            "processed_report": report,
            "anomaly_pos": pos,
            "anomaly_neg": neg[:4],
        })
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{split}-processed.json").write_text(json.dumps(items, indent=1))
    print(f"{split}: {len(items)} reports")


def convert_mimic_cxr(reports_root: Path, out_dir: Path, *, split_csv: Path,
                      jpg_root: Path | None, metadata_csv: Path | None):
    """Official-layout MIMIC-CXR conversion (ref ``scripts/data/vl/MIMIC-CXR/
    MIMIC-CXR.py:276-444``): walk ``files/pXX/pXXXXXXXX/sXXXXXXXX.txt``,
    section each report, keep studies with findings >= 10 words AND
    impression >= 2 words, strip communication notes from the impression, and
    route studies into train/validate/test via the official split CSV.
    ``metadata_csv`` (mimic-cxr-2.0.0-metadata.csv) supplies per-image
    ViewPosition -> the ``plane`` field the frontal-view logic consumes."""
    import csv as _csv

    split_map: dict[tuple[str, str], str] = {}
    with open(split_csv, newline="") as f:
        for row in _csv.DictReader(f):
            split_map[("s" + row["study_id"], "p" + row["subject_id"])] = row["split"]
    planes: dict[str, str] = {}
    if metadata_csv is not None:
        with open(metadata_csv, newline="") as f:
            for row in _csv.DictReader(f):
                planes[row["dicom_id"]] = row.get("ViewPosition") or ""

    by_split: dict[str, list] = {"train": [], "validate": [], "test": []}
    n_seen = n_kept = 0
    for txt in sorted(reports_root.rglob("s*.txt")):
        study_id, subject_id = txt.stem, txt.parent.name
        group = txt.parent.parent.name
        n_seen += 1
        sections = extract_findings_impression(txt.read_text())
        findings, impression = sections["findings"], sections["impression"]
        if not findings or not impression:
            continue
        if len(findings.split()) < 10 or len(impression.split()) < 2:
            continue
        images, img_planes = [], []
        if jpg_root is not None:
            study_dir = jpg_root / "files" / group / subject_id / study_id
            if study_dir.is_dir():
                for p in sorted(study_dir.iterdir()):
                    images.append(str(p))
                    img_planes.append(planes.get(p.stem, ""))
        split = split_map.get((study_id, subject_id), "train")
        split = {"val": "validate", "valid": "validate"}.get(split, split)
        by_split.setdefault(split, []).append({
            "key": study_id,
            "image": images,
            "modality": ["X-ray"] * len(images),
            "plane": img_planes,
            "findings": findings,
            "impression": impression,
        })
        n_kept += 1
    out_dir.mkdir(parents=True, exist_ok=True)
    for split, items in by_split.items():
        (out_dir / f"{split}.json").write_text(json.dumps(items, indent=1))
        print(f"{split}: {len(items)} studies")
    print(f"kept {n_kept}/{n_seen} reports")


# CT-RATE anomaly-label column -> taxonomy name (ref ``scripts/data/vl/
# CT-RATE/process-text.py:11-29``; coronary calcification folds into the
# arterial class there too)
CT_RATE_LABELS = [
    ("Arterial wall calcification", "arterial wall calcification"),
    ("Cardiomegaly", "cardiomegaly"),
    ("Pericardial effusion", "pericardial effusion"),
    ("Coronary artery wall calcification", "arterial wall calcification"),
    ("Hiatal hernia", "hiatal hernia"),
    ("Lymphadenopathy", "lymphadenopathy"),
    ("Emphysema", "emphysema"),
    ("Atelectasis", "atelectasis"),
    ("Lung nodule", "nodule"),
    ("Lung opacity", "pulmonary opacification"),
    ("Pleural effusion", "pleural effusion"),
    ("Peribronchial thickening", "peribronchial thickening"),
    ("Consolidation", "pulmonary consolidation"),
    ("Bronchiectasis", "bronchiectasis"),
    ("Interlobular septal thickening", "interlobular septal thickening"),
]


def convert_ct_rate(dataset_dir: Path, out_dir: Path, split: str,
                    metadata_csv: Path | None = None):
    """CT-RATE text+label conversion (ref ``process-text.py:40-86``): join the
    radiology report CSV with the 18-condition predicted-label CSV per study
    directory, emitting ``{split}-raw.json`` with findings / impression /
    anomaly_pos / anomaly_neg. Volumes themselves go through
    ``scripts/data/process.py``-style image preprocessing; CT-RATE nii files
    store raw values — reconstruct HU as ``slope * v + intercept`` with the
    metadata CSV's RescaleSlope/RescaleIntercept when provided."""
    import csv as _csv

    reports_name = "train_reports.csv" if split == "train" else "validation_reports.csv"
    labels_name = "train_predicted_labels.csv" if split == "train" else "valid_predicted_labels.csv"
    report_rows: dict[str, dict] = {}
    with open(dataset_dir / "radiology_text_reports" / reports_name, newline="") as f:
        for row in _csv.DictReader(f):
            report_rows[row["VolumeName"]] = row
    label_rows: dict[str, dict] = {}
    with open(dataset_dir / "multi_abnormality_labels" / labels_name, newline="") as f:
        for row in _csv.DictReader(f):
            label_rows[row["VolumeName"]] = row
    # HU reconstruction params: CT-RATE nii voxels are raw detector values;
    # HU = RescaleSlope * v + RescaleIntercept (+ per-axis spacings)
    meta_rows: dict[str, dict] = {}
    if metadata_csv is not None:
        with open(metadata_csv, newline="") as f:
            for row in _csv.DictReader(f):
                meta_rows[row["VolumeName"]] = row

    image_dir = dataset_dir / ("train" if split == "train" else "valid")
    data = []
    for patient_dir in sorted(p for p in image_dir.iterdir() if p.is_dir()):
        for study_dir in sorted(p for p in patient_dir.iterdir() if p.is_dir()):
            volumes = sorted(study_dir.glob("*.nii.gz"))
            if not volumes:
                continue
            ref = report_rows.get(volumes[0].name)
            lab = label_rows.get(volumes[0].name)
            if ref is None or lab is None or not ref.get("Findings_EN", "").strip():
                continue
            pos, neg = set(), set()
            for col, name in CT_RATE_LABELS:
                (pos if lab.get(col, "0").strip() in ("1", "1.0", "True") else neg).add(name)
            study = {
                "key": study_dir.name,
                "image": [str(v) for v in volumes],
                "modality": ["CT"] * len(volumes),
                "findings": ref["Findings_EN"].strip(),
                "anomaly_pos": sorted(pos),
                "anomaly_neg": sorted(neg - pos),
            }
            if ref.get("Impressions_EN", "").strip():
                study["impression"] = ref["Impressions_EN"].strip()
            if meta_rows:
                rescale = []
                for v in volumes:
                    m = meta_rows.get(v.name, {})
                    rescale.append({
                        "slope": float(m.get("RescaleSlope", 1) or 1),
                        "intercept": float(m.get("RescaleIntercept", 0) or 0),
                        "xy_spacing": m.get("XYSpacing"),
                        "z_spacing": m.get("ZSpacing"),
                    })
                study["rescale"] = rescale
            data.append(study)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{split}-raw.json").write_text(json.dumps(data, indent=1))
    print(f"{split}: {len(data)} studies")


def convert_openi(src: Path, out_dir: Path):
    """OpenI (Indiana University CXR) adapter (ref ``scripts/data/vl/OpenI/
    OpenI.py:10-44``): per report row, collect ``images/images_normalized/
    {uid}_IM*.dcm.png``, require non-empty findings AND impression, copy the
    kept images under the processed dir, shuffle with the reference's seed
    (30924) and split 90/10 train/test. The reference keys the image glob by
    the CSV enumerate index; we use the ``uid`` column when present (same
    value in the official CSV) and fall back to the row index."""
    import csv as _csv
    import shutil

    save_dir = out_dir / "images"
    save_dir.mkdir(parents=True, exist_ok=True)
    data = []
    with open(src / "indiana_reports.csv", newline="") as f:
        for i, item in enumerate(_csv.DictReader(f)):
            uid = item.get("uid", str(i))
            images = sorted((src / "images" / "images_normalized").glob(f"{uid}_IM*.dcm.png"))
            findings = (item.get("findings") or "").strip()
            impression = (item.get("impression") or "").strip()
            if not images or not findings or not impression:
                continue
            save_paths = []
            for origin in images:
                dst = save_dir / origin.name
                shutil.copy(origin, dst)
                save_paths.append(str(dst))
            data.append({
                "key": uid,
                "image": save_paths,
                "modality": ["X-ray"] * len(save_paths),
                "findings": findings,
                "impression": impression,
            })
    np.random.RandomState(30924).shuffle(data)
    cut = int(len(data) * 0.9)
    (out_dir / "train.json").write_text(json.dumps(data[:cut], indent=1))
    (out_dir / "test.json").write_text(json.dumps(data[cut:], indent=1))
    print(f"train: {cut}, test: {len(data) - cut} studies")


def convert_rocov2(src: Path, out_dir: Path, split: str):
    """ROCOv2 caption adapter (ref ``scripts/data/vl/ROCOv2.py``): the
    ``{split}_captions.csv`` ID column names ``{split}/{ID}.jpg``."""
    import csv as _csv

    with open(src / f"{split}_captions.csv", newline="") as f:
        data = [
            {
                "key": row["ID"],
                "image": [str(src / split / (row["ID"] + ".jpg"))],
                "caption": row["Caption"],
            }
            for row in _csv.DictReader(f)
        ]
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / f"{split}.json").write_text(json.dumps(data, indent=1))
    print(f"{split}: {len(data)} captions")


def convert_pmc_oa(src: Path, out_dir: Path, *, check_image: bool = True,
                   num_val: int = 500):
    """PMC-OA caption adapter (ref ``scripts/data/vl/PMC-OA.py``): jsonl rows
    with subfigure image paths; captions stripped, <10-char captions dropped,
    first letter capitalized, trailing period enforced; unreadable images
    dropped when ``check_image``; reference shuffle seed 16358, last
    ``num_val`` rows to validate."""
    img_root = src / "caption_T060_filtered_top4_sep_v0_subfigures"
    data = []
    for line in (src / "pmc_oa.jsonl").read_text().strip().splitlines():
        item = json.loads(line)
        path = img_root / item["image"]
        if check_image and not _image_readable(path):
            continue
        caption = item["caption"].strip()
        if len(caption) < 10:
            continue
        if caption[0].islower():
            caption = caption[0].upper() + caption[1:]
        if caption[-1] != ".":
            caption += "."
        data.append({"image": [str(path)], "caption": caption})
    np.random.RandomState(16358).shuffle(data)
    out_dir.mkdir(parents=True, exist_ok=True)
    (out_dir / "train.json").write_text(json.dumps(data[:-num_val], indent=1))
    (out_dir / "validate.json").write_text(json.dumps(data[-num_val:], indent=1))
    print(f"train: {max(len(data) - num_val, 0)}, validate: {min(num_val, len(data))}")


def _image_readable(path: Path) -> bool:
    from PIL import Image  # outside the try: a missing PIL raises, it drops no row

    try:
        with Image.open(path) as im:
            im.verify()
        return True
    except Exception:  # noqa: BLE001 — any decode failure drops the row
        return False


# Radiopaedia plane normalization (ref ``Radiopaedia/Radiopaedia.py:37-48``);
# unknown planes map to None
RP_PLANE_MAP = {
    "axial": "axial", "coronal": "coronal", "sagittal": "sagittal",
    "frontal": "frontal", "lateral": "lateral", "oblique": "oblique",
    "longitudinal": "longitudinal", "transverse": "transverse",
    "ap": "AP", "pa": "PA",
}
# the RadFM csv hardcodes its cluster mount; paths rewrite to our images dir
RADFM_MOUNT = "/mnt/petrelfs/share_data/zhangxiaoman/DATA/Radio_VQA/processed_file/npys"


def convert_radiopaedia(src: Path, out_dir: Path, json_file: str,
                        *, train_val: bool = False, num_val: int = 250):
    """Radiopaedia (RP3D via RadFM csv) adapter (ref ``Radiopaedia/
    Radiopaedia.py:50-93``): rewrite the RadFM mount paths to the processed
    images dir (``.nii.gz``/``.npy`` -> ``.pt.zst``), keep only images that
    exist on disk, normalize planes through the reference map, carry findings
    + the qa_list when the finding text is non-empty; reference shuffle seed
    233, last ``num_val`` to validate (or everything to test)."""
    images_dir = out_dir / "images"

    def convert_path(radfm_path: str) -> Path:
        path = radfm_path.replace(RADFM_MOUNT, str(images_dir))
        for suffix in (".nii.gz", ".npy"):
            if path.endswith(suffix):
                path = path[: -len(suffix)] + ".pt.zst"
        return Path(path)

    data = []
    for item in json.loads((src / json_file).read_text()):
        ret = {"image": [], "modality": [], "plane": []}
        for i, radfm_path in enumerate(item["image_path"]):
            path = convert_path(radfm_path)
            if not path.exists():
                continue
            ret["image"].append(str(path))
            ret["modality"].append(item["image_modality"][i].strip())
            plane = item["plane_projection"][i]
            if isinstance(plane, str):
                plane = plane.lower()
            ret["plane"].append(RP_PLANE_MAP.get(plane))
        if not ret["image"]:
            continue
        findings = item.get("finding")
        if isinstance(findings, str) and (findings := findings.strip()):
            ret["findings"] = findings
            ret["vqa"] = item.get("qa_list")
        data.append(ret)
    out_dir.mkdir(parents=True, exist_ok=True)
    if train_val:
        np.random.RandomState(233).shuffle(data)
        (out_dir / "train.json").write_text(json.dumps(data[:-num_val], indent=1))
        (out_dir / "validate.json").write_text(json.dumps(data[-num_val:], indent=1))
        print(f"train: {max(len(data) - num_val, 0)}, validate: {min(num_val, len(data))}")
    else:
        (out_dir / "test.json").write_text(json.dumps(data, indent=1))
        print(f"test: {len(data)} items")


def convert_vqa_med(src: Path, out_dir: Path):
    """VQA-Med-2019 adapter (ref ``scripts/data/vl/VQA-Med.py``): pipe-
    separated QA lines (``img|q|a`` for train/validate, ``img|cat|q|a`` for
    test), sorted then grouped by consecutive image id; images copied under
    the processed dir as ``images/{id}.jpg``."""
    import shutil

    layout = [
        ("ImageClef-2019-VQA-Med-Training/All_QA_Pairs_train.txt", "train.json", False,
         "ImageClef-2019-VQA-Med-Training/Train_images"),
        ("ImageClef-2019-VQA-Med-Validation/All_QA_Pairs_val.txt", "validate.json", False,
         "ImageClef-2019-VQA-Med-Validation/Val_images"),
        ("VQAMed2019Test/VQAMed2019_Test_Questions_w_Ref_Answers.txt", "test.json", True,
         "VQAMed2019Test/VQAMed2019_Test_Images"),
    ]
    (out_dir / "images").mkdir(parents=True, exist_ok=True)
    for txt_file, out_file, test, img_dir in layout:
        if not (src / txt_file).exists():
            continue
        rows = sorted(
            (line.split("|") for line in (src / txt_file).read_text().splitlines() if line),
            key=lambda x: x[0],  # stable by image id only (ref VQA-Med.py:13)
        )
        processed, vqa, img = [], [], ""

        def flush():
            if vqa:
                processed.append(
                    {"image": [str(out_dir / "images" / (img + ".jpg"))], "vqa": list(vqa)}
                )

        for item in rows:
            if item[0] != img:
                flush()
                img, vqa = item[0], []
            vqa.append({
                "question": item[2 if test else 1],
                "answer": item[3 if test else 2].strip(),
            })
        flush()
        (out_dir / out_file).write_text(json.dumps(processed, indent=1))
        print(f"{out_file}: {len(processed)} images")
        if (src / img_dir).is_dir():
            for p in (src / img_dir).iterdir():
                shutil.copy(p, out_dir / "images" / p.name)


def label_reports(dataset_dir: Path, split: str, chexbert_ckpt: Path | None = None,
                  labeler=None) -> Path:
    """Anomaly-label a converted dataset's reports (ref ``scripts/data/vl/
    label.py:17-104``: the reference labels VL training reports with the
    CheXbert MODEL). With ``chexbert_ckpt`` (or an injected ``labeler``) the
    real ``eval.models.ChexbertLabeler`` runs; otherwise the keyword labeler
    is the flagged fallback. Writes ``anomaly_pos/anomaly_neg`` (+ a
    ``labeler`` provenance field) in place and returns the json path."""
    if labeler is not None:
        name = getattr(labeler, "name", "custom")
    elif chexbert_ckpt is not None:
        from ..eval.models import ChexbertLabeler

        model = ChexbertLabeler(chexbert_ckpt)
        labeler, name = model.label, "chexbert"
    else:
        labeler, name = KeywordChexpertLabeler(), "keyword"

    path = dataset_dir / f"{split}.json"
    data = json.loads(path.read_text())
    for item in data:
        report = item.get("processed_report") or "\n".join(
            filter(None, [item.get("findings"), item.get("impression")])
        )
        labels = np.asarray(labeler(report))
        # condition list ends with "No Finding" — excluded from pos/neg sets
        item["anomaly_pos"] = [
            c for c, l in zip(CHEXPERT_CONDITIONS[:-1], labels[:-1]) if l
        ]
        item["anomaly_neg"] = [
            c for c, l in zip(CHEXPERT_CONDITIONS[:-1], labels[:-1]) if not l
        ][:4]
        item["labeler"] = name
    path.write_text(json.dumps(data, indent=1))
    print(f"{split}: labeled {len(data)} reports with {name}")
    return path
