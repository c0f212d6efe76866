"""Multi-annotator box fusion (VinDr-CXR style) + a box-dataset processor.

Equivalent of the reference's VinDr-CXR processor
(``scripts/data/local/processors/VinDrCXR.py``): several radiologists draw
overlapping boxes for the same finding; annotations are fused by

  1. dropping exact duplicates from the same annotator,
  2. graph clustering across *different* annotators with an adaptive IoU
     threshold — starting low (0.25) and raising in 0.05 steps until no
     cluster contains more boxes than there are annotators,
  3. averaging each cluster's corners.

``BoxFolderProcessor`` turns a folder of 2-D images + a CSV of per-annotator
boxes into the processed-dataset layout (no masks; instance boxes only), the
input contract of the instance-grounding (VinDr) training path.

The port's own copy of ``mmmm_tpu/preprocess/boxes.py``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .processor import CaseSpec, Processor, ProcessorConfig
from ..data.sparse import Sparse, Target
from ..utils import save_pt_zst


def box_iou_2d(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pairwise IoU of (N, 4) / (M, 4) (x0, y0, x1, y1) corner boxes."""
    inter_lo = np.maximum(a[:, None, :2], b[None, :, :2])
    inter_hi = np.minimum(a[:, None, 2:], b[None, :, 2:])
    inter = np.clip(inter_hi - inter_lo, 0, None).prod(-1)
    area_a = np.clip(a[:, 2:] - a[:, :2], 0, None).prod(-1)
    area_b = np.clip(b[:, 2:] - b[:, :2], 0, None).prod(-1)
    union = area_a[:, None] + area_b[None, :] - inter
    return inter / np.maximum(union, 1e-9)


def _connected_components(adj: np.ndarray) -> tuple[int, np.ndarray]:
    n = adj.shape[0]
    labels = np.full(n, -1)
    cur = 0
    for s in range(n):
        if labels[s] >= 0:
            continue
        stack = [s]
        labels[s] = cur
        while stack:
            u = stack.pop()
            for v in np.nonzero(adj[u])[0]:
                if labels[v] < 0:
                    labels[v] = cur
                    stack.append(v)
        cur += 1
    return cur, labels


def fuse_annotator_boxes(
    boxes: np.ndarray,  # (N, 4) x0 y0 x1 y1
    annotators: np.ndarray,  # (N,) annotator ids
    iou_start: float = 0.25,
    iou_step: float = 0.05,
) -> np.ndarray:
    """Cluster cross-annotator boxes and average each cluster; returns (K, 4)."""
    boxes = np.asarray(boxes, np.float64)
    annotators = np.asarray(annotators)
    if len(boxes) == 0:
        return boxes.reshape(0, 4)
    # drop exact duplicates from the same annotator
    seen = {}
    keep = []
    for i, (b, r) in enumerate(zip(boxes, annotators)):
        key = (tuple(np.round(b, 3)), r)
        if key not in seen:
            seen[key] = i
            keep.append(i)
    boxes, annotators = boxes[keep], annotators[keep]

    iou = box_iou_2d(boxes, boxes)
    cross = annotators[:, None] != annotators[None, :]
    num_rads = len(np.unique(annotators))
    th = iou_start
    while True:
        nc, labels = _connected_components((iou >= th) & cross | np.eye(len(boxes), dtype=bool))
        _, counts = np.unique(labels, return_counts=True)
        th += iou_step
        if th > 1 or counts.max() <= num_rads:
            break
    return np.stack([boxes[labels == i].mean(0) for i in range(nc)])


@dataclasses.dataclass
class BoxCase:
    key: str
    image: Path
    # class name -> list of (annotator_id, (x0, y0, x1, y1))
    annotations: dict[str, list[tuple[str, tuple[float, float, float, float]]]]
    neg_classes: list[str] = dataclasses.field(default_factory=list)


def load_box_cases(src: Path, csv_path: Path | None = None) -> list[BoxCase]:
    """Build ``BoxCase`` list from a VinDr-CXR-style folder.

    Layout (ref ``scripts/data/local/processors/VinDrCXR.py:19-100``): images
    anywhere under ``src`` named ``<image_id>.<ext>``, plus an annotation CSV
    with columns ``image_id, class_name, rad_id, x_min, y_min, x_max, y_max``
    (the official VinDr header). Rows whose class is "No finding" mark that
    annotator as all-negative for the study; a study with no positive rows
    becomes a pure-negative case (``neg_classes`` = every class seen in the
    CSV), matching the reference's complete-anomaly contract.
    """
    import csv

    src = Path(src)
    if csv_path is None:
        for cand in ("annotations_train.csv", "train.csv", "boxes.csv", "annotations.csv"):
            if (src / cand).exists():
                csv_path = src / cand
                break
        else:
            raise FileNotFoundError(f"no annotation csv found under {src}")

    by_image: dict[str, dict[str, list[tuple[str, tuple[float, float, float, float]]]]] = {}
    negatives: dict[str, bool] = {}
    all_classes: set[str] = set()
    with open(csv_path, newline="") as f:
        for row in csv.DictReader(f):
            key = row["image_id"]
            cls = row["class_name"].strip()
            by_image.setdefault(key, {})
            if cls.lower() == "no finding" or row.get("x_min") in (None, "", "nan"):
                negatives[key] = True
                continue
            all_classes.add(cls)
            box = (float(row["x_min"]), float(row["y_min"]), float(row["x_max"]), float(row["y_max"]))
            by_image[key].setdefault(cls, []).append((row.get("rad_id", "r0"), box))

    image_index: dict[str, Path] = {}
    for ext in ("png", "jpg", "jpeg", "nii.gz", "nii"):
        for p in src.rglob(f"*.{ext}"):
            image_index.setdefault(p.name[: -len(ext) - 1], p)

    cases = []
    for key, anns in sorted(by_image.items()):
        if key not in image_index:
            continue
        neg = sorted(all_classes - set(anns)) if (negatives.get(key) or not anns) else []
        cases.append(BoxCase(key=key, image=image_index[key], annotations=anns, neg_classes=neg))
    return cases


class BoxFolderProcessor(Processor):
    """2-D images + per-annotator boxes -> processed instance-box dataset."""

    def __init__(self, name: str, cases: list[BoxCase], output_root: Path,
                 conf: ProcessorConfig | None = None):
        self.name = name
        self._cases = cases
        super().__init__(output_root, conf)

    def get_cases(self):
        return self._cases

    def process_case(self, case: BoxCase) -> dict:  # type: ignore[override]
        data, spacing = self.load_image(case.image)
        d, h, w = data.shape
        scale = min(1.0, self.conf.max_smaller_edge / min(h, w))
        new_shape = (d, int(round(h * scale)), int(round(w * scale)))
        if new_shape != data.shape:
            from ..data.transforms import resize_3d

            data = resize_3d(data[None], new_shape)[0]
        mn, mx = float(data.min()), float(data.max())
        image_u8 = np.round((data - mn) / max(mx - mn, 1e-8) * 255).astype(np.uint8)[None]

        targets: dict[str, list[Target]] = {"anatomy": [], "anomaly": []}
        from ..data.target_tax import get_target_tax

        tax = get_target_tax()
        for cls_name, anns in case.annotations.items():
            rads = np.asarray([a for a, _ in anns])
            raw = np.asarray([b for _, b in anns], np.float64) * scale
            fused = fuse_annotator_boxes(raw, rads)
            fused = np.clip(np.round(fused), 0, [new_shape[2], new_shape[1]] * 2)
            # (x0, y0, x1, y1) -> (d0, h0, w0, d1, h1, w1)
            boxes6 = np.zeros((len(fused), 6), np.int64)
            boxes6[:, 0], boxes6[:, 3] = 0, 1
            boxes6[:, 1], boxes6[:, 4] = fused[:, 1], fused[:, 3]
            boxes6[:, 2], boxes6[:, 5] = fused[:, 0], fused[:, 2]
            category = tax[cls_name].category if cls_name in tax else "anomaly"
            targets.setdefault(category, []).append(
                Target(name=cls_name, semantic=False, boxes=boxes6)
            )
        sparse = Sparse(
            spacing=np.asarray(spacing),
            shape=np.asarray(new_shape, np.int64),
            modalities=["X-ray"],
            mean=np.asarray([float(image_u8.mean())], np.float32),
            std=np.asarray([float(image_u8.std())], np.float32),
            targets=targets,
            neg_targets={"anatomy": [], "anomaly": list(case.neg_classes)},
            complete_anomaly=True,
        )
        final_dir = self.output_dir / "data" / case.key
        tmp_dir = final_dir.with_name("." + case.key)
        tmp_dir.mkdir(parents=True, exist_ok=True)
        save_pt_zst(image_u8, tmp_dir / "images.pt.zst")
        (tmp_dir / "sparse.json").write_bytes(sparse.to_json())
        tmp_dir.rename(final_dir)
        return {"key": case.key, "status": "ok", "num_targets": sum(len(v) for v in targets.values())}
