"""Offline dataset processor framework.

Equivalent of the reference's local processor framework
(``scripts/data/local/processors/_base.py``): per case —

  load NIfTI/PNG -> reorient to (D, H, W) canonical order -> clip intensity at
  the +-3-sigma quantiles of the foreground -> crop to foreground -> resize
  (max smaller in-plane edge capped) -> min-max quantize to uint8 -> group
  targets (instance boxes from mask components, <=10k foreground positions per
  class) -> save ``images.pt.zst``, ``masks.pt.zst``, ``class_positions.npz``,
  ``sparse.json`` with atomic temp-dir rename, skip-if-exists resume, and
  per-case exception isolation -> collect ``info.csv``.

Dataset adapters subclass ``Processor`` and implement ``get_cases``; see
``NNUNetProcessor`` for the nnU-Net / Medical-Segmentation-Decathlon layout.

The port's own copy of ``mmmm_tpu/preprocess/processor.py``.
"""
from __future__ import annotations

import dataclasses
import json
import traceback
from pathlib import Path

import numpy as np

from .nifti import read_nifti
from ..data.sparse import Sparse, Target
from ..data.transforms import resize_3d
from ..utils import save_pt_zst


@dataclasses.dataclass
class CaseSpec:
    key: str
    images: dict[str, Path]  # modality -> path
    seg: Path | None = None  # label volume (integer classes)
    class_map: dict[int, str] | None = None  # label value -> taxonomy name
    semantic: dict[str, bool] | None = None  # per-class: instances merged?
    neg_classes: list[str] | None = None


@dataclasses.dataclass(kw_only=True)
class ProcessorConfig:
    max_smaller_edge: int = 512
    clip_sigma: float = 3.0
    max_class_positions: int = 10000
    min_instance_voxels: int = 8
    complete_anomaly: bool = False


def reorient_to_dhw(data: np.ndarray, affine: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Permute/flip voxel axes so dim order is (slowest spacing ... fastest),
    i.e., the through-plane axis comes first — the heuristic analog of the
    reference's SRA/RAS/ASR inference. Returns (data, spacing (3,))."""
    spacing = np.linalg.norm(affine[:3, :3], axis=0)
    order = np.argsort(-spacing)  # largest spacing first (through-plane)
    data = np.transpose(data, order)
    return np.ascontiguousarray(data), spacing[order]


class SkipCase(Exception):
    pass


class Processor:
    name: str = "dataset"

    def __init__(self, output_root: Path, conf: ProcessorConfig | None = None):
        self.output_dir = Path(output_root) / self.name
        self.conf = conf or ProcessorConfig()

    # -- adapter interface --------------------------------------------------
    def get_cases(self) -> list[CaseSpec]:
        raise NotImplementedError

    def load_image(self, path: Path) -> tuple[np.ndarray, np.ndarray]:
        """Returns (data (D, H, W) float, spacing (3,))."""
        if str(path).endswith((".nii", ".nii.gz")):
            img = read_nifti(path)
            data = img.data
            if data.ndim == 4:
                data = data[..., 0]
            return reorient_to_dhw(data.astype(np.float32), img.affine)
        if Path(path).is_dir() or str(path).endswith((".dcm", ".dicom")):
            # DICOM series directory or single file (ref loads these through
            # MONAI LoadImage, processors/_base.py:104-180 — e.g. CHAOS)
            from .dicom import read_dicom_file, read_dicom_series

            if Path(path).is_dir():
                return read_dicom_series(path)
            frame, meta = read_dicom_file(path)
            ps = meta.get("PixelSpacing") or [1.0, 1.0]
            if frame.ndim == 2:
                frame = frame[None]
                spacing = [meta.get("SliceThickness") or 1e6, ps[0], ps[1]]
            else:
                spacing = [meta.get("SliceThickness") or 1.0, ps[0], ps[1]]
            return frame.astype(np.float32), np.asarray(spacing)
        from PIL import Image

        arr = np.asarray(Image.open(path).convert("L"), np.float32)
        return arr[None], np.asarray([1e6, 1.0, 1.0])  # 2-D: huge z spacing

    # -- pipeline -----------------------------------------------------------
    def process(self, limit: int | None = None) -> list[dict]:
        cases = self.get_cases()
        if limit:
            cases = cases[:limit]
        info = []
        for case in cases:
            out_dir = self.output_dir / "data" / case.key
            if out_dir.exists():
                info.append({"key": case.key, "status": "exists"})
                continue
            try:
                rec = self.process_case(case)
                info.append(rec)
            except SkipCase as e:
                info.append({"key": case.key, "status": f"skip: {e}"})
            except Exception:
                info.append({"key": case.key, "status": "error"})
                (self.output_dir / f"{case.key}.error.log").parent.mkdir(parents=True, exist_ok=True)
                (self.output_dir / f"{case.key}.error.log").write_text(traceback.format_exc())
        self._write_info(info)
        self._write_split(info)
        return info

    def _write_split(self, info: list[dict], val_frac: float = 0.05,
                     test_frac: float = 0.05):
        """``split.json`` for the data loader (ref ``_base.py:298-303``:
        processors emit per-dataset splits; datasets with official splits
        override ``get_split``). Default: deterministic hash split by key, so
        re-processing never reshuffles cases between splits."""
        import hashlib

        split = self.get_split()
        if split is None:
            split = {"train": [], "validate": [], "test": []}
            ok = [r["key"] for r in info if r.get("status") in ("ok", "exists")]
            for key in ok:
                h = int(hashlib.sha1(f"{self.name}/{key}".encode()).hexdigest(), 16)
                u = (h % 10_000) / 10_000
                if u < test_frac:
                    split["test"].append(key)
                elif u < test_frac + val_frac:
                    split["validate"].append(key)
                else:
                    split["train"].append(key)
        (self.output_dir / "split.json").write_text(json.dumps(split, indent=1))

    def get_split(self) -> dict[str, list[str]] | None:
        """Override to supply a dataset's official split; None = hash split."""
        return None

    def process_case(self, case: CaseSpec) -> dict:
        conf = self.conf
        images, spacings = [], []
        for path in case.images.values():
            data, spacing = self.load_image(path)
            images.append(data)
            spacings.append(spacing)
        shape0 = images[0].shape
        if any(i.shape != shape0 for i in images):
            raise SkipCase("modalities not co-registered")
        spacing = np.asarray(spacings[0], np.float64)

        seg = None
        if case.seg is not None:
            seg_img = read_nifti(case.seg)
            seg, _ = reorient_to_dhw(seg_img.data.astype(np.int32), seg_img.affine)
            if seg.shape != shape0:
                raise SkipCase("segmentation shape mismatch")

        # intensity clip at +-sigma quantiles of each modality
        from scipy.stats import norm

        lo_q, hi_q = norm.cdf(-conf.clip_sigma), norm.cdf(conf.clip_sigma)
        clipped = []
        for img in images:
            lo, hi = np.quantile(img, lo_q), np.quantile(img, hi_q)
            clipped.append(np.clip(img, lo, hi))
        images = clipped

        # foreground crop (union over modalities, above per-modality min)
        fg = np.zeros(shape0, bool)
        for img in images:
            fg |= img > img.min()
        if not fg.any():
            raise SkipCase("empty image")
        nz = np.argwhere(fg)
        lo_c, hi_c = nz.min(0), nz.max(0) + 1
        crop = tuple(slice(int(a), int(b)) for a, b in zip(lo_c, hi_c))
        images = [img[crop] for img in images]
        if seg is not None:
            seg = seg[crop]

        # resize: cap the smaller in-plane edge
        d, h, w = images[0].shape
        scale = min(1.0, conf.max_smaller_edge / min(h, w))
        new_shape = (d, int(round(h * scale)), int(round(w * scale)))
        if new_shape != images[0].shape:
            images = [resize_3d(img[None], new_shape)[0] for img in images]
            spacing = spacing * np.asarray(
                [d / new_shape[0], h / new_shape[1], w / new_shape[2]]
            )
        shape = images[0].shape

        # min-max -> uint8, record stats
        out_images = np.empty((len(images), *shape), np.uint8)
        means, stds = [], []
        for i, img in enumerate(images):
            mn, mx = float(img.min()), float(img.max())
            means.append(float(img.mean()))
            stds.append(float(img.std()))
            out_images[i] = np.round((img - mn) / max(mx - mn, 1e-8) * 255).astype(np.uint8)

        # targets from segmentation
        masks_rows: list[np.ndarray] = []
        targets: dict[str, list[Target]] = {"anatomy": [], "anomaly": []}
        positions: dict[str, np.ndarray] = {}
        if seg is not None and case.class_map:
            from scipy import ndimage

            from ..data.target_tax import get_target_tax

            tax = get_target_tax()
            if new_shape != (d, h, w):
                seg = np.round(resize_3d(seg[None].astype(np.float32), shape)[0]).astype(np.int32)
            for value, name in sorted(case.class_map.items()):
                cls_mask = seg == value
                if not cls_mask.any():
                    continue
                semantic = (case.semantic or {}).get(name, True)
                if semantic:
                    instances = [cls_mask]
                else:
                    labeled, n = ndimage.label(cls_mask)
                    instances = [
                        inst
                        for i in range(1, n + 1)
                        if (inst := labeled == i).sum() >= self.conf.min_instance_voxels
                    ] or [cls_mask]
                index_lo = len(masks_rows)
                boxes = []
                for inst in instances:
                    masks_rows.append(inst)
                    nzi = np.argwhere(inst)
                    boxes.append([*nzi.min(0), *(nzi.max(0) + 1)])
                fg_pos = np.argwhere(cls_mask)
                if len(fg_pos) > conf.max_class_positions:
                    sel = np.random.default_rng(0).choice(len(fg_pos), conf.max_class_positions, replace=False)
                    fg_pos = fg_pos[sel]
                positions[name] = fg_pos.astype(np.int32)
                category = tax[name].category if name in tax else "anatomy"
                targets.setdefault(category, []).append(
                    Target(
                        name=name,
                        semantic=semantic,
                        index_offset=(index_lo, len(masks_rows)),
                        position_offset=(0, len(fg_pos)),
                        boxes=np.asarray(boxes, np.int64),
                        mask_sizes=np.asarray([m.sum() for m in masks_rows[index_lo:]], np.int64),
                    )
                )

        neg = case.neg_classes or []
        sparse = Sparse(
            spacing=spacing,
            shape=np.asarray(shape, np.int64),
            modalities=list(case.images.keys()),
            mean=np.asarray(means, np.float32),
            std=np.asarray(stds, np.float32),
            targets=targets,
            neg_targets={"anatomy": [], "anomaly": list(neg)},
            complete_anomaly=conf.complete_anomaly,
        )

        # atomic save: write to .key temp dir, then rename
        final_dir = self.output_dir / "data" / case.key
        tmp_dir = final_dir.with_name("." + case.key)
        tmp_dir.mkdir(parents=True, exist_ok=True)
        save_pt_zst(out_images, tmp_dir / "images.pt.zst")
        if masks_rows:
            save_pt_zst(np.stack(masks_rows), tmp_dir / "masks.pt.zst")
        if positions:
            np.savez_compressed(tmp_dir / "class_positions.npz", **positions)
        (tmp_dir / "sparse.json").write_bytes(sparse.to_json())
        tmp_dir.rename(final_dir)
        return {
            "key": case.key,
            "status": "ok",
            "shape": "x".join(map(str, shape)),
            "num_targets": sum(len(v) for v in targets.values()),
            "num_masks": len(masks_rows),
        }

    def _write_info(self, info: list[dict]):
        import csv

        self.output_dir.mkdir(parents=True, exist_ok=True)
        path = self.output_dir / "info.csv"
        keys = sorted({k for r in info for k in r})
        with open(path, "w", newline="") as f:
            writer = csv.DictWriter(f, fieldnames=keys)
            writer.writeheader()
            writer.writerows(info)


class NNUNetProcessor(Processor):
    """nnU-Net / MSD layout: imagesTr/{case}_0000.nii.gz + labelsTr/{case}.nii.gz
    + dataset.json with a ``labels`` map."""

    def __init__(self, dataset_dir: Path, output_root: Path, *, name: str | None = None,
                 modality: str = "CT", semantic: dict[str, bool] | None = None,
                 conf: ProcessorConfig | None = None):
        self.dataset_dir = Path(dataset_dir)
        self.name = name or self.dataset_dir.name
        self.modality = modality
        self.semantic = semantic
        super().__init__(output_root, conf)

    def get_cases(self) -> list[CaseSpec]:
        meta = json.loads((self.dataset_dir / "dataset.json").read_text())
        labels = meta.get("labels", {})
        # nnU-Net v1: {"0": "background", ...}; v2: {"background": 0, ...}
        if labels and isinstance(next(iter(labels.values())), str):
            class_map = {int(k): v for k, v in labels.items() if v.lower() != "background"}
        else:
            class_map = {int(v): k for k, v in labels.items() if k.lower() != "background"}
        cases = []
        labels_dir = self.dataset_dir / "labelsTr"
        images_dir = self.dataset_dir / "imagesTr"
        for seg_path in sorted(labels_dir.glob("*.nii*")):
            key = seg_path.name.replace(".nii.gz", "").replace(".nii", "")
            img = images_dir / f"{key}_0000{''.join(seg_path.suffixes)}"
            if not img.exists():
                img = images_dir / seg_path.name
            if not img.exists():
                continue
            cases.append(
                CaseSpec(
                    key=key,
                    images={self.modality: img},
                    seg=seg_path,
                    class_map=class_map,
                    semantic=self.semantic,
                )
            )
        return cases
