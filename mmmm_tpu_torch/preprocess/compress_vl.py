"""Compress VL dataset images into crop-resized ``.pt.zst`` tensors, the
port of ``scripts/data/compress_vl.py`` (host only).

Equivalent of the reference's per-dataset compress passes
(``scripts/data/vl/MIMIC-CXR/MIMIC-CXR-compress.py``, ``Radiopaedia/
RP-compress.py``): walk a processed ``{split}.json``, nonzero-crop each image,
resize by the token-budget rule (z capped at 4 x 32 slices; smaller in-plane
edge capped at ``int(sqrt(256/max_tokens_z)) * 32``, aspect preserved —
ref ``vl/_utils.py:14-35``), store uint8 volumes as zstd tensors (the port's
native zstd, ``utils/io.py``), and rewrite the JSON to the new paths.
Resume-safe (existing outputs are skipped; writes are atomic) and parallel
across worker threads (IO + zstd release the GIL). PIL is imported only for
2-D image files.
"""
from __future__ import annotations

import json
import math
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np

from ..data.transforms import resize_3d
from ..utils.io import load_pt_zst, save_pt_zst


def get_resize(shape: tuple[int, int, int]) -> list[int]:
    """Token-budget resize rule (ref ``vl/_utils.py:14-21``)."""
    max_tokens_z = min(4, shape[0])
    max_smaller_edge = int((256 / max_tokens_z) ** 0.5) * 32
    resize_shape = [min(max_tokens_z * 32, shape[0]), *shape[1:]]
    base = min(resize_shape[1:])
    if base > max_smaller_edge:
        for j in (1, 2):
            resize_shape[j] = math.ceil(resize_shape[j] * max_smaller_edge / base)
    return resize_shape


def crop_resize(image: np.ndarray) -> np.ndarray | None:
    """(C, D, H, W) any dtype -> nonzero-cropped, resized uint8 (C, d, h, w)."""
    mask = (image > 0).any(0)
    if not mask.any():
        return None
    nz = np.nonzero(mask)
    lo = [int(a.min()) for a in nz]
    hi = [int(a.max()) + 1 for a in nz]
    image = image[:, lo[0]:hi[0], lo[1]:hi[1], lo[2]:hi[2]]
    target = tuple(get_resize(image.shape[1:]))
    lo_v, hi_v = float(image.min()), float(image.max())
    scaled = (image.astype(np.float32) - lo_v) / max(hi_v - lo_v, 1e-8)
    if target != image.shape[1:]:
        scaled = np.stack([resize_3d(c[None], target)[0] for c in scaled])
    return np.round(np.clip(scaled, 0, 1) * 255).astype(np.uint8)


def _load_any(path: Path) -> np.ndarray:
    """Image file or tensor -> (C, D, H, W)."""
    if path.name.endswith(".pt.zst"):
        arr = np.asarray(load_pt_zst(path))
        while arr.ndim < 4:
            arr = arr[None]
        return arr
    from PIL import Image

    arr = np.asarray(Image.open(path).convert("L"))
    return arr[None, None]


def process_study(study: dict, image_root: Path | None, save_dir: Path) -> dict | None:
    study = dict(study)
    new_paths = []
    shapes: list[list[int] | None] = []
    for i, image_path in enumerate(study["image"]):
        src = Path(image_path)
        if image_root is not None and not src.is_absolute():
            src = image_root / src
        rel = Path(*src.parts[-4:]) if len(src.parts) >= 4 else Path(src.name)
        save_path = (save_dir / rel).with_suffix("").with_suffix(".pt.zst")
        new_paths.append(str(save_path))
        if "modality" in study and study["modality"][i] == "X-Ray":
            study["modality"][i] = "X-ray"  # normalize (ref compress step)
        shape_path = save_path.with_suffix("").with_suffix(".shape.json")
        if save_path.exists() or not src.exists():
            # resume: recover the shape from the sidecar so re-runs emit
            # identical metadata without re-decoding the tensor
            shapes.append(
                json.loads(shape_path.read_text()) if shape_path.exists() else None
            )
            continue
        image = crop_resize(_load_any(src))
        if image is None:
            return None
        save_path.parent.mkdir(parents=True, exist_ok=True)
        tmp = save_path.with_name("." + save_path.name)
        save_pt_zst(image, tmp)
        tmp.rename(save_path)
        shape_path.write_text(json.dumps(list(image.shape)))
        shapes.append(list(image.shape))
    study["image"] = new_paths
    # per-image shapes: lets the multi-host plan pass (vl.probe_image_shape)
    # compute bucket keys without zstd-decoding the tensor
    if any(s is not None for s in shapes):
        study["shape"] = shapes
    return study


def compress_dataset(data_dir: Path, save_dir: Path, image_root: Path | None = None,
                     splits=("train", "validate", "test"), workers: int = 4) -> dict:
    """Every split's studies compressed into ``save_dir`` with its rewritten
    ``{split}.json``; returns ``{split: (kept, total)}``."""
    data_dir, save_dir = Path(data_dir), Path(save_dir)
    save_dir.mkdir(parents=True, exist_ok=True)
    counts = {}
    for split in splits:
        src = data_dir / f"{split}.json"
        if not src.exists():
            continue
        items = json.loads(src.read_text())
        with ThreadPoolExecutor(workers) as ex:
            results = list(ex.map(lambda st: process_study(st, image_root, save_dir), items))
        kept = [r for r in results if r is not None]
        (save_dir / f"{split}.json").write_text(json.dumps(kept, indent=1))
        print(f"{split}: {len(kept)}/{len(items)} studies compressed")
        counts[split] = (len(kept), len(items))
    return counts
