"""Stage-0 patch sampling pipeline (``mmmm/models/sam/data.py`` equivalent).

Per case: sample a static patch shape (bucketed), force-fit foreground by
centering on a random voxel of a random present class with probability
``fg_prob`` (the reference precomputes ``class_positions.pt`` for this;
positions are recovered from the masks when absent), crop + pad, sample
positive/negative classes up to ``max_classes``, and apply intensity
augmentation (scale / shift / noise / gamma). Output shapes are fully static:
(image, class_idx, class_valid, masks).

The port's own copy of ``mmmm_tpu/data/align.py``.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

import numpy as np

from .sparse import Sparse
from ..utils.io import load_pt_zst


@dataclasses.dataclass(kw_only=True)
class AlignTransConf:
    patch_shape: tuple[int, int, int] = (16, 128, 128)
    patch_size_z: int = 8  # static ViT z patch for this bucket
    max_classes: int = 4
    num_neg: int = 1
    fg_prob: float = 0.9
    intensity_aug: bool = True


class AlignPatchTransform:
    def __init__(self, conf: AlignTransConf, class_to_idx: dict[str, int], seed=None):
        self.conf = conf
        self.class_to_idx = class_to_idx
        self.R = np.random.RandomState(seed)

    def _augment(self, image: np.ndarray) -> np.ndarray:
        R = self.R
        if R.uniform() < 0.3:
            image = image * R.uniform(0.8, 1.2)
        if R.uniform() < 0.3:
            image = image + R.uniform(-0.1, 0.1)
        if R.uniform() < 0.2:
            image = image + R.normal(0, 0.03, image.shape).astype(np.float32)
        if R.uniform() < 0.2:
            image = np.clip(image, 0, None) ** R.uniform(0.8, 1.25)
        return np.clip(image, 0.0, 1.0)

    def __call__(self, data: dict) -> dict:
        conf, R = self.conf, self.R
        case_dir = Path(data["dataset_dir"]) / "data" / data["key"]
        sparse = Sparse.from_json((case_dir / "sparse.json").read_bytes())
        images = load_pt_zst(case_dir / "images.pt.zst")
        mi = R.randint(len(sparse.modalities)) if len(sparse.modalities) > 1 else 0
        image = images[mi : mi + 1].astype(np.float32) / 255.0
        masks_all = load_pt_zst(case_dir / "masks.pt.zst")

        targets = [t for ts in sparse.targets.values() for t in ts if t.index_offset]
        neg_names = [n for ns in sparse.neg_targets.values() for n in ns]
        spatial = np.asarray(image.shape[1:])
        patch = np.asarray(conf.patch_shape)

        # choose crop origin: fg-forced around a random voxel of a random class
        origin = np.zeros(3, np.int64)
        chosen = None
        if targets and R.uniform() < conf.fg_prob:
            chosen = targets[R.randint(len(targets))]
            m = masks_all[slice(*chosen.index_offset)].any(axis=0)
            fg = np.argwhere(m)
            if len(fg):
                center = fg[R.randint(len(fg))]
                origin = np.clip(center - patch // 2, 0, np.maximum(spatial - patch, 0))
        else:
            hi = np.maximum(spatial - patch, 0)
            origin = np.asarray([R.randint(h + 1) for h in hi])
        sl = tuple(slice(int(o), int(o + p)) for o, p in zip(origin, patch))
        crop = image[(slice(None), *sl)]
        pad = [(0, 0)] + [(0, int(p - s)) for p, s in zip(patch, crop.shape[1:])]
        crop = np.pad(crop, pad)

        # sample classes: present ones first (ensuring the fg class), then negatives
        pos_names = [t.name for t in targets if t.name in self.class_to_idx]
        R.shuffle(pos_names)
        if chosen is not None and chosen.name in self.class_to_idx:
            pos_names = [chosen.name] + [n for n in pos_names if n != chosen.name]
        pos_names = pos_names[: conf.max_classes - conf.num_neg]
        negs = [n for n in neg_names if n in self.class_to_idx]
        R.shuffle(negs)
        names = (pos_names + negs)[: conf.max_classes]

        n = conf.max_classes
        class_idx = np.zeros(n, np.int64)
        valid = np.zeros(n, bool)
        out_masks = np.zeros((n, *conf.patch_shape), np.float32)
        name_to_target = {t.name: t for t in targets}
        for i, name in enumerate(names):
            class_idx[i] = self.class_to_idx[name]
            valid[i] = True
            t = name_to_target.get(name)
            if t is not None:
                m = masks_all[slice(*t.index_offset)].any(axis=0)[sl]
                out_masks[i, : m.shape[0], : m.shape[1], : m.shape[2]] = m
        if conf.intensity_aug:
            crop = self._augment(crop)
        crop = np.repeat(crop, 3, axis=0) if crop.shape[0] == 1 else crop
        return {
            "image": crop.astype(np.float32),
            "patch_size": (conf.patch_size_z, 16, 16),
            "class_idx": class_idx,
            "class_valid": valid,
            "masks": out_masks,
        }


def collate_align(points: list[dict]) -> dict:
    return {
        "image": np.stack([p["image"] for p in points]),
        "patch_size": points[0]["patch_size"],
        "class_idx": np.stack([p["class_idx"] for p in points]),
        "class_valid": np.stack([p["class_valid"] for p in points]),
        "masks": np.stack([p["masks"] for p in points]),
    }
