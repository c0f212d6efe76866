"""Sparse per-case metadata schema (``mmmm/data/sparse.py`` equivalent).

JSON layout is compatible with the reference's mashumaro/ORJSON serialization
so processed datasets interoperate: numpy fields serialize as nested lists,
targets keyed by category ("anatomy" / "anomaly").

The port's own copy of ``mmmm_tpu/data/sparse.py``.
"""
from __future__ import annotations

import dataclasses
import json
from typing import Any

import numpy as np


@dataclasses.dataclass
class Target:
    """One class present in the case (possibly multiple instances).

    Attributes mirror ``Sparse.Target`` (``sparse.py:45-63``):
      semantic: instances merged in the mask (boxes less meaningful);
      position_offset: range into class_positions.pt;
      index_offset: range into the mask channel axis;
      boxes: (N, 6) MONAI StandardMode corners (x0, y0, z0, x1, y1, z1).
    """

    name: str
    semantic: bool
    position_offset: tuple[int, int] | None = None
    index_offset: tuple[int, int] | None = None
    mask_sizes: np.ndarray | None = None
    boxes: np.ndarray | None = None

    def to_dict(self) -> dict:
        return {
            "name": self.name,
            "semantic": self.semantic,
            "position_offset": list(self.position_offset) if self.position_offset else None,
            "index_offset": list(self.index_offset) if self.index_offset else None,
            "mask_sizes": None if self.mask_sizes is None else np.asarray(self.mask_sizes).tolist(),
            "boxes": None if self.boxes is None else np.asarray(self.boxes).tolist(),
        }

    @classmethod
    def from_dict(cls, d: dict) -> "Target":
        return cls(
            name=d["name"],
            semantic=d["semantic"],
            position_offset=tuple(d["position_offset"]) if d.get("position_offset") else None,
            index_offset=tuple(d["index_offset"]) if d.get("index_offset") else None,
            mask_sizes=None if d.get("mask_sizes") is None else np.asarray(d["mask_sizes"], np.int64),
            boxes=None if d.get("boxes") is None else np.asarray(d["boxes"], np.int64),
        )


@dataclasses.dataclass
class Sparse:
    spacing: np.ndarray  # (3,) float64
    shape: np.ndarray  # (3,) int64 (D, H, W)
    modalities: list[str]
    mean: np.ndarray  # per-modality intensity mean
    std: np.ndarray
    targets: dict[str, list[Target]]  # category -> targets
    neg_targets: dict[str, list[str]]  # category -> class names surely absent
    complete_anomaly: bool = False
    extra: Any = None

    def to_json(self) -> bytes:
        d = {
            "spacing": self.spacing.tolist(),
            "shape": self.shape.tolist(),
            "modalities": self.modalities,
            "mean": np.asarray(self.mean).tolist(),
            "std": np.asarray(self.std).tolist(),
            "targets": {k: [t.to_dict() for t in v] for k, v in self.targets.items()},
            "neg_targets": self.neg_targets,
            "complete_anomaly": self.complete_anomaly,
            "extra": self.extra,
        }
        return json.dumps(d, indent=2).encode()

    @classmethod
    def from_json(cls, raw: bytes | str) -> "Sparse":
        d = json.loads(raw)
        return cls(
            spacing=np.asarray(d["spacing"], np.float64),
            shape=np.asarray(d["shape"], np.int64),
            modalities=d["modalities"],
            mean=np.asarray(d["mean"], np.float32),
            std=np.asarray(d["std"], np.float32),
            targets={k: [Target.from_dict(t) for t in v] for k, v in d["targets"].items()},
            neg_targets=d["neg_targets"],
            complete_anomaly=d.get("complete_anomaly", False),
            extra=d.get("extra"),
        )
