"""Localized (segmentation/detection) dataset transform.

Equivalent of ``mmmm/data/dataset/local/transform.py``: per sample it

  1. loads ``sparse.json`` + ``images.pt.zst`` (+ ``masks.pt.zst``), picks a
     modality,
  2. samples positive/negative target classes per category and generates
     presence/anomaly conversations with optional ``<p>``-grounding,
  3. samples the z patch size (log-normal) and the in-plane resize that fits
     the vision-token budget, resizes, pads, applies random flips/rot90,
  4. builds semantic masks per grounded class (union over instances) — or, for
     box-only datasets (VinDr-CXR), instance boxes + index offsets,
  5. CLIP-normalizes the VLM image (grounding image stays min-max, following
     SegVol) and builds the packed VLM inputs.

TPU delta: the image is additionally padded up to a *quantized token grid*
(``quantize_grid``) so batches bucket into a small set of static shapes, and
the grounded-target axis is padded to ``max_targets`` downstream.

The port's own copy of ``mmmm_tpu/data/local.py``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .defs import Split
from .input_builder import VLMInputs, prepare_vlm_inputs
from .sparse import Sparse
from .target_tax import ANATOMY, ANOMALY, get_target_tax
from .templates import gen_anomaly_conv, gen_general_conv, gen_modality_conv, toss
from .tokenizer import MMMMTokenizer
from .transforms import (
    corners_to_center_size,
    divisible_pad,
    divisible_pad_shape,
    ensure_rgb,
    get_max_resize,
    get_patch_size_z,
    intensity_norm,
    rand_flips_rot90,
    resize_3d,
    sample_flips_rot90,
    scale_boxes,
    shift_boxes,
)
from ..utils.io import load_pt_zst


@dataclasses.dataclass(kw_only=True)
class LocalTransConf:
    """``LocalTransConf`` (``local/transform.py:59-72``) + bucketing knobs."""

    max_vision_tokens: int = 144
    max_tokens_z: int = 4
    log2_patch_size_z_std: float = 0.25
    num_pos: int = 2
    num_neg: int = 2
    modality_prob: float = 0.8
    grounding_prob: float = 0.99
    neg_grounding_prob: float = 0.2
    # TPU bucketing: token-grid quantization steps (z, h, w)
    grid_quant: tuple[int, int, int] = (1, 4, 4)


@dataclasses.dataclass(kw_only=True)
class DatasetConf:
    """Shared vision geometry (``_dataset.py:DatasetConf``)."""

    base_vit_patch_size_z: int = 16
    vit_patch_size_xy: int = 16
    pool_size_xy: int = 2
    base_pool_size_z: int = 2
    max_seq_len: int = 1024
    bop_weight: float = 1.0
    max_targets: int = 8  # static grounded-target axis
    max_instances: int = 16  # static instance-label axis
    # MIMIC-CXR negative-report (no anomaly_pos) target sampling share; None
    # disables the reweighting (ref datamodule.py:48-62; phase-vlm sets 0.2,
    # phase-grg 0.05 — conf/phase-*/data.yaml)
    mimic_cxr_neg_weight: float | None = None
    local_trans: LocalTransConf = dataclasses.field(default_factory=LocalTransConf)
    vl_trans: object | None = None  # VLTransConf (set for vl datasets)
    grg_trans: object | None = None  # GRGTransConf (set for grg datasets)

    @property
    def stride_xy(self) -> int:
        return self.vit_patch_size_xy * self.pool_size_xy


def quantize_grid(tokens: tuple[int, int, int], quant: tuple[int, int, int]) -> tuple[int, int, int]:
    return tuple(int(-(-t // q) * q) for t, q in zip(tokens, quant))


def get_local_data_list(dataset_dir: Path, split: Split = Split.TRAIN) -> list[dict]:
    dataset_dir = Path(dataset_dir)
    split_path = dataset_dir / "split.json"
    keys = None
    if split_path.exists():
        keys = set(json.loads(split_path.read_text())[split.value])
    data_dir = dataset_dir / "data"
    out = []
    for case_dir in sorted(data_dir.iterdir()):
        if keys is None or case_dir.name in keys:
            out.append({"dataset": dataset_dir.name, "dataset_dir": dataset_dir, "key": case_dir.name})
    return out


class LocalTransform:
    def __init__(
        self,
        conf: DatasetConf,
        tokenizer: MMMMTokenizer,
        inference: bool = False,
        target_tax: dict | None = None,
        seed: int | None = None,
    ):
        self.conf = conf
        self.tokenizer = tokenizer
        self.inference = inference
        self.target_tax = target_tax if target_tax is not None else get_target_tax()
        self.R = np.random.RandomState(seed)

    def _sample_targets(self, names, limit: int, category: str, R=None) -> list[str]:
        R = R if R is not None else self.R
        names = [n for n in names if (t := self.target_tax.get(n)) and t.category == category]
        if len(names) > limit:
            names = R.choice(names, limit, replace=False).tolist()
        return names

    def __call__(self, data: dict, rng: np.random.RandomState | None = None, plan_only: bool = False) -> dict:
        """Transform one sample; with ``plan_only`` skip all pixel IO/math and
        return only the bucket-determining metadata (host-invariant schedule).

        The plan path consumes the RNG identically to materialization, so a
        per-sample ``rng`` (``sampling.sample_rng``) makes plan and full
        results agree on every decision."""
        conf, tc = self.conf, self.conf.local_trans
        R = rng if rng is not None else self.R
        dataset_name = data["dataset"]
        case_dir = Path(data["dataset_dir"]) / "data" / data["key"]
        sparse = Sparse.from_json((case_dir / "sparse.json").read_bytes())
        if len(sparse.modalities) == 1:
            modality, mslice = sparse.modalities[0], slice(None)
        else:
            mi = R.randint(len(sparse.modalities))
            modality, mslice = sparse.modalities[mi], slice(mi, mi + 1)
        mask_path = case_dir / "masks.pt.zst"
        if plan_only:
            image = masks_all = None
            spatial_in = tuple(int(s) for s in np.asarray(sparse.shape))
        else:
            images = load_pt_zst(case_dir / "images.pt.zst")  # (M, D, H, W) uint8
            image = images[mslice].astype(np.float32) / 255.0
            masks_all = load_pt_zst(mask_path) if mask_path.exists() else None
            spatial_in = image.shape[1:]

        targets = {t.name: t for ts in sparse.targets.values() for t in ts}
        neg_targets = [n for ns in sparse.neg_targets.values() for n in ns]

        # conversations + grounded class ordering
        grounding = toss(R, tc.grounding_prob)
        neg_grounding = toss(R, tc.neg_grounding_prob) if grounding else False
        conv, grounded = [], []
        c1, g1 = gen_general_conv(
            self._sample_targets(targets, tc.num_pos, ANATOMY, R),
            self._sample_targets(neg_targets, tc.num_neg, ANATOMY, R),
            grounding, neg_grounding, self.tokenizer, self.target_tax, R,
        )
        conv += c1
        grounded += g1
        c2, g2 = gen_anomaly_conv(
            self._sample_targets(targets, tc.num_pos, ANOMALY, R),
            self._sample_targets(neg_targets, tc.num_neg, ANOMALY, R),
            grounding, neg_grounding, self.tokenizer, self.target_tax, dataset_name, R,
        )
        conv += c2
        grounded += g2
        grounded = grounded[: conf.max_targets]
        if not conv or toss(R, tc.modality_prob):
            conv = gen_modality_conv(modality, R) + conv

        # geometry: z patch + in-plane resize to token budget
        size_z = spatial_in[0]
        patch_size_z, pool_size_z, stride_z, tokens_z = get_patch_size_z(
            conf.base_vit_patch_size_z, conf.base_pool_size_z, size_z, tc.max_tokens_z,
            tc.log2_patch_size_z_std, R,
        )
        resize_hw = get_max_resize(spatial_in[1:], conf.stride_xy, tc.max_vision_tokens // tokens_z)
        resize = (min(size_z, tokens_z * stride_z), *resize_hw)
        stride = (stride_z, conf.stride_xy, conf.stride_xy)
        patch_size = (patch_size_z, conf.vit_patch_size_xy, conf.vit_patch_size_xy)
        pool_size = (pool_size_z, conf.pool_size_xy, conf.pool_size_xy)

        instance = not mask_path.exists()
        if plan_only:
            # shape-only simulation of resize -> pad -> flip/rot90 -> grid pad
            flips_k = sample_flips_rot90(R) if not self.inference else (None, 0)
            shape = divisible_pad_shape(resize, stride)
            if flips_k[1] % 2:
                shape = (shape[0], shape[2], shape[1])
            tokens = tuple(s // st for s, st in zip(shape, stride))
            qgrid = quantize_grid(tokens, tc.grid_quant)
            final_spatial = tuple(g * st for g, st in zip(qgrid, stride))
            num_image_tokens = int(np.prod(qgrid))
            vlm_inputs, _ = prepare_vlm_inputs(
                conv, self.tokenizer, num_image_tokens,
                inference=self.inference, grounding=grounding,
                max_seq_len=conf.max_seq_len, bop_weight=conf.bop_weight,
            )
            return {
                "plan": True,
                "src": (dataset_name, data["key"]),
                "image_shape": (3, *final_spatial),
                "patch_size": patch_size,
                "pool_size": pool_size,
                "grounding": grounding,
                "instance": instance,
                "labels_present": not self.inference,
                "seq_len": len(vlm_inputs.input_ids),
            }

        # labels for grounded classes
        if instance:
            boxes_list, index_offsets = [], np.zeros((len(grounded), 2), np.int64)
            off = 0
            for i, cname in enumerate(grounded):
                t = targets.get(cname)
                n = 0
                if t is not None and t.boxes is not None:
                    boxes_list.append(np.asarray(t.boxes, np.int64))
                    n = len(t.boxes)
                index_offsets[i] = (off, off + n)
                off += n
            boxes = (
                np.concatenate(boxes_list) if boxes_list else np.zeros((0, 6), np.int64)
            )
            sem_masks = None
        else:
            sem_masks = np.zeros((len(grounded), *image.shape[1:]), np.float32)
            for i, cname in enumerate(grounded):
                t = targets.get(cname)
                if t is not None and t.index_offset is not None:
                    sem_masks[i] = masks_all[slice(*t.index_offset)].any(axis=0)
            boxes, index_offsets = None, None

        # spatial: resize -> pad-to-stride -> rand flip/rot90
        orig_spatial = image.shape[1:]
        image = resize_3d(image, resize)
        if sem_masks is not None:
            sem_masks = resize_3d(sem_masks, resize)
        if boxes is not None and len(boxes):
            boxes = scale_boxes(boxes, orig_spatial, resize)
        image, pad_before = divisible_pad(image, stride)
        if sem_masks is not None:
            sem_masks, _ = divisible_pad(sem_masks, stride)
        if boxes is not None and len(boxes):
            boxes = shift_boxes(boxes, pad_before)
        if not self.inference:
            image, sem_masks, boxes = rand_flips_rot90(image, sem_masks, boxes, R)

        # TPU bucketing: pad to the quantized token grid
        tokens = tuple(s // st for s, st in zip(image.shape[1:], stride))
        qgrid = quantize_grid(tokens, tc.grid_quant)
        target_shape = tuple(g * st for g, st in zip(qgrid, stride))
        extra = [(0, t - s) for t, s in zip(target_shape, image.shape[1:])]
        image = np.pad(image, [(0, 0), *extra])
        if sem_masks is not None:
            sem_masks = np.pad(sem_masks, [(0, 0), *extra])

        if boxes is not None:
            boxes_cs = corners_to_center_size(boxes, image.shape[1:]) if len(boxes) else np.zeros((0, 6), np.float32)
        image = ensure_rgb(image)
        grounding_image = image
        image = intensity_norm(image)

        num_image_tokens = int(np.prod([s // st for s, st in zip(image.shape[1:], stride)]))
        vlm_inputs, text = prepare_vlm_inputs(
            conv, self.tokenizer, num_image_tokens,
            inference=self.inference, grounding=grounding,
            max_seq_len=conf.max_seq_len, bop_weight=conf.bop_weight,
        )
        return {
            "src": (dataset_name, data["key"]),
            "image": image.astype(np.float32),
            "grounding_image": grounding_image.astype(np.float32),
            "patch_size": patch_size,
            "pool_size": pool_size,
            "vlm_inputs": vlm_inputs,
            "masks": None if sem_masks is None else sem_masks.round().astype(bool),
            "boxes": None if boxes is None else boxes_cs,
            "index_offsets": index_offsets,
            "instance": instance,
            "grounding": grounding,
            "text": text,
        }
