"""Grounded-report-generation dataset transform (stage 3).

Equivalent of ``mmmm/data/dataset/grg.py``: loads the vg-processed image and
its LLM-derived phrase tags, injects ``<p> ... </p>`` around each tagged
report span, and attaches per-phrase labels — 2-D pseudo-boxes for MIMIC-CXR
(``{key}_box.json``) or 3-D pseudo-masks for CT-RATE (``{key}_seg.pt.zst`` +
``{key}_seg.json`` target list). Tags without labels stay ungrounded in the
loss via the label mask; seq-len truncation drops trailing targets
(``handle_truncation_``, ``grg.py:71-82``).

Divergence note: the reference's box-gathering loop appends a stale loop
variable for every selected tag (``grg.py:178``), attaching the *last* class's
boxes to all tags; this implementation attaches each tag's own boxes.

The port's own copy of ``mmmm_tpu/data/grg.py``.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .defs import ConvTurn, Split
from .input_builder import prepare_vlm_inputs
from .tokenizer import MMMMTokenizer
from .transforms import (
    corners_to_center_size,
    divisible_pad,
    divisible_pad_shape,
    ensure_rgb,
    get_max_resize,
    get_patch_size_z,
    intensity_norm,
    resize_3d,
    scale_boxes,
    shift_boxes,
)
from .vl import REFERRINGS, REPORT_PROMPTS, load_image_any
from ..utils.io import load_pt_zst


def get_grg_data_list(dataset_dir: Path, split: Split = Split.TRAIN) -> list[dict]:
    dataset_dir = Path(dataset_dir)
    name = dataset_dir.name
    data = json.loads((dataset_dir / f"{split.value}.json").read_text())
    if name == "MIMIC-CXR":
        data = [d for d in data if any(p in ("PA", "AP") for p in d.get("plane", []))]
    for item in data:
        item["dataset"] = name
        item["dataset_dir"] = str(dataset_dir)
    return data


@dataclasses.dataclass(kw_only=True)
class GRGTransConf:
    max_tokens: int = 144
    max_tokens_z: int = 4
    log2_patch_size_z_std: float = 0.25
    grounding_prob: float = 0.99
    max_num_vg_mask: int = 8
    max_num_vg_box: int = 8
    equalize: bool = False
    grid_quant: tuple[int, int, int] = (1, 4, 4)


def equalize_uint8(image: np.ndarray) -> np.ndarray:
    """Per-channel histogram equalization of a uint8 array (torchvision
    ``equalize`` analog, used by phase-grg)."""
    out = np.empty_like(image)
    for c in range(image.shape[0]):
        hist = np.bincount(image[c].reshape(-1), minlength=256)
        nonzero = hist[hist > 0]
        if len(nonzero) <= 1:
            out[c] = image[c]
            continue
        step = (hist.sum() - nonzero[-1]) // 255
        if step == 0:
            out[c] = image[c]
            continue
        lut = (np.cumsum(hist) - hist // 2) // step
        lut = np.clip(np.concatenate([[0], lut[:-1]]), 0, 255).astype(np.uint8)
        out[c] = lut[image[c]]
    return out


class GRGTransform:
    def __init__(self, conf, tokenizer: MMMMTokenizer, inference: bool = False, seed=None):
        self.conf = conf
        self.tc: GRGTransConf = conf.grg_trans
        self.tokenizer = tokenizer
        self.inference = inference
        self.R = np.random.RandomState(seed)

    def _reduce(self, mask: np.ndarray, max_num: int, R=None):
        R = R if R is not None else self.R
        if mask.sum() <= max_num:
            return mask
        on = np.nonzero(mask)[0]
        off = R.choice(on, int(mask.sum()) - max_num, replace=False)
        mask[off] = False
        return mask

    def __call__(self, data: dict, rng: np.random.RandomState | None = None, plan_only: bool = False) -> dict:
        conf, tc = self.conf, self.tc
        R = rng if rng is not None else self.R
        dataset = data["dataset"]
        base_dir = Path(data["dataset_dir"])
        candidates = np.arange(len(data["image"]))
        if dataset == "MIMIC-CXR" and data.get("plane"):
            frontal = np.asarray([p in ("PA", "AP") for p in data["plane"]])
            candidates = candidates[frontal]
        idx = int(R.choice(candidates))
        image_rel = data["image"][idx]
        key = data.get("key", Path(str(image_rel)).name.split(".")[0])
        image_path = base_dir / image_rel

        if plan_only:
            from .vl import probe_image_shape

            image = None
            c_in, *spatial_in = probe_image_shape(image_path, data, idx)
        else:
            image_u8 = load_image_any(image_path)
            if tc.equalize:
                image_u8 = equalize_uint8(image_u8)
            image = image_u8.astype(np.float32) / 255.0
            c_in, spatial_in = image.shape[0], image.shape[1:]

        size_z = spatial_in[0]
        patch_size_z, pool_size_z, stride_z, tokens_z = get_patch_size_z(
            conf.base_vit_patch_size_z, conf.base_pool_size_z, size_z,
            tc.max_tokens_z, tc.log2_patch_size_z_std, R,
        )
        stride = (stride_z, conf.stride_xy, conf.stride_xy)
        resize = (
            min(size_z, tokens_z * stride_z),
            *get_max_resize(spatial_in[1:], conf.stride_xy, tc.max_tokens // tokens_z),
        )

        # --- labels -------------------------------------------------------
        tags: list[dict] = data["tags"]
        grounding = bool(tags) and toss_prob(R, tc.grounding_prob)
        vg_label_mask = np.zeros(len(tags) if grounding else 0, bool)
        masks = boxes = index_offsets = None
        instance = False
        box_path = base_dir / f"{key}_box.json"
        seg_meta_path = base_dir / f"{key}_seg.json"
        if box_path.exists():
            instance = True
            if grounding:
                target_boxes = {}
                for name, bx in json.loads(box_path.read_text()).items():
                    bx = np.asarray(bx, np.float64)  # (N, 4) x0 y0 x1 y1
                    b3 = np.zeros((len(bx), 6), np.float64)
                    b3[:, 0], b3[:, 3] = 0, 1
                    b3[:, [2, 1, 5, 4]] = bx
                    target_boxes[name] = b3
                for i, tag in enumerate(tags):
                    if tag["target"] in target_boxes:
                        vg_label_mask[i] = True
                vg_label_mask = self._reduce(vg_label_mask, tc.max_num_vg_box, R)
                boxes_list, index_offsets_list, off = [], [], 0
                for i, tag in enumerate(tags):
                    if not vg_label_mask[i]:
                        continue
                    b = target_boxes[tag["target"]]
                    boxes_list.append(b)
                    index_offsets_list.append((off, off + len(b)))
                    off += len(b)
                if boxes_list:
                    boxes = np.round(np.concatenate(boxes_list)).astype(np.int64)
                    index_offsets = np.asarray(index_offsets_list, np.int64)
        elif grounding and seg_meta_path.exists():
            targets = json.loads(seg_meta_path.read_text())
            ref_masks = None if plan_only else load_pt_zst(base_dir / f"{key}_seg.pt.zst")
            t2i = {t: i for i, t in enumerate(targets)}
            for i, tag in enumerate(tags):
                if tag["target"] in t2i:
                    vg_label_mask[i] = True
            vg_label_mask = self._reduce(vg_label_mask, tc.max_num_vg_mask, R)
            if not plan_only:
                rows = [ref_masks[t2i[tag["target"]]] for i, tag in enumerate(tags) if vg_label_mask[i]]
                if rows:
                    masks = np.stack(rows).astype(np.float32)

        # --- spatial ------------------------------------------------------
        padded = divisible_pad_shape(resize, stride)
        tokens = tuple(s // st for s, st in zip(padded, stride))
        qgrid = tuple(int(-(-t // q) * q) for t, q in zip(tokens, tc.grid_quant))
        target_shape = tuple(g * st for g, st in zip(qgrid, stride))
        if not plan_only:
            orig_spatial = image.shape[1:]
            image = resize_3d(image, resize)
            if masks is not None:
                masks = resize_3d(masks, resize)
            if boxes is not None:
                boxes = scale_boxes(boxes, orig_spatial, resize)
            image, pad_before = divisible_pad(image, stride)
            if masks is not None:
                masks, _ = divisible_pad(masks, stride)
            if boxes is not None:
                boxes = shift_boxes(boxes, pad_before)
            extra = [(0, t - s) for t, s in zip(target_shape, image.shape[1:])]
            image = np.pad(image, [(0, 0), *extra])
            if masks is not None:
                masks = np.pad(masks, [(0, 0), *extra])
            if boxes is not None:
                boxes = corners_to_center_size(boxes, image.shape[1:])
            image = ensure_rgb(image)
            grounding_image = image
            image = intensity_norm(image)

        # --- conversation: tag-injected report ----------------------------
        report: str = data["ref_report"]
        if grounding:
            pieces, last = [], 0
            for tag in tags:
                start, end = tag["start"], tag["end"]
                if start > 1 and report[start - 1] == " ":
                    start -= 1  # keep the leading space inside the phrase (SP tokenization)
                pieces += [report[last:start], "<p>", report[start:end], "</p>"]
                last = end
            report = "".join([*pieces, report[last:]])
        conversation = [ConvTurn(R.choice(REPORT_PROMPTS).format(R.choice(REFERRINGS)), report)]
        num_image_tokens = int(np.prod(qgrid))
        vlm_inputs, text = prepare_vlm_inputs(
            conversation, self.tokenizer, num_image_tokens,
            inference=self.inference, grounding=grounding,
            max_seq_len=conf.max_seq_len, bop_weight=conf.bop_weight,
        )

        # truncation: targets whose </p> fell off the sequence lose labels
        num_prompts = int((vlm_inputs.input_ids[1:] == self.tokenizer.eop_token_id).sum())
        vg_label_mask = vg_label_mask[:num_prompts]
        num_targets = int(vg_label_mask.sum())
        if plan_only:
            return {
                "plan": True,
                "src": (dataset, str(image_path)),
                "image_shape": (3 if c_in == 1 else c_in, *target_shape),
                "patch_size": (patch_size_z, conf.vit_patch_size_xy, conf.vit_patch_size_xy),
                "pool_size": (pool_size_z, conf.pool_size_xy, conf.pool_size_xy),
                "grounding": grounding and num_targets > 0,
                "instance": instance,
                "labels_present": not self.inference,
                "seq_len": len(vlm_inputs.input_ids),
            }
        if masks is not None:
            masks = masks[:num_targets] if num_targets else None
        if boxes is not None and index_offsets is not None:
            index_offsets = index_offsets[:num_targets] if num_targets else None
            if index_offsets is not None:
                boxes = boxes[: index_offsets[-1, 1]]
            else:
                boxes = None

        return {
            "src": (dataset, str(image_path)),
            "image": image.astype(np.float32),
            "grounding_image": grounding_image.astype(np.float32),
            "patch_size": (patch_size_z, conf.vit_patch_size_xy, conf.vit_patch_size_xy),
            "pool_size": (pool_size_z, conf.pool_size_xy, conf.pool_size_xy),
            "vlm_inputs": vlm_inputs,
            "masks": None if masks is None else masks.round().astype(bool),
            "boxes": boxes,
            "index_offsets": index_offsets,
            "instance": instance,
            "grounding": grounding and num_targets > 0,
            "vg_label_mask": vg_label_mask,
            "text": text,
        }


def toss_prob(R, p):
    return R.uniform() < p
