"""Vision-language (report / VQA / caption) dataset transform.

Equivalent of ``mmmm/data/dataset/vl.py``: samples one image (MIMIC-CXR
frontal-view preference), applies the z-patch + token-budget resize + pad +
CLIP normalization, and assembles a conversation from modality/plane Q&A,
caption, report, anomaly-checklist, or VQA turns by configured probabilities.
No grounding labels are produced (stage-2 training).

The port's own copy of ``mmmm_tpu/data/vl.py``. ``PIL`` is imported only where
a PNG or JPEG is opened; ``.pt`` images need ``torch`` alone.
"""
from __future__ import annotations

import dataclasses
import json
from pathlib import Path

import numpy as np

from .defs import ConvTurn, Split
from .input_builder import prepare_vlm_inputs
from .target_tax import get_target_tax
from .templates import gen_general_conv, gen_modality_conv, toss
from .tokenizer import MMMMTokenizer
from .transforms import (
    divisible_pad,
    divisible_pad_shape,
    ensure_rgb,
    get_max_resize,
    get_patch_size_z,
    intensity_norm,
    resize_3d,
)
from ..utils.io import load_pt_zst

CAPTION_PROMPTS = [
    "Briefly describe this {}.",
    "Provide a short description of this {}.",
    "Write a caption for this {}.",
    "What does this {} show, in brief?",
]
REPORT_PROMPTS = [
    "Please write a radiology report for this {}, including findings and impression.",
    "Provide a report with findings and impression for this {}.",
    "Generate a detailed radiology report for the given {}.",
    "What are the findings and impression for this {}?",
    "Examine the {} and produce a clinical report with findings and impression.",
    "Report on this {}.",
]
FINDINGS_PROMPTS = [
    "What are the findings in this {}?",
    "Write the findings section of the report for this {}.",
    "Describe the findings visible in this {}.",
]
PLANE_PROMPTS = [
    "In what plane is this {} acquired?",
    "What imaging plane is shown here?",
    "Which plane is the {} in?",
]
REFERRINGS = [
    "image", "medical image", "radiograph", "scan", "radiology image",
    "radiology scan", "medical scan",
]


def load_image_any(path) -> np.ndarray:
    """Load an image file to (C, D, H, W) uint8; 2-D images get depth 1."""
    path = Path(path)
    if path.name.endswith(".pt.zst"):
        arr = load_pt_zst(path)
    elif path.suffix == ".pt":
        import torch

        arr = torch.load(path, map_location="cpu", weights_only=False).numpy()
    else:
        from PIL import Image

        img = np.asarray(Image.open(path))
        if img.ndim == 2:
            img = img[None]
        else:
            img = img.transpose(2, 0, 1)
        arr = img[:, None]  # (C, 1, H, W)
    assert arr.dtype == np.uint8, arr.dtype
    return arr


def probe_image_shape(path, data: dict | None = None, idx: int | None = None) -> tuple[int, int, int, int]:
    """(C, D, H, W) of an image file WITHOUT decoding pixels when possible.

    Order: per-item ``shape`` metadata (emitted by the VL converters) ->
    PIL header read (jpg/png: lazy, no pixel decode) -> full load (``.pt``
    containers without metadata; correct but slow — converters should emit
    ``shape``)."""
    if data is not None and data.get("shape") is not None and idx is not None:
        s = data["shape"][idx]
        if s is not None:
            s = tuple(int(x) for x in s)
            return s if len(s) == 4 else (s[0], 1, *s[1:])
    path = Path(path)
    if path.name.endswith(".pt.zst") or path.suffix == ".pt":
        return tuple(load_image_any(path).shape)
    from PIL import Image

    with Image.open(path) as img:
        w, h = img.size
        c = len(img.getbands())
    return (c, 1, h, w)


def get_vl_data_list(dataset_dir: Path, split: Split = Split.TRAIN, processed: bool | None = None) -> list[dict]:
    dataset_dir = Path(dataset_dir)
    name = dataset_dir.name
    if processed is None:
        processed = (dataset_dir / f"{split.value}-processed.json").exists()
    fname = f"{split.value}-processed.json" if processed else f"{split.value}.json"
    data = json.loads((dataset_dir / fname).read_text())
    for item in data:
        item["dataset"] = name
    return data


@dataclasses.dataclass(kw_only=True)
class VLTransConf:
    max_tokens: int = 144
    max_tokens_z: int = 4
    log2_patch_size_z_std: float = 0.25
    ac_ratio: float = 0.2  # anomaly-checklist instead of report
    modality_prob: float = 0.2
    plane_prob: float = 0.2
    report_ratio: float = 0.8  # report vs VQA when both available
    grid_quant: tuple[int, int, int] = (1, 4, 4)


class VLTransform:
    def __init__(self, conf, tokenizer: MMMMTokenizer, inference: bool = False, target_tax=None, seed=None):
        self.conf = conf
        self.tc: VLTransConf = conf.vl_trans
        self.tokenizer = tokenizer
        self.inference = inference
        self.target_tax = target_tax if target_tax is not None else get_target_tax()
        self.R = np.random.RandomState(seed)

    def __call__(self, data: dict, rng: np.random.RandomState | None = None, plan_only: bool = False) -> dict:
        conf, tc = self.conf, self.tc
        R = rng if rng is not None else self.R
        dataset = data["dataset"]
        candidates = np.arange(len(data["image"]))
        allow_report = True
        if dataset == "MIMIC-CXR" and data.get("plane"):
            frontal = np.asarray([p in ("PA", "AP") for p in data["plane"]])
            if frontal.all() or (frontal.any() and toss(R, 0.9)):
                candidates = candidates[frontal]
            else:
                candidates = candidates[~frontal]
                allow_report = False
        idx = int(R.choice(candidates))
        image_path = data["image"][idx]
        modality = data["modality"][idx] if data.get("modality") else None
        plane = data["plane"][idx] if data.get("plane") else None

        if plan_only:
            image = None
            c_in, *spatial_in = probe_image_shape(image_path, data, idx)
        else:
            image = load_image_any(image_path).astype(np.float32) / 255.0
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
        padded = divisible_pad_shape(resize, stride)
        tokens = tuple(s // st for s, st in zip(padded, stride))
        qgrid = tuple(int(-(-t // q) * q) for t, q in zip(tokens, tc.grid_quant))
        target_shape = tuple(g * st for g, st in zip(qgrid, stride))
        if not plan_only:
            image = resize_3d(image, resize)
            image, _ = divisible_pad(image, stride)
            image = np.pad(image, [(0, 0), *[(0, t - s) for t, s in zip(target_shape, image.shape[1:])]])
            image = ensure_rgb(image)
            image = intensity_norm(image)

        referring = R.choice(REFERRINGS)
        conversation: list[ConvTurn] = []
        caption = data.get("processed_caption")
        report = data.get("processed_report") if allow_report else None
        vqa = data.get("vqa")
        force = not caption and not report and not vqa
        if modality and (force or toss(R, tc.modality_prob)):
            conversation += gen_modality_conv(modality, R)
        if plane and (force or toss(R, tc.plane_prob)):
            conversation.append(ConvTurn(R.choice(PLANE_PROMPTS).format(referring), plane))
        R.shuffle(conversation)
        if caption:
            conversation.append(ConvTurn(R.choice(CAPTION_PROMPTS).format(referring), caption))
        elif report and (not vqa or toss(R, tc.report_ratio)):
            pos, neg = data.get("anomaly_pos") or [], data.get("anomaly_neg") or []
            if (pos or neg) and toss(R, tc.ac_ratio):
                ac_conv, _ = gen_general_conv(
                    pos, neg, False, False, self.tokenizer, self.target_tax, R
                )
                conversation += ac_conv
            else:
                conversation.append(ConvTurn(R.choice(REPORT_PROMPTS).format(referring), report))
        elif vqa:
            conv_vqa = [ConvTurn(qa["question"], qa["answer"]) for qa in vqa]
            R.shuffle(conv_vqa)
            conversation += conv_vqa

        num_image_tokens = int(np.prod(qgrid))
        vlm_inputs, text = prepare_vlm_inputs(
            conversation, self.tokenizer, num_image_tokens,
            inference=self.inference, grounding=False,
            max_seq_len=conf.max_seq_len, bop_weight=1.0,
        )
        if plan_only:
            return {
                "plan": True,
                "src": (dataset, str(image_path)),
                "image_shape": (3 if c_in == 1 else c_in, *target_shape),
                "patch_size": (patch_size_z, conf.vit_patch_size_xy, conf.vit_patch_size_xy),
                "pool_size": (pool_size_z, conf.pool_size_xy, conf.pool_size_xy),
                "grounding": False,
                "instance": False,
                "labels_present": not self.inference,
                "seq_len": len(vlm_inputs.input_ids),
            }
        return {
            "src": (dataset, str(image_path)),
            "image": image.astype(np.float32),
            "grounding_image": None,
            "patch_size": (patch_size_z, conf.vit_patch_size_xy, conf.vit_patch_size_xy),
            "pool_size": (pool_size_z, conf.pool_size_xy, conf.pool_size_xy),
            "vlm_inputs": vlm_inputs,
            "masks": None,
            "boxes": None,
            "index_offsets": None,
            "instance": False,
            "grounding": False,
            "text": text,
        }
