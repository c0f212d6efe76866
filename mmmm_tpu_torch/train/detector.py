"""The pseudo-box detector's training and inference, the port of
``scripts/data/detector.py`` (``train``: fit on a processed VinDr-CXR set of
fused boxes, log mAP@0.5 on a held-out tail, save ``params.npz``;
``infer``: write ``{stem}_box.json`` for tagged studies, the input of the
grounded-report transform's instance grounding, ``data/grg.py``).

File reading is kept apart from the functions on arrays, so a caller with
cases in memory (``chip_smoke.py``, on a machine without ``zstandard`` or
``PIL``) drives the same code: ``case_from_arrays`` builds a training case,
``train_detector`` fits over a sequence of them, ``infer_images`` runs over
tagged items. The optimizer is the script's ``chain(clip_by_global_norm(0.1),
adamw(cosine_decay_schedule(lr, steps), weight_decay=1e-4))``.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Callable, Sequence

import numpy as np
import torch

from ..models.detector import (VINDR_CLASSES, DetectorConfig, compute_map, detector_forward,
                               detector_loss, equalize_image, init_detector_params,
                               select_boxes)
from ..ops._cuda import resolve_device
from ..params import _flatten
from .optim import AdamW, OptimizerConfig


def detector_config(size: int, layers: int, queries: int) -> DetectorConfig:
    """The commands' configuration from their ``--size``, ``--layers`` and
    ``--queries``."""
    return DetectorConfig(image_size=size, enc_layers=layers, dec_layers=layers,
                          num_queries=queries, max_gt=min(24, queries))


def _nearest_index(n: int, size: int) -> np.ndarray:
    return np.clip((np.arange(size) + 0.5) * n / size, 0, n - 1).astype(np.int64)


def nearest_resize(img: np.ndarray, size: int) -> np.ndarray:
    """(H, W) -> (size, size), nearest, as the script resizes."""
    h, w = img.shape
    return img[_nearest_index(h, size)][:, _nearest_index(w, size)]


def case_from_arrays(image: np.ndarray, sparse, size: int, class_to_idx: dict,
                     max_gt: int):
    """One training case from a processed case's (H, W) image in [0, 1] and
    its ``Sparse``: (image (size, size, 1), boxes (max_gt, 4) normalized
    cxcywh, classes (max_gt,), valid (max_gt,))."""
    h, w = image.shape
    img = nearest_resize(np.asarray(image, np.float32), size)
    boxes = np.zeros((max_gt, 4), np.float32)
    classes = np.zeros((max_gt,), np.int32)
    valid = np.zeros((max_gt,), bool)
    i = 0
    for targets in sparse.targets.values():
        for t in targets:
            if t.boxes is None or t.name not in class_to_idx:
                continue
            for b in np.asarray(t.boxes, np.float64):
                if i >= max_gt:
                    break
                # (d0, h0, w0, d1, h1, w1) -> normalized cxcywh
                y0, x0, y1, x1 = b[1] / h, b[2] / w, b[4] / h, b[5] / w
                boxes[i] = [(x0 + x1) / 2, (y0 + y1) / 2, x1 - x0, y1 - y0]
                classes[i] = class_to_idx[t.name]
                valid[i] = True
                i += 1
    return img[..., None], boxes, classes, valid


def load_case(case_dir: Path, size: int, class_to_idx: dict, max_gt: int):
    """``case_from_arrays`` over a processed case directory
    (``sparse.json``, ``images.pt.zst``)."""
    from ..data.sparse import Sparse
    from ..utils import load_pt_zst

    sp = Sparse.from_json((case_dir / "sparse.json").read_bytes())
    img = load_pt_zst(case_dir / "images.pt.zst")  # (1, D, H, W) uint8
    return case_from_arrays(np.asarray(img[0, 0], np.float32) / 255.0, sp, size,
                            class_to_idx, max_gt)


class CaseDirs(Sequence):
    """The processed cases of ``data_dir/data`` as a lazy sequence of
    training cases (each read when it is indexed, as the script reads)."""

    def __init__(self, data_dir: Path, cfg: DetectorConfig):
        root = Path(data_dir) / "data"
        self.dirs = sorted(p for p in root.iterdir() if (p / "sparse.json").exists())
        self.cfg = cfg
        self.class_to_idx = {n: i for i, n in enumerate(VINDR_CLASSES)}

    def __len__(self) -> int:
        return len(self.dirs)

    def __getitem__(self, i):
        return load_case(self.dirs[i], self.cfg.image_size, self.class_to_idx, self.cfg.max_gt)


def _batch_tensors(cases, idx, device):
    batch = [cases[int(i)] for i in idx]
    images, gb, gc, gv = (np.stack([b[j] for b in batch]) for j in range(4))
    return (torch.from_numpy(images).to(device), torch.from_numpy(gb).to(device),
            torch.from_numpy(gc).long().to(device), torch.from_numpy(gv).to(device))


def detector_optimizer(lr: float, steps: int) -> AdamW:
    """``chain(clip_by_global_norm(0.1), adamw(cosine_decay_schedule(lr,
    steps), weight_decay=1e-4))``."""
    return AdamW(OptimizerConfig(lr=lr, weight_decay=1e-4, max_steps=steps, grad_clip_norm=0.1,
                                 form="plain_adamw_cosine"))


def evaluate_map(params, cfg: DetectorConfig, cases, device) -> float:
    """mAP@0.5 of the detector's top class a query over ``cases``, one image
    at a time, as the script's held-out gauge."""
    dets, gts = [], []
    for img, gb, gc, gv in cases:
        with torch.no_grad():
            out = detector_forward(params, cfg, torch.from_numpy(img[None]).to(device))
        prob = 1 / (1 + np.exp(-out["class_logits"][0].cpu().numpy().astype(np.float64)))
        bx = out["boxes"][0].cpu().numpy()
        xyxy = np.clip(np.concatenate([bx[:, :2] - bx[:, 2:] / 2, bx[:, :2] + bx[:, 2:] / 2],
                                      -1), 0, 1)
        dets.append({"boxes": xyxy, "scores": prob.max(-1), "classes": prob.argmax(-1)})
        v = gv.astype(bool)
        g = gb.astype(np.float32)
        gts.append({"boxes": np.concatenate([g[:, :2] - g[:, 2:] / 2, g[:, :2] + g[:, 2:] / 2],
                                            -1)[v], "classes": gc[v]})
    return compute_map(dets, gts, cfg.num_classes)


def train_detector(cfg: DetectorConfig, cases: Sequence, *, steps: int, batch: int,
                   lr: float = 2e-4, seed: int = 0, log_every: int = 50,
                   eval_frac: float = 0.1, device: str | torch.device = "cuda",
                   params: dict | None = None, log: Callable[[str], None] = print,
                   on_step: Callable[[int, torch.Tensor], None] | None = None) -> dict:
    """Fit the detector over ``cases`` (a sequence of ``case_from_arrays``
    tuples): each step draws ``batch`` indices from ``np.random.
    default_rng(seed)``, as the script does; ``params`` replaces the seeded
    init; ``on_step(it, loss)`` is called after each step. Returns
    ``{"params", "losses" (every step's loss, on the host), "map" (mAP@0.5
    over the last ``max(1, int(len(cases) eval_frac))`` cases, or None)}``."""
    dev = resolve_device(device)
    if params is None:
        params = init_detector_params(cfg, seed, dev)
    flat = _flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    opt = detector_optimizer(lr, steps)
    opt_state = opt.init(flat)
    rng = np.random.default_rng(seed)
    losses = []
    for it in range(steps):
        idx = rng.integers(0, len(cases), batch)
        loss = detector_loss(params, cfg, *_batch_tensors(cases, idx, dev))
        grads = torch.autograd.grad(loss, list(flat.values()))
        opt.step(flat, dict(zip(flat, grads)), opt_state)
        loss = loss.detach()
        losses.append(loss)
        if on_step is not None:
            on_step(it, loss)
        if it % log_every == 0:
            log(f"[{it}] loss={float(loss):.4f}")
    result = {"params": params, "losses": [float(x) for x in losses], "map": None}
    if eval_frac > 0:
        n_eval = max(1, int(len(cases) * eval_frac))
        ap = evaluate_map(params, cfg, [cases[i] for i in range(len(cases) - n_eval, len(cases))],
                          dev)
        log(f"mAP@0.5 (held-out {n_eval}) = {ap:.4f}")
        result["map"] = ap
    return result


def read_image(path: Path) -> np.ndarray:
    """An image file as (H, W) float32: ``.pt.zst`` / ``.zst`` and ``.pt``
    volumes take their first channel and slice; other files are read with
    PIL as luminance."""
    path = Path(path)
    if path.suffix == ".zst" or path.suffix == ".pt":
        from ..data.vl import load_image_any
        from ..utils import load_pt_zst

        arr = load_image_any(path) if path.suffix == ".pt" else load_pt_zst(path)
        arr = np.asarray(arr, np.float32)
        while arr.ndim > 2:
            arr = arr[0]
        return arr
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"), np.float32)


def infer_images(params, cfg: DetectorConfig, items: list, out_dir: Path, *,
                 image_root: Path | None = None, score_th: float = 0.1,
                 device: str | torch.device = "cuda") -> int:
    """Write ``{stem}_box.json`` for every existing image of every tagged
    item (``{"image": [paths], "tags": [{"target": name}, ...]}``): the
    image equalized, resized (nearest) to the training size, one forward,
    then ``select_boxes`` over the item's tagged VinDr classes. Returns the
    number of files written."""
    dev = resolve_device(device)
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    n_written = 0
    for item in items:
        tagged = sorted({t["target"] for t in item.get("tags", [])
                         if t.get("target") in VINDR_CLASSES})
        for image_rel in item["image"]:
            img_path = Path(image_root) / image_rel if image_root else Path(image_rel)
            if not img_path.exists():
                continue
            raw = read_image(img_path)
            h, w = raw.shape
            eq = equalize_image(raw).astype(np.float32) / 255.0
            net_in = torch.from_numpy(nearest_resize(eq, cfg.image_size)[None, ..., None])
            with torch.no_grad():
                out = detector_forward(params, cfg, net_in.to(dev))
            results = select_boxes(out["class_logits"][0].float().cpu().numpy(),
                                   out["boxes"][0].float().cpu().numpy(), tagged, (h, w),
                                   score_th=score_th)
            stem = img_path.name.split(".")[0]
            (out_dir / f"{stem}_box.json").write_text(json.dumps(results, indent=2))
            n_written += 1
    return n_written
