"""Self-label CT volumes with the aligned SAM head (pseudo-mask construction),
the port of ``scripts/data/self_label.py``.

Replaces the reference's vendored SAT inference for CT-RATE grounded-report
labels (``scripts/data/vg/CT-RATE/sat/inference.py``): instead of an external
text-prompted segmenter, the framework's own stage-0-aligned SAM produces the
per-target masks. For each case listed in a vg ``<split>.json`` it

  1. resolves the tagged targets present in the report,
  2. runs the SAM head with those classes' frozen prompt embeddings
     (``models/segvol/sam.py sam_forward``, then a sigmoid; the encoder's
     attention is K4 on the card, once a layer),
  3. thresholds the sigmoid masks and writes ``{key}_seg.pt.zst`` +
     ``{key}_seg.json`` — exactly the files ``data/grg.py`` consumes.

The JAX script ``jit``s the SAM call; here it runs eagerly under
``torch.inference_mode()``. Volumes are resized on the host
(``data/transforms.py resize_3d``) before and after, as there.
"""
from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import torch

from ..data.transforms import resize_3d
from ..data.vl import load_image_any
from ..models.segvol import SamConfig
from ..models.segvol.sam import sam_forward
from ..ops._cuda import resolve_device
from ..params import map_tree
from ..utils.io import save_pt_zst


def sam_probabilities(params: dict, cfg: SamConfig, patch_size, device):
    """``probs(image (1, 3, D, H, W), prompts (1, N, C)) -> (N, D, H, W)``:
    the sigmoid of SAM's semantic mask logits, numpy in, numpy out, over
    ``params`` moved to ``device``."""
    dev = resolve_device(device)
    params = map_tree(lambda t: torch.as_tensor(t).to(dev), params)
    patch = tuple(patch_size)

    def probs(image: np.ndarray, prompts: np.ndarray) -> np.ndarray:
        with torch.inference_mode():
            masks, _ = sam_forward(params, cfg, torch.as_tensor(image, device=dev), patch,
                                   torch.as_tensor(prompts, device=dev))
            return torch.sigmoid(masks)[0].cpu().numpy()

    return probs


def self_label(vg_dir: Path, probs_fn, embeddings: dict, *, shape, split: str = "train",
               threshold: float = 0.5, max_targets: int = 8, limit: int | None = None) -> int:
    """Label every case of ``vg_dir/<split>.json`` with tagged targets in
    ``embeddings`` and no ``{key}_seg.pt.zst`` yet: the volume resized to
    ``shape`` (grid x patch), ``probs_fn`` (:func:`sam_probabilities`),
    the probabilities resized back and thresholded. Returns the number of
    cases labeled."""
    vg_dir = Path(vg_dir)
    items = json.loads((vg_dir / f"{split}.json").read_text())
    if limit:
        items = items[:limit]
    done = 0
    for item in items:
        key = item.get("key") or Path(str(item["image"][0])).name.split(".")[0]
        out_seg = vg_dir / f"{key}_seg.pt.zst"
        if out_seg.exists():
            continue
        targets = sorted({t["target"] for t in item.get("tags", []) if t["target"] in embeddings})
        targets = targets[:max_targets]
        if not targets:
            continue
        vol = load_image_any(vg_dir / item["image"][0]).astype(np.float32) / 255.0
        orig_shape = vol.shape[1:]
        vol = resize_3d(vol, tuple(shape))
        if vol.shape[0] == 1:
            vol = np.repeat(vol, 3, axis=0)
        prompts = np.stack([embeddings[t] for t in targets])[None]  # (1, N, C)
        probs = probs_fn(vol[None], prompts)  # (N, D, H, W)
        probs = resize_3d(np.asarray(probs), orig_shape)
        masks = (probs > threshold).astype(bool)
        save_pt_zst(masks, out_seg)
        (vg_dir / f"{key}_seg.json").write_text(json.dumps(targets))
        done += 1
        print(f"[{done}] {key}: {len(targets)} targets, fg voxels {int(masks.sum())}", flush=True)
    print(f"labeled {done} cases")
    return done
