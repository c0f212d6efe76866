"""The segmentation ablation, the port of ``scripts/seg_exp.py``: train the
3-D UNet (``models/unet.py``) or the text-prompted SAM head (one learned
prompt a class) on one processed segmentation dataset with DiceFocal
``per_channel``, then report per-class Dice on a held-out split.

``run_seg_exp(cfg, cases)`` is the experiment on arrays; ``load_cases``
reads a processed dataset (``images.pt.zst``, ``masks.pt.zst``,
``sparse.json``); ``SEG_EXP_DEFAULTS`` are the script's defaults, which a
``-c`` config and then the command's flags override. The optimizer is
``optax.adamw(cosine_decay_schedule(lr, steps), weight_decay)``: every leaf
decays, no clipping. The SAM arm's encoder attention goes through
``"auto"``: K4 forward on the card, the backward recomputed through the
plain version.
"""
from __future__ import annotations

from pathlib import Path
from typing import Callable

import numpy as np
import torch

from ..ops._cuda import resolve_device
from ..params import _flatten
from .optim import AdamW, OptimizerConfig

SEG_EXP_DEFAULTS = {
    "steps": 2000, "batch": 2, "patch": [32, 96, 96], "lr": 1e-3,
    "weight_decay": 5e-2, "channels": [16, 32, 64, 128],
    "val_frac": 0.2, "seed": 0, "log_every": 50,
}


def load_cases(data_dir: Path, classes: list[str]):
    """[(image (C, D, H, W) f32 in [0, 1], masks (K, D, H, W) bool)] per
    case of ``data_dir/data`` that has any of ``classes``."""
    from ..data.sparse import Sparse
    from ..utils import load_pt_zst

    cases = []
    for case_dir in sorted((Path(data_dir) / "data").iterdir()):
        sp_path = case_dir / "sparse.json"
        mask_path = case_dir / "masks.pt.zst"
        if not sp_path.exists() or not mask_path.exists():
            continue
        sp = Sparse.from_json(sp_path.read_bytes())
        img = np.asarray(load_pt_zst(case_dir / "images.pt.zst"), np.float32) / 255.0
        masks_all = np.asarray(load_pt_zst(mask_path))
        sem = np.zeros((len(classes), *img.shape[1:]), bool)
        found = False
        for targets in sp.targets.values():
            for t in targets:
                if t.name in classes and t.index_offset is not None:
                    lo, hi = t.index_offset
                    sem[classes.index(t.name)] |= masks_all[lo:hi].any(0)
                    found = True
        if found:
            cases.append((img, sem))
    return cases


def sample_patch(rng, image, masks, patch):
    """Foreground-biased patch crop (ref base.py patch sampling)."""
    shape = image.shape[1:]
    patch = tuple(min(p, s) for p, s in zip(patch, shape))
    if rng.random() < 0.5 and masks.any():
        k = rng.choice(np.nonzero(masks.any((1, 2, 3)))[0])
        zz, yy, xx = np.nonzero(masks[k])
        i = rng.integers(len(zz))
        center = (zz[i], yy[i], xx[i])
        lo = [int(np.clip(c - p // 2, 0, s - p)) for c, p, s in zip(center, patch, shape)]
    else:
        lo = [rng.integers(0, s - p + 1) for p, s in zip(patch, shape)]
    sl = tuple(slice(a, a + p) for a, p in zip(lo, patch))
    return image[(slice(None), *sl)], masks[(slice(None), *sl)]


def sam_config(cfg: dict, in_channels: int):
    """The SAM arm's ``SamConfig``: the script's head (embed 256, 6 layers,
    8 heads, patch (4, 16, 16), pos-embed (8, 8, 8)) updated by the
    config's ``sam`` block."""
    from ..models.segvol import SamConfig

    kw = dict(in_channels=in_channels, embed_dim=256, encoder_num_layers=6,
              encoder_num_heads=8, patch_size=(4, 16, 16), pos_embed_shape=(8, 8, 8))
    kw.update({k: tuple(v) if isinstance(v, list) else v
               for k, v in (cfg.get("sam") or {}).items()})
    return SamConfig(**kw)


def build_model(cfg: dict, in_channels: int, device):
    """(params, forward) of the experiment's arm; ``forward(params,
    image (B, C, D, H, W))`` gives (B, K, D, H, W) logits."""
    n_cls, seed = len(cfg["classes"]), cfg["seed"]
    if cfg["model"] == "unet":
        from ..models.unet import init_unet_params, unet_forward

        params = init_unet_params(in_channels, n_cls, tuple(cfg["channels"]), seed, device)
        return params, unet_forward
    if cfg["model"] != "sam":
        raise ValueError(f"model must be 'unet' or 'sam', got {cfg['model']!r}")
    from ..models.segvol.sam import sam_forward
    from ..params import init_sam_params

    scfg = sam_config(cfg, in_channels)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    prompts = torch.randn(n_cls, scfg.embed_dim, generator=gen, device=device) * 0.02
    params = {"sam": init_sam_params(scfg, seed=seed, device=device), "prompts": prompts}

    def forward(params, image):
        pr = params["prompts"][None].expand(image.shape[0], -1, -1)
        return sam_forward(params["sam"], scfg, image, scfg.patch_size, pr)[0]

    return params, forward


def seg_loss(logits, target):
    """The mean of DiceFocal ``per_channel`` over fp32 logits."""
    from ..models.segvol.loss import DiceFocalLoss

    return DiceFocalLoss().per_channel(logits.float(), target).mean()


def val_dice(logits, target):
    """Per-class Dice of the thresholded prediction."""
    pred = torch.sigmoid(logits.float()) > 0.5
    tgt = target > 0.5
    inter = (pred & tgt).sum((0, 2, 3, 4))
    denom = pred.sum((0, 2, 3, 4)) + tgt.sum((0, 2, 3, 4))
    return 2 * inter / denom.clamp(min=1)


def run_seg_exp(cfg: dict, cases: list, *, device: str | torch.device = "cuda",
                params: dict | None = None, log: Callable[[str], None] = print,
                on_step: Callable[[int, torch.Tensor], None] | None = None) -> dict:
    """Train ``cfg["model"]`` on the cases after the first
    ``max(1, int(len(cases) val_frac))`` and report Dice on those.
    ``cfg`` holds ``model``, ``classes``, ``steps``, ``batch``, ``patch``,
    ``lr``, ``weight_decay``, ``channels``, ``val_frac``, ``seed``,
    ``log_every`` and optionally ``sam``; ``cases`` are ``load_cases``
    pairs. ``params`` replaces the arm's seeded init; ``on_step(it,
    loss)`` is called after each step. Returns the results dict (model,
    per-class and mean Dice, rounded to 4 places)."""
    dev = resolve_device(device)
    if len(cases) < 2:
        raise ValueError(f"need >= 2 cases with {cfg['classes']}, found {len(cases)}")
    n_val = max(1, int(len(cases) * cfg["val_frac"]))
    val_cases, train_cases = cases[:n_val], cases[n_val:]
    log(f"{len(train_cases)} train / {len(val_cases)} val cases")
    init, forward = build_model(cfg, cases[0][0].shape[0], dev)
    params = init if params is None else params
    flat = _flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    opt = AdamW(OptimizerConfig(lr=cfg["lr"], weight_decay=cfg["weight_decay"],
                                max_steps=cfg["steps"], grad_clip_norm=None,
                                form="plain_adamw_cosine"))
    opt_state = opt.init(flat)
    rng = np.random.default_rng(cfg["seed"])
    patch = tuple(cfg["patch"])
    for it in range(cfg["steps"]):
        imgs, tgts = [], []
        for _ in range(cfg["batch"]):
            img, msk = train_cases[rng.integers(len(train_cases))]
            pi, pm = sample_patch(rng, img, msk, patch)
            imgs.append(pi)
            tgts.append(pm.astype(np.float32))
        image = torch.from_numpy(np.stack(imgs)).to(dev)
        target = torch.from_numpy(np.stack(tgts)).to(dev)
        loss = seg_loss(forward(params, image), target)
        # the SAM arm leaves the prompt encoder's point, box and mask
        # leaves unused: no gradient, which the optimizer takes as zeros
        grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        opt.step(flat, dict(zip(flat, grads)), opt_state)
        if on_step is not None:
            on_step(it, loss.detach())
        if it % cfg["log_every"] == 0:
            log(f"[{it}] loss={loss.item():.4f}")
    dices = []
    for img, msk in val_cases:
        pi, pm = sample_patch(rng, img, msk, patch)  # center-ish eval patch
        with torch.no_grad():
            logits = forward(params, torch.from_numpy(np.ascontiguousarray(pi[None])).to(dev))
            dices.append(val_dice(logits, torch.from_numpy(pm[None].astype(np.float32)).to(dev))
                         .cpu().numpy())
    per_class = np.stack(dices).mean(0)
    return {
        "model": cfg["model"],
        "dice": {c: round(float(d), 4) for c, d in zip(cfg["classes"], per_class)},
        "mean_dice": round(float(per_class.mean()), 4),
    }
