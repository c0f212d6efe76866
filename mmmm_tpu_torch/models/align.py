"""Stage-0 SAM alignment, the port of ``mmmm_tpu/models/align.py``
(``AlignConfig``, ``align_training_step``): SAM or instance SAM trained
alone against frozen per-class prompt embeddings, before it is coupled with
the LLM. The JAX function ``vmap``s the instance set loss over the batch;
the port loops over it, as ``models/mmmm.py _grounding_loss`` does.
"""
from __future__ import annotations

import dataclasses

import torch

from .segvol import SamConfig
from .segvol.loss import DiceFocalLoss, InstanceSamLoss, masked_mean
from .segvol.sam import instance_sam_forward, sam_forward


@dataclasses.dataclass(frozen=True)
class AlignConfig:
    sam: SamConfig = dataclasses.field(default_factory=SamConfig)
    instance: bool = False
    mask_loss: DiceFocalLoss = dataclasses.field(
        default_factory=lambda: DiceFocalLoss(dice_weight=2, focal_weight=2, focal_gamma=2))
    isam_loss: InstanceSamLoss = dataclasses.field(default_factory=InstanceSamLoss)


def align_training_step(sam_params: dict, cfg: AlignConfig, class_embeddings: torch.Tensor,
                        batch: dict, *, attn_impl: str = "auto", remat=False):
    """``(loss, logs)`` of one patch batch.

    batch: image (B, C, D, H, W) fp32, ``patch_size`` (a tuple), class_idx
    (B, N), class_valid (B, N), masks (B, N, D, H, W) in {0, 1}; instance
    mode adds boxes_label (B, L, 6) and index_offsets (B, N, 2).
    ``class_embeddings`` (num_classes, prompt_dim) is frozen."""
    prompts = class_embeddings[batch["class_idx"].long()]  # (B, N, C)
    valid = batch["class_valid"]
    if not cfg.instance:
        masks_logits, _ = sam_forward(sam_params, cfg.sam, batch["image"], batch["patch_size"],
                                      prompts, attn_impl=attn_impl, remat=remat)
        logits, target = masks_logits.float(), batch["masks"].float()
        log = cfg.mask_loss.masked(logits, target, valid, return_dict=True)
        loss = log.pop("total")
        # the per-class positive-dice metric
        dice_per = 1.0 - cfg.mask_loss.dice(logits, target)  # (B, N)
        has_fg = batch["masks"].bool().flatten(2).any(-1) & valid.bool()
        log["dice-pos"] = masked_mean(dice_per, has_fg)
        log["loss"] = loss
        return loss, log
    out = instance_sam_forward(sam_params, cfg.sam, batch["image"], batch["patch_size"], prompts,
                               attn_impl=attn_impl, remat=remat, upsample_to_image=False)
    losses, logs = [], []
    for i in range(batch["image"].shape[0]):
        loss_i, log_i = cfg.isam_loss.sample_loss(
            None, None, out.boxes[i, :, 1:], out.disc_logit[i], None, None,
            batch["boxes_label"][i], batch["index_offsets"][i], valid[i])
        losses.append(loss_i)
        logs.append(log_i)
    loss = torch.stack(losses).mean()
    log = {k: torch.stack([lg[k] for lg in logs]).mean() for k in logs[0]}
    log["loss"] = loss
    return loss, log
