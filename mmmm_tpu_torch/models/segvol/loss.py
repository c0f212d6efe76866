"""Grounding losses, the port of ``mmmm_tpu/models/segvol/loss.py``: the
Dice-focal mask loss and the DETR-style instance set loss with exact
Hungarian matching (``ops/hungarian.py``), over padded target axes with
validity masks and masked means."""
from __future__ import annotations

import dataclasses

import torch

from ...ops.hungarian import hungarian

_EPS = 1e-8


def _bce(logits, targets):
    return logits.clamp_min(0) - logits * targets + torch.log1p(torch.exp(-logits.abs()))


def sigmoid_focal_loss(logits, targets, gamma: float, alpha: float | None = None):
    """Elementwise focal loss (luolib.losses semantics)."""
    p = torch.sigmoid(logits)
    p_t = p * targets + (1 - p) * (1 - targets)
    loss = _bce(logits, targets) * (1 - p_t) ** gamma
    if alpha is not None:
        loss = loss * (alpha * targets + (1 - alpha) * (1 - targets))
    return loss


def masked_mean(x, mask, dim=None, denom=None):
    """The mean of ``x`` where ``mask`` holds; with ``denom`` (``dim``
    None) its sum over that count instead of the mask's."""
    mask = mask.to(x.dtype)
    if dim is None:
        return (x * mask).sum() / (mask.sum() if denom is None else denom).clamp_min(1.0)
    return (x * mask).sum(dim) / mask.sum(dim).clamp_min(1.0)


def _spatial(x):
    return tuple(range(x.dim() - 3, x.dim()))


@dataclasses.dataclass(frozen=True)
class DiceFocalLoss:
    """Dice (no-smooth numerator) + sigmoid focal."""

    dice_weight: float = 2.0
    focal_weight: float = 2.0
    focal_gamma: float = 2.0
    focal_alpha: float | None = None

    def dice(self, logits, target):
        """(..., D, H, W) -> per-channel (...,); ``target=None`` (all
        negative) gives 1."""
        if target is None:
            return torch.ones(logits.shape[:-3], dtype=logits.dtype, device=logits.device)
        sp = _spatial(logits)
        p = torch.sigmoid(logits)
        inter = (target * p).sum(sp)
        denom = target.sum(sp) + p.sum(sp)
        return 1.0 - 2.0 * inter / denom.clamp_min(_EPS)

    def focal(self, logits, target):
        if target is None:
            target = torch.zeros_like(logits)
        if self.focal_gamma < _EPS:
            per = _bce(logits, target)
        else:
            per = sigmoid_focal_loss(logits, target, self.focal_gamma, self.focal_alpha)
        return per.mean(_spatial(logits))

    def per_channel(self, logits, target):
        """(..., D, H, W) -> per-channel (...,) total loss."""
        return (self.dice_weight * self.dice(logits, target)
                + self.focal_weight * self.focal(logits, target))

    def masked(self, logits, target, valid, return_dict: bool = False, denom=None):
        """Masked-mean total over a padded channel axis (``denom``: the
        count that divides, where not ``valid``'s)."""
        dice = masked_mean(self.dice(logits, target), valid, denom=denom)
        focal = masked_mean(self.focal(logits, target), valid, denom=denom)
        total = self.dice_weight * dice + self.focal_weight * focal
        if return_dict:
            key = "ce" if self.focal_gamma < _EPS else f"focal-{self.focal_gamma:.1f}"
            return {"dice": dice, key: focal, "total": total}
        return total


def center_size_to_corners(boxes):
    """(..., 6) (cx, cy, cz, sx, sy, sz) -> (min (..., 3), max (..., 3))."""
    center, size = boxes[..., :3], boxes[..., 3:]
    return center - size / 2, center + size / 2


def box_pair_giou_3d(a, b):
    """Elementwise GIoU of two broadcastable (..., 6) CenterSize boxes."""
    a_min, a_max = center_size_to_corners(a)
    b_min, b_max = center_size_to_corners(b)
    inter = (torch.minimum(a_max, b_max) - torch.maximum(a_min, b_min)).clamp_min(0).prod(-1)
    vol_a = (a_max - a_min).clamp_min(0).prod(-1)
    vol_b = (b_max - b_min).clamp_min(0).prod(-1)
    union = vol_a + vol_b - inter
    iou = inter / union.clamp_min(_EPS)
    enclose = (torch.maximum(a_max, b_max) - torch.minimum(a_min, b_min)).clamp_min(0).prod(-1)
    return iou - (enclose - union) / enclose.clamp_min(_EPS)


@dataclasses.dataclass(frozen=True)
class InstanceSamLoss:
    """DETR-style set loss with per-target Hungarian matching (box L1 5,
    GIoU 2, presence 2, focal gamma 2 / alpha 0.85, ``match_ce``)."""

    mask_loss: DiceFocalLoss | None = None
    use_neg_mask: bool = False
    box_l1_weight: float = 5.0
    box_giou_weight: float = 2.0
    disc_weight: float = 2.0
    disc_focal_gamma: float = 2.0
    disc_focal_alpha: float | None = 0.85
    match_ce: bool = True

    def _box_cost(self, boxes_reg, labels):
        """(..., K, 6) x (..., K, 6) -> (..., K_query, K_label) L1 + GIoU."""
        q, t = boxes_reg[..., :, None, :], labels[..., None, :, :]
        l1 = (q - t).abs().mean(-1)
        return self.box_l1_weight * l1 + self.box_giou_weight * (1.0 - box_pair_giou_3d(q, t))

    def match_one_target(self, boxes_reg, disc_logit, boxes_label_g, num_pos, masks_ds=None,
                         masks_label_ds=None):
        """(..., K) matched label column per query (columns >= num_pos are
        negatives); leading dims are targets matched independently."""
        k = disc_logit.shape[-1]
        col_is_pos = (torch.arange(k, device=disc_logit.device)
                      < torch.as_tensor(num_pos)[..., None])[..., None, :]
        if self.match_ce:
            p = torch.sigmoid(disc_logit)
            cost_pos, cost_neg = self.disc_weight * (1 - p), self.disc_weight * p
        else:
            cost_pos = self.disc_weight * sigmoid_focal_loss(
                disc_logit, torch.ones_like(disc_logit), self.disc_focal_gamma,
                self.disc_focal_alpha)
            cost_neg = self.disc_weight * sigmoid_focal_loss(
                disc_logit, torch.zeros_like(disc_logit), self.disc_focal_gamma,
                self.disc_focal_alpha)
        disc_cost = torch.where(col_is_pos, cost_pos[..., :, None], cost_neg[..., :, None])
        if masks_label_ds is not None:
            pair = self.mask_loss.per_channel(masks_ds[..., :, None, :, :, :],
                                              masks_label_ds[..., None, :, :, :, :])
        else:
            pair = self._box_cost(boxes_reg, boxes_label_g)
        return hungarian(disc_cost + torch.where(col_is_pos, pair, 0.0))

    def sample_loss(self, masks_logits, masks_logits_ds, boxes_reg, disc_logit, masks_label,
                    masks_label_ds, boxes_label, index_offsets, target_valid):
        """Set loss of one sample with N padded targets; returns (loss, log).

        masks_logits (N, K, D, H, W) or None; masks_logits_ds (N, K, d, h, w)
        or None; boxes_reg (N, K, 6); disc_logit (N, K); masks_label
        (Lmax, D, H, W) or None; masks_label_ds (Lmax, d, h, w) or None;
        boxes_label (Lmax, 6); index_offsets (N, 2); target_valid (N,)."""
        n, k = disc_logit.shape
        dev = disc_logit.device
        disc_logit, boxes_reg = disc_logit.float(), boxes_reg.float()
        index_offsets = index_offsets.long()
        num_pos = (index_offsets[:, 1] - index_offsets[:, 0]).clamp(0, k)
        lmax = boxes_label.shape[0]
        gather_idx = (index_offsets[:, :1] + torch.arange(k, device=dev)[None]).clamp(
            0, max(lmax - 1, 0))
        labels_g = boxes_label[gather_idx]
        with torch.no_grad():  # the match is detached, as in the reference
            if masks_label_ds is not None:
                match = self.match_one_target(boxes_reg, disc_logit, labels_g, num_pos,
                                              masks_logits_ds.float(),
                                              masks_label_ds[gather_idx].float())
            else:
                match = self.match_one_target(boxes_reg, disc_logit, labels_g, num_pos)
        match_is_pos = match < num_pos[:, None]
        valid_q = target_valid[:, None].expand(n, k).bool()
        pos_q = match_is_pos & valid_q

        log = {}
        disc_per = sigmoid_focal_loss(disc_logit, match_is_pos.float(), self.disc_focal_gamma,
                                      self.disc_focal_alpha)
        disc_loss = masked_mean(disc_per, valid_q)
        log[f"instance-disc-focal-{self.disc_focal_gamma:.1f}"] = disc_loss
        loss = self.disc_weight * disc_loss

        matched_idx = gather_idx.gather(1, match)
        matched_boxes = boxes_label[matched_idx]
        l1 = masked_mean((boxes_reg - matched_boxes).abs().mean(-1), pos_q)
        giou = masked_mean(1.0 - box_pair_giou_3d(boxes_reg, matched_boxes), pos_q)
        has_pos = pos_q.any()
        zero = torch.zeros((), device=dev)
        if masks_label is None:
            box_loss = self.box_l1_weight * l1 + self.box_giou_weight * giou
            loss = loss + torch.where(has_pos, box_loss, zero)
            log["instance-box-l1"] = l1
            log["instance-box-giou"] = giou
        else:
            matched_masks = masks_label[matched_idx].float()
            mask_per = self.mask_loss.per_channel(masks_logits.float(), matched_masks)
            mask_loss_pos = masked_mean(mask_per, pos_q)
            loss = loss + torch.where(has_pos, mask_loss_pos, zero)
            log["instance-mask-pos"] = mask_loss_pos
            if self.use_neg_mask:
                neg_per = self.mask_loss.per_channel(masks_logits.float(), None)
                loss = loss + masked_mean(neg_per, (~match_is_pos) & valid_q)
        return loss, log
