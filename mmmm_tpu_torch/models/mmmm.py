"""Top-level MMMM configuration, the grounding projection and the training
loss, the port of ``mmmm_tpu/models/mmmm.py`` (``MMMMConfig`` with its loss
fields, ``vg_project``, ``gather_vg_prompts``, ``MMMMModel.training_step``),
and ``MMMMModel``, the front that ``build.build_model`` returns.

Precision policy of the reference: the VLM runs in the parameter dtype
(bf16 when serving or training with ``bf16_vlm``), SAM, iSAM and
``vg_proj`` stay fp32, and the grounding path recasts the hidden states to
fp32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.profiler import record_function

from ..ops.fused_ce import fused_weighted_ce_loss
from ..ops.resample import nearest_resize
from ..parallel.distributed import all_reduce_sum
from ..params import init_params
from ..peft.lora import materialize
from .cogvlm import CogVLMConfig
from .cogvlm.model import cogvlm_forward
from .segvol import SamConfig
from .segvol.loss import DiceFocalLoss, InstanceSamLoss
from .segvol.sam import instance_sam_forward, sam_forward


@dataclasses.dataclass(frozen=True)
class MMMMConfig:
    vlm: CogVLMConfig = dataclasses.field(default_factory=CogVLMConfig)
    sam: SamConfig = dataclasses.field(default_factory=SamConfig)
    lm_loss_weight: float = 1.0
    mask_loss: DiceFocalLoss = dataclasses.field(
        default_factory=lambda: DiceFocalLoss(dice_weight=2, focal_weight=2, focal_gamma=2))
    isam_loss: InstanceSamLoss = dataclasses.field(default_factory=InstanceSamLoss)
    # token ids are filled in from the tokenizer at build time
    bop_token_id: int = -1
    eop_token_id: int = -1

    def __post_init__(self):
        if self.isam_loss.mask_loss is None:
            object.__setattr__(self, "isam_loss",
                               dataclasses.replace(self.isam_loss, mask_loss=self.mask_loss))

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "MMMMConfig":
        return cls(vlm=CogVLMConfig.tiny(vocab_size), sam=SamConfig.tiny())


class MMMMModel:
    """A config and the way to make its parameters (``params.init_params``)."""

    def __init__(self, cfg: MMMMConfig):
        self.cfg = cfg

    def init(self, seed: int = 0, dtype: torch.dtype = torch.float32,
             device: str | torch.device = "cuda") -> dict:
        return init_params(self.cfg, seed, dtype, device)


def vg_project(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Linear(C, C) -> ReLU -> Linear(C, prompt_dim) in fp32."""
    p = params["vg_proj"]
    x = F.relu(hidden.float() @ p["w1"] + p["b1"])
    return x @ p["w2"] + p["b2"]


def gather_vg_prompts(params: dict, hidden: torch.Tensor,
                      vg_positions: torch.Tensor) -> torch.Tensor:
    """Project the hidden states (B, S, C) at ``vg_positions`` (B, N), the
    positions whose next-token prediction is ``</p>``, into SAM prompt
    space: (B, N, prompt_dim)."""
    idx = vg_positions.long()[..., None].expand(-1, -1, hidden.shape[-1])
    return vg_project(params, hidden.gather(1, idx))


def training_step(params: dict, cfg: MMMMConfig, batch: dict, *, vg_mode: str = "none",
                  attn_impl: str = "auto", remat=False,
                  vis_span: tuple[int, int] | str | None = None, group=None):
    """One loss evaluation; returns ``(loss, logs)``.

    With a data-parallel ``group`` the batch is this process's slice of the
    global batch, and each mean divides by the global batch's count (tokens,
    valid targets, samples): the processes' losses and logs sum to the
    global batch's, as the reference's SPMD step computes them.

    ``batch`` holds tensors on the run's device (padded, static shapes):
    input_ids, token_type_ids, position_ids, attention_mask, labels, weight
    (B, S); image (B, C, D, H, W) with ``patch_size`` and ``pool_size``
    tuples; for grounding, grounding_image, vg_positions and vg_valid (B, N)
    and per mode: semantic ``masks`` (B, N, D, H, W); instance
    ``boxes_label`` (B, Lmax, 6), ``index_offsets`` (B, N, 2) and optional
    ``masks_label`` (B, Lmax, D, H, W)."""
    tokens, targets = _global_counts(batch, vg_mode, group)
    hidden, _ = cogvlm_forward(
        params["cogvlm"], cfg.vlm, batch["input_ids"], batch["token_type_ids"],
        batch["position_ids"], batch["attention_mask"], batch.get("image"),
        batch.get("patch_size"), batch.get("pool_size"), attn_impl=attn_impl, remat=remat,
        return_logits=False, vis_span=vis_span)
    with record_function("ce"):
        lm_loss = fused_weighted_ce_loss(hidden, materialize(params["cogvlm"]["llm"]["lm_head"]),
                                         batch["labels"], batch.get("weight"),
                                         denom=tokens)
    log = {"lm_loss": lm_loss}
    if vg_mode == "none":
        return cfg.lm_loss_weight * lm_loss, log

    with record_function("sam_loss"):
        vg_loss = _grounding_loss(params, cfg, batch, hidden, vg_mode, attn_impl, remat, log,
                                  targets)
    log["vg_loss"] = vg_loss
    total = cfg.lm_loss_weight * lm_loss + vg_loss
    log["loss"] = total
    return total, log


def _global_counts(batch, vg_mode: str, group) -> tuple:
    """``(tokens, targets)``: the global batch's labelled tokens and its
    valid targets (semantic) or samples (instance; None without grounding),
    which divide this process's sums, in one all-reduce over the
    data-parallel ``group``; ``(None, None)`` without a group (each loss
    divides by its own count)."""
    if group is None:
        return None, None
    labels = batch["labels"]
    counts = [(labels != -100).sum()]
    if vg_mode == "semantic":
        counts.append(batch["vg_valid"].sum())
    elif vg_mode == "instance":
        counts.append(torch.tensor(batch["grounding_image"].shape[0], device=labels.device))
    counts = all_reduce_sum(torch.stack(counts).float(), group).unbind()
    return counts[0], counts[1] if len(counts) > 1 else None


def _grounding_loss(params, cfg: MMMMConfig, batch, hidden, vg_mode, attn_impl, remat, log,
                    denom=None):
    """The SAM (semantic) or iSAM (instance) pass and its loss, divided by
    ``denom`` where given (the global valid targets or samples); adds the
    loss's parts to ``log``."""
    prompts = gather_vg_prompts(params, hidden.float(), batch["vg_positions"])
    g_image = batch["grounding_image"].float()
    patch_size = batch["patch_size"]
    valid = batch["vg_valid"]
    if vg_mode == "semantic":
        masks_logits, _ = sam_forward(params["sam"], cfg.sam, g_image, patch_size, prompts,
                                      attn_impl=attn_impl, remat=remat)
        vg_log = cfg.mask_loss.masked(masks_logits.float(), batch["masks"].float(), valid,
                                      return_dict=True, denom=denom)
        vg_loss = vg_log.pop("total")
        log.update({f"vg/{k}": v for k, v in vg_log.items()})
    elif vg_mode == "instance":
        use_masks = "masks_label" in batch
        out = instance_sam_forward(params["isam"], cfg.sam, g_image, patch_size, prompts,
                                   attn_impl=attn_impl, remat=remat,
                                   upsample_to_image=use_masks)
        if use_masks:
            masks_label_ds = nearest_resize(batch["masks_label"].float(),
                                            tuple(out.masks_logits_low_res.shape[3:]))
        losses, logs = [], []
        for i in range(g_image.shape[0]):
            loss_i, log_i = cfg.isam_loss.sample_loss(
                out.masks_logits[i, :, 1:] if use_masks else None,
                out.masks_logits_low_res[i, :, 1:] if use_masks else None,
                out.boxes[i, :, 1:], out.disc_logit[i],
                batch["masks_label"][i] if use_masks else None,
                masks_label_ds[i] if use_masks else None,
                batch["boxes_label"][i], batch["index_offsets"][i], valid[i])
            losses.append(loss_i)
            logs.append(log_i)
        mean = (lambda xs: torch.stack(xs).mean()) if denom is None else \
            (lambda xs: torch.stack(xs).sum() / denom)
        vg_loss = mean(losses)
        log.update({f"vg/{k}": mean([lg[k] for lg in logs]) for k in logs[0]})
    else:
        raise ValueError(f"unknown vg_mode {vg_mode!r}")
    return vg_loss
