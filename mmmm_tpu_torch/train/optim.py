"""Optimizer: AdamW with warmup-cosine, no-decay path masking and global-norm
clipping, the port of ``mmmm_tpu/train/optim.py``: optax's
``chain(clip_by_global_norm(c), adamw(warmup_cosine_decay_schedule, mask))``
written out in PyTorch in optax's order and arithmetic.

Per step, over the flattened trainable tree (leaf paths as the reference's
``"lora/..."`` / ``"ft/..."``):

  1. ``g_norm = sqrt(sum g^2)``; if ``g_norm >= c``: ``g = (g / g_norm) * c``
     (``torch.nn.utils.clip_grad_norm_`` divides by ``g_norm + 1e-6``: not
     the same number);
  2. ``mu = (1 - b1) g + b1 mu``, ``nu = (1 - b2) g^2 + b2 nu``, ``count += 1``;
  3. ``u = (mu / (1 - b1^count)) / (sqrt(nu / (1 - b2^count)) + eps)``
     (``eps_root = 0``), plus ``wd * p`` where the decay mask holds;
  4. ``p -= lr(count - 1) * u``: the schedule's count starts at 0, where the
     warmup gives lr 0, so the first step moves no parameter (the moments
     still move).

A leaf with no gradient in a step (``None``) takes zeros: it still decays
and its moments still move, as in the reference where every leaf has a
gradient. Updates are in place, under ``torch.no_grad``.
"""
from __future__ import annotations

import dataclasses
import math
import re

import torch


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    lr: float = 5e-5
    weight_decay: float = 0.01
    warmup_steps: int = 2000
    max_steps: int = 40000
    min_lr_ratio: float = 0.0
    grad_clip_norm: float = 1.0
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8


_NO_DECAY = (  # a pattern string: re.match caches its compiled form
    r".*(_b|/b\d?|bias|ln\w*|norm\w*|input_ln|post_ln|pos|cls|cls_pos|boi|eoi"
    r"|iou_token|mask_tokens|no_mask_embed|pe_gaussian)$"
)


def decays(path: str, leaf: torch.Tensor) -> bool:
    """The reference's decay mask: matrices whose path is not a no-decay name."""
    return leaf.dim() >= 2 and not re.match(_NO_DECAY, path)


def schedule(cfg: OptimizerConfig, count: int) -> float:
    """optax ``warmup_cosine_decay_schedule(0, lr, max(warmup, 1),
    max(max_steps, warmup + 1), lr * min_lr_ratio)`` at ``count``."""
    warmup = max(cfg.warmup_steps, 1)
    decay_steps = max(cfg.max_steps, cfg.warmup_steps + 1) - warmup
    end = cfg.lr * cfg.min_lr_ratio
    if count < warmup:
        return cfg.lr * count / warmup
    alpha = 0.0 if cfg.lr == 0.0 else end / cfg.lr
    c = min(count - warmup, decay_steps)
    return cfg.lr * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / decay_steps)) + alpha)


def global_norm(tensors) -> torch.Tensor:
    """sqrt of the sum of squares over every tensor, fp32, on the device."""
    return torch.sqrt(sum(t.float().square().sum() for t in tensors))


class AdamW:
    """``chain(clip_by_global_norm, adamw)`` over a flat ``{path: tensor}``
    dict; its state is ``{"count": int, "mu": {path: t}, "nu": {path: t}}``."""

    def __init__(self, cfg: OptimizerConfig):
        self.cfg = cfg

    def init(self, params: dict) -> dict:
        return {"count": 0,
                "mu": {p: torch.zeros_like(t) for p, t in params.items()},
                "nu": {p: torch.zeros_like(t) for p, t in params.items()}}

    @torch.no_grad()
    def step(self, params: dict, grads: dict, state: dict) -> torch.Tensor:
        """Update ``params`` and ``state`` in place; returns the global norm
        of the gradients before clipping."""
        cfg = self.cfg
        grads = {p: torch.zeros_like(t) if grads.get(p) is None else grads[p]
                 for p, t in params.items()}
        g_norm = global_norm(grads.values())
        clip = g_norm >= cfg.grad_clip_norm
        lr = schedule(cfg, state["count"])
        count = state["count"] + 1
        bc1, bc2 = 1 - cfg.b1 ** count, 1 - cfg.b2 ** count
        for path, p in params.items():
            g = grads[path]
            g = torch.where(clip, (g / g_norm.to(g.dtype)) * cfg.grad_clip_norm, g)
            mu, nu = state["mu"][path], state["nu"][path]
            mu.mul_(cfg.b1).add_((1 - cfg.b1) * g)
            nu.mul_(cfg.b2).add_((1 - cfg.b2) * g.square())
            u = (mu / bc1) / (torch.sqrt(nu / bc2) + cfg.eps)
            if decays(path, p):
                u = u + cfg.weight_decay * p
            p.add_(u * -lr)
        state["count"] = count
        return g_norm


def make_optimizer(cfg: OptimizerConfig) -> AdamW:
    return AdamW(cfg)
