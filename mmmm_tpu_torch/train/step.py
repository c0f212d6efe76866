"""The LoRA training step, the port of ``mmmm_tpu/train/step.py``
(``TrainState``, ``init_train_state``, ``effective_params``,
``make_step_fn``, ``make_train_step``): LoRA-merged forward, gradients by
autograd, global-norm clip and AdamW.

Precision policy (the reference's): trainable masters (LoRA factors, the
finetuned SAM, iSAM, ``vg_proj`` and ``embed_tokens``) are fp32; with
``bf16_vlm`` the whole CogVLM subtree is cast to bf16 before the merge,
``embed_tokens`` included, and the fp32 masters take fp32 gradients back
through the cast; ``frozen_vlm_bf16`` stores the frozen CogVLM base in
bf16. LoRA merges per layer inside the rematerialized layer
(``peft/lora.py``).

Profiler spans: ``vit``, ``llm_forward``, ``ce``, ``sam_loss`` (the
forward), ``backward`` (rematerialized layers recompute in it) and
``optimizer``.

The step updates the state in place (parameters, Adam moments, counts), as
PyTorch allows, instead of returning a new tree; it returns the same
``TrainState`` object and the logs (device tensors), with
``logs["grad_norm"]`` the global norm before clipping.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch
from torch.profiler import record_function

from ..models.mmmm import MMMMConfig, training_step
from ..ops._cuda import resolve_device
from ..params import init_params
from ..peft.lora import (LoraConfig, flatten, lora_init, lora_merge, merge_trainable,
                         split_trainable, unflatten)
from .optim import AdamW


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: dict  # {"lora": ..., "ft": ...}, fp32 leaves that require grad
    opt_state: dict  # AdamW state over flatten(trainable): count, mu, nu


def _cast_vlm(tree: dict, dtype) -> dict:
    out = dict(tree)
    out["cogvlm"] = unflatten({p: t.to(dtype) if t.dtype == torch.float32 else t
                               for p, t in flatten(tree["cogvlm"]).items()})
    return out


def init_train_state(cfg: MMMMConfig, optimizer: AdamW, lora_cfg: LoraConfig, *,
                     seed: int = 0, frozen_vlm_bf16: bool = False,
                     device: str | torch.device = "cuda",
                     params: dict | None = None) -> tuple[TrainState, dict]:
    """Returns ``(state, frozen)``: the model from ``seed`` (or ``params``, a
    port tree in fp32, e.g. from ``params_from_jax``), LoRA factors from a
    generator seeded ``seed + 1``, the finetuned subset as fp32 masters and
    the frozen rest, its CogVLM in bf16 with ``frozen_vlm_bf16``.

    Made from the seed with ``frozen_vlm_bf16``, the CogVLM tower is drawn
    in bf16 directly (the flagship's 17 B fp32 parameters would not fit the
    card) and ``embed_tokens`` is then cast up to its fp32 master."""
    dev = resolve_device(device)
    if params is None:
        dtype = torch.bfloat16 if frozen_vlm_bf16 else torch.float32
        params = init_params(cfg, seed, dtype=dtype, device=dev)
    lora = lora_init(torch.Generator(device=dev).manual_seed(seed + 1), params, lora_cfg)
    ft, frozen = split_trainable(params)
    if frozen_vlm_bf16 and "cogvlm" in frozen:
        frozen = _cast_vlm(frozen, torch.bfloat16)
    trainable = {"lora": lora, "ft": unflatten({p: t.float() for p, t in flatten(ft).items()})}
    for t in flatten(trainable).values():
        t.requires_grad_(True)
    return TrainState(0, trainable, optimizer.init(flatten(trainable))), frozen


def effective_params(trainable: dict, frozen: dict, lora_cfg: LoraConfig, bf16_vlm: bool,
                     dropout: tuple[int, int] | None = None) -> dict:
    """The model's parameters: frozen + finetuned, the CogVLM cast to bf16
    with ``bf16_vlm``, LoRA leaves to merge where used (``dropout=(seed,
    step)`` for LoRA dropout)."""
    base = merge_trainable(trainable["ft"], frozen)
    if bf16_vlm:
        base = _cast_vlm(base, torch.bfloat16)
    return lora_merge(base, trainable["lora"], lora_cfg, dropout=dropout)


def make_step_fn(cfg: MMMMConfig, optimizer: AdamW, lora_cfg: LoraConfig, *,
                 vg_mode: str = "none", bf16_vlm: bool = False, attn_impl: str = "auto",
                 remat=True, dropout_seed: int | None = 0,
                 vis_span: tuple[int, int] | str | None = None):
    """The step_fn(state, frozen, batch) -> (state, logs) over a batch of
    tensors already on the state's device. A fresh LoRA-dropout mask each
    step, deterministic in ``(dropout_seed, step)``."""
    use_dropout = dropout_seed is not None and lora_cfg.dropout > 0.0

    def step_fn(state: TrainState, frozen: dict, batch: dict):
        params = effective_params(state.trainable, frozen, lora_cfg, bf16_vlm,
                                  dropout=(dropout_seed, state.step) if use_dropout else None)
        loss, logs = training_step(params, cfg, batch, vg_mode=vg_mode, attn_impl=attn_impl,
                                   remat=remat, vis_span=vis_span)
        flat = flatten(state.trainable)
        with record_function("backward"):
            grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        logs = {k: v.detach() for k, v in logs.items()}
        with record_function("optimizer"):
            logs["grad_norm"] = optimizer.step(flat, dict(zip(flat, grads)), state.opt_state)
        state.step += 1
        return state, logs

    return step_fn


def batch_to(batch: dict, device: torch.device) -> dict:
    """Array leaves (numpy or tensors) on ``device``, dtypes kept;
    ``patch_size`` / ``pool_size`` and other non-arrays pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out


def make_train_step(cfg: MMMMConfig, optimizer: AdamW, lora_cfg: LoraConfig, *,
                    vg_mode: str = "none", bf16_vlm: bool = False, attn_impl: str = "auto",
                    remat=True, mesh=None, dropout_seed: int | None = 0,
                    vis_span: tuple[int, int] | str | None = None,
                    device: str | torch.device = "cuda"):
    """The step(state, frozen, batch) -> (state, logs) on ``device``; the
    batch's arrays are moved there. ``mesh`` (sharded training) waits for
    the parallel slice of the port."""
    if mesh is not None:
        raise NotImplementedError("make_train_step(mesh=...) waits for the parallel slice "
                                  "of the port (ROADMAP Queue 1)")
    dev = resolve_device(device)
    step_fn = make_step_fn(cfg, optimizer, lora_cfg, vg_mode=vg_mode, bf16_vlm=bf16_vlm,
                           attn_impl=attn_impl, remat=remat, dropout_seed=dropout_seed,
                           vis_span=vis_span)

    def run(state: TrainState, frozen: dict, batch: dict):
        return step_fn(state, frozen, batch_to(batch, dev))

    return run
