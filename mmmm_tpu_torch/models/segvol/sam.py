"""Semantic SAM forward over a fixed-size target axis, the port of
``_decode_all_targets`` and ``sam_forward`` in
``mmmm_tpu/models/segvol/sam.py``."""
from __future__ import annotations

import torch

from ...ops.resample import trilinear_resize
from .config import SamConfig
from .decoder import dense_pe, encode_text_prompt, mask_decoder_forward
from .encoder import encoder_forward


def _decode_all_targets(params, cfg: SamConfig, embeds, prompts, patch_size_z: int):
    """Mask-decode every (sample, target) pair in one batched call.

    embeds (B, C, gd, gh, gw); prompts (B, N, C). Returns masks (B, N, K+1,
    d', h', w') and token embeddings (B, N, K+1, C)."""
    b, n = prompts.shape[:2]
    grid = tuple(embeds.shape[2:])
    pe = dense_pe(params["prompt"], grid)
    flat = prompts.reshape(b * n, -1)
    sparse, dense = encode_text_prompt(params["prompt"], flat, grid)
    masks, tokens = mask_decoder_forward(
        params["decoder"], cfg, embeds.repeat_interleave(n, dim=0), pe, sparse, dense,
        flat, patch_size_z,
    )
    return masks.reshape(b, n, *masks.shape[1:]), tokens.reshape(b, n, *tokens.shape[1:])


def sam_forward(params: dict, cfg: SamConfig, image: torch.Tensor,
                patch_size: tuple[int, int, int], prompts: torch.Tensor):
    """Semantic path: (B, N, D, H, W) mask logits of the semantic token,
    upsampled to the image grid, and the low-res logits."""
    embeds = encoder_forward(params["encoder"], cfg, image, patch_size)
    masks, _ = _decode_all_targets(params, cfg, embeds, prompts, patch_size[0])
    semantic_low = masks[:, :, 0]
    return trilinear_resize(semantic_low, tuple(image.shape[2:])), semantic_low
