"""SAM forward passes over a fixed-size target axis, the port of
``_decode_all_targets``, ``sam_forward`` (semantic: masks),
``sam_forward_prompted`` (point, box and mask prompts),
``instance_sam_forward`` and ``InstanceSamOutput`` (instance: masks, boxes
and presence logits) in ``mmmm_tpu/models/segvol/sam.py``."""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from ...ops.resample import trilinear_resize
from .config import SamConfig
from .decoder import dense_pe, encode_prompts, encode_text_prompt, mask_decoder_forward
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
                patch_size: tuple[int, int, int], prompts: torch.Tensor, *,
                upsample_to_image: bool = True, attn_impl: str = "auto", remat=False):
    """Semantic path: (B, N, D, H, W) mask logits of the semantic token,
    upsampled to the image grid (or left low-res), and the low-res logits."""
    embeds = encoder_forward(params["encoder"], cfg, image, patch_size, attn_impl=attn_impl,
                             remat=remat)
    masks, _ = _decode_all_targets(params, cfg, embeds, prompts, patch_size[0])
    semantic_low = masks[:, :, 0]
    if not upsample_to_image:
        return semantic_low, semantic_low
    return trilinear_resize(semantic_low, tuple(image.shape[2:])), semantic_low


def sam_forward_prompted(params: dict, cfg: SamConfig, image: torch.Tensor,
                         patch_size: tuple[int, int, int], *, points=None, boxes=None,
                         mask=None, text_embedding=None, upsample_to_image: bool = True,
                         attn_impl: str = "auto"):
    """Interactive segmentation of one sample (1, C, D, H, W) from point,
    box and mask (and optionally text) prompts, the SegVol prompt modes
    beside MMMM's text path (ref ``prompt_encoder.py:123-151`` and the
    ``sam.py`` forward). ``points`` is ((N, 3) un-normalized (x, y, z)
    against the (H, W, D) input size, (N,) labels); ``boxes`` (N, 6) as
    (x0, y0, z0, x1, y1, z1); ``mask`` (1, 4 gd, 4 gh, 4 gw) over the
    encoder's grid. Returns (mask logits (D, H, W), low-res logits)."""
    embeds = encoder_forward(params["encoder"], cfg, image, patch_size, attn_impl=attn_impl)
    grid = tuple(embeds.shape[2:])
    d, h, w = image.shape[2:]
    sparse, dense = encode_prompts(params["prompt"], grid, (h, w, d), points=points,
                                   boxes=boxes, mask=mask, text_embedding=text_embedding)
    pe = dense_pe(params["prompt"], grid)
    text = None if text_embedding is None else text_embedding[None]
    masks, _ = mask_decoder_forward(params["decoder"], cfg, embeds, pe, sparse[None], dense,
                                    text, patch_size[0])
    low = masks[0, 0]  # the semantic mask token
    if not upsample_to_image:
        return low, low
    return trilinear_resize(low, tuple(image.shape[2:])), low


@dataclasses.dataclass
class InstanceSamOutput:
    """All tensors carry (B, N_targets, ...) axes; padded targets are invalid."""

    masks_logits: torch.Tensor  # (B, N, K+1, D, H, W), or low-res without upsampling
    masks_logits_low_res: torch.Tensor  # (B, N, K+1, d', h', w')
    boxes: torch.Tensor  # (B, N, K+1, 6) CenterSize in [0, 1], fp32
    disc_logit: torch.Tensor  # (B, N, K) fp32


def instance_sam_forward(params: dict, cfg: SamConfig, image: torch.Tensor,
                         patch_size: tuple[int, int, int], prompts: torch.Tensor, *,
                         upsample_to_image: bool = True, attn_impl: str = "auto",
                         remat=False) -> InstanceSamOutput:
    """Instance path: the mask decoder's tokens through the DETR-style box
    head (``relu(relu(t w1 + b1) w2 + b2) w3 + b3`` -> sigmoid) and the
    presence head over tokens ``1:`` (``relu(t w1 + b1) w2 + b2``)."""
    embeds = encoder_forward(params["encoder"], cfg, image, patch_size, attn_impl=attn_impl,
                             remat=remat)
    masks_low, tokens = _decode_all_targets(params, cfg, embeds, prompts, patch_size[0])
    bh, dh = params["box_head"], params["disc_head"]
    x = F.relu(tokens @ bh["w1"] + bh["b1"])
    x = F.relu(x @ bh["w2"] + bh["b2"])
    boxes = torch.sigmoid((x @ bh["w3"] + bh["b3"]).float())
    y = F.relu(tokens[:, :, 1:] @ dh["w1"] + dh["b1"])
    disc = (y @ dh["w2"] + dh["b2"])[..., 0].float()
    full = (trilinear_resize(masks_low, tuple(image.shape[2:])) if upsample_to_image
            else masks_low)
    return InstanceSamOutput(full, masks_low, boxes, disc)
