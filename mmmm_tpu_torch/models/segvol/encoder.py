"""SAM image encoder, the port of ``mmmm_tpu/models/segvol/encoder.py``
(``encoder_forward``): a 3-D ViT with variable-z patch embedding and pre-norm
blocks (``x = x + attn(norm1(x)); x = x + mlp(norm2(x))``), qkv without
bias. Its attention is kernel K4, in fp32 under the reference precision
policy."""
from __future__ import annotations

import torch

from ...ops.dense_attn import dense_attention
from ...ops.gelu import gelu
from ...ops.norm import layer_norm
from ...ops.resample import resample_nd, variable_patch_embed_3d
from ...params import layer
from .config import SamConfig


def _block(x, lp, *, num_heads: int):
    b, s, c = x.shape
    d = c // num_heads
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
    q, k, v = (t.reshape(b, s, num_heads, d).contiguous()
               for t in (h @ lp["qkv_w"]).split(c, dim=-1))
    attn = dense_attention(q, k, v, d ** -0.5).reshape(b, s, c)
    x = x + attn @ lp["out_w"] + lp["out_b"]
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"])
    h = gelu(h @ lp["fc1_w"] + lp["fc1_b"])
    return x + h @ lp["fc2_w"] + lp["fc2_b"]


def encoder_forward(params: dict, cfg: SamConfig, image: torch.Tensor,
                    patch_size: tuple[int, int, int]) -> torch.Tensor:
    """Image (B, C, D, H, W) -> embeddings (B, C_e, gd, gh, gw)."""
    p = params["patch"]
    x = variable_patch_embed_3d(image, p["proj_w"], p["proj_b"], patch_size)
    b, c, gd, gh, gw = x.shape
    pos = resample_nd(p["pos"].float(), (gd, gh, gw)).to(x.dtype)
    x = (x + pos).reshape(b, c, -1).transpose(1, 2)
    for li in range(cfg.encoder_num_layers):
        x = _block(x, layer(params["layers"], li), num_heads=cfg.encoder_num_heads)
    x = layer_norm(x, params["norm_w"], params["norm_b"])
    return x.transpose(1, 2).reshape(b, c, gd, gh, gw)
