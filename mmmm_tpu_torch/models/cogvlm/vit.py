"""EVA2-CLIP 3-D vision tower, the port of ``mmmm_tpu/models/cogvlm/vit.py``
(``vit_forward``).

Patch embed with the runtime-collapsed z kernel, the 3-D position embedding
resampled to the token grid, a cls token, post-norm layers
(``x = x + ln1(attn(x)); x = x + ln2(mlp(x))``) whose attention is kernel K4,
max-pool over ``pool_size``, the GLU projection into LLM space, and the
boi/eoi tokens: output (B, 2 + T', C_llm).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.dense_attn import dense_attention
from ...ops.gelu import gelu
from ...ops.norm import layer_norm
from ...ops.resample import resample_nd, variable_patch_embed_3d
from ...params import layer
from .config import CogVLMConfig


def _vit_layer(x, lp, *, num_heads: int, eps: float):
    b, s, c = x.shape
    head_dim = lp["qkv_w"].shape[-1] // (3 * num_heads)
    scale = (c // num_heads) ** -0.5
    qkv = x @ lp["qkv_w"] + lp["qkv_b"]
    q, k, v = (t.contiguous() for t in qkv.reshape(b, s, 3 * num_heads, head_dim).chunk(3, dim=2))
    attn = dense_attention(q, k, v, scale)
    attn = attn.reshape(b, s, num_heads * head_dim) @ lp["dense_w"] + lp["dense_b"]
    x = x + layer_norm(attn, lp["ln1_w"], lp["ln1_b"], eps)
    h = gelu(x @ lp["fc1_w"] + lp["fc1_b"])
    h = h @ lp["fc2_w"] + lp["fc2_b"]
    return x + layer_norm(h, lp["ln2_w"], lp["ln2_b"], eps)


def _max_pool(x: torch.Tensor, pool_size: tuple[int, int, int]) -> torch.Tensor:
    """Non-overlapping max pool of (B, C, D, H, W) (window == stride, VALID)."""
    b, c, d, h, w = x.shape
    pz, ph, pw = pool_size
    x = x[:, :, : d - d % pz, : h - h % ph, : w - w % pw]
    x = x.reshape(b, c, d // pz, pz, h // ph, ph, w // pw, pw)
    return x.amax(dim=(3, 5, 7))


def vit_forward(params: dict, cfg: CogVLMConfig, image: torch.Tensor,
                patch_size: tuple[int, int, int],
                pool_size: tuple[int, int, int]) -> torch.Tensor:
    """Encode an image batch (B, C, D, H, W) to LLM-space tokens (B, 2 + T', C_llm)."""
    v = cfg.vision
    p = params["patch"]
    x = variable_patch_embed_3d(image, p["proj_w"], p["proj_b"], patch_size)
    b, c, gd, gh, gw = x.shape
    pos = resample_nd(p["pos"].float(), (gd, gh, gw)).to(x.dtype)
    x = (x + pos).reshape(b, c, gd * gh * gw).transpose(1, 2)
    cls = (p["cls"] + p["cls_pos"]).to(x.dtype)
    x = torch.cat([cls[None].expand(b, 1, c), x], dim=1)
    for li in range(v.num_hidden_layers):
        x = _vit_layer(x, layer(params["layers"], li), num_heads=v.num_heads,
                       eps=v.layer_norm_eps)
    x = x[:, 1:]
    if any(s > 1 for s in pool_size):
        x = x.transpose(1, 2).reshape(b, c, gd, gh, gw)
        x = _max_pool(x, pool_size).reshape(b, c, -1).transpose(1, 2)
    g = params["glu"]
    x = x @ g["linear_proj"]
    x = gelu(layer_norm(x, g["ln_w"], g["ln_b"]))
    x = F.silu(x @ g["gate"]) * (x @ g["h4h"])
    x = x @ g["4hh"]
    boi = params["boi"].to(x.dtype)[None, None].expand(b, 1, x.shape[-1])
    eoi = params["eoi"].to(x.dtype)[None, None].expand(b, 1, x.shape[-1])
    return torch.cat([boi, x, eoi], dim=1)
