"""SAM image encoder, the port of ``mmmm_tpu/models/segvol/encoder.py``
(``encoder_forward``): a 3-D ViT with variable-z patch embedding and pre-norm
blocks (``x = x + attn(norm1(x)); x = x + mlp(norm2(x))``), qkv without
bias. Its attention is ``segment_attention`` over one all-valid segment,
fp32 under the reference precision policy (``impl="auto"``: kernel K4 on
the card; ``"pallas"``: K3 forward, K7 backward, both on CUDA cores with
TF32 off); each block runs inside ``remat_call``."""
from __future__ import annotations

import torch

from ...ops.attention import segment_attention
from ...ops.gelu import gelu
from ...ops.norm import layer_norm
from ...ops.resample import resample_nd, variable_patch_embed_3d
from ...ops.remat import remat_call
from ...params import layer
from ...peft.lora import materialize
from .config import SamConfig


def _block(x, lp, *, num_heads: int, segments, attn_impl: str):
    lp = materialize(lp)  # ZeRO-sharded weights are gathered inside the layer
    b, s, c = x.shape
    d = c // num_heads
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"])
    q, k, v = (t.reshape(b, s, num_heads, d).contiguous()
               for t in (h @ lp["qkv_w"]).split(c, dim=-1))
    attn = segment_attention(q, k, v, segments, impl=attn_impl, all_valid=True).reshape(b, s, c)
    x = x + attn @ lp["out_w"] + lp["out_b"]
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"])
    h = gelu(h @ lp["fc1_w"] + lp["fc1_b"])
    return x + h @ lp["fc2_w"] + lp["fc2_b"]


def encoder_forward(params: dict, cfg: SamConfig, image: torch.Tensor,
                    patch_size: tuple[int, int, int], *, attn_impl: str = "auto",
                    remat=False) -> torch.Tensor:
    """Image (B, C, D, H, W) -> embeddings (B, C_e, gd, gh, gw)."""
    p = params["patch"]
    x = variable_patch_embed_3d(image, p["proj_w"], p["proj_b"], patch_size)
    b, c, gd, gh, gw = x.shape
    pos = resample_nd(p["pos"].float(), (gd, gh, gw)).to(x.dtype)
    x = (x + pos).reshape(b, c, -1).transpose(1, 2)
    segments = torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)

    def body(h, lp):
        return _block(h, lp, num_heads=cfg.encoder_num_heads, segments=segments,
                      attn_impl=attn_impl)

    for li in range(cfg.encoder_num_layers):
        x = remat_call(body, remat, x, layer(params["layers"], li))
    x = layer_norm(x, params["norm_w"], params["norm_b"])
    return x.transpose(1, 2).reshape(b, c, gd, gh, gw)
