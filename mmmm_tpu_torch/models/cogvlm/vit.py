"""EVA2-CLIP 3-D vision tower, the port of ``mmmm_tpu/models/cogvlm/vit.py``
(``vit_forward``, ``pad_attention_heads``).

Patch embed with the runtime-collapsed z kernel, the 3-D position embedding
resampled to the token grid, a cls token, post-norm layers
(``x = x + ln1(attn(x)); x = x + ln2(mlp(x))``), max-pool over
``pool_size``, the GLU projection into LLM space, and the boi/eoi tokens:
output (B, 2 + T', C_llm). The attention is ``segment_attention`` over one
all-valid segment (through ``parallel/ring_attention.py attention``, which
rings it under ``"ring"``; ``impl="auto"``: kernel K4 on the card; ``"pallas"``:
K3 forward, K7 backward). Each layer runs inside ``remat_call`` and merges
its LoRA leaves there; the GLU's are merged where it runs.

Under tensor parallelism (``parallel/tensor.py``) each process holds whole
heads of the (padded) qkv weight, its columns of ``fc1`` and of the GLU's
``gate`` / ``h4h`` and the matching rows of ``dense_w``, ``fc2_w`` and
``4hh``: each of those three products is summed over the model group, and
its replicated bias is added once, after the sum. The softmax scale stays
that of the whole head count.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ...ops.gelu import gelu
from ...ops.norm import layer_norm
from ...ops.resample import resample_nd, variable_patch_embed_3d
from ...ops.remat import remat_call
from ...parallel.ring_attention import attention
from ...parallel.tensor import check_local, copy_to_model, local_count, reduce_from_model
from ...params import layer
from ...peft.lora import materialize
from .config import CogVLMConfig


def _dot(x, w):
    """``x @ w`` in the two operands' promoted dtype, as ``jnp.dot`` promotes
    (an fp32 image over bf16 weights runs the tower in fp32)."""
    ct = torch.promote_types(x.dtype, w.dtype)
    return x.to(ct) @ w.to(ct)


def _vit_layer(x, lp, *, num_heads: int, width: int, eps: float, segments, attn_impl: str):
    """One post-norm layer over this process's heads; ``num_heads`` and
    ``width`` (the MLP's) are the whole layer's."""
    lp = materialize(lp)
    b, s, c = x.shape
    heads = local_count(num_heads, "ViT heads")
    check_local(lp["fc1_w"].shape[-1], width, "the ViT's MLP columns")
    head_dim = lp["qkv_w"].shape[-1] // (3 * heads)
    scale = (c // num_heads) ** -0.5  # the whole head count's, also on a piece
    xin = copy_to_model(x)
    qkv = _dot(xin, lp["qkv_w"]) + lp["qkv_b"]
    q, k, v = (t.contiguous() for t in qkv.reshape(b, s, 3 * heads, head_dim).chunk(3, dim=2))
    attn = attention(q, k, v, segments, impl=attn_impl, scale=scale, all_valid=True)
    attn = reduce_from_model(_dot(attn.reshape(b, s, heads * head_dim), lp["dense_w"]))
    x = x + layer_norm(attn + lp["dense_b"], lp["ln1_w"], lp["ln1_b"], eps)
    h = gelu(_dot(copy_to_model(x), lp["fc1_w"]) + lp["fc1_b"])
    h = reduce_from_model(_dot(h, lp["fc2_w"])) + lp["fc2_b"]
    return x + layer_norm(h, lp["ln2_w"], lp["ln2_b"], eps)


def pad_attention_heads(vit_params: dict, num_heads: int, target: int = 128) -> dict:
    """Pad every attention head from its width (the flagship's 1792 / 16 =
    112) to ``target`` lanes with zeros in the weights: the q/k/v columns of
    ``qkv_w`` and ``qkv_b`` and the matching rows of ``dense_w``.

    Zero q/k lanes leave the logits unchanged (``_vit_layer`` keeps the
    scale of the true width), zero v lanes give zero output lanes that the
    zero ``dense_w`` rows ignore; the forward is the same up to the
    products' rounding. The attention kernel then runs at D = ``target``
    with no per-call pad (``ops/attention.py with_padded_head``)."""
    p = dict(vit_params)
    layers = dict(p["layers"])
    ell, c, _ = layers["qkv_w"].shape
    d = c // num_heads
    if d == target:
        return vit_params

    def pad_last(a, shape_head):
        lead = a.shape[:-1]
        a = a.reshape(*lead, *shape_head, d)
        return F.pad(a, (0, target - d)).reshape(*lead, -1)

    layers["qkv_w"] = pad_last(layers["qkv_w"], (3, num_heads))
    layers["qkv_b"] = pad_last(layers["qkv_b"], (3, num_heads))
    dw = layers["dense_w"].reshape(ell, num_heads, d, c)
    layers["dense_w"] = F.pad(dw, (0, 0, 0, target - d)).reshape(ell, num_heads * target, c)
    p["layers"] = layers
    return p


def _max_pool(x: torch.Tensor, pool_size: tuple[int, int, int]) -> torch.Tensor:
    """Non-overlapping max pool of (B, C, D, H, W) (window == stride, VALID)."""
    b, c, d, h, w = x.shape
    pz, ph, pw = pool_size
    x = x[:, :, : d - d % pz, : h - h % ph, : w - w % pw]
    x = x.reshape(b, c, d // pz, pz, h // ph, ph, w // pw, pw)
    return x.amax(dim=(3, 5, 7))


def vit_forward(params: dict, cfg: CogVLMConfig, image: torch.Tensor,
                patch_size: tuple[int, int, int], pool_size: tuple[int, int, int], *,
                attn_impl: str = "auto", remat=False) -> torch.Tensor:
    """Encode an image batch (B, C, D, H, W) to LLM-space tokens (B, 2 + T', C_llm)."""
    v = cfg.vision
    p = params["patch"]
    x = variable_patch_embed_3d(image, p["proj_w"], p["proj_b"], patch_size)
    b, c, gd, gh, gw = x.shape
    pos = resample_nd(p["pos"].float(), (gd, gh, gw)).to(x.dtype)
    x = (x + pos).reshape(b, c, gd * gh * gw).transpose(1, 2)
    cls = (p["cls"] + p["cls_pos"]).to(x.dtype)
    x = torch.cat([cls[None].expand(b, 1, c), x], dim=1)
    segments = torch.ones(x.shape[:2], dtype=torch.int32, device=x.device)

    def body(h, lp):
        return _vit_layer(h, lp, num_heads=v.num_heads, width=v.intermediate_size,
                          eps=v.layer_norm_eps, segments=segments, attn_impl=attn_impl)

    for li in range(v.num_hidden_layers):
        x = remat_call(body, remat, x, layer(params["layers"], li))
    x = x[:, 1:]
    if any(s > 1 for s in pool_size):
        x = x.transpose(1, 2).reshape(b, c, gd, gh, gw)
        x = _max_pool(x, pool_size).reshape(b, c, -1).transpose(1, 2)
    g = materialize(params["glu"])
    x = _dot(x, g["linear_proj"])
    x = copy_to_model(gelu(layer_norm(x, g["ln_w"], g["ln_b"])))
    check_local(g["gate"].shape[-1], cfg.intermediate_size, "the GLU's columns")
    x = F.silu(_dot(x, g["gate"])) * _dot(x, g["h4h"])
    x = reduce_from_model(_dot(x, g["4hh"]))
    boi = params["boi"].to(x.dtype)[None, None].expand(b, 1, x.shape[-1])
    eoi = params["eoi"].to(x.dtype)[None, None].expand(b, 1, x.shape[-1])
    return torch.cat([boi, x, eoi], dim=1)
