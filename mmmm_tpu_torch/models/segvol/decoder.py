"""SAM prompt encoder (text path) and two-way mask decoder, the port of
``mmmm_tpu/models/segvol/decoder.py`` (``dense_pe``, ``encode_text_prompt``,
``two_way_forward``, ``mask_decoder_forward``).

The JAX package runs the mask decoder per (sample, target) under ``vmap``;
here every function takes a leading batch dimension written out, so one
call decodes all targets of all samples. Its attentions are tiny (about 10
queries against 512 grid tokens) and stay plain PyTorch, as they stayed
plain XLA in the reference.
"""
from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from ...ops.gelu import gelu
from ...ops.norm import layer_norm
from ...ops.resample import variable_upsample_3d
from ...params import layer
from .config import SamConfig


def dense_pe(params: dict, grid_shape: tuple[int, int, int]) -> torch.Tensor:
    """Random-Fourier positional grid (C, gd, gh, gw); the encoded vector is
    the (dim1, dim0, dim2) normalized center coordinates, as the reference's
    ``PositionEmbeddingRandom``."""
    d0, d1, d2 = grid_shape
    g = np.mgrid[0:d0, 0:d1, 0:d2].astype(np.float32) + 0.5
    gauss = params["pe_gaussian"]
    coords = torch.from_numpy(np.stack([g[1] / d1, g[0] / d0, g[2] / d2], axis=-1))
    coords = 2 * coords.to(gauss.device) - 1
    proj = 2 * math.pi * (coords @ gauss.float())  # fp32, as the reference promotes
    return torch.cat([proj.sin(), proj.cos()], dim=-1).permute(3, 0, 1, 2)


def encode_text_prompt(params: dict, text_embedding: torch.Tensor, grid_shape):
    """(..., C) text embedding -> (sparse (..., 1, C), dense (C, *grid))."""
    sparse = text_embedding[..., None, :]
    dense = params["no_mask_embed"].reshape(-1, 1, 1, 1).expand(
        text_embedding.shape[-1], *grid_shape)
    return sparse, dense


def _linear(x, w, b):
    """``x @ w + b`` in the wider of the two dtypes, as the reference's
    type promotion gives it where a bf16 head meets the fp32 positional
    grid (``sam_bf16``)."""
    dt = torch.promote_types(x.dtype, w.dtype)
    return x.to(dt) @ w.to(dt) + b.to(dt)


def _attn(p, q, k, v, num_heads: int):
    """Multi-head attention on (..., S, C) operands."""
    qh = _linear(q, p["q_w"], p["q_b"])
    kh = _linear(k, p["k_w"], p["k_b"])
    vh = _linear(v, p["v_w"], p["v_b"])
    internal = qh.shape[-1]
    d = internal // num_heads

    def split(x):
        return x.reshape(*x.shape[:-1], num_heads, d).transpose(-3, -2)  # (..., H, S, d)

    qh, kh, vh = split(qh), split(kh), split(vh)
    logits = (qh.float() @ kh.float().transpose(-1, -2))
    probs = torch.softmax(logits * d ** -0.5, dim=-1).to(vh.dtype)
    out = (probs @ vh).transpose(-3, -2).reshape(*q.shape[:-1], internal)
    return _linear(out, p["out_w"], p["out_b"])


def _ln(p, x):
    return layer_norm(x, p["w"], p["b"])


def two_way_forward(params: dict, cfg: SamConfig, image_embedding, image_pe, point_embedding):
    """Two-way attention between query tokens (..., Q, C) and image tokens
    (..., T, C) with positional encoding ``image_pe`` (T, C); returns
    (queries, keys)."""
    queries = point_embedding
    keys = image_embedding
    h = cfg.decoder_num_heads
    for li in range(cfg.decoder_depth):
        lp = layer(params["layers"], li)
        if li == 0:
            queries = _attn(lp["self_attn"], queries, queries, queries, h)
        else:
            q = queries + point_embedding
            queries = queries + _attn(lp["self_attn"], q, q, queries, h)
        queries = _ln(lp["norm1"], queries)

        q = queries + point_embedding
        k = keys + image_pe
        queries = _ln(lp["norm2"], queries + _attn(lp["cross_t2i"], q, k, keys, h))

        mlp = (F.relu(queries @ lp["mlp_fc1_w"] + lp["mlp_fc1_b"]) @ lp["mlp_fc2_w"]
               + lp["mlp_fc2_b"])
        queries = _ln(lp["norm3"], queries + mlp)

        q = queries + point_embedding
        k = keys + image_pe
        keys = _ln(lp["norm4"], keys + _attn(lp["cross_i2t"], k, q, queries, h))

    q = queries + point_embedding
    k = keys + image_pe
    queries = _ln(params["norm_final"], queries + _attn(params["final_attn"], q, k, keys, h))
    return queries, keys


def _mlp3(p, x):
    x = F.relu(x @ p["w1"] + p["b1"])
    x = F.relu(x @ p["w2"] + p["b2"])
    return x @ p["w3"] + p["b3"]


def mask_decoder_forward(params: dict, cfg: SamConfig, image_embeddings, image_pe,
                         sparse_prompt, dense_prompt, text_embedding, patch_size_z: int):
    """Per-target mask logits for a batch of n targets.

    image_embeddings (n, C, gd, gh, gw); image_pe and dense_prompt (C, gd,
    gh, gw); sparse_prompt (n, N_sp, C); text_embedding (n, C) or None.
    Returns (masks (n, K+1, d', h', w'), mask_tokens_out (n, K+1, C))."""
    n, c, gd, gh, gw = image_embeddings.shape
    output_tokens = torch.cat([params["iou_token"], params["mask_tokens"]], dim=0)
    tokens = torch.cat([output_tokens[None].expand(n, -1, -1), sparse_prompt], dim=1)
    src = (image_embeddings + dense_prompt).reshape(n, c, -1).transpose(1, 2)  # (n, T, C)
    pe = image_pe.reshape(c, -1).T
    hs, src = two_way_forward(params["transformer"], cfg, src, pe, tokens)
    mask_tokens_out = hs[:, 1: 1 + cfg.num_mask_tokens]

    up = src.transpose(1, 2).reshape(n, c, gd, gh, gw)
    up = variable_upsample_3d(up, params["up1_w"], params["up1_b"], patch_size_z, cnt=0)
    up = _ln(params["up_ln"], up.permute(0, 2, 3, 4, 1)).permute(0, 4, 1, 2, 3)
    up = gelu(up)
    up = variable_upsample_3d(up, params["up2_w"], params["up2_b"], patch_size_z, cnt=1)
    up = gelu(up)  # (n, C/8, d', h', w')

    hyper_in = torch.cat([_mlp3(params["hyper_semantic"], mask_tokens_out[:, :1]),
                          _mlp3(params["hyper_instance"], mask_tokens_out[:, 1:])], dim=1)
    masks = torch.einsum("nmc,ncdhw->nmdhw", hyper_in, up)
    if text_embedding is not None:
        txt = text_embedding @ params["txt_align_w"] + params["txt_align_b"]  # (n, C/8)
        masks = masks + torch.einsum("nc,ncdhw->ndhw", txt, up)[:, None]
    return masks, mask_tokens_out
