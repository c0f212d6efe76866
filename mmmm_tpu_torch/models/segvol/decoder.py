"""SAM prompt encoder and two-way mask decoder, the port of
``mmmm_tpu/models/segvol/decoder.py`` (``dense_pe``, ``encode_text_prompt``,
the point, box and mask prompts with ``encode_prompts``,
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


def _pe_with_coords(params, coords, image_size):
    """Random-Fourier encoding of un-normalized (x, y, z) point coords against
    an (H, W, D) image size (ref ``forward_with_coords``,
    ``prompt_encoder.py:191-200``: x/=W, y/=H, z/=D)."""
    h, w, d = image_size
    norm = coords / torch.tensor([w, h, d], dtype=coords.dtype, device=coords.device)
    norm = 2 * norm - 1
    proj = 2 * math.pi * (norm @ params["pe_gaussian"].to(norm.dtype))
    return torch.cat([proj.sin(), proj.cos()], dim=-1)


def encode_point_prompt(params: dict, points: torch.Tensor, labels: torch.Tensor,
                        image_size: tuple[int, int, int], pad: bool = True) -> torch.Tensor:
    """Point prompts (N, 3) un-normalized (x, y, z), labels (N,) 1 positive,
    0 negative, -1 padding -> (N[+1], C) sparse embeddings.

    As ``_embed_points`` (``prompt_encoder.py:66-83``): +0.5 pixel-center
    shift, a padding point appended when no box accompanies the points,
    label identity embeddings (padding points drop their encoding and take
    ``not_a_point_embed``)."""
    points = points + 0.5
    if pad:
        points = torch.cat([points, points.new_zeros((1, 3))])
        labels = torch.cat([labels, labels.new_full((1,), -1)])
    pe = _pe_with_coords(params, points, image_size)
    lab = labels[:, None]
    pe = torch.where(lab == -1, params["not_a_point_embed"][None], pe)
    pe = pe + torch.where(lab == 0, params["point_embeddings"][0][None], 0.0)
    return pe + torch.where(lab == 1, params["point_embeddings"][1][None], 0.0)


def encode_box_prompt(params: dict, boxes: torch.Tensor,
                      image_size: tuple[int, int, int]) -> torch.Tensor:
    """Box prompts (N, 6) un-normalized (x0, y0, z0, x1, y1, z1) -> (N * 2, C):
    two encoded corners with their identity embeddings (ref ``_embed_boxes``,
    ``prompt_encoder.py:85-92``)."""
    corners = (boxes + 0.5).reshape(-1, 2, 3)
    pe = _pe_with_coords(params, corners, image_size)
    pe = pe + params["point_embeddings"][2:4][None]
    return pe.reshape(-1, pe.shape[-1])


def _ln_channels_last(p, x, eps=1e-6):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * p["scale"] + p["bias"]


def _conv3d(x, w, b, stride: int):
    """VALID conv of (N, C, D, H, W) by a channels-last (kD, kH, kW, in, out)
    weight."""
    return F.conv3d(x, w.permute(4, 3, 0, 1, 2), b, stride=stride)


def encode_mask_prompt(params: dict, mask: torch.Tensor) -> torch.Tensor:
    """(1, D, H, W) input mask -> dense (C, D/4, H/4, W/4) embedding: the 3-D
    working equivalent of the reference's (dead-code 2-D) mask downscaling
    stack, conv (stride 2) + LayerNorm + exact GELU twice, then a 1x1
    projection."""
    p = params["mask_down"]
    x = mask[None].to(p["conv1_w"].dtype)  # (1, 1, D, H, W)

    def ln_gelu(x, q):
        return gelu(_ln_channels_last(q, x.permute(0, 2, 3, 4, 1))).permute(0, 4, 1, 2, 3)

    x = ln_gelu(_conv3d(x, p["conv1_w"], p["conv1_b"], 2), p["ln1"])
    x = ln_gelu(_conv3d(x, p["conv2_w"], p["conv2_b"], 2), p["ln2"])
    return _conv3d(x, p["conv3_w"], p["conv3_b"], 1)[0]  # (C, d, h, w)


def encode_prompts(params: dict, grid_shape: tuple[int, int, int],
                   image_size: tuple[int, int, int], *, points=None, boxes=None, mask=None,
                   text_embedding=None):
    """The prompt encoder's forward (ref ``prompt_encoder.py:123-151``): the
    point, box and text sparse embeddings concatenated in that order; dense
    is the mask's embedding, or the no-mask embedding broadcast over the
    grid. ``points`` is a (coords, labels) pair."""
    parts = []
    if points is not None:
        parts.append(encode_point_prompt(params, *points, image_size, pad=boxes is None))
    if boxes is not None:
        parts.append(encode_box_prompt(params, boxes, image_size))
    if text_embedding is not None:
        parts.append(text_embedding[None, :])
    if not parts:
        raise ValueError("at least one prompt type is required")
    sparse = torch.cat(parts, dim=0)
    if mask is not None:
        dense = encode_mask_prompt(params, mask)
    else:
        dense = params["no_mask_embed"].reshape(-1, 1, 1, 1).expand(sparse.shape[-1],
                                                                    *grid_shape)
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
