"""Checkpoint importers with the 2-D -> 3-D weight surgery, the port of
``mmmm_tpu/train/import_torch.py``.

Carries the released torch checkpoints over into the port's parameter tree
(the JAX layout of ``params.py``):

  - HF CogVLM (THUDM/cogvlm-chat-hf) -> the ``cogvlm`` subtree, with the
    MMMM surgery rules (``visual.py:37-57``, ``resample.py:31-53``): the
    ViT position table (1 + 35*35, C) -> ``cls_pos`` and the grid resampled
    to (32, 32) and repeated over z = 8; the patch conv (C, 3, 14, 14) ->
    resampled over H and W with the response kept, then mean-inflated over
    z to (C, 3, 16, 16, 16);
  - SegVol SAM -> a ``sam`` / ``isam`` subtree (``image_encoder.py:82-119``,
    ``mask_decoder.py:76-87``, ``build_sam.py:58-77``): the flattened
    patch embedding unfolded and resampled, the 1-D token-grid position
    table made a 3-D grid, 4-D LayerNormNd stats mean-collapsed, the
    mask-token table padded to 1 + num_instances rows.

State-dict leaves may be torch tensors or numpy arrays; the importers work
on CPU tensors in the source dtype (resampling in fp32 through the port's
``ops/resample.py resample_nd``, so the surgery does not depend on a card)
and ``merge_imported`` puts each leaf on the fresh tree's device and dtype.
Torch Linear weights are (out, in) and transpose to the (in, out) matmul
convention; per-layer weights stack into the (L, ...) layout.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models.cogvlm import CogVLMConfig
from ..models.segvol import SamConfig
from ..ops.resample import resample_nd


def _cpu(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu()
    return torch.from_numpy(np.array(x))


def _resample(x: torch.Tensor, shape: tuple[int, ...], scale: bool = False) -> torch.Tensor:
    return resample_nd(x.float(), tuple(shape), scale=scale)


def _t(w: torch.Tensor) -> torch.Tensor:
    return w.transpose(-1, -2).contiguous()


def _stack(sd: dict, fmt: str, num_layers: int, transpose: bool = False) -> torch.Tensor:
    out = torch.stack([sd[fmt.format(i)] for i in range(num_layers)])
    return _t(out) if transpose else out


def _stack_trees(trees: list):
    """Stack a list of equal-structured dicts of tensors leaf by leaf."""
    if isinstance(trees[0], dict):
        return {k: _stack_trees([t[k] for t in trees]) for k in trees[0]}
    return torch.stack(trees)


def inflate_conv_z(weight, depth: int, mode: str = "mean") -> torch.Tensor:
    """2-D conv kernel (Co, Ci, H, W) -> 3-D (Co, Ci, depth, H, W).

    ``mean``: each z slice = W/depth (sum over z preserves the 2-D response);
    ``center``: response concentrated at the central slice(s).
    """
    weight = _cpu(weight)
    shape = (*weight.shape[:2], depth, *weight.shape[2:])
    if mode == "mean":
        return (weight[:, :, None] / depth).expand(shape).contiguous()
    if mode == "center":
        out = weight.new_zeros(shape)
        if depth % 2:
            out[:, :, depth // 2] = weight
        else:
            out[:, :, depth // 2 - 1] = weight / 2
            out[:, :, depth // 2] = weight / 2
        return out
    raise ValueError(mode)


def import_cogvlm(state_dict: dict, cfg: CogVLMConfig, *,
                  vocab_resize_mean: bool = True) -> dict:
    """HF CogVLM ``state_dict`` -> the port's ``cogvlm`` tree (CPU tensors)."""
    sd = {k: _cpu(v) for k, v in state_dict.items()}
    L = cfg.num_hidden_layers
    v = cfg.vision
    lv = v.num_hidden_layers

    # ---- token embeddings / head (with vocab extension) -------------------
    def extend_vocab(w: torch.Tensor) -> torch.Tensor:
        if w.shape[0] >= cfg.vocab_size:
            return w[: cfg.vocab_size]
        extra = cfg.vocab_size - w.shape[0]
        fill = (w.double().mean(0, keepdim=True).to(w.dtype) if vocab_resize_mean
                else w.new_zeros((1, w.shape[1])))
        return torch.cat([w, fill.expand(extra, -1)], dim=0)

    lp = "model.layers.{}."
    mlp = lambda ex: {
        "gate": _stack(sd, lp + f"mlp.{ex}.gate_proj.weight", L, True),
        "up": _stack(sd, lp + f"mlp.{ex}.up_proj.weight", L, True),
        "down": _stack(sd, lp + f"mlp.{ex}.down_proj.weight", L, True),
    }
    llm = {
        "embed_tokens": extend_vocab(sd["model.embed_tokens.weight"]),
        "norm": sd["model.norm.weight"],
        "lm_head": _t(extend_vocab(sd["lm_head.weight"])),
        "layers": {
            "vis_qkv": _stack(sd, lp + "self_attn.vision_expert_query_key_value.weight", L, True),
            "lang_qkv": _stack(sd, lp + "self_attn.language_expert_query_key_value.weight", L,
                               True),
            "vis_dense": _stack(sd, lp + "self_attn.vision_expert_dense.weight", L, True),
            "lang_dense": _stack(sd, lp + "self_attn.language_expert_dense.weight", L, True),
            "vis_mlp": mlp("vision_mlp"),
            "lang_mlp": mlp("language_mlp"),
            "input_ln": _stack(sd, lp + "input_layernorm.weight", L),
            "post_ln": _stack(sd, lp + "post_attention_layernorm.weight", L),
        },
    }

    # ---- vision tower -----------------------------------------------------
    vp = "model.vision."
    # pos embed (1 + h*w, C): row 0 is cls; grid resampled + z-repeated
    pos = sd[vp + "patch_embedding.position_embedding.weight"]
    cls_pos, grid = pos[:1], pos[1:]
    h0, w0 = v.pt_pos_embed_shape
    grid = grid.reshape(h0, w0, -1).permute(2, 0, 1)[None]  # (1, C, h0, w0)
    if (h0, w0) != tuple(v.pos_embed_shape[1:]):
        grid = _resample(grid, tuple(v.pos_embed_shape[1:]))
    grid = grid[:, :, None].expand(-1, -1, v.pos_embed_shape[0], -1, -1).contiguous()

    proj_w = sd[vp + "patch_embedding.proj.weight"]  # (C, 3, ph0, pw0) 2-D conv
    if proj_w.dim() == 4:
        if tuple(proj_w.shape[2:]) != tuple(v.patch_size[1:]):
            proj_w = _resample(proj_w, tuple(v.patch_size[1:]), scale=True)
        proj_w = inflate_conv_z(proj_w, v.patch_size[0], "mean")

    tp = vp + "transformer.layers.{}."
    vision = {
        "patch": {
            "proj_w": proj_w,
            "proj_b": sd[vp + "patch_embedding.proj.bias"],
            "cls": sd[vp + "patch_embedding.cls_embedding"].reshape(1, -1),
            "cls_pos": cls_pos.contiguous(),
            "pos": grid,
        },
        "layers": {
            "qkv_w": _stack(sd, tp + "attention.query_key_value.weight", lv, True),
            "qkv_b": _stack(sd, tp + "attention.query_key_value.bias", lv),
            "dense_w": _stack(sd, tp + "attention.dense.weight", lv, True),
            "dense_b": _stack(sd, tp + "attention.dense.bias", lv),
            "ln1_w": _stack(sd, tp + "input_layernorm.weight", lv),
            "ln1_b": _stack(sd, tp + "input_layernorm.bias", lv),
            "ln2_w": _stack(sd, tp + "post_attention_layernorm.weight", lv),
            "ln2_b": _stack(sd, tp + "post_attention_layernorm.bias", lv),
            "fc1_w": _stack(sd, tp + "mlp.fc1.weight", lv, True),
            "fc1_b": _stack(sd, tp + "mlp.fc1.bias", lv),
            "fc2_w": _stack(sd, tp + "mlp.fc2.weight", lv, True),
            "fc2_b": _stack(sd, tp + "mlp.fc2.bias", lv),
        },
        "glu": {
            "linear_proj": _t(sd[vp + "linear_proj.linear_proj.weight"]),
            "ln_w": sd[vp + "linear_proj.norm1.weight"],
            "ln_b": sd[vp + "linear_proj.norm1.bias"],
            "gate": _t(sd[vp + "linear_proj.gate_proj.weight"]),
            "h4h": _t(sd[vp + "linear_proj.dense_h_to_4h.weight"]),
            "4hh": _t(sd[vp + "linear_proj.dense_4h_to_h.weight"]),
        },
        "boi": sd[vp + "boi"].reshape(-1),
        "eoi": sd[vp + "eoi"].reshape(-1),
    }
    return {"llm": llm, "vision": vision}


def import_segvol_sam(state_dict: dict, cfg: SamConfig, *, pt_in_channels: int = 1,
                      pt_patch_size: tuple[int, int, int] = (4, 16, 16),
                      pt_pos_embed_shape: tuple[int, int, int] = (8, 8, 8),
                      instance: bool = False, fresh_mask_tokens=None) -> dict:
    """SegVol ``state_dict`` (keys relative to the sam module) -> the port's
    sam tree (CPU tensors). Heads absent from the checkpoint (box/disc for
    iSAM, fresh mask tokens) are left out; merge over a fresh init.

    ``fresh_mask_tokens``: the freshly initialized (num_mask_tokens, C) table;
    rows beyond the pretrained ones keep this init (the reference clones the
    module's own fresh rows, ``mask_decoder.py:83-88``) instead of zeros."""
    sd = {k: _cpu(v) for k, v in state_dict.items()}
    c = cfg.embed_dim
    L = cfg.encoder_num_layers

    # patch embedding stored flattened: (C, p0*p1*p2*ci)
    pw = sd["image_encoder.patch_embedding.patch_embeddings.1.weight"]
    p0, p1, p2 = pt_patch_size
    pw = pw.reshape(c, p0, p1, p2, pt_in_channels).permute(0, 4, 1, 2, 3)
    if tuple(pt_patch_size) != tuple(cfg.patch_size):
        pw = _resample(pw, tuple(cfg.patch_size), scale=True)
    if pt_in_channels == 1 and cfg.in_channels != 1:
        pw = pw.repeat(1, cfg.in_channels, 1, 1, 1) / cfg.in_channels

    pos = sd["image_encoder.patch_embedding.position_embeddings"]  # (1, T, C)
    d0, h0, w0 = pt_pos_embed_shape
    pos = pos.reshape(d0, h0, w0, c).permute(3, 0, 1, 2)[None]
    if tuple(pt_pos_embed_shape) != tuple(cfg.pos_embed_shape):
        pos = _resample(pos, tuple(cfg.pos_embed_shape))

    ep = "image_encoder.blocks.{}."
    encoder = {
        "patch": {
            "proj_w": pw.contiguous(),
            "proj_b": sd["image_encoder.patch_embedding.patch_embeddings.1.bias"],
            "pos": pos.contiguous(),
        },
        "layers": {
            "qkv_w": _stack(sd, ep + "attn.qkv.weight", L, True),
            "out_w": _stack(sd, ep + "attn.out_proj.weight", L, True),
            "out_b": _stack(sd, ep + "attn.out_proj.bias", L),
            "ln1_w": _stack(sd, ep + "norm1.weight", L),
            "ln1_b": _stack(sd, ep + "norm1.bias", L),
            "ln2_w": _stack(sd, ep + "norm2.weight", L),
            "ln2_b": _stack(sd, ep + "norm2.bias", L),
            "fc1_w": _stack(sd, ep + "mlp.linear1.weight", L, True),
            "fc1_b": _stack(sd, ep + "mlp.linear1.bias", L),
            "fc2_w": _stack(sd, ep + "mlp.linear2.weight", L, True),
            "fc2_b": _stack(sd, ep + "mlp.linear2.bias", L),
        },
        "norm_w": sd["image_encoder.norm.weight"],
        "norm_b": sd["image_encoder.norm.bias"],
    }

    prompt = {
        "pe_gaussian": sd["prompt_encoder.pe_layer.positional_encoding_gaussian_matrix"],
        "no_mask_embed": sd["prompt_encoder.no_mask_embed.weight"].reshape(-1),
    }
    # point/box prompt identities (Embedding(1, C) each); the reference's 2-D
    # mask_downscaling stack is dead code on 3-D inputs and is NOT imported:
    # the 3-D equivalent keeps its fresh init (models/segvol/decoder.py)
    if "prompt_encoder.point_embeddings.0.weight" in sd:
        prompt["point_embeddings"] = torch.stack(
            [sd[f"prompt_encoder.point_embeddings.{i}.weight"].reshape(-1) for i in range(4)])
        prompt["not_a_point_embed"] = sd["prompt_encoder.not_a_point_embed.weight"].reshape(-1)

    md = "mask_decoder."
    # mask tokens: pad pretrained rows to 1 + num_instances
    mt = sd[md + "mask_tokens.weight"]
    if mt.shape[0] < cfg.num_mask_tokens:
        if fresh_mask_tokens is not None:
            pad = _cpu(fresh_mask_tokens)[mt.shape[0]: cfg.num_mask_tokens].to(mt.dtype)
        else:
            pad = mt.new_zeros((cfg.num_mask_tokens - mt.shape[0], mt.shape[1]))
        mt = torch.cat([mt, pad], dim=0)
    mt = mt[: cfg.num_mask_tokens]

    # LayerNormNd stats possibly stored 4-D: mean-collapse (mask_decoder.py:76-81)
    ln_w = sd[md + "output_upscaling.1.weight"]
    ln_b = sd[md + "output_upscaling.1.bias"]
    if ln_w.dim() > 1:
        collapse = lambda t: t.reshape(t.shape[0], -1).double().mean(-1).to(t.dtype)
        ln_w, ln_b = collapse(ln_w), collapse(ln_b)

    def attn(prefix):
        return {
            "q_w": _t(sd[prefix + "q_proj.weight"]), "q_b": sd[prefix + "q_proj.bias"],
            "k_w": _t(sd[prefix + "k_proj.weight"]), "k_b": sd[prefix + "k_proj.bias"],
            "v_w": _t(sd[prefix + "v_proj.weight"]), "v_b": sd[prefix + "v_proj.bias"],
            "out_w": _t(sd[prefix + "out_proj.weight"]), "out_b": sd[prefix + "out_proj.bias"],
        }

    def ln(prefix):
        return {"w": sd[prefix + "weight"], "b": sd[prefix + "bias"]}

    layers = []
    for i in range(cfg.decoder_depth):
        p = f"{md}transformer.layers.{i}."
        layers.append({
            "self_attn": attn(p + "self_attn."),
            "norm1": ln(p + "norm1."),
            "cross_t2i": attn(p + "cross_attn_token_to_image."),
            "norm2": ln(p + "norm2."),
            "mlp_fc1_w": _t(sd[p + "mlp.lin1.weight"]), "mlp_fc1_b": sd[p + "mlp.lin1.bias"],
            "mlp_fc2_w": _t(sd[p + "mlp.lin2.weight"]), "mlp_fc2_b": sd[p + "mlp.lin2.bias"],
            "norm3": ln(p + "norm3."),
            "cross_i2t": attn(p + "cross_attn_image_to_token."),
            "norm4": ln(p + "norm4."),
        })

    def mlp3(prefix):
        return {
            "w1": _t(sd[prefix + "layers.0.weight"]), "b1": sd[prefix + "layers.0.bias"],
            "w2": _t(sd[prefix + "layers.1.weight"]), "b2": sd[prefix + "layers.1.bias"],
            "w3": _t(sd[prefix + "layers.2.weight"]), "b3": sd[prefix + "layers.2.bias"],
        }

    decoder = {
        "iou_token": sd[md + "iou_token.weight"],
        "mask_tokens": mt,
        "transformer": {
            "layers": _stack_trees(layers),
            "final_attn": attn(md + "transformer.final_attn_token_to_image."),
            "norm_final": ln(md + "transformer.norm_final_attn."),
        },
        "up1_w": sd[md + "output_upscaling.0.weight"],
        "up1_b": sd[md + "output_upscaling.0.bias"],
        "up_ln": {"w": ln_w, "b": ln_b},
        "up2_w": sd[md + "output_upscaling.3.weight"],
        "up2_b": sd[md + "output_upscaling.3.bias"],
        "hyper_semantic": mlp3(md + "output_hypernetworks_mlps.0."),
        "hyper_instance": mlp3(md + "output_hypernetworks_mlps.1."),
        "txt_align_w": _t(sd[md + "txt_align_upscaled_embedding.weight"]),
        "txt_align_b": sd[md + "txt_align_upscaled_embedding.bias"],
    }
    return {"encoder": encoder, "prompt": prompt, "decoder": decoder}


def merge_imported(fresh: dict, imported: dict) -> dict:
    """Overlay imported leaves onto a freshly initialized tree: heads the
    checkpoint does not cover keep their init, every other leaf must agree in
    shape and takes the fresh leaf's device and dtype."""
    out = {}
    for k, v in fresh.items():
        if k not in imported:
            out[k] = v
        elif isinstance(v, dict):
            out[k] = merge_imported(v, imported[k])
        else:
            iv = _cpu(imported[k])
            if tuple(iv.shape) != tuple(v.shape):
                raise ValueError(f"shape mismatch at {k}: {tuple(iv.shape)} vs {tuple(v.shape)}")
            out[k] = iv.to(dtype=v.dtype).to(device=v.device)
    return out
