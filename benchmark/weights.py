"""Seeded weights of the VividMed model, made by the benchmark and handed to
both sides.

Every leaf, and every layer of a stacked leaf, is drawn from its own
``torch.Generator`` whose seed is a hash of the run's seed, the leaf's path
and the layer index. The program gets the whole tree, made on the device in
the dtype it is served in; the reference draws any one layer again, with
the same call, long after the program has quantized and released its
copy. The tree's layout is the port's (linear weights ``(in, out)``,
layers stacked on a leading axis); the initializers are the model's
(normal(0, std) weights, zero biases, unit norms).
"""
from __future__ import annotations

import hashlib

import torch

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _leaf(shape, init="normal", std=None, fp32=False, stacked=False):
    return {"shape": tuple(shape), "init": init, "std": std, "fp32": fp32, "stacked": stacked}


def llm_spec(vlm: dict) -> dict:
    c, i, n, v = (vlm["hidden_size"], vlm["intermediate_size"], vlm["num_hidden_layers"],
                  vlm["vocab_size"])
    s = lambda shape, init="normal": _leaf((n, *shape), init, stacked=True)
    spec = {"embed_tokens": _leaf((v, c)), "norm": _leaf((c,), "ones"), "lm_head": _leaf((c, v))}
    for e in ("vis", "lang"):
        spec[f"layers/{e}_qkv"] = s((c, 3 * c))
        spec[f"layers/{e}_dense"] = s((c, c))
        spec[f"layers/{e}_mlp/gate"] = s((c, i))
        spec[f"layers/{e}_mlp/up"] = s((c, i))
        spec[f"layers/{e}_mlp/down"] = s((i, c))
    spec["layers/input_ln"] = s((c,), "ones")
    spec["layers/post_ln"] = s((c,), "ones")
    return spec


def vit_spec(vlm: dict) -> dict:
    vc = vlm["vision"]
    c, i, n = vc["hidden_size"], vc["intermediate_size"], vc["num_hidden_layers"]
    cl, il = vlm["hidden_size"], vlm["intermediate_size"]
    s = lambda shape, init="normal": _leaf((n, *shape), init, stacked=True)
    return {
        "patch/proj_w": _leaf((c, vc["in_channels"], *vc["patch_size"])),
        "patch/proj_b": _leaf((c,), "zeros"), "patch/cls": _leaf((1, c), "zeros"),
        "patch/cls_pos": _leaf((1, c), "zeros"), "patch/pos": _leaf((1, c, *vc["pos_embed_shape"])),
        "layers/qkv_w": s((c, 3 * c)), "layers/qkv_b": s((3 * c,), "zeros"),
        "layers/dense_w": s((c, c)), "layers/dense_b": s((c,), "zeros"),
        "layers/ln1_w": s((c,), "ones"), "layers/ln1_b": s((c,), "zeros"),
        "layers/ln2_w": s((c,), "ones"), "layers/ln2_b": s((c,), "zeros"),
        "layers/fc1_w": s((c, i)), "layers/fc1_b": s((i,), "zeros"),
        "layers/fc2_w": s((i, c)), "layers/fc2_b": s((c,), "zeros"),
        "glu/linear_proj": _leaf((c, cl)), "glu/ln_w": _leaf((cl,), "ones"),
        "glu/ln_b": _leaf((cl,), "zeros"), "glu/gate": _leaf((cl, il)),
        "glu/h4h": _leaf((cl, il)), "glu/4hh": _leaf((il, cl)),
        "boi": _leaf((cl,), "zeros"), "eoi": _leaf((cl,), "zeros"),
    }


def sam_spec(sam: dict) -> dict:
    """The semantic SAM head (fp32): encoder, text prompt, mask decoder."""
    f = lambda shape, init="normal", std=None: _leaf(shape, init, std, fp32=True)
    st = lambda depth, shape, init="normal": _leaf((depth, *shape), init, fp32=True, stacked=True)
    c, n = sam["embed_dim"], sam["encoder_num_layers"]
    i = c * sam["encoder_mlp_ratio"]
    dd, md = sam["decoder_depth"], sam["decoder_mlp_dim"]
    internal = c // sam["attention_downsample_rate"]
    spec = {
        "encoder/patch/proj_w": f((c, sam["in_channels"], *sam["patch_size"])),
        "encoder/patch/proj_b": f((c,), "zeros"), "encoder/patch/pos": f((1, c, *sam["pos_embed_shape"])),
        "encoder/layers/qkv_w": st(n, (c, 3 * c)), "encoder/layers/out_w": st(n, (c, c)),
        "encoder/layers/out_b": st(n, (c,), "zeros"),
        "encoder/layers/ln1_w": st(n, (c,), "ones"), "encoder/layers/ln1_b": st(n, (c,), "zeros"),
        "encoder/layers/ln2_w": st(n, (c,), "ones"), "encoder/layers/ln2_b": st(n, (c,), "zeros"),
        "encoder/layers/fc1_w": st(n, (c, i)), "encoder/layers/fc1_b": st(n, (i,), "zeros"),
        "encoder/layers/fc2_w": st(n, (i, c)), "encoder/layers/fc2_b": st(n, (c,), "zeros"),
        "encoder/norm_w": f((c,), "ones"), "encoder/norm_b": f((c,), "zeros"),
        "prompt/pe_gaussian": f((3, c // 2), std=1.0), "prompt/no_mask_embed": f((c,)),
        "decoder/iou_token": f((1, c)), "decoder/mask_tokens": f((sam["num_instances"] + 1, c)),
        "decoder/up1_w": f((c, c // 4, 2, 2, 2)), "decoder/up1_b": f((c // 4,), "zeros"),
        "decoder/up_ln/w": f((c // 4,), "ones"), "decoder/up_ln/b": f((c // 4,), "zeros"),
        "decoder/up2_w": f((c // 4, c // 8, 2, 2, 2)), "decoder/up2_b": f((c // 8,), "zeros"),
        "decoder/txt_align_w": f((c, c // 8)), "decoder/txt_align_b": f((c // 8,), "zeros"),
        "decoder/transformer/norm_final/w": f((c,), "ones"),
        "decoder/transformer/norm_final/b": f((c,), "zeros"),
    }
    for hyper in ("hyper_semantic", "hyper_instance"):
        for k, shape in (("w1", (c, c)), ("w2", (c, c)), ("w3", (c, c // 8))):
            spec[f"decoder/{hyper}/{k}"] = f(shape)
            spec[f"decoder/{hyper}/b{k[1]}"] = f(shape[-1:], "zeros")
    t = "decoder/transformer/layers"
    for name, width in (("self_attn", c), ("cross_t2i", internal), ("cross_i2t", internal)):
        for p in ("q", "k", "v"):
            spec[f"{t}/{name}/{p}_w"] = st(dd, (c, width))
            spec[f"{t}/{name}/{p}_b"] = st(dd, (width,), "zeros")
        spec[f"{t}/{name}/out_w"] = st(dd, (width, c))
        spec[f"{t}/{name}/out_b"] = st(dd, (c,), "zeros")
    for p in ("q", "k", "v"):
        spec[f"decoder/transformer/final_attn/{p}_w"] = f((c, internal))
        spec[f"decoder/transformer/final_attn/{p}_b"] = f((internal,), "zeros")
    spec["decoder/transformer/final_attn/out_w"] = f((internal, c))
    spec["decoder/transformer/final_attn/out_b"] = f((c,), "zeros")
    for k in ("norm1", "norm2", "norm3", "norm4"):
        spec[f"{t}/{k}/w"] = st(dd, (c,), "ones")
        spec[f"{t}/{k}/b"] = st(dd, (c,), "zeros")
    spec[f"{t}/mlp_fc1_w"] = st(dd, (c, md))
    spec[f"{t}/mlp_fc1_b"] = st(dd, (md,), "zeros")
    spec[f"{t}/mlp_fc2_w"] = st(dd, (md, c))
    spec[f"{t}/mlp_fc2_b"] = st(dd, (c,), "zeros")
    return spec


def model_spec(cfg: dict) -> dict:
    """``{path: leaf}`` of the whole served tree."""
    c, pd = cfg["vlm"]["hidden_size"], cfg["sam"]["embed_dim"]
    spec = {f"cogvlm/llm/{k}": v for k, v in llm_spec(cfg["vlm"]).items()}
    spec.update({f"cogvlm/vision/{k}": v for k, v in vit_spec(cfg["vlm"]).items()})
    spec.update({f"sam/{k}": v for k, v in sam_spec(cfg["sam"]).items()})
    spec.update({"vg_proj/w1": _leaf((c, c), fp32=True), "vg_proj/b1": _leaf((c,), "zeros", fp32=True),
                 "vg_proj/w2": _leaf((c, pd), fp32=True), "vg_proj/b2": _leaf((pd,), "zeros", fp32=True)})
    return spec


def leaf_seed(seed: int, path: str, layer: int | None) -> int:
    digest = hashlib.blake2b(f"{seed}/{path}/{layer}".encode(), digest_size=8).digest()
    return int.from_bytes(digest, "little") & ((1 << 63) - 1)


def draw(cfg: dict, seed: int, path: str, leaf: dict, layer: int | None, device) -> torch.Tensor:
    """One leaf (or one layer of a stacked leaf) in its served dtype."""
    dtype = torch.float32 if leaf["fp32"] else DTYPES[cfg["dtype"]]
    shape = leaf["shape"][1:] if leaf["stacked"] else leaf["shape"]
    if leaf["init"] == "zeros":
        return torch.zeros(shape, dtype=dtype, device=device)
    if leaf["init"] == "ones":
        return torch.ones(shape, dtype=dtype, device=device)
    gen = torch.Generator(device=device).manual_seed(leaf_seed(seed, path, layer))
    std = cfg.get("init_std_overrides", {}).get(path, leaf["std"] or cfg["init_std"])
    w = torch.randn(shape, generator=gen, dtype=dtype, device=device).mul_(std)
    if path == "cogvlm/llm/lm_head":
        for tok, bias in cfg["head_bias"].items():  # so the random model writes tag pairs
            w[:, int(tok)] += bias
    return w


def draw_layer(cfg: dict, seed: int, prefix: str, layer: int, device) -> dict:
    """``{relative path: tensor}`` of one layer of the stacked leaves under
    ``prefix`` (the reference's blocks)."""
    spec = model_spec(cfg)
    out = {}
    for path, leaf in spec.items():
        if path.startswith(prefix + "/") and leaf["stacked"]:
            out[path[len(prefix) + 1:]] = draw(cfg, seed, path, leaf, layer, device)
    return out


def draw_leaves(cfg: dict, seed: int, prefix: str, device) -> dict:
    """The unstacked leaves under ``prefix``, by relative path."""
    return {path[len(prefix) + 1:]: draw(cfg, seed, path, leaf, None, device)
            for path, leaf in model_spec(cfg).items()
            if path.startswith(prefix + "/") and not leaf["stacked"]}


def make_tree(cfg: dict, seed: int, device) -> dict:
    """The whole tree as nested dicts, stacked leaves filled layer by layer."""
    tree: dict = {}
    for path, leaf in model_spec(cfg).items():
        if leaf["stacked"]:
            first = draw(cfg, seed, path, leaf, 0, device)
            t = torch.empty((leaf["shape"][0], *first.shape), dtype=first.dtype, device=device)
            t[0] = first
            for li in range(1, leaf["shape"][0]):
                t[li] = draw(cfg, seed, path, leaf, li, device)
        else:
            t = draw(cfg, seed, path, leaf, None, device)
        *parents, name = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[name] = t
    return tree
