"""Plain PyTorch reference of the VividMed grounded-report model, in fp32
with TF32 off.

Written from the architecture, not from the port: EVA2-CLIP-E ViT over a
3-D volume (strided patch convolution, resampled position grid, cls token,
post-norm layers, 2x2x2 max pool, GLU projection, boi/eoi), the CogVLM
decoder with a vision and a language expert in every layer (a token takes
the vision expert when it and its successor are image tokens), LLaMA
rotary embeddings by position id, RMSNorm, SwiGLU, and the SegVol SAM head
(pre-norm ViT encoder, random-Fourier positional grid, two-way mask
decoder, two stride-2 transposed convolutions, hypernetwork masks,
trilinear resize). It imports nothing of the program; its weights are drawn
again from the seed by ``benchmark.weights``, one layer at a time, and the
program's int8 weight quantization is worked out again from them.

Departures: none in the mathematics. The program's bf16 GELU is a fitted
polynomial of the exact GELU; the reference takes the exact one.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import weights as W

LLM_QUANTIZED = ("vis_qkv", "lang_qkv", "vis_dense", "lang_dense", "vis_mlp/gate", "vis_mlp/up",
                 "vis_mlp/down", "lang_mlp/gate", "lang_mlp/up", "lang_mlp/down")


# ``llm_weight_bits`` the reference models: int8 per output channel, or the
# weights as drawn (16: the configuration's bf16 or fp32)
MODELLED_BITS = (8, 16)


def refuse_unmodelled(cfg: dict) -> None:
    """Raise on a configuration whose LLM weights the reference would not
    quantize as the configuration states."""
    if cfg["llm_weight_bits"] not in MODELLED_BITS:
        raise ValueError(f"the reference models llm_weight_bits {MODELLED_BITS}, not "
                         f"{cfg['llm_weight_bits']}: add that quantization to the reference")


def strict_fp32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def int8_weight(w: torch.Tensor) -> torch.Tensor:
    """Symmetric int8 per output channel over the contraction dim (-2) of an
    ``(in, out)`` weight, as the configuration states; returned dequantized
    in fp32."""
    wf = w.float()
    scale = wf.abs().amax(dim=-2, keepdim=True).clamp_min(1e-8) / 127.0
    return torch.round(wf / scale) * scale


def layer_norm(x, w, b, eps):
    return F.layer_norm(x, x.shape[-1:], w.float(), b.float(), eps)


def rms_norm(x, w, eps):
    return w.float() * (x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps))


def attention(q, k, v, scale, mask=None):
    """q, k, v (N, H, S, D); ``mask`` broadcast to (N, H, Sq, Sk), True = see."""
    logits = (q @ k.transpose(-1, -2)) * scale
    if mask is not None:
        logits = logits.masked_fill(~mask, float("-inf"))
    return torch.softmax(logits, dim=-1) @ v


def heads(x, h):
    n, s, c = x.shape
    return x.reshape(n, s, h, c // h).transpose(1, 2)


def merge(x):
    n, h, s, d = x.shape
    return x.transpose(1, 2).reshape(n, s, h * d)


def patch_embed(image, w, b, patch):
    """Non-overlapping patches of a volume through a convolution whose
    stored depth is summed down to the patch depth ``patch[0]``."""
    co, ci, dmax, kh, kw = w.shape
    pz = patch[0]
    w = w.reshape(co, ci, pz, dmax // pz, kh, kw).sum(dim=3)
    return F.conv3d(image.float(), w, b, stride=tuple(patch))


def continue_positions(last_pos: int, last_tok: int, served, bop: int, eop: int) -> list:
    """Position ids of the served tokens when they are fed back: one past
    the previous token's, held where the previous token is ``<p>`` or the
    token is ``</p>``."""
    out, pos, prev = [], last_pos, last_tok
    for t in served:
        pos = pos + (0 if (prev == bop or t == eop) else 1)
        out.append(pos)
        prev = t
    return out


class Reference:
    """The model of one configuration and seed, on ``device``."""

    def __init__(self, cfg: dict, seed: int, device):
        self.cfg, self.seed, self.dev = cfg, seed, torch.device(device)
        self.vlm, self.vis, self.sam = cfg["vlm"], cfg["vlm"]["vision"], cfg["sam"]
        refuse_unmodelled(cfg)
        self.bits = cfg["llm_weight_bits"]

    def _leaves(self, prefix):
        return {k: v.float() for k, v in W.draw_leaves(self.cfg, self.seed, prefix, self.dev).items()}

    def _layer(self, prefix, li):
        return W.draw_layer(self.cfg, self.seed, prefix, li, self.dev)

    def _llm_weight(self, w):
        return int8_weight(w) if self.bits == 8 else w.float()

    # ---- vision tower -------------------------------------------------
    def vision_tokens(self, image: torch.Tensor, patch, pool) -> torch.Tensor:
        """(N, C, D, H, W) volume -> (N, 2 + T', C_llm) LLM-space tokens."""
        v = self.vis
        p = self._leaves("cogvlm/vision/patch")
        x = patch_embed(image, p["proj_w"], p["proj_b"], patch)
        n, c, gd, gh, gw = x.shape
        pos = F.interpolate(p["pos"], size=(gd, gh, gw), mode="trilinear", align_corners=False)
        x = (x + pos).flatten(2).transpose(1, 2)
        cls = (p["cls"] + p["cls_pos"])[None].expand(n, 1, c)
        x = torch.cat([cls, x], dim=1)
        h, eps = v["num_heads"], v["layer_norm_eps"]
        for li in range(v["num_hidden_layers"]):
            lp = {k: t.float() for k, t in self._layer("cogvlm/vision/layers", li).items()}
            qkv = x @ lp["qkv_w"] + lp["qkv_b"]
            q, k, vv = (heads(t, h) for t in qkv.split(c, dim=-1))
            a = merge(attention(q, k, vv, (c // h) ** -0.5)) @ lp["dense_w"] + lp["dense_b"]
            x = x + layer_norm(a, lp["ln1_w"], lp["ln1_b"], eps)
            m = F.gelu(x @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
            x = x + layer_norm(m, lp["ln2_w"], lp["ln2_b"], eps)
        x = x[:, 1:].transpose(1, 2).reshape(n, c, gd, gh, gw)
        x = F.max_pool3d(x, kernel_size=tuple(pool), stride=tuple(pool)).flatten(2).transpose(1, 2)
        g = self._leaves("cogvlm/vision/glu")
        x = F.gelu(layer_norm(x @ g["linear_proj"], g["ln_w"], g["ln_b"], self.cfg["glu_ln_eps"]))
        x = (F.silu(x @ g["gate"]) * (x @ g["h4h"])) @ g["4hh"]
        ends = self._leaves("cogvlm/vision")
        boi = ends["boi"][None, None].expand(n, 1, -1)
        eoi = ends["eoi"][None, None].expand(n, 1, -1)
        return torch.cat([boi, x, eoi], dim=1)

    # ---- language model -----------------------------------------------
    def embed(self, ids: torch.Tensor) -> torch.Tensor:
        table = W.draw(self.cfg, self.seed, "cogvlm/llm/embed_tokens",
                       W.model_spec(self.cfg)["cogvlm/llm/embed_tokens"], None, self.dev)
        return table[ids.long()].float()

    def llm_hidden(self, x, token_types, positions, valid) -> torch.Tensor:
        """Causal forward of right-padded sequences ``x`` (N, S, C) fp32 with
        ``token_types`` and ``positions`` (N, S) and ``valid`` (N, S) bool;
        returns the final-norm hidden states (N, S, C)."""
        vlm = self.vlm
        n, s, c = x.shape
        h = vlm["num_attention_heads"]
        d = c // h
        eps = vlm["rms_norm_eps"]
        tt = token_types
        vis = F.pad((tt[:, :-1] == 1) & (tt[:, 1:] == 1), (0, 1), value=False)[..., None]
        inv = 1.0 / (vlm["rope_base"] ** (torch.arange(0, d, 2, device=self.dev).float() / d))
        ang = positions.float()[..., None] * inv
        ang = torch.cat([ang, ang], dim=-1)[:, None]  # (N, 1, S, D)
        cos, sin = ang.cos(), ang.sin()

        def rope(t):
            t1, t2 = t.chunk(2, dim=-1)
            return t * cos + torch.cat([-t2, t1], dim=-1) * sin

        idx = torch.arange(s, device=self.dev)
        mask = (idx[None, :] <= idx[:, None])[None, None] & valid[:, None, None, :]
        for li in range(vlm["num_hidden_layers"]):
            raw = self._layer("cogvlm/llm/layers", li)
            lp = {k: (self._llm_weight(t) if k in LLM_QUANTIZED else t.float())
                  for k, t in raw.items()}
            del raw

            def expert(t, name):
                return torch.where(vis, t @ lp[f"vis_{name}"], t @ lp[f"lang_{name}"])

            def swiglu(t, e):
                return (F.silu(t @ lp[f"{e}_mlp/gate"]) * (t @ lp[f"{e}_mlp/up"])) @ lp[f"{e}_mlp/down"]

            y = rms_norm(x, lp["input_ln"], eps)
            q, k, v = (heads(t, h) for t in expert(y, "qkv").split(c, dim=-1))
            ctx = merge(attention(rope(q), rope(k), v, d ** -0.5, mask))
            x = x + expert(ctx, "dense")
            y = rms_norm(x, lp["post_ln"], eps)
            x = x + torch.where(vis, swiglu(y, "vis"), swiglu(y, "lang"))
            del lp
        norm = self._leaves("cogvlm/llm")["norm"]
        return rms_norm(x, norm, eps)

    def lm_head(self) -> torch.Tensor:
        spec = W.model_spec(self.cfg)["cogvlm/llm/lm_head"]
        head = W.draw(self.cfg, self.seed, "cogvlm/llm/lm_head", spec, None, self.dev)
        return int8_weight(head) if self.bits == 8 else head.float()

    # ---- grounding -----------------------------------------------------
    def vg_project(self, hidden: torch.Tensor) -> torch.Tensor:
        p = self._leaves("vg_proj")
        return F.relu(hidden @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]

    def sam_masks(self, image: torch.Tensor, patch, prompts: torch.Tensor) -> torch.Tensor:
        """Semantic mask logits (N, T, D, H, W) of grounding volumes (N, C, D,
        H, W) for text prompts (N, T, C_sam)."""
        sam = self.sam
        p = self._leaves("sam/encoder")
        x = patch_embed(image, p["patch/proj_w"], p["patch/proj_b"], patch)
        n, c, gd, gh, gw = x.shape
        pos = F.interpolate(p["patch/pos"], size=(gd, gh, gw), mode="trilinear",
                            align_corners=False)
        x = (x + pos).flatten(2).transpose(1, 2)
        h, eps = sam["encoder_num_heads"], self.cfg["sam_ln_eps"]
        for li in range(sam["encoder_num_layers"]):
            lp = {k: t.float() for k, t in self._layer("sam/encoder/layers", li).items()}
            y = layer_norm(x, lp["ln1_w"], lp["ln1_b"], eps)
            q, k, v = (heads(t, h) for t in (y @ lp["qkv_w"]).split(c, dim=-1))
            x = x + merge(attention(q, k, v, (c // h) ** -0.5)) @ lp["out_w"] + lp["out_b"]
            y = layer_norm(x, lp["ln2_w"], lp["ln2_b"], eps)
            x = x + F.gelu(y @ lp["fc1_w"] + lp["fc1_b"]) @ lp["fc2_w"] + lp["fc2_b"]
        emb = layer_norm(x, p["norm_w"], p["norm_b"], eps)  # (N, T_img, C)

        pr = self._leaves("sam/prompt")
        z, y_, x_ = torch.meshgrid(*(torch.arange(g, device=self.dev).float() + 0.5
                                     for g in (gd, gh, gw)), indexing="ij")
        coords = torch.stack([y_ / gh, z / gd, x_ / gw], dim=-1) * 2 - 1
        proj = 2 * math.pi * (coords @ pr["pe_gaussian"])
        pe = torch.cat([proj.sin(), proj.cos()], dim=-1).reshape(-1, c)  # (T_img, C)

        t = prompts.shape[1]
        flat = prompts.reshape(n * t, c)
        keys = (emb + pr["no_mask_embed"]).repeat_interleave(t, dim=0)
        d = self._leaves("sam/decoder")
        tokens = torch.cat([d["iou_token"], d["mask_tokens"]], dim=0)
        point = torch.cat([tokens[None].expand(n * t, -1, -1), flat[:, None]], dim=1)
        queries, keys = self._two_way(keys, pe, point)
        k_mask = sam["num_instances"] + 1
        mask_tok = queries[:, 1:1 + k_mask]

        up = keys.transpose(1, 2).reshape(n * t, c, gd, gh, gw)
        up = F.conv_transpose3d(up, d["up1_w"], d["up1_b"], stride=2)
        up = layer_norm(up.permute(0, 2, 3, 4, 1), d["up_ln/w"], d["up_ln/b"], eps)
        up = F.gelu(up.permute(0, 4, 1, 2, 3))
        up = F.gelu(F.conv_transpose3d(up, d["up2_w"], d["up2_b"], stride=2))

        def mlp3(name, x):
            x = F.relu(x @ d[f"{name}/w1"] + d[f"{name}/b1"])
            x = F.relu(x @ d[f"{name}/w2"] + d[f"{name}/b2"])
            return x @ d[f"{name}/w3"] + d[f"{name}/b3"]

        semantic = mlp3("hyper_semantic", mask_tok[:, 0]) + (flat @ d["txt_align_w"] + d["txt_align_b"])
        low = torch.einsum("nc,ncdhw->ndhw", semantic, up)
        full = F.interpolate(low[:, None], size=tuple(image.shape[2:]), mode="trilinear",
                             align_corners=False)[:, 0]
        return full.reshape(n, t, *full.shape[1:])

    def _two_way(self, keys, pe, point):
        sam, eps = self.sam, self.cfg["sam_ln_eps"]
        h = sam["decoder_num_heads"]
        base = "sam/decoder/transformer"

        def attn(p, q, k, v):
            qh, kh, vh = (heads(t @ p[f"{n}_w"] + p[f"{n}_b"], h)
                          for t, n in ((q, "q"), (k, "k"), (v, "v")))
            out = attention(qh, kh, vh, qh.shape[-1] ** -0.5)
            return merge(out) @ p["out_w"] + p["out_b"]

        def sub(lp, name):
            return {k[len(name) + 1:]: v for k, v in lp.items() if k.startswith(name + "/")}

        queries = point
        for li in range(sam["decoder_depth"]):
            lp = {k: v.float() for k, v in self._layer(base + "/layers", li).items()}
            if li == 0:
                queries = attn(sub(lp, "self_attn"), queries, queries, queries)
            else:
                q = queries + point
                queries = queries + attn(sub(lp, "self_attn"), q, q, queries)
            queries = layer_norm(queries, lp["norm1/w"], lp["norm1/b"], eps)
            q, k = queries + point, keys + pe
            queries = layer_norm(queries + attn(sub(lp, "cross_t2i"), q, k, keys),
                                 lp["norm2/w"], lp["norm2/b"], eps)
            mlp = F.relu(queries @ lp["mlp_fc1_w"] + lp["mlp_fc1_b"]) @ lp["mlp_fc2_w"] + lp["mlp_fc2_b"]
            queries = layer_norm(queries + mlp, lp["norm3/w"], lp["norm3/b"], eps)
            q, k = queries + point, keys + pe
            keys = layer_norm(keys + attn(sub(lp, "cross_i2t"), k, q, queries),
                              lp["norm4/w"], lp["norm4/b"], eps)
        top = self._leaves(base)
        q, k = queries + point, keys + pe
        queries = layer_norm(queries + attn(sub(top, "final_attn"), q, k, keys),
                             top["norm_final/w"], top["norm_final/b"], eps)
        return queries, keys
