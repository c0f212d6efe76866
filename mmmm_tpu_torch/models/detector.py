"""DINO-style deformable detector for pseudo-box labeling (2-D X-ray), the
port of ``mmmm_tpu/models/detector.py``.

A small conv backbone (strides 8/16/32, GroupNorm), a deformable-attention
encoder over the multi-scale tokens (``ops/deform_attn.py``), two-stage
query selection, an iterative box-refinement decoder, and the DETR set
loss with exact rectangular assignment (``ops/hungarian.py
lap_rectangular``: the kernel LAP on the card).

Parameters keep the JAX tree: nested dicts and lists, linear weights
``(in, out)``, conv weights HWIO (permuted to OIHW at use), so a
``params.npz`` of either package loads in the other. The public layout is
JAX's: images (B, H, W, 1) in [0, 1], boxes normalized cxcywh.

Where the port differs in form, not in value:
  - ``"SAME"`` padding with a stride is asymmetric (the 7x7 stem at stride 4
    on 512 pads (1, 2)); the port pads explicitly, then convolves unpadded;
  - ``lax.top_k`` takes ties at the lower index: the port sorts stably;
  - ``detector_loss`` builds the cost matrices of every (head, image) first
    and solves them in one ``lap_rectangular`` call (one LAP launch a call)
    where JAX makes four vmapped calls;
  - clips are ``maximum``/``minimum``, whose gradient at a tie is halved as
    JAX's is (``clamp``'s is not).
``select_boxes``, ``equalize_image`` and ``compute_map`` are numpy, copied.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch
import torch.nn.functional as F

from ..ops.deform_attn import ms_deform_attn
from ..ops.hungarian import lap_rectangular
from ..ops.resample import pad_same
from ..params import Leaf, _init_tree

# VinDr-CXR finding -> taxonomy name (ref infer.py:18-42; "Other lesion" is
# dropped there too). Order defines the class-id space of the detector.
VINDR_CLASSES = [
    "aortic enlargement", "atelectasis", "calcification", "cardiomegaly",
    "clavicle fracture", "pulmonary consolidation", "pulmonary edema",
    "pulmonary emphysema", "pulmonary artery enlargement",
    "interstitial lung disease", "pulmonary infiltrate", "pulmonary cavity",
    "pulmonary cyst", "pulmonary opacification", "mediastinal shift",
    "lung nodule",
    "pleural effusion", "pleural thickening", "pneumothorax",
    "pulmonary fibrosis", "rib fracture",
]


@dataclasses.dataclass(frozen=True)
class DetectorConfig:
    num_classes: int = len(VINDR_CLASSES)
    d_model: int = 128
    n_heads: int = 8
    n_points: int = 4
    enc_layers: int = 3
    dec_layers: int = 3
    ffn_dim: int = 512
    num_queries: int = 100
    backbone_dims: tuple[int, ...] = (32, 64, 128, 128)  # /4 /8 /16 /32
    image_size: int = 512
    max_gt: int = 24  # static padded GT slots per image
    focal_alpha: float = 0.25
    focal_gamma: float = 2.0
    cost_class: float = 2.0
    cost_bbox: float = 5.0
    cost_giou: float = 2.0

    @property
    def n_levels(self) -> int:
        return 3  # /8, /16, /32

    def level_shapes(self) -> list[tuple[int, int]]:
        return [(self.image_size // s, self.image_size // s) for s in (8, 16, 32)]


# ------------------------------------------------------------- parameter tree

def _linear_spec(d_in, d_out, zero=False):
    return {"w": Leaf((d_in, d_out), "zeros" if zero else "normal", d_in ** -0.5, fp32=True),
            "b": _zeros(d_out)}


def _mlp_spec(dims):
    return [_linear_spec(a, b) for a, b in zip(dims[:-1], dims[1:])]


def _zeros(*shape):
    return Leaf(shape, "zeros", fp32=True)


def _norm_spec(d):
    return {"scale": Leaf((d,), "ones", fp32=True), "bias": _zeros(d)}


def _conv_spec(kh, kw, c_in, c_out):
    return {"w": Leaf((kh, kw, c_in, c_out), std=(2.0 / (kh * kw * c_in)) ** 0.5, fp32=True),
            "b": _zeros(c_out)}


def _deform_attn_spec(cfg):
    h, lv, p = cfg.n_heads, cfg.n_levels, cfg.n_points
    # deformable-DETR init: point offsets spread on a ring per head
    theta = np.arange(h) * 2 * math.pi / h
    grid = np.stack([np.cos(theta), np.sin(theta)], -1)
    grid = grid / np.abs(grid).max(-1, keepdims=True)
    ring = np.tile(grid[:, None, None, :], (1, lv, p, 1)) * np.arange(1, p + 1)[None, None, :, None]
    offsets = _linear_spec(cfg.d_model, h * lv * p * 2, zero=True)
    offsets["b"] = Leaf((h * lv * p * 2,), "fill", fp32=True,
                        value=tuple(ring.reshape(-1).astype(np.float32)))
    return {"offsets": offsets, "weights": _linear_spec(cfg.d_model, h * lv * p, zero=True),
            "value": _linear_spec(cfg.d_model, cfg.d_model), "out": _linear_spec(cfg.d_model, cfg.d_model)}


def detector_spec(cfg: DetectorConfig) -> dict:
    """The parameter tree of ``init_detector_params`` as ``params.Leaf``s (fp32)."""
    d, dims = cfg.d_model, cfg.backbone_dims
    backbone = {"stem": _conv_spec(7, 7, 1, dims[0]), "stem_gn": _norm_spec(dims[0])}
    for i in range(1, 4):
        backbone[f"down{i}"] = _conv_spec(3, 3, dims[i - 1], dims[i])
        backbone[f"gn{i}a"] = _norm_spec(dims[i])
        backbone[f"res{i}"] = _conv_spec(3, 3, dims[i], dims[i])
        backbone[f"gn{i}b"] = _norm_spec(dims[i])
    mha = {k: _linear_spec(d, d) for k in ("q", "k", "v", "out")}
    prior = -math.log((1 - 0.01) / 0.01)  # focal-friendly class bias (prior 0.01)
    return {
        "backbone": backbone,
        "input_proj": [{**_linear_spec(dims[i], d), "gn": _norm_spec(d)} for i in (1, 2, 3)],
        "level_embed": Leaf((cfg.n_levels, d), fp32=True),
        "encoder": [{"attn": _deform_attn_spec(cfg), "ln1": _norm_spec(d),
                     "ffn": _mlp_spec((d, cfg.ffn_dim, d)), "ln2": _norm_spec(d)}
                    for _ in range(cfg.enc_layers)],
        "enc_out_ln": _norm_spec(d),
        "enc_class": {"w": _linear_spec(d, cfg.num_classes)["w"],
                      "b": Leaf((cfg.num_classes,), "fill", fp32=True, value=prior)},
        "enc_box": _mlp_spec((d, d, 4)),
        "query_embed": Leaf((cfg.num_queries, d), fp32=True),
        "ref_point_head": _mlp_spec((d, d, d)),
        "decoder": [{"self_attn": dict(mha), "ln1": _norm_spec(d),
                     "cross_attn": _deform_attn_spec(cfg), "ln2": _norm_spec(d),
                     "ffn": _mlp_spec((d, cfg.ffn_dim, d)), "ln3": _norm_spec(d),
                     "box_head": _mlp_spec((d, d, 4))}
                    for _ in range(cfg.dec_layers)],
        "class_head": {"w": _linear_spec(d, cfg.num_classes)["w"],
                       "b": Leaf((cfg.num_classes,), "fill", fp32=True, value=prior)},
    }


def init_detector_params(cfg: DetectorConfig, seed: int = 0,
                         device: str | torch.device = "cuda") -> dict:
    """Random parameters in the JAX tree's layout (the same initializers;
    another generator, so other values)."""
    return _init_tree(detector_spec(cfg), seed, torch.float32, device)


# ---------------------------------------------------------------- primitives

def _max0(x):
    return torch.maximum(x, x.new_zeros(()))


def _apply_linear(p, x):
    return x @ p["w"] + p["b"]


def _apply_mlp(layers, x):
    for i, p in enumerate(layers):
        x = _apply_linear(p, x)
        if i + 1 < len(layers):
            x = torch.relu(x)
    return x


def _layernorm(p, x, eps=1e-5):
    m = x.mean(-1, keepdim=True)
    v = ((x - m) ** 2).mean(-1, keepdim=True)
    return (x - m) * torch.rsqrt(v + eps) * p["scale"] + p["bias"]


def _groupnorm(p, x, groups=8, eps=1e-5):
    """GroupNorm of NCHW ``x``: groups split the channel axis contiguously,
    as JAX's NHWC reshape does; biased variance."""
    b, c, h, w = x.shape
    g = x.reshape(b, groups, c // groups, h, w)
    m = g.mean((2, 3, 4), keepdim=True)
    v = ((g - m) ** 2).mean((2, 3, 4), keepdim=True)
    g = (g - m) * torch.rsqrt(v + eps)
    return g.reshape(b, c, h, w) * p["scale"][:, None, None] + p["bias"][:, None, None]


def _conv(p, x, stride=1):
    """NCHW ``x``, HWIO weight, ``"SAME"`` padding with JAX's split."""
    x, pad = pad_same(x, p["w"].shape[:2], stride)
    return F.conv2d(x, p["w"].permute(3, 2, 0, 1), p["b"], stride=stride, padding=pad)


def inverse_sigmoid(x, eps=1e-5):
    x = torch.minimum(torch.maximum(x, x.new_tensor(eps)), x.new_tensor(1 - eps))
    return torch.log(x) - torch.log1p(-x)


def box_cxcywh_to_xyxy(b):
    c, s = b[..., :2], b[..., 2:]
    return torch.cat([c - s / 2, c + s / 2], -1)


def giou_2d(a, b):
    """Generalized IoU of broadcastable (..., 4) xyxy boxes."""
    lt = torch.maximum(a[..., :2], b[..., :2])
    rb = torch.minimum(a[..., 2:], b[..., 2:])
    inter = _max0(rb - lt).prod(-1)
    area_a = _max0(a[..., 2:] - a[..., :2]).prod(-1)
    area_b = _max0(b[..., 2:] - b[..., :2]).prod(-1)
    union = area_a + area_b - inter
    iou = inter / torch.maximum(union, union.new_tensor(1e-9))
    hull_lt = torch.minimum(a[..., :2], b[..., :2])
    hull_rb = torch.maximum(a[..., 2:], b[..., 2:])
    hull = _max0(hull_rb - hull_lt).prod(-1)
    return iou - (hull - union) / torch.maximum(hull, hull.new_tensor(1e-9))


def _sine_embed(pos, d):
    """(..., 2) normalized xy -> (..., d) sine/cos embedding."""
    npf = d // 2
    t = 10000 ** ((2 * (torch.arange(npf, device=pos.device) // 2)).float() / npf)
    out = []
    for i in range(2):
        x = pos[..., i:i + 1] * 2 * math.pi / t
        out.append(torch.cat([torch.sin(x[..., 0::2]), torch.cos(x[..., 1::2])], -1))
    return torch.cat(out, -1)


# ------------------------------------------------------------------- forward

def _backbone(params, x):
    p = params["backbone"]
    y = torch.relu(_groupnorm(p["stem_gn"], _conv(p["stem"], x, stride=4)))
    feats = []
    for i in range(1, 4):
        y = torch.relu(_groupnorm(p[f"gn{i}a"], _conv(p[f"down{i}"], y, stride=2)))
        y = y + torch.relu(_groupnorm(p[f"gn{i}b"], _conv(p[f"res{i}"], y)))
        feats.append(y)
    return feats  # /8, /16, /32, NCHW


def _token_centers(shapes, device):
    out = []
    for h, w in shapes:
        ys = (torch.arange(h, device=device) + 0.5) / h
        xs = (torch.arange(w, device=device) + 0.5) / w
        gy, gx = torch.meshgrid(ys, xs, indexing="ij")
        out.append(torch.stack([gx, gy], -1).reshape(-1, 2))
    return torch.cat(out, 0)  # (T, 2)


def _split_levels(tokens, shapes, heads, head_dim):
    """(B, T, D) -> per level (B, H, W, heads, head_dim)."""
    out, start = [], 0
    b = tokens.shape[0]
    for h, w in shapes:
        out.append(tokens[:, start:start + h * w].reshape(b, h, w, heads, head_dim))
        start += h * w
    return out


def _deform_attn(p, cfg, query, value_tokens, ref, shapes, ref_wh=None):
    b, q, _ = query.shape
    h, lv, pts = cfg.n_heads, cfg.n_levels, cfg.n_points
    head_dim = cfg.d_model // h
    off = _apply_linear(p["offsets"], query).reshape(b, q, h, lv, pts, 2)
    w = _apply_linear(p["weights"], query).reshape(b, q, h, lv * pts)
    w = torch.softmax(w, -1).reshape(b, q, h, lv, pts)
    values = _apply_linear(p["value"], value_tokens)
    value_levels = _split_levels(values, shapes, h, head_dim)
    if ref_wh is None:
        norm = torch.tensor([[wl, hl] for hl, wl in shapes], dtype=torch.float32,
                            device=query.device)
        loc = ref[:, :, None, None, None, :] + off / norm[None, None, None, :, None, :]
    else:
        scale = (ref_wh / (2 * pts))[:, :, None, None, None, :]
        loc = ref[:, :, None, None, None, :] + off * scale
    return _apply_linear(p["out"], ms_deform_attn(value_levels, loc, w))


def _self_attn(p, x, h):
    b, q, d = x.shape
    hd = d // h

    def heads(t):
        return t.reshape(b, q, h, hd).transpose(1, 2)

    qh, kh, vh = (heads(_apply_linear(p[n], x)) for n in ("q", "k", "v"))
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, kh) / math.sqrt(hd)
    probs = torch.softmax(logits, -1)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vh).transpose(1, 2).reshape(b, q, d)
    return _apply_linear(p["out"], out)


def _take_rows(x, idx):
    """``take_along_axis(x, idx[..., None], 1)``: x (B, T, C), idx (B, Q)."""
    return x.gather(1, idx[..., None].expand(*idx.shape, x.shape[-1]))


def detector_forward(params, cfg: DetectorConfig, images: torch.Tensor) -> dict:
    """images: (B, H, W, 1) in [0, 1]. Returns the per-layer outputs: boxes
    normalized cxcywh, ``class_logits`` pre-sigmoid."""
    feats = _backbone(params, images.permute(0, 3, 1, 2))
    shapes = [(f.shape[2], f.shape[3]) for f in feats]
    b, dev = images.shape[0], images.device
    tokens = []
    for lvl, f in enumerate(feats):
        proj = params["input_proj"][lvl]
        t = f.flatten(2).transpose(1, 2) @ proj["w"] + proj["b"]
        tokens.append(_layernorm(proj["gn"], t) + params["level_embed"][lvl])
    x = torch.cat(tokens, 1)  # (B, T, D)
    centers = _token_centers(shapes, dev)[None]  # (1, T, 2)
    pos = _sine_embed(centers, cfg.d_model)
    enc_ref = centers.expand(b, -1, -1)

    for layer in params["encoder"]:
        a = _deform_attn(layer["attn"], cfg, x + pos, x, enc_ref, shapes)
        x = _layernorm(layer["ln1"], x + a)
        x = _layernorm(layer["ln2"], x + _apply_mlp(layer["ffn"], x))

    # two-stage proposals
    memory = _layernorm(params["enc_out_ln"], x)
    enc_logits = _apply_linear(params["enc_class"], memory)  # (B, T, C)
    sizes = torch.cat([torch.full((h * w, 2), 4.0 / max(h, w), device=dev)
                       for h, w in shapes])[None]
    anchors = torch.cat([enc_ref, sizes.expand(b, -1, -1)], -1)
    enc_boxes = torch.sigmoid(inverse_sigmoid(anchors) + _apply_mlp(params["enc_box"], memory))
    score = enc_logits.max(-1).values
    # lax.top_k: descending, ties at the lower index (a stable sort)
    top_idx = torch.sort(score.detach(), dim=-1, descending=True, stable=True).indices
    top_idx = top_idx[:, :cfg.num_queries]
    ref = _take_rows(enc_boxes, top_idx).detach()
    enc_top_logits = _take_rows(enc_logits, top_idx)

    q = params["query_embed"][None].expand(b, -1, -1)
    layer_logits, layer_boxes = [], []
    for layer in params["decoder"]:
        qpos = _apply_mlp(params["ref_point_head"], _sine_embed(ref[..., :2], cfg.d_model))
        q = _layernorm(layer["ln1"], q + _self_attn(layer["self_attn"], q + qpos, cfg.n_heads))
        a = _deform_attn(layer["cross_attn"], cfg, q + qpos, x, ref[..., :2], shapes,
                         ref_wh=ref[..., 2:])
        q = _layernorm(layer["ln2"], q + a)
        q = _layernorm(layer["ln3"], q + _apply_mlp(layer["ffn"], q))
        delta = _apply_mlp(layer["box_head"], q)
        ref = torch.sigmoid(inverse_sigmoid(ref) + delta)
        layer_logits.append(_apply_linear(params["class_head"], q))
        layer_boxes.append(ref)
        ref = ref.detach()
    return {
        "class_logits": layer_logits[-1],
        "boxes": layer_boxes[-1],
        "aux": list(zip(layer_logits[:-1], layer_boxes[:-1])),
        "enc_logits": enc_top_logits,
        "enc_boxes": _take_rows(enc_boxes, top_idx),
    }


# ----------------------------------------------------------------------- loss

def _focal_loss(logits, targets_onehot, alpha, gamma):
    p = torch.sigmoid(logits)
    pos = targets_onehot > 0
    ce = torch.logaddexp(torch.zeros_like(logits), torch.where(pos, -logits, logits))
    pt = torch.where(pos, p, 1 - p)
    w = torch.where(pos, alpha, 1 - alpha)
    return (w * (1 - pt) ** gamma * ce).sum(-1)


def match_costs(cfg: DetectorConfig, logits, boxes, gt_boxes, gt_classes, gt_valid):
    """The matcher's (N, K, Q) costs of N (image, head) problems: logits
    (N, Q, C), boxes (N, Q, 4), GT (N, K, ...); padded GT rows flat 0."""
    with torch.no_grad():
        prob = torch.sigmoid(logits)
        p_gt = prob.gather(2, gt_classes[:, None, :].expand(-1, prob.shape[1], -1))
        p_gt = p_gt.transpose(1, 2)  # (N, K, Q)
        alpha, gamma = cfg.focal_alpha, cfg.focal_gamma
        eps = p_gt.new_tensor(1e-8)
        pos_cost = -alpha * (1 - p_gt) ** gamma * torch.log(torch.maximum(p_gt, eps))
        neg_cost = -(1 - alpha) * p_gt ** gamma * torch.log(torch.maximum(1 - p_gt, eps))
        cost_cls = pos_cost - neg_cost
        cost_l1 = (gt_boxes[:, :, None] - boxes[:, None]).abs().sum(-1)
        cost_giou = -giou_2d(box_cxcywh_to_xyxy(gt_boxes)[:, :, None],
                             box_cxcywh_to_xyxy(boxes)[:, None])
        cost = cfg.cost_class * cost_cls + cfg.cost_bbox * cost_l1 + cfg.cost_giou * cost_giou
        return torch.where(gt_valid[:, :, None], cost, 0.0)


def _set_loss(cfg, logits, boxes, gt_boxes, gt_classes, gt_valid, col):
    """Per-problem DETR loss (N,) given the assignment ``col`` (N, K)."""
    n, q, c = logits.shape
    num_gt = torch.clamp_min(gt_valid.sum(-1), 1).float()
    # one-hot targets; padded rows go to an extra row that is dropped
    scat = torch.where(gt_valid, col, q)
    onehot = torch.zeros(n, q + 1, c, device=logits.device)
    onehot[torch.arange(n, device=logits.device)[:, None], scat, gt_classes] = 1.0
    onehot = onehot[:, :q]
    loss_cls = _focal_loss(logits, onehot, cfg.focal_alpha, cfg.focal_gamma).sum(-1) / num_gt
    matched = _take_rows(boxes, col)  # (N, K, 4)
    l1 = (matched - gt_boxes).abs().sum(-1)
    gi = 1 - giou_2d(box_cxcywh_to_xyxy(matched), box_cxcywh_to_xyxy(gt_boxes))
    loss_box = torch.where(gt_valid, l1, 0.0).sum(-1) / num_gt
    loss_giou = torch.where(gt_valid, gi, 0.0).sum(-1) / num_gt
    return cfg.cost_class * loss_cls + cfg.cost_bbox * loss_box + cfg.cost_giou * loss_giou


def detector_loss(params, cfg: DetectorConfig, images, gt_boxes, gt_classes, gt_valid):
    """Batched loss incl. aux decoder layers and the encoder proposals: the
    final head, then each aux head, then the encoder's, summed per image,
    then the mean. Every (head, image) cost matrix is solved in one
    ``lap_rectangular`` call."""
    out = detector_forward(params, cfg, images)
    heads = [(out["class_logits"], out["boxes"]), *out["aux"],
             (out["enc_logits"], out["enc_boxes"])]
    nh, b = len(heads), images.shape[0]
    logits = torch.cat([lo for lo, _ in heads])  # (nh B, Q, C)
    boxes = torch.cat([bx for _, bx in heads])
    gb, gc, gv = (t.repeat(nh, *([1] * (t.dim() - 1))) for t in (gt_boxes, gt_classes, gt_valid))
    col = lap_rectangular(match_costs(cfg, logits, boxes, gb, gc, gv))
    per = _set_loss(cfg, logits, boxes, gb, gc, gv, col).reshape(nh, b)
    total = per[0]
    for h in range(1, nh):
        total = total + per[h]
    return total.mean()


# ------------------------------------------------------------------ inference

def select_boxes(
    logits: np.ndarray,  # (Q, C) pre-sigmoid
    boxes: np.ndarray,  # (Q, 4) normalized cxcywh
    tagged_classes: list[str],
    image_hw: tuple[int, int],
    class_names: list[str] = VINDR_CLASSES,
    score_th: float = 0.1,
    topk: int = 100,
) -> dict[str, list[list[float]]]:
    """Reference ``select_instances`` semantics (``infer.py:84-96``): keep
    detections of report-tagged classes with score >= 0.1; if a tagged class
    has detections but none pass, keep its single best. Returns absolute
    xyxy pixel boxes per taxonomy name: the ``{key}_box.json`` contract."""
    prob = 1 / (1 + np.exp(-np.asarray(logits, np.float64)))  # (Q, C)
    q, c = prob.shape
    flat = prob.reshape(-1)
    top = np.argsort(flat)[::-1][:topk]
    scores = flat[top]
    qi, ci = top // c, top % c
    h, w = image_hw
    bx = np.asarray(boxes, np.float32)
    xyxy = np.concatenate([bx[..., :2] - bx[..., 2:] / 2, bx[..., :2] + bx[..., 2:] / 2], -1)
    xyxy = np.clip(xyxy, 0, 1) * np.asarray([w, h, w, h])
    out: dict[str, list[list[float]]] = {}
    name_to_idx = {n: i for i, n in enumerate(class_names)}
    for name in tagged_classes:
        idx = name_to_idx.get(name)
        if idx is None:
            continue
        cls_mask = ci == idx
        sel = cls_mask & (scores >= score_th)
        if not sel.any() and cls_mask.any():
            first = np.nonzero(cls_mask)[0][0]
            sel = np.zeros_like(sel)
            sel[first] = True
        if sel.any():
            out[name] = xyxy[qi[sel]].tolist()
    return out


def equalize_image(img: np.ndarray) -> np.ndarray:
    """Histogram equalization over uint8, matching torchvision's
    ``tvtf.equalize`` applied by the reference before inference
    (``infer.py:110-112``)."""
    img = np.asarray(img)
    if img.dtype != np.uint8:
        lo, hi = float(img.min()), float(img.max())
        img = np.round((img - lo) / max(hi - lo, 1e-8) * 255).astype(np.uint8)
    hist = np.bincount(img.reshape(-1), minlength=256)
    nonzero = hist[hist > 0]
    if nonzero.size <= 1:
        return img
    step = (hist.sum() - nonzero[-1]) // 255
    if step == 0:
        return img
    lut = (np.cumsum(hist) - hist // 2) // step
    lut = np.clip(np.concatenate([[0], lut[:-1]]), 0, 255).astype(np.uint8)
    return lut[img]


def _iou_xyxy(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """(N, 4) x (M, 4) -> (N, M) IoU of xyxy boxes."""
    lt = np.maximum(a[:, None, :2], b[None, :, :2])
    rb = np.minimum(a[:, None, 2:], b[None, :, 2:])
    wh = np.clip(rb - lt, 0, None)
    inter = wh[..., 0] * wh[..., 1]
    area_a = (a[:, 2] - a[:, 0]) * (a[:, 3] - a[:, 1])
    area_b = (b[:, 2] - b[:, 0]) * (b[:, 3] - b[:, 1])
    return inter / np.maximum(area_a[:, None] + area_b[None, :] - inter, 1e-9)


def compute_map(
    detections: list[dict],  # per image: {"boxes" (N,4 xyxy), "scores" (N,), "classes" (N,)}
    ground_truths: list[dict],  # per image: {"boxes" (M,4 xyxy), "classes" (M,)}
    num_classes: int,
    iou_th: float = 0.5,
) -> float:
    """mAP@iou_th, VOC all-point interpolation (the detector-quality gauge
    the reference gets from detrex's COCO evaluator)."""
    aps = []
    for c in range(num_classes):
        scores, matches, n_gt = [], [], 0
        for det, gt in zip(detections, ground_truths):
            gt_boxes = np.asarray(gt["boxes"], np.float64).reshape(-1, 4)[
                np.asarray(gt["classes"]).reshape(-1) == c
            ]
            n_gt += len(gt_boxes)
            sel = np.asarray(det["classes"]).reshape(-1) == c
            d_boxes = np.asarray(det["boxes"], np.float64).reshape(-1, 4)[sel]
            d_scores = np.asarray(det["scores"], np.float64).reshape(-1)[sel]
            order = np.argsort(-d_scores)
            used = np.zeros(len(gt_boxes), bool)
            for j in order:
                scores.append(d_scores[j])
                if len(gt_boxes) == 0:
                    matches.append(False)
                    continue
                ious = _iou_xyxy(d_boxes[j:j + 1], gt_boxes)[0]
                best = int(np.argmax(ious))
                if ious[best] >= iou_th and not used[best]:
                    used[best] = True
                    matches.append(True)
                else:
                    matches.append(False)
        if n_gt == 0:
            continue
        if not scores:
            aps.append(0.0)
            continue
        order = np.argsort(-np.asarray(scores))
        tp = np.asarray(matches)[order]
        cum_tp = np.cumsum(tp)
        recall = cum_tp / n_gt
        precision = cum_tp / (np.arange(len(tp)) + 1)
        # all-point interpolation
        ap, best_p = 0.0, 0.0
        prev_r = 1.0
        for p, r in zip(precision[::-1], recall[::-1]):
            best_p = max(best_p, p)
            ap += best_p * (prev_r - r)
            prev_r = r
        ap += best_p * prev_r
        aps.append(float(ap))
    return float(np.mean(aps)) if aps else 0.0
