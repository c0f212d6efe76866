"""The port's parameters: a nested dict of tensors with the JAX package's tree
layout (``MMMMModel(cfg).init``): linear weights stored ``(in, out)``, the
layers of each tower stacked on a leading ``(L, ...)`` axis, the same keys.

``param_spec`` is the one description of that tree (shape, initializer,
precision class per leaf); ``init_params`` fills it from a seeded
``torch.Generator`` and ``params_from_jax`` fills it from a JAX tree, leaf by
leaf, refusing any leaf it does not know and any it leaves unset.
``train_state_from_jax`` carries a JAX training state (step, trainable
tree, optax AdamW moments) and its frozen tree over the same way.

Precision follows the reference policy: the CogVLM tower takes the caller's
dtype, SAM, instance SAM and ``vg_proj`` stay fp32.
"""
from __future__ import annotations

import dataclasses
from typing import TYPE_CHECKING

import numpy as np
import torch

from .ops._cuda import resolve_device
from .ops.quant import INT4_GROUP, LLM_QUANT_KEYS, MLP_QUANT_KEYS

if TYPE_CHECKING:  # models.mmmm imports the model functions, which import layer()
    from .models.mmmm import MMMMConfig


@dataclasses.dataclass(frozen=True)
class Leaf:
    shape: tuple[int, ...]
    init: str = "normal"  # "normal" | "zeros" | "ones"
    std: float = 0.02
    fp32: bool = False  # True: always fp32 (grounding heads)


def layer(tree: dict, i: int) -> dict:
    """Layer ``i`` of a stacked ``(L, ...)`` subtree, as views."""
    return {k: layer(v, i) if isinstance(v, dict) else v[i] for k, v in tree.items()}


def _llm_spec(cfg) -> dict:
    c, i, n, v = cfg.hidden_size, cfg.intermediate_size, cfg.num_hidden_layers, cfg.vocab_size
    mlp = {"gate": Leaf((n, c, i)), "up": Leaf((n, c, i)), "down": Leaf((n, i, c))}
    return {
        "embed_tokens": Leaf((v, c)),
        "layers": {
            "vis_qkv": Leaf((n, c, 3 * c)), "lang_qkv": Leaf((n, c, 3 * c)),
            "vis_dense": Leaf((n, c, c)), "lang_dense": Leaf((n, c, c)),
            "vis_mlp": dict(mlp), "lang_mlp": dict(mlp),
            "input_ln": Leaf((n, c), "ones"), "post_ln": Leaf((n, c), "ones"),
        },
        "norm": Leaf((c,), "ones"),
        "lm_head": Leaf((c, v)),
    }


def _vit_spec(cfg) -> dict:
    vc = cfg.vision
    c, i, n = vc.hidden_size, vc.intermediate_size, vc.num_hidden_layers
    cl, il = cfg.hidden_size, cfg.intermediate_size
    return {
        "patch": {
            "proj_w": Leaf((c, vc.in_channels, *vc.patch_size)), "proj_b": Leaf((c,), "zeros"),
            "cls": Leaf((1, c), "zeros"), "cls_pos": Leaf((1, c), "zeros"),
            "pos": Leaf((1, c, *vc.pos_embed_shape)),
        },
        "layers": {
            "qkv_w": Leaf((n, c, 3 * c)), "qkv_b": Leaf((n, 3 * c), "zeros"),
            "dense_w": Leaf((n, c, c)), "dense_b": Leaf((n, c), "zeros"),
            "ln1_w": Leaf((n, c), "ones"), "ln1_b": Leaf((n, c), "zeros"),
            "ln2_w": Leaf((n, c), "ones"), "ln2_b": Leaf((n, c), "zeros"),
            "fc1_w": Leaf((n, c, i)), "fc1_b": Leaf((n, i), "zeros"),
            "fc2_w": Leaf((n, i, c)), "fc2_b": Leaf((n, c), "zeros"),
        },
        "glu": {
            "linear_proj": Leaf((c, cl)), "ln_w": Leaf((cl,), "ones"),
            "ln_b": Leaf((cl,), "zeros"), "gate": Leaf((cl, il)), "h4h": Leaf((cl, il)),
            "4hh": Leaf((il, cl)),
        },
        "boi": Leaf((cl,), "zeros"),
        "eoi": Leaf((cl,), "zeros"),
    }


def _sam_spec(cfg, instance: bool) -> dict:
    f = lambda shape, init="normal", std=0.02: Leaf(tuple(shape), init, std, fp32=True)
    c, i, n = cfg.embed_dim, cfg.encoder_mlp_dim, cfg.encoder_num_layers
    mc = 16
    ln = lambda ch: {"w": f((ch,), "ones"), "b": f((ch,), "zeros")}

    def attn(internal, depth=None):
        lead = () if depth is None else (depth,)
        return {
            "q_w": f((*lead, c, internal)), "q_b": f((*lead, internal), "zeros"),
            "k_w": f((*lead, c, internal)), "k_b": f((*lead, internal), "zeros"),
            "v_w": f((*lead, c, internal)), "v_b": f((*lead, internal), "zeros"),
            "out_w": f((*lead, internal, c)), "out_b": f((*lead, c), "zeros"),
        }

    def mlp3(cin, ch, cout):
        return {"w1": f((cin, ch)), "b1": f((ch,), "zeros"), "w2": f((ch, ch)),
                "b2": f((ch,), "zeros"), "w3": f((ch, cout)), "b3": f((cout,), "zeros")}

    dd, internal, md = cfg.decoder_depth, c // cfg.attention_downsample_rate, cfg.decoder_mlp_dim
    stacked_ln = {"w": f((dd, c), "ones"), "b": f((dd, c), "zeros")}
    spec = {
        "encoder": {
            "patch": {"proj_w": f((c, cfg.in_channels, *cfg.patch_size)),
                      "proj_b": f((c,), "zeros"), "pos": f((1, c, *cfg.pos_embed_shape))},
            "layers": {
                "qkv_w": f((n, c, 3 * c)), "out_w": f((n, c, c)), "out_b": f((n, c), "zeros"),
                "ln1_w": f((n, c), "ones"), "ln1_b": f((n, c), "zeros"),
                "ln2_w": f((n, c), "ones"), "ln2_b": f((n, c), "zeros"),
                "fc1_w": f((n, c, i)), "fc1_b": f((n, i), "zeros"),
                "fc2_w": f((n, i, c)), "fc2_b": f((n, c), "zeros"),
            },
            "norm_w": f((c,), "ones"), "norm_b": f((c,), "zeros"),
        },
        "prompt": {
            "pe_gaussian": f((3, c // 2), std=1.0),
            "no_mask_embed": f((c,)),
            "point_embeddings": f((4, c)),
            "not_a_point_embed": f((c,)),
            "mask_down": {
                "conv1_w": f((2, 2, 2, 1, mc // 4), std=0.2), "conv1_b": f((mc // 4,), "zeros"),
                "ln1": {"scale": f((mc // 4,), "ones"), "bias": f((mc // 4,), "zeros")},
                "conv2_w": f((2, 2, 2, mc // 4, mc), std=0.2), "conv2_b": f((mc,), "zeros"),
                "ln2": {"scale": f((mc,), "ones"), "bias": f((mc,), "zeros")},
                "conv3_w": f((1, 1, 1, mc, c), std=0.2), "conv3_b": f((c,), "zeros"),
            },
        },
        "decoder": {
            "iou_token": f((1, c)),
            "mask_tokens": f((cfg.num_mask_tokens, c)),
            "transformer": {
                "layers": {
                    "self_attn": attn(c, dd), "norm1": dict(stacked_ln),
                    "cross_t2i": attn(internal, dd), "norm2": dict(stacked_ln),
                    "mlp_fc1_w": f((dd, c, md)), "mlp_fc1_b": f((dd, md), "zeros"),
                    "mlp_fc2_w": f((dd, md, c)), "mlp_fc2_b": f((dd, c), "zeros"),
                    "norm3": dict(stacked_ln),
                    "cross_i2t": attn(internal, dd), "norm4": dict(stacked_ln),
                },
                "final_attn": attn(internal),
                "norm_final": ln(c),
            },
            "up1_w": f((c, c // 4, 2, 2, 2)), "up1_b": f((c // 4,), "zeros"),
            "up_ln": ln(c // 4),
            "up2_w": f((c // 4, c // 8, 2, 2, 2)), "up2_b": f((c // 8,), "zeros"),
            "hyper_semantic": mlp3(c, c, c // 8),
            "hyper_instance": mlp3(c, c, c // 8),
            "txt_align_w": f((c, c // 8)), "txt_align_b": f((c // 8,), "zeros"),
        },
    }
    if instance:
        spec["box_head"] = {"w1": f((c, c)), "b1": f((c,), "zeros"), "w2": f((c, c)),
                            "b2": f((c,), "zeros"), "w3": f((c, 6)), "b3": f((6,), "zeros")}
        spec["disc_head"] = {"w1": f((c, c)), "b1": f((c,), "zeros"), "w2": f((c, 1)),
                             "b2": f((1,), "zeros")}
    return spec


def param_spec(cfg: MMMMConfig) -> dict:
    """The full parameter tree of ``cfg`` as nested dicts of :class:`Leaf`."""
    c, pd = cfg.vlm.hidden_size, cfg.sam.embed_dim
    return {
        "cogvlm": {"llm": _llm_spec(cfg.vlm), "vision": _vit_spec(cfg.vlm)},
        "sam": _sam_spec(cfg.sam, instance=False),
        "isam": _sam_spec(cfg.sam, instance=True),
        "vg_proj": {"w1": Leaf((c, c), fp32=True), "b1": Leaf((c,), "zeros", fp32=True),
                    "w2": Leaf((c, pd), fp32=True), "b2": Leaf((pd,), "zeros", fp32=True)},
    }


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, path + "/"))
        else:
            out[path] = v
    return out


def _unflatten(flat: dict) -> dict:
    tree: dict = {}
    for path, v in flat.items():
        *parents, leaf = path.split("/")
        node = tree
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def init_params(cfg: MMMMConfig, seed: int = 0, dtype: torch.dtype = torch.bfloat16,
                device: str | torch.device = "cuda") -> dict:
    """Random parameters (normal(0, std) / zeros / ones, as the JAX init) made
    on ``device`` from a ``torch.Generator`` seeded with ``seed``; the CogVLM
    tower in ``dtype``, the grounding heads in fp32. The values differ from
    the JAX init's (another generator)."""
    dev = resolve_device(device)
    gen = torch.Generator(device=dev).manual_seed(seed)
    flat = {}
    for path, leaf in _flatten(param_spec(cfg)).items():
        dt = torch.float32 if leaf.fp32 else dtype
        if leaf.init == "normal":
            t = torch.randn(leaf.shape, generator=gen, dtype=dt, device=dev).mul_(leaf.std)
        elif leaf.init == "zeros":
            t = torch.zeros(leaf.shape, dtype=dt, device=dev)
        else:
            t = torch.ones(leaf.shape, dtype=dt, device=dev)
        flat[path] = t
    return _unflatten(flat)


# the leaves quantize_llm_for_serving converts to {"q", "s"}
_QUANTIZABLE = frozenset(
    [f"cogvlm/llm/layers/{k}" for k in LLM_QUANT_KEYS]
    + [f"cogvlm/llm/layers/{m}/{k}" for m in ("lang_mlp", "vis_mlp") for k in MLP_QUANT_KEYS]
    + ["cogvlm/llm/lm_head"])


def _to_tensor(arr, device) -> torch.Tensor:
    a = np.asarray(arr)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, copy=True)).to(device)


def params_from_jax(tree: dict, device: str | torch.device = "cuda", *,
                    cfg: MMMMConfig | None = None) -> dict:
    """Map the JAX package's parameter tree (leaves as numpy arrays or
    anything ``np.asarray`` takes) onto the port's parameters on ``device``,
    keeping each leaf's dtype.

    The LLM weights that ``quantize_llm_for_serving`` converts may come as
    its ``{"q", "s"}`` int8 leaves instead (``q`` of the weight's shape,
    ``s`` with dim -2 of size 1) or, for ``bits=4``, as ``{"q4", "s4"}``
    (``q4`` with dim -2 halved, ``s4`` with one row per group of 128).

    Raises on a leaf the port does not consume and on a port parameter the
    tree leaves unset (the set of names does not depend on the widths);
    with ``cfg`` it also checks every shape."""
    dev = resolve_device(device)
    flat = _flatten(tree)
    from .models.mmmm import MMMMConfig

    spec = _flatten(param_spec(cfg or MMMMConfig.tiny()))
    wanted = {}  # tree path -> expected shape
    for path, leaf in spec.items():
        if path in _QUANTIZABLE and f"{path}/q" in flat:
            wanted[f"{path}/q"] = leaf.shape
            wanted[f"{path}/s"] = (*leaf.shape[:-2], 1, leaf.shape[-1])
        elif path in _QUANTIZABLE and f"{path}/q4" in flat:
            *lead, k, n = leaf.shape
            wanted[f"{path}/q4"] = (*lead, k // 2, n)
            wanted[f"{path}/s4"] = (*lead, k // INT4_GROUP, n)
        else:
            wanted[path] = leaf.shape
    unknown = sorted(set(flat) - set(wanted))
    missing = sorted(set(wanted) - set(flat))
    if unknown or missing:
        raise ValueError(f"params_from_jax: leaves not consumed {unknown}; "
                         f"parameters left unset {missing}")
    out = {}
    for path, shape in wanted.items():
        t = _to_tensor(flat[path], dev)
        if cfg is not None and tuple(t.shape) != shape:
            raise ValueError(f"params_from_jax: {path} has shape {tuple(t.shape)}, "
                             f"expected {shape}")
        out[path] = t
    return _unflatten(out)


def _optax_nodes(tree, attrs):
    """Every node of an optax state tree (nested tuples of named tuples)
    that has all of ``attrs`` as fields (a tuple's ``count`` method is none)."""
    if all(hasattr(tree, a) and not callable(getattr(tree, a)) for a in attrs):
        yield tree
    if isinstance(tree, (tuple, list)):
        for child in tree:
            yield from _optax_nodes(child, attrs)


def train_state_from_jax(state, frozen: dict, device: str | torch.device = "cuda", *,
                         cfg: MMMMConfig | None = None):
    """Map a JAX ``TrainState`` of ``mmmm_tpu.train.step`` (its optimizer
    ``optax.chain(clip_by_global_norm, adamw)``) and its frozen tree onto the
    port's ``(TrainState, frozen)`` on ``device``, keeping dtypes.

    The model's leaves (finetuned and frozen together) are checked as
    :func:`params_from_jax` checks them; the LoRA factors must be exactly
    ``default_lora_targets`` with ``a`` (.., in, r) and ``b`` (.., r, out);
    Adam's ``mu`` and ``nu`` must match the trainable tree leaf for leaf,
    and every ``count`` of the optimizer state must equal the step."""
    from .peft.lora import default_lora_targets, split_trainable
    from .train.step import TrainState

    dev = resolve_device(device)
    ft_paths = set(_flatten(state.trainable["ft"]))
    full = params_from_jax(_unflatten({**_flatten(frozen), **_flatten(state.trainable["ft"])}),
                           dev, cfg=cfg)
    ft, frozen_t = split_trainable(full)
    if set(_flatten(ft)) != ft_paths:
        raise ValueError("train_state_from_jax: the finetuned leaves are not "
                         "FINETUNE_PATH_PREFIXES' subset")
    shapes = {p: tuple(t.shape) for p, t in _flatten(full).items()}
    lora = {p: _to_tensor(a, dev) for p, a in _flatten(state.trainable["lora"]).items()}
    targets = default_lora_targets(full)
    if set(lora) != {f"{t}/{n}" for t in targets for n in ("a", "b")}:
        raise ValueError(f"train_state_from_jax: LoRA leaves {sorted(lora)} are not the "
                         f"factors of {targets}")
    for t in targets:
        *lead, fan_in, fan_out = shapes[t]
        a, b = lora[f"{t}/a"].shape, lora[f"{t}/b"].shape
        if a[:-1] != (*lead, fan_in) or b != (*lead, a[-1], fan_out):
            raise ValueError(f"train_state_from_jax: {t} factors {tuple(a)} {tuple(b)} do not "
                             f"fit its shape {shapes[t]}")
    trainable = {"lora": _unflatten(lora), "ft": ft}
    flat = _flatten(trainable)
    (adam,) = list(_optax_nodes(state.opt_state, ("mu", "nu", "count")))
    moments = {}
    for name in ("mu", "nu"):
        m = {p: _to_tensor(a, dev) for p, a in _flatten(getattr(adam, name)).items()}
        if set(m) != set(flat) or any(m[p].shape != t.shape for p, t in flat.items()):
            raise ValueError(f"train_state_from_jax: Adam's {name} does not match the "
                             "trainable tree")
        moments[name] = m
    step = int(np.asarray(state.step))
    counts = {int(np.asarray(n.count)) for n in _optax_nodes(state.opt_state, ("count",))}
    if counts != {step}:
        raise ValueError(f"train_state_from_jax: optimizer counts {counts} != step {step}")
    for t in flat.values():
        t.requires_grad_(True)
    return TrainState(step, trainable, {"count": step, **moments}), frozen_t
