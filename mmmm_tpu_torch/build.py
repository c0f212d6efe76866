"""Builders from config dicts, the port of ``mmmm_tpu/build.py``
(``build_tokenizer``, ``build_model``, ``load_model_with_adapter``):
a YAML run config -> tokenizer, model and parameters on the card.
"""
from __future__ import annotations

import dataclasses

import torch

from .config import build, load_yaml
from .data.tokenizer import MMMMTokenizer
from .models.mmmm import MMMMConfig, MMMMModel


def build_tokenizer(cfg: dict | None) -> MMMMTokenizer:
    """The HuggingFace tokenizer at ``cfg["path"]``, else the byte tokenizer."""
    path = (cfg or {}).get("path")
    if path:
        return MMMMTokenizer.from_pretrained(path)
    return MMMMTokenizer.byte_fallback()


def build_model(cfg: dict | None, tokenizer: MMMMTokenizer) -> MMMMModel:
    """The model of a config's ``model`` section, with the tokenizer's
    ``<p>``/``</p>`` ids and a vocabulary that holds the tokenizer's."""
    mcfg: MMMMConfig = build(MMMMConfig, cfg or {})
    mcfg = dataclasses.replace(
        mcfg, bop_token_id=tokenizer.bop_token_id, eop_token_id=tokenizer.eop_token_id,
        vlm=dataclasses.replace(mcfg.vlm, vocab_size=max(mcfg.vlm.vocab_size, len(tokenizer))))
    return MMMMModel(mcfg)


def load_model_with_adapter(config_path: str, adapter: str | None, quantize: bool = False,
                            device: str | torch.device = "cuda"):
    """Config (and an optional ``adapter.npz`` of either package) ->
    ``(model, params on device, tokenizer, config dict)``. The base weights
    are ``model.init(0)`` in fp32; the adapter's finetuned leaves replace
    theirs and its LoRA factors are merged in (``W + scale * A @ B``).
    ``quantize=True`` then makes the LLM W8A16 (``quantize_llm_for_serving``)."""
    from .ops.quant import quantize_llm_for_serving
    from .peft import LoraConfig, lora_merge, materialize, merge_trainable, split_trainable
    from .train.checkpoint import load_adapter

    cfg = load_yaml(config_path)
    tokenizer = build_tokenizer(cfg.get("tokenizer"))
    model = build_model(cfg.get("model"), tokenizer)
    params = model.init(0, device=device)
    if adapter:
        dev = params["vg_proj"]["w1"].device
        to_dev = lambda tree: {k: to_dev(v) if isinstance(v, dict) else v.to(dev)
                               for k, v in tree.items()}
        trainable = to_dev(load_adapter(adapter))
        _, frozen = split_trainable(params)
        params = merge_trainable(trainable["ft"], frozen)
        lora_cfg = build(LoraConfig, cfg.get("lora") or {})
        params = materialize(lora_merge(params, trainable["lora"], lora_cfg))
    if quantize:
        params = dict(params)
        params["cogvlm"] = quantize_llm_for_serving(params["cogvlm"])
    return model, params, tokenizer, cfg
