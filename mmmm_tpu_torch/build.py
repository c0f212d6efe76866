"""Builders from config dicts, the port of ``mmmm_tpu/build.py``
(``build_tokenizer``, ``build_model``, ``build_dataset``,
``load_model_with_adapter``): a YAML run config -> tokenizer, model,
dataset and parameters on the card.
"""
from __future__ import annotations

import dataclasses
from pathlib import Path

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


def build_dataset(cfg: dict, tokenizer: MMMMTokenizer, conf_dir: Path):
    """The ``MultiDataset`` of a config's ``data`` section: ``conf`` (with
    ``vl_trans`` and ``grg_trans``), the ``datasets`` specs (a relative
    ``dir`` resolves against ``conf_dir``), ``target_tax`` and
    ``skip_missing`` (default true: train on whatever subset of a roster is
    on disk)."""
    from .data.dataset import DatasetSpec, MultiDataset
    from .data.grg import GRGTransConf
    from .data.local import DatasetConf
    from .data.vl import VLTransConf

    dconf: DatasetConf = build(DatasetConf, cfg.get("conf") or {})
    if cfg.get("vl_trans") is not None:
        dconf.vl_trans = build(VLTransConf, cfg["vl_trans"])
    if cfg.get("grg_trans") is not None:
        dconf.grg_trans = build(GRGTransConf, cfg["grg_trans"])
    specs = []
    for s in cfg.get("datasets", []):
        d = dict(s)
        if d.get("dir"):
            p = Path(d["dir"])
            if not p.is_absolute():
                p = (conf_dir / p).resolve()
            d["dir"] = p
        specs.append(DatasetSpec(**d))
    target_tax = None
    if tax_path := cfg.get("target_tax"):
        from .data.target_tax import load_target_tax

        target_tax = load_target_tax(tax_path)
    return MultiDataset(dconf, specs, tokenizer, target_tax=target_tax,
                        skip_missing=bool(cfg.get("skip_missing", True)))


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
