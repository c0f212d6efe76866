"""HF PEFT adapter interop, the port of ``mmmm_tpu/train/peft_export.py``:
LoRA factors in and out of the PEFT layout that the reference releases
(``README.md:61-65``; ``adapter_model.safetensors`` + ``adapter_config.json``).

  - ``export_peft_adapter``: the stacked (L, in, r) / (L, r, out) factors ->
    per-layer ``...lora_A.weight`` (r, in) / ``...lora_B.weight`` (out, r)
    torch-convention tensors in a safetensors file;
  - ``import_peft_adapter``: the reverse, restacking per-layer tensors
    (``adapter_model.bin`` through ``torch.load`` where no safetensors file
    is present; ``.lora_A.default.weight`` names too).

The name mapping covers the CogVLM module paths of the reference's PEFT
wrapping (``base_model.model.model.layers.{i}.self_attn.*`` etc.). The
safetensors format is read and written here (``save_safetensors``,
``load_safetensors``: an 8-byte little-endian header length, a JSON header
of dtype, shape and byte offsets, then the raw little-endian tensor bytes),
so neither direction needs the ``safetensors`` package.
"""
from __future__ import annotations

import json
import re
import sys
from pathlib import Path

import torch

from ..peft import LoraConfig

# our stacked path -> HF module format string
_PATH_MAP = {
    "cogvlm/llm/layers/vis_qkv": "base_model.model.model.layers.{}.self_attn.vision_expert_query_key_value",
    "cogvlm/llm/layers/lang_qkv": "base_model.model.model.layers.{}.self_attn.language_expert_query_key_value",
    "cogvlm/llm/layers/vis_dense": "base_model.model.model.layers.{}.self_attn.vision_expert_dense",
    "cogvlm/llm/layers/lang_dense": "base_model.model.model.layers.{}.self_attn.language_expert_dense",
    "cogvlm/llm/layers/vis_mlp/gate": "base_model.model.model.layers.{}.mlp.vision_mlp.gate_proj",
    "cogvlm/llm/layers/vis_mlp/up": "base_model.model.model.layers.{}.mlp.vision_mlp.up_proj",
    "cogvlm/llm/layers/vis_mlp/down": "base_model.model.model.layers.{}.mlp.vision_mlp.down_proj",
    "cogvlm/llm/layers/lang_mlp/gate": "base_model.model.model.layers.{}.mlp.language_mlp.gate_proj",
    "cogvlm/llm/layers/lang_mlp/up": "base_model.model.model.layers.{}.mlp.language_mlp.up_proj",
    "cogvlm/llm/layers/lang_mlp/down": "base_model.model.model.layers.{}.mlp.language_mlp.down_proj",
    "cogvlm/llm/lm_head": "base_model.model.lm_head",
    "cogvlm/vision/layers/qkv_w": "base_model.model.model.vision.transformer.layers.{}.attention.query_key_value",
    "cogvlm/vision/layers/dense_w": "base_model.model.model.vision.transformer.layers.{}.attention.dense",
    "cogvlm/vision/layers/fc1_w": "base_model.model.model.vision.transformer.layers.{}.mlp.fc1",
    "cogvlm/vision/layers/fc2_w": "base_model.model.model.vision.transformer.layers.{}.mlp.fc2",
    "cogvlm/vision/glu/linear_proj": "base_model.model.model.vision.linear_proj.linear_proj",
    "cogvlm/vision/glu/gate": "base_model.model.model.vision.linear_proj.gate_proj",
    "cogvlm/vision/glu/h4h": "base_model.model.model.vision.linear_proj.dense_h_to_4h",
    "cogvlm/vision/glu/4hh": "base_model.model.model.vision.linear_proj.dense_4h_to_h",
}

_DTYPES = {"F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
           "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32,
           "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool}
_NAMES = {v: k for k, v in _DTYPES.items()}


def save_safetensors(path: str | Path, tensors: dict[str, torch.Tensor],
                     metadata: dict[str, str] | None = None) -> None:
    """Write ``tensors`` as a safetensors file. Tensors are laid out by
    element size, then name, so every offset is aligned to its element."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors files are little-endian")
    order = sorted(tensors, key=lambda k: (-tensors[k].element_size(), k))
    header: dict = {"__metadata__": metadata} if metadata else {}
    offset = 0
    for name in order:
        t = tensors[name]
        n = t.numel() * t.element_size()
        header[name] = {"dtype": _NAMES[t.dtype], "shape": list(t.shape),
                        "data_offsets": [offset, offset + n]}
        offset += n
    head = json.dumps(header, separators=(",", ":")).encode()
    head += b" " * (-len(head) % 8)
    with open(path, "wb") as f:
        f.write(len(head).to_bytes(8, "little"))
        f.write(head)
        for name in order:
            t = tensors[name].detach().cpu().contiguous()
            if t.numel():
                f.write(memoryview(t.reshape(-1).view(torch.uint8).numpy()))


def load_safetensors(path: str | Path) -> dict[str, torch.Tensor]:
    """Read a safetensors file into CPU tensors (views of one buffer)."""
    if sys.byteorder != "little":
        raise RuntimeError("safetensors files are little-endian")
    with open(path, "rb") as f:
        n = int.from_bytes(f.read(8), "little")
        header = json.loads(f.read(n))
        header.pop("__metadata__", None)
        size = max((h["data_offsets"][1] for h in header.values()), default=0)
        raw = torch.empty(size, dtype=torch.uint8)
        if size and f.readinto(memoryview(raw.numpy())) != size:
            raise ValueError(f"{path}: file shorter than its header says")
    out = {}
    for name, h in header.items():
        dt = _DTYPES[h["dtype"]]
        a, b = h["data_offsets"]
        item = torch.empty((), dtype=dt).element_size()
        body = raw[a:b] if a % item == 0 else raw[a:b].clone()
        out[name] = body.view(dt).reshape(h["shape"])
    return out


def _flatten(tree: dict, prefix: str = "") -> dict:
    out = {}
    for k, v in tree.items():
        p = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict) and not ("a" in v and "b" in v):
            out.update(_flatten(v, p))
        else:
            out[p] = v
    return out


def export_peft_adapter(path: str | Path, lora_tree: dict, cfg: LoraConfig) -> None:
    """Write ``lora_tree``'s mapped factors (any device) and ``cfg`` as an HF
    PEFT adapter directory at ``path``."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    tensors = {}
    target_modules = set()
    for our_path, ab in _flatten(lora_tree).items():
        fmt = _PATH_MAP.get(our_path)
        if fmt is None:
            continue
        a, b = ab["a"].detach().cpu(), ab["b"].detach().cpu()
        target_modules.add(fmt.rsplit(".", 1)[-1])
        if a.dim() == 3:  # stacked layers
            for i in range(a.shape[0]):
                mod = fmt.format(i)
                tensors[f"{mod}.lora_A.weight"] = a[i].T.contiguous()
                tensors[f"{mod}.lora_B.weight"] = b[i].T.contiguous()
        else:
            tensors[f"{fmt}.lora_A.weight"] = a.T.contiguous()
            tensors[f"{fmt}.lora_B.weight"] = b.T.contiguous()
    save_safetensors(path / "adapter_model.safetensors", tensors, {"format": "pt"})
    (path / "adapter_config.json").write_text(json.dumps({
        "peft_type": "LORA",
        "r": cfg.r,
        "lora_alpha": cfg.alpha,
        "lora_dropout": cfg.dropout,
        "use_rslora": cfg.use_rslora,
        "target_modules": sorted(target_modules),
        "bias": "none",
        "task_type": "CAUSAL_LM",
    }, indent=2))


def import_peft_adapter(path: str | Path, num_layers: int,
                        num_vision_layers: int) -> tuple[dict, LoraConfig]:
    """An HF PEFT adapter directory -> (LoRA tree of CPU tensors in the port's
    stacked layout, its ``LoraConfig``)."""
    path = Path(path)
    peft_cfg = json.loads((path / "adapter_config.json").read_text())
    cfg = LoraConfig(
        r=peft_cfg["r"],
        alpha=peft_cfg["lora_alpha"],
        dropout=peft_cfg.get("lora_dropout", 0.0),
        use_rslora=peft_cfg.get("use_rslora", False),
    )
    st_path = path / "adapter_model.safetensors"
    if st_path.exists():
        tensors = load_safetensors(st_path)
    else:
        tensors = torch.load(path / "adapter_model.bin", map_location="cpu", weights_only=False)
    # strip any "weight"-naming variants: "...lora_A.weight" / "...lora_A.default.weight"
    norm = {re.sub(r"\.lora_(A|B)\.(default\.)?weight$", r".lora_\1", k): v
            for k, v in tensors.items()}

    tree: dict = {}

    def set_path(p, value):
        cur = tree
        parts = p.split("/")
        for part in parts[:-1]:
            cur = cur.setdefault(part, {})
        cur[parts[-1]] = value

    for our_path, fmt in _PATH_MAP.items():
        n = num_vision_layers if "/vision/layers/" in our_path else num_layers
        if "{}" in fmt:
            mods = [fmt.format(i) for i in range(n)]
            if n and all(f"{m}.lora_A" in norm for m in mods):
                set_path(our_path, {"a": torch.stack([norm[f"{m}.lora_A"].T for m in mods]),
                                    "b": torch.stack([norm[f"{m}.lora_B"].T for m in mods])})
        elif f"{fmt}.lora_A" in norm:
            set_path(our_path, {"a": norm[f"{fmt}.lora_A"].T.contiguous(),
                                "b": norm[f"{fmt}.lora_B"].T.contiguous()})
    return tree, cfg
