"""Baseline VLM harnesses for finetune/eval comparison, the port of
``scripts/evaluate/baselines.py``.

The reference registers seven comparison models, each with its own loader,
prompt format, and image pipeline (``scripts/evaluate/models/{cogvlm,
instructblip,llavamed,llavanext,m3d,radfm,r2gengpt}.py`` +
``scripts/finetune/cli.py:11-64``). This module provides the same registry
abstraction natively: ``build_baseline(name, checkpoint, tokenizer)`` returns
a uniform ``predict(image_path, question) -> str`` callable.

Every harness runs on the card unless ``device="cpu"``: the model and
each processed input are moved there (a CUDA device asked for where there
is none raises before anything loads). The HF harnesses load LOCAL
checkpoints only (``local_files_only=True``: nothing is downloaded) and
need ``transformers`` (imported inside each, so a missing package raises
and names itself); models whose code the reference vendors (RadFM,
R2GenGPT) raise with instructions unless their packages are importable.
The "mmmm" entry is the port's own model, through the same path as
``cli.py predict``.
"""
from __future__ import annotations

from typing import Callable

from ..ops._cuda import resolve_device

REGISTRY: dict[str, Callable] = {}


def register(name):
    def deco(fn):
        REGISTRY[name] = fn
        return fn
    return deco


def build_baseline(name: str, checkpoint: str, tokenizer: str | None = None,
                   **kwargs) -> Callable[[str, str], str]:
    if name not in REGISTRY:
        raise KeyError(f"unknown baseline {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name](checkpoint, tokenizer or checkpoint, **kwargs)


def _load_image_rgb(path: str):
    from PIL import Image

    if str(path).endswith(".pt.zst"):
        import numpy as np

        from ..utils.io import load_pt_zst

        arr = np.asarray(load_pt_zst(path))
        while arr.ndim > 2:
            arr = arr[arr.shape[0] // 2] if arr.shape[0] > 4 else arr[0]
        lo, hi = float(arr.min()), float(arr.max())
        arr = ((arr - lo) / max(hi - lo, 1e-8) * 255).astype("uint8")
        return Image.fromarray(arr).convert("RGB")
    return Image.open(path).convert("RGB")


@register("instructblip")
def _instructblip(checkpoint, tokenizer, max_new_tokens=256, finetuned=False,
                  device="cuda"):
    """ref ``models/instructblip.py:11-50``."""
    dev = resolve_device(device)
    import torch
    from transformers import InstructBlipForConditionalGeneration, InstructBlipProcessor

    model = InstructBlipForConditionalGeneration.from_pretrained(
        checkpoint, local_files_only=True, low_cpu_mem_usage=True
    ).to(dev).eval()
    processor = InstructBlipProcessor.from_pretrained(tokenizer, local_files_only=True)

    def predict(image_path: str, question: str) -> str:
        text = f"Question: {question} Answer: " if finetuned else question
        inputs = processor(images=_load_image_rgb(image_path), text=text,
                           return_tensors="pt").to(dev)
        with torch.inference_mode():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens)
        return processor.decode(out[0], skip_special_tokens=True).strip()

    return predict


@register("llavanext")
def _llavanext(checkpoint, tokenizer, max_new_tokens=256, device="cuda"):
    """ref ``models/llavanext.py`` (llava-v1.6 conversation format)."""
    dev = resolve_device(device)
    import torch
    from transformers import LlavaNextForConditionalGeneration, LlavaNextProcessor

    model = LlavaNextForConditionalGeneration.from_pretrained(
        checkpoint, local_files_only=True, low_cpu_mem_usage=True
    ).to(dev).eval()
    processor = LlavaNextProcessor.from_pretrained(tokenizer, local_files_only=True)

    def predict(image_path: str, question: str) -> str:
        prompt = f"[INST] <image>\n{question} [/INST]"
        inputs = processor(images=_load_image_rgb(image_path), text=prompt,
                           return_tensors="pt").to(dev)
        with torch.inference_mode():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens)
        text = processor.decode(out[0], skip_special_tokens=True)
        return text.split("[/INST]")[-1].strip()

    return predict


@register("llavamed")
def _llavamed(checkpoint, tokenizer, max_new_tokens=256, device="cuda"):
    """LLaVA-Med ships LLaVA-architecture weights; served via the generic
    llava processor path (ref ``models/llavamed.py`` uses the vendored llava
    repo; the HF-converted checkpoints load here)."""
    dev = resolve_device(device)
    import torch
    from transformers import AutoProcessor, LlavaForConditionalGeneration

    model = LlavaForConditionalGeneration.from_pretrained(
        checkpoint, local_files_only=True, low_cpu_mem_usage=True
    ).to(dev).eval()
    processor = AutoProcessor.from_pretrained(tokenizer, local_files_only=True)

    def predict(image_path: str, question: str) -> str:
        prompt = f"USER: <image>\n{question} ASSISTANT:"
        inputs = processor(images=_load_image_rgb(image_path), text=prompt,
                           return_tensors="pt").to(dev)
        with torch.inference_mode():
            out = model.generate(**inputs, max_new_tokens=max_new_tokens)
        text = processor.decode(out[0], skip_special_tokens=True)
        return text.split("ASSISTANT:")[-1].strip()

    return predict


@register("cogvlm")
def _cogvlm(checkpoint, tokenizer, max_new_tokens=256, device="cuda"):
    """THUDM/cogvlm-chat-hf via its remote code (ref ``models/cogvlm.py``);
    the base model MMMM itself extends."""
    dev = resolve_device(device)
    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer, local_files_only=True)
    model = AutoModelForCausalLM.from_pretrained(
        checkpoint, trust_remote_code=True, local_files_only=True,
        low_cpu_mem_usage=True,
    ).to(dev).eval()

    def predict(image_path: str, question: str) -> str:
        inputs = model.build_conversation_input_ids(
            tok, query=question, images=[_load_image_rgb(image_path)]
        )
        batch = {
            "input_ids": inputs["input_ids"][None].to(dev),
            "token_type_ids": inputs["token_type_ids"][None].to(dev),
            "attention_mask": inputs["attention_mask"][None].to(dev),
            "images": [[inputs["images"][0].to(dev)]],
        }
        with torch.inference_mode():
            out = model.generate(**batch, max_new_tokens=max_new_tokens)
        return tok.decode(out[0, inputs["input_ids"].shape[0]:],
                          skip_special_tokens=True).strip()

    return predict


@register("m3d")
def _m3d(checkpoint, tokenizer, max_new_tokens=256, device="cuda"):
    """M3D-LaMed 3-D VLM via its remote code (ref ``models/m3d.py``): expects
    a (1, 1, 32, 256, 256) normalized volume and an <im_patch>-prefixed
    prompt."""
    dev = resolve_device(device)
    import numpy as np
    import torch
    from transformers import AutoModelForCausalLM, AutoTokenizer

    tok = AutoTokenizer.from_pretrained(tokenizer, local_files_only=True)
    model = AutoModelForCausalLM.from_pretrained(
        checkpoint, trust_remote_code=True, local_files_only=True,
        low_cpu_mem_usage=True,
    ).to(dev).eval()

    def predict(image_path: str, question: str) -> str:
        from ..data.transforms import resize_3d
        from ..utils.io import load_pt_zst

        if str(image_path).endswith(".pt.zst"):
            vol = np.asarray(load_pt_zst(image_path), np.float32)
        else:
            vol = np.asarray(_load_image_rgb(image_path).convert("L"), np.float32)[None]
        while vol.ndim > 3:
            vol = vol[0]
        vol = resize_3d(vol[None], (32, 256, 256))[0]
        lo, hi = float(vol.min()), float(vol.max())
        vol = (vol - lo) / max(hi - lo, 1e-8)
        image = torch.from_numpy(vol)[None, None].to(dev)
        prompt = "<im_patch>" * 256 + question
        ids = tok(prompt, return_tensors="pt")["input_ids"].to(dev)
        with torch.inference_mode():
            out = model.generate(images=image, input_ids=ids,
                                 max_new_tokens=max_new_tokens, do_sample=False)
        return tok.decode(out[0], skip_special_tokens=True).strip()

    return predict


def _vendored(name: str, package: str):
    def factory(checkpoint, tokenizer, **kwargs):
        try:
            __import__(package)
        except ImportError as e:
            raise ImportError(
                f"{name} uses a vendored architecture; install/clone its "
                f"package ({package}) next to this repo to enable it "
                f"(ref scripts/evaluate/models/{name}.py)"
            ) from e
        raise NotImplementedError(
            f"{name}: package found but no adapter is wired; see "
            f"scripts/evaluate/models/{name}.py in the reference for the contract"
        )

    return factory


REGISTRY["radfm"] = _vendored("radfm", "Model.RadFM")
REGISTRY["r2gengpt"] = _vendored("r2gengpt", "r2gengpt")


@register("mmmm")
def _mmmm(checkpoint, tokenizer, max_new_tokens=256, adapter=None, device="cuda"):
    """The port's model — the path ``cli.py predict`` takes; ``checkpoint``
    is its config file."""
    dev = resolve_device(device)
    import numpy as np

    from ..cli import _data_conf, load_model, prepare_image
    from ..data import ConvTurn
    from ..data.input_builder import prepare_vlm_inputs
    from ..models.inference import generate_grounded

    model, params, tok, cfg = load_model(checkpoint, adapter, device=dev)
    dconf = _data_conf(cfg)

    def predict(image_path: str, question: str) -> str:
        image, _, patch, pool, n_tokens = prepare_image(str(image_path), dconf)
        inputs, _ = prepare_vlm_inputs(
            [ConvTurn(question, "")], tok, n_tokens, inference=True, grounding=False,
        )
        res = generate_grounded(
            params, model.cfg, tok,
            np.asarray(inputs.input_ids)[None], np.asarray(inputs.token_type_ids)[None],
            np.asarray(inputs.position_ids)[None], np.asarray([len(inputs.input_ids)]),
            image[None], patch, pool, max_new_tokens=max_new_tokens, device=dev,
        )
        return res.text[0]

    return predict
