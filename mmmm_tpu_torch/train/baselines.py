"""Baseline VQA/report finetuning harnesses (HF torch models), the port of
``scripts/finetune/baselines.py``.

Equivalent of the reference's per-baseline finetune datamodules
(the reference's ``scripts/finetune/cli.py:11-64``, ``_vqa/_base.py``): each
baseline gets a transform that builds supervised (inputs, labels) through its
OWN processor/prompt format, and a small torch training loop drives it over a
processed VL dataset (the same ``{split}.json`` contract the MMMM datamodule
reads, through ``data/vl.py``). Implemented: instructblip, llavanext
(HF-native), cogvlm + m3d (HF remote-code) and llavamed (llava-codebase
loader) — 5 of the reference's 6; the RadFM vendored architecture remains a
predict-hook guard in ``eval/baselines.py``. They need ``transformers``
(imported where a model is loaded) and a local checkpoint, and train on the
card unless ``--device cpu``.

Supervision follows the reference's scheme (``_vqa/_base.py:30-60``): the
prompt tokens are CE-ignored, the answer tokens are supervised. By default
only the language-model tail finetunes (vision towers frozen), as in the
reference's CPU-feasible default; ``--train-all`` unfreezes everything.

    python -m mmmm_tpu_torch.cli finetune-baseline --model instructblip \
        --checkpoint <hf dir> --processor <hf dir> \
        --dataset-dir <processed/VQA-RAD> --out runs/ft-iblip
"""
from __future__ import annotations

import json
from pathlib import Path

from ..data.defs import Split
from ..data.vl import get_vl_data_list
from ..ops._cuda import resolve_device

CE_IGNORE_INDEX = -100


# -- per-model supervised-example builders -----------------------------------

def _mask_prompt(inputs, processor, answer: str):
    """CE-mask everything except the answer suffix (the processor may prepend
    image placeholder tokens, so a prompt-length prefix count is unreliable —
    the answer token count from the end is)."""
    n_answer = len(processor.tokenizer(answer, add_special_tokens=False)["input_ids"])
    labels = inputs["input_ids"].clone()
    labels[:, : labels.shape[1] - n_answer] = CE_IGNORE_INDEX
    inputs["labels"] = labels
    return inputs


def instructblip_example(processor, image, question: str, answer: str):
    """InstructBLIP: 'Question: {q} Answer: {a}', prompt CE-masked, qformer
    sees the instruction only (ref ``scripts/finetune/_vqa`` prompt format)."""
    prompt = f"Question: {question} Answer: "
    inputs = processor(images=image, text=prompt + answer, return_tensors="pt")
    inputs = _mask_prompt(inputs, processor, answer)
    q_inputs = processor.qformer_tokenizer(prompt, return_tensors="pt")
    inputs["qformer_input_ids"] = q_inputs["input_ids"]
    inputs["qformer_attention_mask"] = q_inputs["attention_mask"]
    return inputs


def llavanext_example(processor, image, question: str, answer: str):
    """LLaVA-NeXT: '[INST] <image> q [/INST] a', prompt + image placeholders
    CE-masked (llava-v1.6 conversation format)."""
    prompt = f"[INST] <image>\n{question} [/INST] "
    inputs = processor(images=image, text=prompt + answer, return_tensors="pt")
    return _mask_prompt(inputs, processor, answer)


# CLIP statistics, adopted by CogVLM and the reference's baseline transforms
# (the reference's scripts/finetune/_utils.py:7-18)
CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
# llava-codebase image sentinel (spliced at embed time, not a vocab id)
LLAVA_IMAGE_TOKEN_INDEX = -200


def _prep_image(image, size, *, gray: bool = False, depth: int | None = None):
    """Reference baseline image path (_vqa/_base.py:26-29, m3d.py:57-62):
    to-float [0,1] -> resize -> CLIP intensity norm (RGB) or raw gray;
    ``depth`` repeats a 2-D grayscale slice into a (1, depth, H, W) volume
    (M3D feeds X-rays as constant-depth volumes). torch-native (bilinear
    interpolate) — torchvision is not in this image."""
    import torch

    if not isinstance(image, torch.Tensor):
        import numpy as np

        arr = np.asarray(image.convert("L" if gray else "RGB"))
        t = torch.from_numpy(arr)
        t = t[None] if gray else t.permute(2, 0, 1)
    else:
        t = image
    if not t.is_floating_point():
        t = t.float() / 255.0
    t = torch.nn.functional.interpolate(
        t[None].float(), size=tuple(size), mode="bilinear", align_corners=False
    )[0]
    if gray:
        if depth:
            t = t.expand(depth, *t.shape[1:])[None].clone()  # (1, D, H, W)
        return t
    mean = t.new_tensor(CLIP_MEAN)[:, None, None]
    std = t.new_tensor(CLIP_STD)[:, None, None]
    return (t - mean) / std


def pack_qa_pairs(tokenizer, pairs, *, max_seq_len=None, first_prefix: str = ""):
    """The reference's multi-QA supervised packing, reproduced exactly
    (_vqa/_base.py:30-60): ids = bos + [prompt_i + answer_i]* + eos; labels
    CE-ignore each prompt except that from the second pair on the FIRST
    prompt slot supervises eos (the model must learn to close the previous
    answer), and the leading bos label slot is shifted away by the causal
    loss. Returns (input_ids, labels) as (1, S) tensors."""
    import torch

    text_ids: list[list[int]] = []
    labels: list[list[int]] = []
    for i, (query, answer) in enumerate(pairs):
        prompt = f"Question: {query} Answer:"
        if i == 0:
            prompt = first_prefix + prompt
        pid = tokenizer.encode(prompt, add_special_tokens=False)
        aid = tokenizer.encode(answer, add_special_tokens=False)
        text_ids.extend([pid, aid])
        if i > 0:
            labels.extend([[tokenizer.eos_token_id],
                           [CE_IGNORE_INDEX] * (len(pid) - 1), aid])
        else:
            labels.extend([[CE_IGNORE_INDEX] * len(pid), aid])
    flat = [t for seg in text_ids for t in seg]
    lflat = [t for seg in labels for t in seg]
    ids = [tokenizer.bos_token_id, *flat, tokenizer.eos_token_id]
    labs = [tokenizer.bos_token_id, *lflat, tokenizer.eos_token_id]
    if max_seq_len is not None:
        ids, labs = ids[:max_seq_len], labs[:max_seq_len]
    return torch.tensor(ids)[None], torch.tensor(labs)[None]


class SimpleVLProcessor:
    """Processor shim for baselines without an HF processor class (CogVLM /
    llava-codebase LLaVA-Med / M3D): a tokenizer plus the model's image and
    layout constants."""

    def __init__(self, tokenizer, resize=(224, 224), *, num_vision_tokens=0,
                 proj_out_num=256, image_token_id=LLAVA_IMAGE_TOKEN_INDEX):
        self.tokenizer = tokenizer
        self.resize = tuple(resize)
        self.num_vision_tokens = num_vision_tokens
        self.proj_out_num = proj_out_num
        self.image_token_id = image_token_id

    def save_pretrained(self, out):
        self.tokenizer.save_pretrained(out)


def cogvlm_example(processor, image, question, answer):
    """CogVLM-base: text ids packed per the VQA scheme, then expanded around
    the ``35*35 + 2`` vision-token span at position 1 with token_type_ids
    marking it, exactly as the reference's training_step builds them
    (_vqa/cogvlm.py:44-66); images ride as (B, 1, C, H, W)."""
    import torch

    tok = processor.tokenizer
    ids, labels = pack_qa_pairs(tok, [(question, answer)])
    nvis = processor.num_vision_tokens or (35 * 35 + 2)
    b, s = ids.shape
    tt = torch.zeros((b, nvis + s), dtype=torch.long)
    tt[:, 1 : 1 + nvis] = 1
    new_ids = torch.zeros_like(tt)
    new_ids[tt == 0] = ids.view(-1)
    mask = torch.ones_like(tt)
    new_labels = torch.full_like(tt, CE_IGNORE_INDEX)
    new_labels[tt == 0] = labels.view(-1)
    img = _prep_image(image, processor.resize)
    return {
        "input_ids": new_ids, "token_type_ids": tt, "attention_mask": mask,
        "labels": new_labels, "images": img[None, None],  # (B, 1, C, H, W)
    }


def llavamed_example(processor, image, question, answer):
    """LLaVA-Med (llava codebase): '<image>\\n' prefixes the first prompt and
    its token id is post-replaced with the splice sentinel -200
    (llava.mm_utils.tokenizer_image_token convention); the whole first prompt
    — image token included — is CE-masked by the packing
    (_vqa/llavamed.py:70-108)."""
    tok = processor.tokenizer
    ids, labels = pack_qa_pairs(tok, [(question, answer)], first_prefix="<image>\n")
    img_vocab_id = tok.convert_tokens_to_ids("<image>")
    ids = ids.clone()
    ids[ids == img_vocab_id] = processor.image_token_id
    import torch

    return {
        "input_ids": ids, "attention_mask": torch.ones_like(ids),
        "labels": labels, "images": _prep_image(image, processor.resize)[None],
    }


def m3d_example(processor, image, question, answer):
    """M3D-LaMed: ``<im_patch>`` x proj_out_num (256) prefixes the first
    prompt (masked with it); X-ray images feed as grayscale constant-depth
    volumes (1, 32, H, W) in bf16 (_vqa/m3d.py:55-100)."""
    import torch

    tok = processor.tokenizer
    prefix = "<im_patch>" * processor.proj_out_num
    ids, labels = pack_qa_pairs(tok, [(question, answer)], first_prefix=prefix)
    img = _prep_image(image, processor.resize, gray=True, depth=32)
    return {
        "input_ids": ids, "attention_mask": torch.ones_like(ids),
        "labels": labels, "images": img[None].to(torch.bfloat16),
    }


EXAMPLE_BUILDERS = {
    "instructblip": instructblip_example,
    "llavanext": llavanext_example,
    "cogvlm": cogvlm_example,
    "llavamed": llavamed_example,
    "m3d": m3d_example,
}


# which parameter names stay trainable when vision towers are frozen; the
# reference LoRAs every nn.Linear (vision included) — our CPU-feasible
# default trains the LM weights directly and freezes vision (--train-all
# restores everything-trains)
_TRAINABLE_PRED = {
    "default": lambda n: ("language_model" in n or "lm_head" in n
                          or "text_model" in n),
    # CogVLM/M3D/llava-codebase models nest vision under model.vision /
    # vision_tower; everything else (incl. the visual-expert matrices, which
    # ARE language-path weights) trains
    "by_vision_substring": lambda n: "vision" not in n,
}


def _freeze_for_finetune(model, train_all: bool, *, pred: str = "default"):
    """Vision towers frozen; language model trains (reference finetunes the
    LM with PEFT — without the peft lib we finetune the LM weights directly)."""
    if train_all:
        return
    keep = _TRAINABLE_PRED[pred]
    for name, p in model.named_parameters():
        p.requires_grad = keep(name)


def iter_vqa_items(dataset_dir: Path, split: str = "train"):
    """Yield (image_path, question, answer) from the processed VL contract."""
    for item in get_vl_data_list(Path(dataset_dir), Split(split)):
        image = item["image"][0]
        if item.get("vqa"):
            for qa in item["vqa"]:
                yield image, qa["question"], qa["answer"]
        elif item.get("processed_report") or item.get("findings"):
            report = item.get("processed_report") or item["findings"]
            yield image, "Please write a radiology report for this image.", report


# the reference's report-generation finetune prompt, verbatim
# (the reference's scripts/finetune/_rg/_base.py:35)
RG_PROMPT = "Please write a radiology report for me:"


def iter_report_items(dataset_dir: Path, split: str = "train"):
    """Yield (image_path, RG_PROMPT, report) per the reference ``_rg/_base.py``
    contract: prompt CE-masked, the processed report supervised."""
    for item in get_vl_data_list(Path(dataset_dir), Split(split)):
        report = item.get("processed_report") or item.get("findings")
        if report and item.get("image"):
            yield item["image"][0], RG_PROMPT, report


def finetune_torch_model(
    model,
    processor,
    examples,  # iterable of (image_path_or_PIL, question, answer)
    example_builder,
    *,
    steps: int = 100,
    lr: float = 2e-5,
    grad_accum: int = 4,
    log_every: int = 10,
    train_all: bool = False,
    freeze_pred: str = "default",
) -> list[float]:
    """The shared training loop; returns per-log-step mean losses. Each
    example's tensors go to the device the model lies on."""
    import torch

    dev = next(model.parameters()).device
    _freeze_for_finetune(model, train_all, pred=freeze_pred)
    params = [p for p in model.parameters() if p.requires_grad]
    if not params:
        raise ValueError("nothing trainable after freezing")
    opt = torch.optim.AdamW(params, lr=lr, weight_decay=0.01)
    model.train()
    losses, window = [], []
    pool = list(examples)
    step = 0
    while step < steps:
        for image, q, a in pool:
            if step >= steps:
                break
            if isinstance(image, (str, Path)):
                from PIL import Image

                image = Image.open(image).convert("RGB")
            inputs = example_builder(processor, image, q, a)
            out = model(**{k: v.to(dev) if isinstance(v, torch.Tensor) else v
                           for k, v in inputs.items()})
            (out.loss / grad_accum).backward()
            window.append(float(out.loss.detach()))
            step += 1
            if step % grad_accum == 0:
                torch.nn.utils.clip_grad_norm_(params, 1.0)
                opt.step()
                opt.zero_grad()
            if step % log_every == 0:
                losses.append(sum(window) / len(window))
                print(json.dumps({"step": step, "loss": losses[-1]}), flush=True)
                window = []
    return losses


def load_finetune_model(name: str, checkpoint: str, processor_dir: str | None = None,
                        device: str = "cuda"):
    """``(model, processor, freeze_pred)`` of a local HF checkpoint of the
    baseline ``name`` (``main``'s loaders in the JAX script), the model on
    ``device`` (the card unless ``"cpu"``; a CUDA device where there is none
    raises before anything loads)."""
    dev = resolve_device(device)
    freeze_pred = "default"
    if name == "instructblip":
        from transformers import InstructBlipForConditionalGeneration, InstructBlipProcessor

        model = InstructBlipForConditionalGeneration.from_pretrained(
            checkpoint, local_files_only=True, low_cpu_mem_usage=True
        )
        processor = InstructBlipProcessor.from_pretrained(
            processor_dir or checkpoint, local_files_only=True
        )
    elif name == "llavanext":
        from transformers import LlavaNextForConditionalGeneration, LlavaNextProcessor

        model = LlavaNextForConditionalGeneration.from_pretrained(
            checkpoint, local_files_only=True, low_cpu_mem_usage=True
        )
        processor = LlavaNextProcessor.from_pretrained(
            processor_dir or checkpoint, local_files_only=True
        )
    elif name == "cogvlm":
        # THUDM/cogvlm-chat-hf: remote-code architecture + vicuna tokenizer
        # (ref conf: lmsys/vicuna-7b-v1.5); images at 490 -> 35x35 patches
        from transformers import AutoModelForCausalLM, AutoTokenizer

        model = AutoModelForCausalLM.from_pretrained(
            checkpoint, local_files_only=True, trust_remote_code=True,
            low_cpu_mem_usage=True,
        )
        tok = AutoTokenizer.from_pretrained(
            processor_dir or checkpoint, local_files_only=True
        )
        processor = SimpleVLProcessor(tok, (490, 490),
                                      num_vision_tokens=35 * 35 + 2)
        freeze_pred = "by_vision_substring"
    elif name == "llavamed":
        # microsoft/llava-med-*: llava-codebase checkpoint; the vendored
        # ``llava`` package loads it (the reference vendors the same one)
        try:
            from llava.mm_utils import get_model_name_from_path
            from llava.model.builder import load_pretrained_model
        except ImportError as e:  # pragma: no cover - env without llava pkg
            raise ImportError(
                "llavamed needs the llava package (the reference vendors "
                "microsoft/LLaVA-Med's loader); install it or use --model "
                "llavanext for the HF-native llava variant"
            ) from e
        tok, model, _img_proc, _ctx = load_pretrained_model(
            checkpoint, None, get_model_name_from_path(checkpoint)
        )
        processor = SimpleVLProcessor(tok, (256, 256))
        freeze_pred = "by_vision_substring"
    else:  # m3d
        from transformers import AutoModelForCausalLM, AutoTokenizer

        model = AutoModelForCausalLM.from_pretrained(
            checkpoint, local_files_only=True, trust_remote_code=True,
            low_cpu_mem_usage=True,
        )
        tok = AutoTokenizer.from_pretrained(
            processor_dir or checkpoint, local_files_only=True,
            model_max_length=1024,
        )
        processor = SimpleVLProcessor(tok, (256, 256), proj_out_num=256)
        freeze_pred = "by_vision_substring"

    return model.to(dev), processor, freeze_pred
