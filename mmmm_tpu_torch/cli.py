"""Command-line entry points of the port, the counterparts of the JAX
package's ``scripts/cli.py fit``, ``scripts/align_sam.py``,
``scripts/demo.py`` and ``scripts/evaluate/cli.py predict`` / ``evaluate``:

    python -m mmmm_tpu_torch.cli fit -c conf/<phase>/fit.yaml [--no-resume] [--device cpu] [k=v ...]
    python -m mmmm_tpu_torch.cli finetune -c conf/finetune/mmmm-vqa.yaml --dataset-dir DIR
        [--task vqa|report] [--init-adapter adapter.npz] [--device cpu] [k=v ...]
    python -m mmmm_tpu_torch.cli align-sam -c conf/align-sam/fit.yaml [--instance] [--device cpu] [k=v ...]
    python -m mmmm_tpu_torch.cli demo -c conf/tiny/fit.yaml [--image path] [--adapter adapter.npz]
        [--question ...] [--max-new-tokens N] [--instance] [--quantize] [--kv-cache int8]
        [--speculate K] [--interactive] [--device cpu]
    python -m mmmm_tpu_torch.cli predict -c conf/tiny/fit.yaml --task vqa|report
        --dataset-dir DIR --output pred.csv [--batch N] [--continuous] [--device cpu] ...
    python -m mmmm_tpu_torch.cli evaluate --input pred.csv [--suite generic|cxr|ct|all] ...
    python -m mmmm_tpu_torch.cli detector-train --data <processed/VinDr-CXR> --out ckpt/
        [--steps N --batch B --size 512 --layers 3 --queries 100 --lr 2e-4] [--device cpu]
    python -m mmmm_tpu_torch.cli detector-infer --ckpt ckpt/ --tags vg.json
        [--images DIR] --out DIR [--device cpu]
    python -m mmmm_tpu_torch.cli seg-exp [-c conf/seg-exp/unet.yaml] --model unet|sam
        --data <processed dataset> --classes A B [--steps N ...] [--out res.json] [--device cpu]
    python -m mmmm_tpu_torch.cli process --layout nnunet|segfolder|boxfolder | --dataset NAME
        --src RAW --out PROCESSED [--name X] [--limit N]
    python -m mmmm_tpu_torch.cli clean-reports --dir DIR --dataset MIMIC-CXR|CT-RATE|OpenI|ROCOv2
        [--split S] (--rule-based | --params lm.npz [--config lm.yaml] [--tokenizer DIR]
        [--max-new-tokens N] [--continuous] [--speculate K] [--device cpu])
    python -m mmmm_tpu_torch.cli tag-reports --dir DIR [--split S] --out VG_DIR
        (--taxonomy-only | --params lm.npz ... as clean-reports)
    python -m mmmm_tpu_torch.cli self-label --vg-dir VG_DIR --sam sam_aligned.npz
        --embeddings embeds.npz [--threshold 0.5] [--patch-size 8 16 16] [--grid 4 16 16]
        [--sam-config sam.yaml] [--limit N] [--device cpu]
    python -m mmmm_tpu_torch.cli compress-vl --data DIR --out DIR [--image-root R]
        [--splits train validate test] [--workers 4]
    python -m mmmm_tpu_torch.cli convert-vl --format vqa-json|report-folder|mimic-cxr|ct-rate|
        label|openi|rocov2|pmc-oa|radiopaedia|vqa-med --src RAW --out DIR [...]
    python -m mmmm_tpu_torch.cli predict-baseline --model NAME --checkpoint DIR
        --task vqa|report --dataset-dir DIR --output pred.csv [--device cpu]
    python -m mmmm_tpu_torch.cli finetune-baseline --model NAME --checkpoint DIR
        --dataset-dir DIR --out DIR [--task vqa|report] [--steps N] [--device cpu]

The same YAML configs, dotted ``k=v`` overrides (applied before ``${...}``
interpolation) and builders. Every command runs on the card unless
``--device cpu``. ``fit`` trains data parallel over N processes, one card
each (gloo processes with ``--device cpu``), launched with
``COORDINATOR_ADDRESS=host:port NUM_PROCESSES=N PROCESS_ID=i`` in each
process's environment (``trainer.mesh_data`` defaults to ``gcd(batch_size,
N / (mesh_model x mesh_seq x mesh_pipe))``; ``train/trainer.py``), tensor
parallel with ``trainer.mesh_model`` above 1, sequence parallel (ring
attention) with ``trainer.mesh_seq`` and pipeline parallel (GPipe, in
``trainer.pipe_micro`` microbatches) with ``trainer.mesh_pipe`` above 1;
``demo`` and ``predict`` serve tensor parallel
over N such processes with ``--tp N`` (``parallel/sharding.py
tp_serving_params``);
``finetune`` (``scripts/finetune/cli.py``) is ``fit`` over the one
vision-language dataset in ``--dataset-dir``, with the task's transform
ratios, warm-started from an ``adapter.npz`` (the JAX package's
``save_adapter`` writes one too) with a fresh optimizer state;
``align-sam`` writes ``metrics.jsonl`` and ``sam_aligned.npz`` (the SAM
tree, in the JAX package's adapter layout) under ``trainer.out_dir``.
``demo`` prints the report of one image (a synthetic one without
``--image``) with its grounded targets; ``predict`` writes a model's
answers over a VQA or report test set to a CSV, batched or through
``GroundedServer`` (``--continuous``); ``evaluate`` scores such a CSV.
``demo`` and ``predict`` take the commands' functions ``cmd_demo`` and
``cmd_predict`` a model already loaded (``loaded=``), as ``load_model``
returns it. ``detector-train`` and ``detector-infer`` are
``scripts/data/detector.py train`` / ``infer`` (the same flags, the same
``params.npz`` with its ``cfg`` leaf, the mAP@0.5 line, the
``{stem}_box.json`` files; ``train/detector.py``); ``seg-exp`` is
``scripts/seg_exp.py`` (``train/seg_exp.py``); ``process`` is
``scripts/data/process.py`` over ``preprocess/``, host code only.
``clean-reports``, ``tag-reports``, ``self-label``, ``compress-vl`` and
``convert-vl`` are ``scripts/data/*.py`` (``preprocess/``): the LLM routes
run ``models/llm_batch.py make_text_generator`` on the card, ``self-label``
SAM; ``compress-vl`` and ``convert-vl`` are host code (no ``--device``).
``predict-baseline`` is ``scripts/evaluate/cli.py predict-baseline``
(``eval/baselines.py``) and ``finetune-baseline`` is
``scripts/finetune/baselines.py`` (``train/baselines.py``): HF models from
local checkpoints, which need ``transformers``.
"""
from __future__ import annotations

import argparse
import csv
import json
import sys
import time
from pathlib import Path

import numpy as np
import torch


def _load_config(args) -> dict:
    from .config import apply_overrides, load_yaml, resolve_interpolations

    cfg = load_yaml(args.config, resolve=False)
    return resolve_interpolations(apply_overrides(cfg, args.overrides))


def cmd_fit(args):
    from .build import build_dataset, build_model, build_tokenizer
    from .config import build
    from .peft import LoraConfig
    from .train import OptimizerConfig
    from .train.trainer import Trainer, TrainerConfig

    cfg = _load_config(args)
    tokenizer = build_tokenizer(cfg.get("tokenizer"))
    model = build_model(cfg.get("model"), tokenizer)
    dataset = build_dataset(cfg.get("data") or {}, tokenizer, Path(args.config).parent)
    trainer = Trainer(model, dataset, build(OptimizerConfig, cfg.get("optimizer") or {}),
                      build(LoraConfig, cfg.get("lora") or {}),
                      build(TrainerConfig, cfg.get("trainer") or {}), device=args.device)
    print(f"device: {trainer.device}", flush=True)
    trainer.fit(resume=not args.no_resume)


def finetune_config(cfg: dict, dataset_dir, task: str) -> dict:
    """``cfg`` (a resolved config dict) with its ``data`` section set to
    finetune on the vision-language dataset in ``dataset_dir``: VQA only
    (``report_ratio`` and ``ac_ratio`` 0) for ``task="vqa"``, reports only
    (``report_ratio`` 1) for ``"report"``; a ratio the config sets is kept."""
    data_cfg = cfg.setdefault("data", {})
    ds_dir = Path(dataset_dir)
    data_cfg["datasets"] = [{"name": ds_dir.name, "type": "vl", "dir": str(ds_dir)}]
    vt = data_cfg.setdefault("vl_trans", {})
    if task == "vqa":
        vt.setdefault("report_ratio", 0.0)
        vt.setdefault("ac_ratio", 0.0)
    elif task == "report":
        vt.setdefault("report_ratio", 1.0)
    else:
        raise ValueError(f"task must be 'vqa' or 'report', got {task!r}")
    return cfg


def cmd_finetune(args, cfg: dict | None = None, state=None):
    """Downstream VQA or report finetuning: ``fit`` over one
    vision-language dataset. With ``--init-adapter`` the adapter (trainable
    tree) and a fresh optimizer state are written as the step-0 checkpoint
    of ``trainer.out_dir``, and the fit resumes from it; without, it starts
    fresh. ``cfg`` is the config as a dict, in place of ``-c`` and the
    overrides; ``state`` a ``(TrainState, frozen)`` pair to start from
    (``Trainer.fit``). Returns the ``Trainer``."""
    from .build import build_dataset, build_model, build_tokenizer
    from .config import build
    from .peft import LoraConfig
    from .peft.lora import flatten
    from .train import OptimizerConfig
    from .train.checkpoint import CheckpointManager, load_adapter
    from .train.trainer import Trainer, TrainerConfig

    cfg = finetune_config(_load_config(args) if cfg is None else cfg, args.dataset_dir,
                          args.task)
    tokenizer = build_tokenizer(cfg.get("tokenizer"))
    model = build_model(cfg.get("model"), tokenizer)
    dataset = build_dataset(cfg["data"], tokenizer, Path(args.config).parent)
    trainer = Trainer(model, dataset, build(OptimizerConfig, cfg.get("optimizer") or {}),
                      build(LoraConfig, cfg.get("lora") or {}),
                      build(TrainerConfig, cfg.get("trainer") or {}), device=args.device)
    print(f"device: {trainer.device}", flush=True)
    if args.init_adapter:
        warm = load_adapter(args.init_adapter)
        ckpt = CheckpointManager(Path(trainer.cfg.out_dir) / "ckpt", 1)
        ckpt.maybe_save(0, {"trainable": warm, "opt_state": trainer.optimizer.init(flatten(warm))})
        ckpt.wait()
    trainer.fit(resume=bool(args.init_adapter), state=state)
    return trainer


def cmd_align_sam(args):
    """Stage-0 alignment: SAM (or, with ``--instance``, instance SAM)
    trained alone on patches of the local datasets against frozen
    per-class prompt embeddings (``class_embeddings``: an ``.npz`` of
    ``{class name: (C,)}``; random when absent). The SAM encoder's attention
    runs K3 forward and K7 backward (``attn_impl="pallas"``), as the
    trainer's default."""
    from .config import build
    from .data.align import AlignPatchTransform, AlignTransConf, collate_align
    from .data.defs import PROCESSED_LOCAL_DATA_ROOT
    from .data.local import get_local_data_list
    from .data.sparse import Sparse
    from .models.align import AlignConfig, align_training_step
    from .models.segvol import SamConfig
    from .ops._cuda import resolve_device
    from .params import init_sam_params
    from .peft.lora import flatten, unflatten
    from .train import OptimizerConfig, make_optimizer
    from .train.checkpoint import save_adapter
    from .train.step import batch_to

    cfg = _load_config(args)
    dev = resolve_device(args.device)
    sam_cfg = build(SamConfig, cfg.get("sam") or {})
    align_tc = build(AlignTransConf, cfg.get("align") or {})
    trainer_cfg = cfg.get("trainer") or {}
    max_steps = trainer_cfg.get("max_steps", 1000)
    batch_size = trainer_cfg.get("batch_size", 4)
    out_dir = Path(trainer_cfg.get("out_dir", "runs/align-sam"))
    out_dir.mkdir(parents=True, exist_ok=True)

    # datasets ({name, weight?, dir?}; dir defaults to the processed local
    # root / name) and the class index; datasets not on disk are skipped
    data_cfg = cfg.get("data") or {}
    skip_missing = bool(data_cfg.get("skip_missing", True))
    ds_lists, ds_weights, skipped = [], [], []
    for spec in data_cfg.get("datasets", []):
        d = Path(spec["dir"]) if spec.get("dir") else PROCESSED_LOCAL_DATA_ROOT / spec["name"]
        if skip_missing and not d.exists():
            skipped.append(spec.get("name", str(d)))
            continue
        ds_lists.append(get_local_data_list(d))
        ds_weights.append(float(spec.get("weight", 1.0)))
    if skipped:
        print(f"skipping {len(skipped)} dataset(s) without processed data: "
              f"{', '.join(skipped)}", flush=True)
    data_lists = [item for dl in ds_lists for item in dl]
    if not data_lists:
        raise SystemExit("no datasets configured (data.datasets[].{name|dir})")
    names = set()
    for item in data_lists:
        sp = Sparse.from_json((Path(item["dataset_dir"]) / "data" / item["key"]
                               / "sparse.json").read_bytes())
        names |= {t.name for ts in sp.targets.values() for t in ts}
        names |= {n for ns in sp.neg_targets.values() for n in ns}
    class_to_idx = {n: i for i, n in enumerate(sorted(names))}
    # a case's probability is its dataset's weight, as the trainer's sampler
    case_w = np.concatenate([np.full(len(dl), w) for dl, w in zip(ds_lists, ds_weights)])
    case_p = case_w / case_w.sum()
    print(f"{len(data_lists)} cases, {len(class_to_idx)} classes", flush=True)

    if emb_path := cfg.get("class_embeddings"):
        loaded = np.load(emb_path)
        embeds = np.stack([loaded[n] for n in sorted(names)])
    else:
        embeds = np.random.default_rng(0).normal(size=(len(class_to_idx), sam_cfg.embed_dim)) * 0.02
    embeds = torch.as_tensor(embeds, dtype=torch.float32, device=dev)

    align_cfg = AlignConfig(sam=sam_cfg, instance=args.instance)
    flat = flatten(init_sam_params(sam_cfg, instance=args.instance, seed=0, device=dev))
    for t in flat.values():
        t.requires_grad_(True)
    params = unflatten(flat)
    optimizer = make_optimizer(build(OptimizerConfig, cfg.get("optimizer") or {"lr": 2e-4}))
    opt_state = optimizer.init(flat)
    tf = AlignPatchTransform(align_tc, class_to_idx, seed=0)
    patch_vit = tuple(cfg.get("vit_patch_size", (align_tc.patch_size_z, 16, 16)))

    rng = np.random.default_rng(0)
    log_every = trainer_cfg.get("log_every", 50)
    t0 = time.time()
    with (out_dir / "metrics.jsonl").open("a") as log_file:
        for it in range(1, max_steps + 1):
            picks = rng.choice(len(data_lists), batch_size, p=case_p)
            batch = batch_to(collate_align([tf(data_lists[i]) for i in picks]), dev)
            loss, logs = align_training_step(params, align_cfg, embeds,
                                             {**batch, "patch_size": patch_vit},
                                             attn_impl="pallas")
            grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
            optimizer.step(flat, dict(zip(flat, grads)), opt_state)
            if it % log_every == 0 or it == max_steps:
                rec = {"step": it, **{k: float(v.detach()) for k, v in logs.items()},
                       "sec": round(time.time() - t0, 1)}
                print(json.dumps(rec), flush=True)
                log_file.write(json.dumps(rec) + "\n")
                log_file.flush()
    save_adapter(out_dir / "sam_aligned.npz", params)
    print(f"saved {out_dir / 'sam_aligned.npz'}")


def load_model(config, adapter: str | None, quantize: bool = False,
               device: str | torch.device = "cuda"):
    """(model, params on ``device``, tokenizer, config dict) of a config file
    and an optional adapter (``build.load_model_with_adapter``)."""
    from .build import load_model_with_adapter

    return load_model_with_adapter(config, adapter, quantize=quantize, device=device)


def prepare_image(path: str | None, conf):
    """``image_transform`` of the image at ``path``, or of a seeded random
    (1, 1, 64, 64) image without one."""
    from .data.infer_transform import image_transform

    if path:
        return image_transform(path, conf)
    synthetic = np.random.default_rng(0).uniform(0, 255, size=(1, 1, 64, 64)).astype(np.uint8)
    return image_transform(synthetic, conf)


def _data_conf(cfg: dict):
    from .config import build
    from .data.local import DatasetConf

    return build(DatasetConf, (cfg.get("data") or {}).get("conf") or {})


def _tp_params(params: dict, tp: int) -> tuple[dict, bool]:
    """``--tp``: this process's piece of the weights over ``tp`` processes
    (``parallel/sharding.py tp_serving_params``; each process runs the same
    command with ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and
    ``PROCESS_ID``, one device each; one process with ``--tp 2`` raises and
    names them), and whether this process prints and writes (global rank
    0)."""
    from .parallel import process_rank
    from .parallel.sharding import tp_serving_params

    params, _ = tp_serving_params(params, tp)
    return params, process_rank()[0] == 0


def _quiet(*args, **kwargs) -> None:
    """``print`` on the processes that do not print (``--tp``)."""


def cmd_demo(args, loaded=None) -> list:
    """Grounded generation on one image, then (``--interactive``) on each
    follow-up question read from stdin; prints each report, its grounded
    targets and their mask voxels or boxes. Returns each turn's
    ``GroundedResult``."""
    from .data import ConvTurn
    from .data.input_builder import prepare_vlm_inputs
    from .models.inference import generate_grounded

    model, params, tokenizer, cfg = loaded or load_model(args.config, args.adapter,
                                                         args.quantize, args.device)
    params, writer = _tp_params(params, args.tp)
    say = print if writer else _quiet
    image, grounding_image, patch, pool, n_tokens = prepare_image(args.image, _data_conf(cfg))
    results = []

    def run_turn(conversation):
        inputs, _ = prepare_vlm_inputs(conversation, tokenizer, n_tokens, inference=True,
                                       grounding=args.grounding)
        res = generate_grounded(
            params, model.cfg, tokenizer,
            np.asarray(inputs.input_ids)[None], np.asarray(inputs.token_type_ids)[None],
            np.asarray(inputs.position_ids)[None], np.asarray([len(inputs.input_ids)]),
            image[None], patch, pool, max_new_tokens=args.max_new_tokens,
            grounding_image=grounding_image[None], instance=args.instance,
            kv_cache_dtype=args.kv_cache, spec_draft_len=args.speculate, device=args.device)
        results.append(res)
        say("=== generated ===")
        say(res.text[0])
        say("=== grounded targets ===")
        say(res.targets[0])
        valid = res.target_valid
        if res.masks is not None and valid is not None and valid.any():
            probs = torch.sigmoid(res.masks[0].float())
            for i in range(int(valid[0].sum())):
                say(f"target {i}: mask voxels>0.5 = {int((probs[i] > 0.5).sum())}")
        if res.boxes is not None and valid is not None and valid.any():
            disc = torch.sigmoid(res.disc_logit[0]).cpu().numpy()
            boxes = res.boxes[0].cpu().numpy()
            for i in range(int(valid[0].sum())):
                best = int(np.argmax(disc[i]))
                say(f"target {i}: best instance p={disc[i, best]:.3f} "
                      f"box={np.round(boxes[i, best], 3)}")
        return res.text[0]

    conversation = [ConvTurn(args.question, "")]
    answer = run_turn(conversation)
    if args.interactive:
        say("(enter follow-up questions; empty line to quit)")
        while True:
            q = _read_question(writer, args.tp)
            if not q:
                break
            conversation = conversation[:-1] + [ConvTurn(conversation[-1].prompt, answer),
                                                ConvTurn(q, "")]
            answer = run_turn(conversation)
    return results


def _read_question(writer: bool, tp: int) -> str:
    """The next stripped line of standard input ("" at its end); under
    ``--tp`` process 0 reads it and every process of the run gets it."""
    line = (sys.stdin.readline() if writer else "").strip()
    if tp > 1:
        import torch.distributed as dist

        box = [line]
        dist.broadcast_object_list(box, src=0)
        line = box[0]
    return line


def iter_vqa_items(dataset_dir: Path, limit=None):
    data = json.loads((dataset_dir / "test.json").read_text())
    count = 0
    for x in data:
        for vqa in x.get("vqa", []):
            for image in x["image"]:
                yield {"image": image, "question": vqa["question"], "answer": vqa["answer"]}
                count += 1
                if limit and count >= limit:
                    return


def iter_report_items(dataset_dir: Path, name: str, limit=None):
    data = json.loads((dataset_dir / "test-processed.json").read_text())
    count = 0
    for x in data:
        for i, image in enumerate(x["image"]):
            if name == "MIMIC-CXR" and x.get("plane") and x["plane"][i] not in ("AP", "PA"):
                continue
            yield {"image": image, "question": "Please write a radiology report for me:",
                   "answer": x["processed_report"]}
            count += 1
            if limit and count >= limit:
                return


def _write_predictions(path, rows) -> None:
    with open(path, "w", newline="") as f:
        writer = csv.DictWriter(f, fieldnames=["question", "answer", "prediction"])
        writer.writeheader()
        writer.writerows(rows)
    print(f"wrote {len(rows)} predictions to {path}")


def cmd_predict(args, loaded=None) -> list:
    """A model's answers over a VQA (``test.json``) or report
    (``test-processed.json``) test set, written to ``args.output`` as a CSV
    of question, answer and prediction; returns the rows. Batched: rows
    grouped by image shape, patch, pool and a 32-token prompt bucket, each
    group's batches of ``--batch`` through one ``generate_grounded`` call
    (right-padded prompts, their own lengths). ``--continuous``: each image
    family's requests through a ``GroundedServer`` of ``--batch`` slots."""
    from .data import ConvTurn
    from .data.input_builder import prepare_vlm_inputs
    from .models.inference import generate_grounded
    from .models.serving import GroundedServer

    model, params, tokenizer, cfg = loaded or load_model(args.config, args.adapter,
                                                         args.quantize, args.device)
    params, writer = _tp_params(params, args.tp)
    dconf = _data_conf(cfg)
    dataset_dir = Path(args.dataset_dir)
    if args.task == "vqa":
        items = iter_vqa_items(dataset_dir, args.limit)
    else:
        items = iter_report_items(dataset_dir, dataset_dir.name, args.limit)

    batch_n = max(1, args.batch)
    prepared = []
    for item in items:
        img = Path(item["image"])
        img = img if img.is_absolute() else dataset_dir / img
        image, _, patch, pool, n_tokens = prepare_image(str(img), dconf)
        inputs, _ = prepare_vlm_inputs([ConvTurn(item["question"], "")], tokenizer, n_tokens,
                                       inference=True, grounding=False)
        s = len(inputs.input_ids)
        key = (tuple(image.shape), tuple(patch), tuple(pool), -(-s // 32) * 32)
        prepared.append((key, item, image, inputs, s))

    rows = [None] * len(prepared)

    def put(i, text):
        item = prepared[i][1]
        rows[i] = {"question": item["question"], "answer": item["answer"], "prediction": text}
        if writer:
            print(f"[{i}] {text[:60]!r}", flush=True)

    if args.continuous:
        families: dict = {}
        for idx, rec in enumerate(prepared):
            families.setdefault(rec[0][:3], []).append(idx)
        for (_, patch, pool), idxs in families.items():
            n_vis = int(np.sum(np.asarray(prepared[idxs[0]][3].token_type_ids) == 1))
            server = GroundedServer(params, model.cfg, tokenizer, patch_size=patch,
                                    pool_size=pool, n_vis=n_vis, n_slots=batch_n,
                                    max_new_tokens=args.max_new_tokens,
                                    max_prompt_len=max(prepared[i][4] for i in idxs),
                                    device=args.device)
            outs = server.generate([
                {"input_ids": np.asarray(prepared[i][3].input_ids, np.int32),
                 "token_type_ids": np.asarray(prepared[i][3].token_type_ids, np.int32),
                 "position_ids": np.asarray(prepared[i][3].position_ids, np.int32),
                 "image": np.asarray(prepared[i][2], np.float32)} for i in idxs])
            for i, o in zip(idxs, outs):
                put(i, o["text"])
    else:
        groups: dict = {}
        for idx, rec in enumerate(prepared):
            groups.setdefault(rec[0], []).append(idx)
        for (_, patch, pool, bucket), idxs in groups.items():
            for start in range(0, len(idxs), batch_n):
                chunk = idxs[start: start + batch_n]
                b = len(chunk)
                ids, tt, pos = (np.zeros((b, bucket), np.int32) for _ in range(3))
                plen = np.zeros((b,), np.int32)
                for row, i in enumerate(chunk):
                    inp, s = prepared[i][3], prepared[i][4]
                    ids[row, :s] = inp.input_ids
                    tt[row, :s] = inp.token_type_ids
                    pos[row, :s] = inp.position_ids
                    plen[row] = s
                res = generate_grounded(
                    params, model.cfg, tokenizer, ids, tt, pos, plen,
                    np.stack([prepared[i][2] for i in chunk]), patch, pool,
                    max_new_tokens=args.max_new_tokens, spec_draft_len=args.speculate,
                    device=args.device)
                for row, i in enumerate(chunk):
                    put(i, res.text[row])
    rows = [r for r in rows if r is not None]
    if writer:
        _write_predictions(args.output, rows)
    return rows


def _build_model_hooks(args) -> dict:
    """The model-backed scorers whose checkpoints were given (``eval/models.py``;
    they need ``transformers``), on ``args.device``."""
    hooks = {}
    if args.chexbert:
        from transformers import AutoTokenizer

        from .eval.models import ChexbertLabeler

        tok = AutoTokenizer.from_pretrained(args.chexbert_tokenizer or "bert-base-uncased",
                                            local_files_only=True)
        hooks["chexbert"] = ChexbertLabeler(args.chexbert, tokenizer=tok, device=args.device)
    if args.radbert:
        from transformers import AutoTokenizer

        from .eval.models import RadBertClassifier

        tok = AutoTokenizer.from_pretrained(args.radbert_tokenizer, local_files_only=True)
        hooks["radbert"] = RadBertClassifier(args.radbert, tokenizer=tok, device=args.device)
    if args.bertscore_model:
        from .eval.models import BERTScorer

        hooks["bertscore"] = BERTScorer(model_dir=args.bertscore_model, device=args.device)
    return hooks


def cmd_evaluate(args) -> dict:
    """Score a predictions CSV with a metric suite; prints the summary as
    JSON (also to ``--output``), with each labeler's or annotator's source,
    and writes per-row columns to ``--per-row-output``. Returns the summary."""
    from .eval import CTMetrics, CXRMetrics, GenericMetrics
    from .eval.composite import RADCLIQ_COLUMNS, radcliq_scores
    from .eval.radgraph import radgraph_f1

    with open(args.input) as f:
        rows = list(csv.DictReader(f))
    predictions = [r["prediction"] for r in rows]
    references = [r["answer"] for r in rows]
    hooks = _build_model_hooks(args)
    suite = {}
    columns: dict[str, list[float]] = {}
    if args.suite in ("generic", "all"):
        gm = GenericMetrics(bertscore_fn=hooks.get("bertscore"))
        per_row = [gm.compute(p, r) for p, r in zip(predictions, references)]
        for k in per_row[0] if per_row else []:
            columns[k] = [x[k] for x in per_row]
            suite[k] = sum(columns[k]) / len(columns[k])
    if args.suite in ("cxr", "all"):
        cxr = CXRMetrics(labeler=hooks.get("chexbert"))
        suite.update(cxr.compute(predictions, references))
        suite["chexbert_model_backed"] = float("chexbert" in hooks)
        if "chexbert" in hooks:
            columns["chexbert"] = [hooks["chexbert"].similarity(p, r)
                                   for p, r in zip(predictions, references)]
            suite["chexbert"] = sum(columns["chexbert"]) / len(columns["chexbert"])
    if args.suite == "ct":
        ct = CTMetrics(labeler=hooks.get("radbert"))
        suite.update(ct.compute(predictions, references=references))
        suite["radbert_model_backed"] = float("radbert" in hooks)
    if args.suite in ("cxr", "all"):
        # RadGraph-F1 column: official radgraph package > precomputed
        # annotations > taxonomy heuristic (provenance flagged in the output)
        pre = {}
        if args.radgraph_annotations:
            ann = json.loads(Path(args.radgraph_annotations).read_text())
            pre = {"hyp_annotations": ann["hyp"], "ref_annotations": ann["ref"]}
        rg = radgraph_f1(predictions, references, **pre)
        columns["radgraph"] = rg["radgraph"]
        suite["radgraph_f1"] = rg["radgraph_mean"]
        suite["radgraph_annotator"] = rg["annotator"]
        # RadCliQ composite over [radgraph, bertscore, chexbert, bleu2];
        # missing model-backed columns are zero-filled and the run is flagged
        missing = [c for c in RADCLIQ_COLUMNS if c not in columns]
        n = len(predictions)
        full = {c: columns.get(c, [0.0] * n) for c in RADCLIQ_COLUMNS}
        scores = radcliq_scores(full, checkpoint_dir=args.radcliq_dir)
        for k, v in scores.items():
            suite[k] = sum(v) / len(v) if v else 0.0
        if missing:
            suite["radcliq_missing_columns"] = float(len(missing))
    out = {k: (round(v, 4) if isinstance(v, float) else v) for k, v in suite.items()}
    print(json.dumps(out, indent=2))
    if args.output:
        Path(args.output).write_text(json.dumps(out, indent=2))
    if args.per_row_output and columns:
        with open(args.per_row_output, "w", newline="") as f:
            # provenance comment line (read back with comment='#'): the
            # labeler/annotator source beside the metric columns
            prov = {k: v for k, v in suite.items()
                    if k.endswith(("_labeler", "_annotator", "_model_backed"))}
            f.write("# provenance: " + json.dumps(prov) + "\n")
            writer = csv.DictWriter(f, fieldnames=["question", "answer", "prediction", *columns])
            writer.writeheader()
            for i, row in enumerate(rows):
                row = {k: row.get(k, "") for k in ("question", "answer", "prediction")}
                row.update({k: round(columns[k][i], 4) for k in columns})
                writer.writerow(row)
    return out


def cmd_detector_train(args) -> dict:
    """Fit the pseudo-box detector on a processed VinDr-CXR directory and
    save ``params.npz`` (the parameters and the command's settings)."""
    from .train.checkpoint import save_params
    from .train.detector import CaseDirs, detector_config, train_detector

    cfg = detector_config(args.size, args.layers, args.queries)
    cases = CaseDirs(Path(args.data), cfg)
    if not len(cases):
        raise SystemExit(f"no processed cases under {Path(args.data) / 'data'}")
    print(f"{len(cases)} cases; classes={cfg.num_classes}", flush=True)
    result = train_detector(cfg, cases, steps=args.steps, batch=args.batch, lr=args.lr,
                            seed=args.seed, log_every=args.log_every, eval_frac=args.eval_frac,
                            device=args.device, log=lambda m: print(m, flush=True))
    cli_cfg = {k: v for k, v in vars(args).items()
               if isinstance(v, (int, float, str, bool)) and k != "device"}
    save_params(Path(args.out), {"params": result["params"], "cfg": cli_cfg})
    print(f"saved detector to {args.out}")
    return result


def cmd_detector_infer(args) -> int:
    """Write ``{stem}_box.json`` for the images of a tagged-report JSON."""
    from .params import detector_params_from_jax
    from .train.checkpoint import load_params
    from .train.detector import detector_config, infer_images

    cfg = detector_config(args.size, args.layers, args.queries)
    params = detector_params_from_jax(load_params(Path(args.ckpt))["params"], cfg, args.device)
    items = json.loads(Path(args.tags).read_text())
    n = infer_images(params, cfg, items, Path(args.out), image_root=args.images,
                     score_th=args.score_th, device=args.device)
    print(f"wrote {n} *_box.json files to {args.out}")
    return n


def seg_exp_config(args) -> dict:
    """The experiment's settings: the script's defaults, then the ``-c``
    config's, then the flags given."""
    from .train.seg_exp import SEG_EXP_DEFAULTS

    cfg = dict(SEG_EXP_DEFAULTS)
    if args.config:
        from .config import load_yaml

        cfg.update(load_yaml(args.config))
    for k in ("model", "data", "classes", "steps", "batch", "patch", "lr", "weight_decay",
              "channels", "val_frac", "seed", "out", "log_every"):
        if getattr(args, k, None) is not None:
            cfg[k] = getattr(args, k)
    if cfg.get("model") is None or cfg.get("data") is None or cfg.get("classes") is None:
        raise SystemExit("--model, --data and --classes are required (via flags or -c config)")
    return cfg


def cmd_seg_exp(args) -> dict:
    """The segmentation ablation: train, print and write the Dice JSON."""
    from .train.seg_exp import load_cases, run_seg_exp

    cfg = seg_exp_config(args)
    cases = load_cases(Path(cfg["data"]), cfg["classes"])
    if len(cases) < 2:
        raise SystemExit(f"need >= 2 cases with {cfg['classes']}, found {len(cases)}")
    results = run_seg_exp(cfg, cases, device=args.device, log=lambda m: print(m, flush=True))
    print(json.dumps(results, indent=2))
    if cfg.get("out"):
        Path(cfg["out"]).write_text(json.dumps(results, indent=2))
    return results


def cmd_process(args) -> list:
    """Offline dataset processing into the processed layout (host only)."""
    from .preprocess.processor import NNUNetProcessor, ProcessorConfig
    from .preprocess.seg_folder import SegFolderProcessor

    conf = ProcessorConfig(max_smaller_edge=args.max_smaller_edge)
    if args.dataset:
        from .preprocess.registry import build_processor

        proc = build_processor(args.dataset, Path(args.src), Path(args.out), conf)
    elif args.layout == "boxfolder":
        from .preprocess.boxes import BoxFolderProcessor, load_box_cases

        proc = BoxFolderProcessor(args.name or "boxes", load_box_cases(Path(args.src)),
                                  Path(args.out), conf=conf)
    elif args.layout:
        cls = {"nnunet": NNUNetProcessor, "segfolder": SegFolderProcessor}[args.layout]
        proc = cls(Path(args.src), Path(args.out), name=args.name, modality=args.modality,
                   conf=conf)
    else:
        raise SystemExit("one of --dataset or --layout is required")
    info = proc.process(limit=args.limit)
    ok = sum(1 for r in info if r["status"] == "ok")
    exists = sum(1 for r in info if r["status"] == "exists")
    print(f"{proc.name}: {ok} processed, {exists} existing, "
          f"{len(info) - ok - exists} failed/skipped")
    return info


def _text_generator(args):
    """``make_text_generator`` over the ``--params`` CogVLM tree (a
    ``save_params`` file of either package) and ``--config`` (CogVLMConfig
    fields, YAML or JSON) on ``--device``: the LLM route of
    ``clean-reports`` and ``tag-reports``."""
    from .config import build, load_yaml
    from .data.tokenizer import MMMMTokenizer
    from .models.cogvlm import CogVLMConfig
    from .models.llm_batch import make_text_generator
    from .ops._cuda import resolve_device
    from .params import map_tree
    from .train.checkpoint import load_params

    cfg = build(CogVLMConfig, load_yaml(args.config) if args.config else {})
    tok = (MMMMTokenizer.from_pretrained(args.tokenizer) if args.tokenizer
           else MMMMTokenizer.byte_fallback())
    dev = resolve_device(args.device)
    params = map_tree(lambda t: t.to(dev) if isinstance(t, torch.Tensor) else t,
                      load_params(args.params))
    return make_text_generator(params, cfg, tok, max_new_tokens=args.max_new_tokens,
                               continuous=args.continuous, speculate=args.speculate,
                               device=dev)


def cmd_clean_reports(args) -> Path:
    """``scripts/data/clean_reports.py``: the dataset's cleaning prompts
    through the LLM (``--params``) or the rule-based cleaner."""
    from .preprocess.clean_reports import _rule_based_fn, clean_dataset

    if args.rule_based:
        fn, name = _rule_based_fn, "rule-based"
    elif args.params:
        fn, name = _text_generator(args), "llm"
    else:
        raise SystemExit("pass --rule-based or --params")
    return clean_dataset(Path(args.dir), args.dataset, args.split, fn, cleaner_name=name)


def cmd_tag_reports(args) -> Path:
    """``scripts/data/tag_reports.py``: ``<p>`` phrase tags through the
    two-pass LLM tagger (``--params``) or the taxonomy matcher."""
    from .preprocess.tag_reports import tag_dataset

    if args.taxonomy_only:
        fn = None
    elif args.params:
        fn = _text_generator(args)
    else:
        raise SystemExit("pass --params (local LM checkpoint) or --taxonomy-only")
    return tag_dataset(Path(args.dir), args.split, Path(args.out), fn)


def cmd_self_label(args) -> int:
    """``scripts/data/self_label.py``: pseudo-masks of the tagged targets
    through the aligned SAM head; returns the number of cases labeled."""
    from .config import build, load_yaml
    from .models.segvol import SamConfig
    from .preprocess.self_label import sam_probabilities, self_label
    from .train.checkpoint import load_adapter

    cfg = build(SamConfig, load_yaml(args.sam_config)) if args.sam_config else SamConfig()
    embeds_npz = np.load(args.embeddings)
    embeddings = {k: np.asarray(embeds_npz[k], np.float32) for k in embeds_npz.files}
    patch = tuple(args.patch_size)
    shape = tuple(g * p for g, p in zip(args.grid, patch))
    probs = sam_probabilities(load_adapter(args.sam), cfg, patch, args.device)
    return self_label(Path(args.vg_dir), probs, embeddings, shape=shape, split=args.split,
                      threshold=args.threshold, max_targets=args.max_targets,
                      limit=args.limit)


def cmd_compress_vl(args) -> dict:
    """``scripts/data/compress_vl.py`` (host only)."""
    from .preprocess.compress_vl import compress_dataset

    return compress_dataset(Path(args.data), Path(args.out),
                            Path(args.image_root) if args.image_root else None,
                            args.splits, args.workers)


def cmd_convert_vl(args) -> None:
    """``scripts/data/convert_vl.py`` (host only; ``--format label`` with
    ``--chexbert-ckpt`` runs CheXbert on the card)."""
    from .preprocess import convert_vl as cv

    src, out = Path(args.src), Path(args.out)
    if args.format == "vqa-json":
        cv.convert_vqa_json(
            src, out, image_field=args.image_field, question_field=args.question_field,
            answer_field=args.answer_field,
            image_dir=Path(args.image_dir) if args.image_dir else None,
            split_field=args.split_field)
    elif args.format == "mimic-cxr":
        cv.convert_mimic_cxr(
            src, out, split_csv=Path(args.split_csv),
            jpg_root=Path(args.image_dir) if args.image_dir else None,
            metadata_csv=Path(args.metadata_csv) if args.metadata_csv else None)
    elif args.format == "ct-rate":
        cv.convert_ct_rate(
            src, out, args.split,
            metadata_csv=Path(args.metadata_csv) if args.metadata_csv else None)
    elif args.format == "label":
        cv.label_reports(
            src, args.split,
            chexbert_ckpt=Path(args.chexbert_ckpt) if args.chexbert_ckpt else None)
    elif args.format == "openi":
        cv.convert_openi(src, out)
    elif args.format == "rocov2":
        cv.convert_rocov2(src, out, args.split)
    elif args.format == "pmc-oa":
        cv.convert_pmc_oa(src, out, check_image=not args.no_check_image,
                          num_val=args.num_val or 500)
    elif args.format == "radiopaedia":
        cv.convert_radiopaedia(src, out, args.json_file, train_val=args.train_val,
                               num_val=args.num_val or 250)
    elif args.format == "vqa-med":
        cv.convert_vqa_med(src, out)
    else:
        cv.convert_report_folder(src, out, args.split)


def cmd_predict_baseline(args) -> list:
    """``scripts/evaluate/cli.py predict-baseline``: a registered baseline
    VLM over the same test items as ``predict``, the same CSV contract;
    returns the rows."""
    from .eval.baselines import build_baseline

    predict = build_baseline(args.model, args.checkpoint, args.tokenizer, device=args.device)
    dataset_dir = Path(args.dataset_dir)
    if args.task == "vqa":
        items = iter_vqa_items(dataset_dir, args.limit)
    else:
        items = iter_report_items(dataset_dir, dataset_dir.name, args.limit)
    rows = []
    for item in items:
        img = Path(item["image"])
        img = img if img.is_absolute() else dataset_dir / img
        rows.append({"question": item["question"], "answer": item["answer"],
                     "prediction": predict(str(img), item["question"])})
        print(f"[{len(rows)}] {rows[-1]['prediction'][:60]!r}", flush=True)
    _write_predictions(args.output, rows)
    return rows


def cmd_finetune_baseline(args) -> list:
    """``scripts/finetune/baselines.py``: finetune a baseline HF model on a
    processed VL dataset (torch's own loop, on ``--device``); returns the
    logged losses."""
    from .train.baselines import (EXAMPLE_BUILDERS, finetune_torch_model, iter_report_items,
                                  iter_vqa_items, load_finetune_model)

    model, processor, freeze_pred = load_finetune_model(args.model, args.checkpoint,
                                                        args.processor, args.device)
    iterate = iter_report_items if args.task == "report" else iter_vqa_items
    losses = finetune_torch_model(
        model, processor, iterate(Path(args.dataset_dir), args.split),
        EXAMPLE_BUILDERS[args.model], steps=args.steps, lr=args.lr,
        grad_accum=args.grad_accum, train_all=args.train_all, freeze_pred=freeze_pred)
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    model.save_pretrained(out)
    processor.save_pretrained(out)
    (out / "finetune_losses.json").write_text(json.dumps(losses))
    print(f"saved finetuned {args.model} to {out}")
    return losses


def parse_args(argv=None) -> argparse.Namespace:
    """The command line's arguments, ``func`` set to the command's function."""
    parser = argparse.ArgumentParser(prog="mmmm_tpu_torch.cli")
    sub = parser.add_subparsers(dest="command", required=True)
    fit = sub.add_parser("fit", help="run training for a phase config")
    fit.add_argument("-c", "--config", required=True)
    fit.add_argument("--no-resume", action="store_true")
    fit.add_argument("--device", default="cuda")
    fit.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    fit.set_defaults(func=cmd_fit)
    ft = sub.add_parser("finetune", help="downstream VQA or report finetuning")
    ft.add_argument("-c", "--config", required=True)
    ft.add_argument("--dataset-dir", required=True)
    ft.add_argument("--task", choices=["vqa", "report"], default="vqa")
    ft.add_argument("--init-adapter", help="adapter.npz to warm-start from")
    ft.add_argument("--device", default="cuda")
    ft.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    ft.set_defaults(func=cmd_finetune)
    align = sub.add_parser("align-sam", help="stage-0 SAM alignment")
    align.add_argument("-c", "--config", required=True)
    align.add_argument("--instance", action="store_true")
    align.add_argument("--device", default="cuda")
    align.add_argument("overrides", nargs="*", help="dotted key=value overrides")
    align.set_defaults(func=cmd_align_sam)

    demo = sub.add_parser("demo", help="grounded report of one image")
    demo.add_argument("-c", "--config", required=True)
    demo.add_argument("--adapter")
    demo.add_argument("--image")
    demo.add_argument("--question", default="Please write a radiology report for this image.")
    demo.add_argument("--max-new-tokens", type=int, default=256)
    demo.add_argument("--grounding", action="store_true", default=True)
    demo.add_argument("--instance", action="store_true")
    demo.add_argument("--quantize", action="store_true", help="W8A16 int8 LLM weights")
    demo.add_argument("--kv-cache", default="bf16", choices=("bf16", "int8"),
                      help="KV cache dtype")
    demo.add_argument("--speculate", type=int, default=0, metavar="K",
                      help="n-gram speculative decoding with K drafts a step (0 = greedy); "
                           "the same tokens as greedy")
    demo.add_argument("--tp", type=int, default=1, metavar="N",
                      help="tensor-parallel serving over N processes, one device each "
                           "(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID): each holds 1/N "
                           "of the weights; process 0 prints")
    demo.add_argument("--interactive", action="store_true",
                      help="multi-turn: read follow-up questions from stdin")
    demo.add_argument("--device", default="cuda")
    demo.set_defaults(func=cmd_demo)

    pred = sub.add_parser("predict", help="a model's answers over a test set, to CSV")
    pred.add_argument("-c", "--config", required=True)
    pred.add_argument("--adapter")
    pred.add_argument("--quantize", action="store_true", help="W8A16 int8 LLM weights")
    pred.add_argument("--tp", type=int, default=1, metavar="N",
                      help="tensor-parallel serving over N processes, one device each "
                           "(COORDINATOR_ADDRESS, NUM_PROCESSES, PROCESS_ID): each holds 1/N "
                           "of the weights; process 0 prints and writes the CSV")
    pred.add_argument("--task", choices=["vqa", "report"], required=True)
    pred.add_argument("--dataset-dir", required=True)
    pred.add_argument("--output", required=True)
    pred.add_argument("--limit", type=int)
    pred.add_argument("--max-new-tokens", type=int, default=256)
    pred.add_argument("--batch", type=int, default=8,
                      help="rows a generate call (bucketed by image and prompt shape), or "
                           "the server's slots with --continuous")
    pred.add_argument("--speculate", type=int, default=0, metavar="K",
                      help="n-gram speculative decoding, K drafts a step (batched path)")
    pred.add_argument("--continuous", action="store_true",
                      help="slot-pool continuous batching (GroundedServer)")
    pred.add_argument("--device", default="cuda")
    pred.set_defaults(func=cmd_predict)

    ev = sub.add_parser("evaluate", help="score a predictions CSV")
    ev.add_argument("--task", choices=["vqa", "report"], default="report")
    ev.add_argument("--input", required=True)
    ev.add_argument("--suite", choices=["generic", "cxr", "ct", "all"], default="all")
    ev.add_argument("--output")
    ev.add_argument("--per-row-output", help="CSV with per-study metric columns")
    ev.add_argument("--chexbert", help="CheXbert checkpoint (.pth) for model-backed CXR labels")
    ev.add_argument("--chexbert-tokenizer", help="local bert-base-uncased tokenizer dir")
    ev.add_argument("--radbert", help="RadBertClassifier checkpoint for CT labels")
    ev.add_argument("--radbert-tokenizer", help="local RadBERT tokenizer dir")
    ev.add_argument("--bertscore-model", help="local HF encoder dir for BERTScore")
    ev.add_argument("--radcliq-dir", help="dir with normalizer.pkl + composite_metric_v{0,1}.pkl")
    ev.add_argument("--radgraph-annotations",
                    help='offline RadGraph-model annotations JSON {"hyp": [...], "ref": [...]}')
    ev.add_argument("--device", default="cuda", help="device of the model-backed scorers")
    ev.set_defaults(func=cmd_evaluate)

    dt = sub.add_parser("detector-train", help="fit the pseudo-box detector")
    dt.add_argument("--data", required=True, help="processed VinDr-CXR dir")
    dt.add_argument("--out", required=True)
    dt.add_argument("--steps", type=int, default=20000)
    dt.add_argument("--batch", type=int, default=8)
    dt.add_argument("--size", type=int, default=512)
    dt.add_argument("--layers", type=int, default=3)
    dt.add_argument("--queries", type=int, default=100)
    dt.add_argument("--lr", type=float, default=2e-4)
    dt.add_argument("--seed", type=int, default=0)
    dt.add_argument("--log-every", type=int, default=50)
    dt.add_argument("--eval-frac", type=float, default=0.1,
                    help="held-out tail fraction for the mAP@0.5 gauge")
    dt.add_argument("--device", default="cuda")
    dt.set_defaults(func=cmd_detector_train)
    di = sub.add_parser("detector-infer", help="write {stem}_box.json for tagged studies")
    di.add_argument("--ckpt", required=True)
    di.add_argument("--tags", required=True, help="tagged-report JSON")
    di.add_argument("--images", help="image root (paths in tags are relative)")
    di.add_argument("--out", required=True)
    di.add_argument("--size", type=int, default=512)
    di.add_argument("--layers", type=int, default=3)
    di.add_argument("--queries", type=int, default=100)
    di.add_argument("--score-th", type=float, default=0.1)
    di.add_argument("--device", default="cuda")
    di.set_defaults(func=cmd_detector_infer)

    se = sub.add_parser("seg-exp", help="segmentation ablation: UNet or the SAM head")
    se.add_argument("-c", "--config", help="YAML experiment config (conf/seg-exp/{unet,sam}.yaml); "
                    "flags override it")
    se.add_argument("--model", choices=["unet", "sam"])
    se.add_argument("--data", help="processed dataset dir")
    se.add_argument("--classes", nargs="+")
    se.add_argument("--steps", type=int)
    se.add_argument("--batch", type=int)
    se.add_argument("--patch", type=int, nargs=3)
    se.add_argument("--lr", type=float)
    se.add_argument("--weight-decay", type=float, dest="weight_decay")
    se.add_argument("--channels", type=int, nargs="+", help="UNet encoder channels per stage")
    se.add_argument("--val-frac", type=float, dest="val_frac")
    se.add_argument("--seed", type=int)
    se.add_argument("--out", help="JSON results path")
    se.add_argument("--log-every", type=int, dest="log_every")
    se.add_argument("--device", default="cuda")
    se.set_defaults(func=cmd_seg_exp)

    pr = sub.add_parser("process", help="offline dataset processing (host only)")
    pr.add_argument("--layout", choices=["nnunet", "segfolder", "boxfolder"])
    pr.add_argument("--dataset", help="named recipe from preprocess.registry (e.g. AMOS22)")
    pr.add_argument("--src", required=True)
    pr.add_argument("--out", required=True)
    pr.add_argument("--name")
    pr.add_argument("--modality", default="CT")
    pr.add_argument("--limit", type=int)
    pr.add_argument("--max-smaller-edge", type=int, default=512)
    pr.set_defaults(func=cmd_process)

    def llm_options(p):
        p.add_argument("--params", help="LM params .npz (save_params of the CogVLM tree)")
        p.add_argument("--config", help="CogVLMConfig yaml/json for --params")
        p.add_argument("--tokenizer", help="tokenizer path for --params")
        p.add_argument("--max-new-tokens", type=int, default=1024)
        p.add_argument("--continuous", action="store_true",
                       help="slot-pool continuous batching (mid-flight refill, "
                            "automatic template prefix caching)")
        p.add_argument("--speculate", type=int, default=0,
                       help="n-gram speculative draft length (continuous only)")
        p.add_argument("--device", default="cuda", help="the LLM's device")

    cr = sub.add_parser("clean-reports", help="clean reports through the LLM or the rules")
    cr.add_argument("--dir", required=True, help="processed VL dataset dir")
    cr.add_argument("--dataset", required=True,
                    help="MIMIC-CXR | CT-RATE | OpenI | ROCOv2 | <other>")
    cr.add_argument("--split", default="train")
    cr.add_argument("--rule-based", action="store_true",
                    help="deterministic regex cleaner instead of an LLM")
    llm_options(cr)
    cr.set_defaults(func=cmd_clean_reports)
    tr = sub.add_parser("tag-reports", help="<p> phrase tags into a visual-grounding dataset")
    tr.add_argument("--dir", required=True, help="processed VL dataset dir")
    tr.add_argument("--split", default="train")
    tr.add_argument("--out", required=True, help="visual-grounding output dir")
    tr.add_argument("--taxonomy-only", action="store_true")
    llm_options(tr)
    tr.set_defaults(func=cmd_tag_reports)

    sl = sub.add_parser("self-label", help="pseudo-masks of tagged targets through SAM")
    sl.add_argument("--vg-dir", required=True)
    sl.add_argument("--split", default="train")
    sl.add_argument("--sam", required=True, help="sam params npz (align-sam output)")
    sl.add_argument("--embeddings", required=True,
                    help="npz: class name -> (C,) prompt embedding")
    sl.add_argument("--threshold", type=float, default=0.5)
    sl.add_argument("--max-targets", type=int, default=8)
    sl.add_argument("--patch-size", type=int, nargs=3, default=[8, 16, 16])
    sl.add_argument("--grid", type=int, nargs=3, default=[4, 16, 16],
                    help="token grid; input resized to grid*patch*pool")
    sl.add_argument("--sam-config", help="yaml with SamConfig fields (default: flagship)")
    sl.add_argument("--limit", type=int)
    sl.add_argument("--device", default="cuda")
    sl.set_defaults(func=cmd_self_label)

    cv = sub.add_parser("compress-vl", help="crop-resize VL images into .pt.zst (host only)")
    cv.add_argument("--data", required=True, help="dir holding {split}.json")
    cv.add_argument("--out", required=True)
    cv.add_argument("--image-root", help="root for relative image paths")
    cv.add_argument("--splits", nargs="+", default=["train", "validate", "test"])
    cv.add_argument("--workers", type=int, default=4)
    cv.set_defaults(func=cmd_compress_vl)

    co = sub.add_parser("convert-vl", help="raw VQA / report datasets into processed JSON "
                        "(host only)")
    co.add_argument("--format", required=True,
                    choices=["vqa-json", "report-folder", "mimic-cxr", "ct-rate", "label",
                             "openi", "rocov2", "pmc-oa", "radiopaedia", "vqa-med"])
    co.add_argument("--json-file", default="radiology_article_npy_train.json",
                    help="radiopaedia: RadFM csv json under --src")
    co.add_argument("--train-val", action="store_true",
                    help="radiopaedia: split train/validate instead of test")
    co.add_argument("--no-check-image", action="store_true",
                    help="pmc-oa: skip the per-image decode check")
    co.add_argument("--num-val", type=int, default=None,
                    help="pmc-oa/radiopaedia: validate-set size override")
    co.add_argument("--chexbert-ckpt", help="CheXbert checkpoint for --format label")
    co.add_argument("--src", required=True)
    co.add_argument("--out", required=True, help="output dataset dir")
    co.add_argument("--image-field", default="image_name")
    co.add_argument("--question-field", default="question")
    co.add_argument("--answer-field", default="answer")
    co.add_argument("--split-field", default=None)
    co.add_argument("--image-dir", default=None)
    co.add_argument("--split", default="train")
    co.add_argument("--split-csv", help="mimic-cxr-2.0.0-split.csv")
    co.add_argument("--metadata-csv", help="mimic-cxr-2.0.0-metadata.csv (planes)")
    co.set_defaults(func=cmd_convert_vl)

    pb = sub.add_parser("predict-baseline", help="a baseline VLM's answers over a test set")
    pb.add_argument("--model", required=True,
                    help="registry name: mmmm|cogvlm|instructblip|llavanext|llavamed|m3d|"
                         "radfm|r2gengpt")
    pb.add_argument("--checkpoint", required=True,
                    help="local checkpoint dir (mmmm: its config file)")
    pb.add_argument("--tokenizer", help="local tokenizer/processor dir (default: checkpoint)")
    pb.add_argument("--task", choices=["vqa", "report"], required=True)
    pb.add_argument("--dataset-dir", required=True)
    pb.add_argument("--output", required=True)
    pb.add_argument("--limit", type=int)
    pb.add_argument("--device", default="cuda")
    pb.set_defaults(func=cmd_predict_baseline)

    fb = sub.add_parser("finetune-baseline", help="finetune a baseline HF model")
    fb.add_argument("--model", required=True,
                    choices=["cogvlm", "instructblip", "llavamed", "llavanext", "m3d"])
    fb.add_argument("--checkpoint", required=True, help="local HF model dir")
    fb.add_argument("--processor", help="local HF processor dir (default: checkpoint)")
    fb.add_argument("--dataset-dir", required=True)
    fb.add_argument("--task", choices=["vqa", "report"], default="vqa")
    fb.add_argument("--split", default="train")
    fb.add_argument("--out", required=True)
    fb.add_argument("--steps", type=int, default=1000)
    fb.add_argument("--lr", type=float, default=2e-5)
    fb.add_argument("--grad-accum", type=int, default=8)
    fb.add_argument("--train-all", action="store_true")
    fb.add_argument("--device", default="cuda")
    fb.set_defaults(func=cmd_finetune_baseline)
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
