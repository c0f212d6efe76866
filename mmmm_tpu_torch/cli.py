"""Command-line entry points of the port, the counterparts of the JAX
package's ``scripts/cli.py fit``, ``scripts/align_sam.py``,
``scripts/demo.py`` and ``scripts/evaluate/cli.py predict`` / ``evaluate``:

    python -m mmmm_tpu_torch.cli fit -c conf/<phase>/fit.yaml [--no-resume] [--device cpu] [k=v ...]
    python -m mmmm_tpu_torch.cli align-sam -c conf/align-sam/fit.yaml [--instance] [--device cpu] [k=v ...]
    python -m mmmm_tpu_torch.cli demo -c conf/tiny/fit.yaml [--image path] [--adapter adapter.npz]
        [--question ...] [--max-new-tokens N] [--instance] [--quantize] [--kv-cache int8]
        [--speculate K] [--interactive] [--device cpu]
    python -m mmmm_tpu_torch.cli predict -c conf/tiny/fit.yaml --task vqa|report
        --dataset-dir DIR --output pred.csv [--batch N] [--continuous] [--device cpu] ...
    python -m mmmm_tpu_torch.cli evaluate --input pred.csv [--suite generic|cxr|ct|all] ...

The same YAML configs, dotted ``k=v`` overrides (applied before ``${...}``
interpolation) and builders. Every command runs on the card unless
``--device cpu``. ``fit`` needs ``trainer.mesh_*`` at 1 (one device);
``align-sam`` writes ``metrics.jsonl`` and ``sam_aligned.npz`` (the SAM
tree, in the JAX package's adapter layout) under ``trainer.out_dir``.
``demo`` prints the report of one image (a synthetic one without
``--image``) with its grounded targets; ``predict`` writes a model's
answers over a VQA or report test set to a CSV, batched or through
``GroundedServer`` (``--continuous``); ``evaluate`` scores such a CSV.
``demo`` and ``predict`` take the commands' functions ``cmd_demo`` and
``cmd_predict`` a model already loaded (``loaded=``), as ``load_model``
returns it.
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


def _no_tp(n: int) -> None:
    if n != 1:
        raise NotImplementedError(
            f"--tp {n}: tensor-parallel serving is not ported yet (ROADMAP.md Queue 1, "
            "item 8, parallelism); the port serves on one card")


def cmd_demo(args, loaded=None) -> list:
    """Grounded generation on one image, then (``--interactive``) on each
    follow-up question read from stdin; prints each report, its grounded
    targets and their mask voxels or boxes. Returns each turn's
    ``GroundedResult``."""
    from .data import ConvTurn
    from .data.input_builder import prepare_vlm_inputs
    from .models.inference import generate_grounded

    _no_tp(args.tp)
    model, params, tokenizer, cfg = loaded or load_model(args.config, args.adapter,
                                                         args.quantize, args.device)
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
        print("=== generated ===")
        print(res.text[0])
        print("=== grounded targets ===")
        print(res.targets[0])
        valid = res.target_valid
        if res.masks is not None and valid is not None and valid.any():
            probs = torch.sigmoid(res.masks[0].float())
            for i in range(int(valid[0].sum())):
                print(f"target {i}: mask voxels>0.5 = {int((probs[i] > 0.5).sum())}")
        if res.boxes is not None and valid is not None and valid.any():
            disc = torch.sigmoid(res.disc_logit[0]).cpu().numpy()
            boxes = res.boxes[0].cpu().numpy()
            for i in range(int(valid[0].sum())):
                best = int(np.argmax(disc[i]))
                print(f"target {i}: best instance p={disc[i, best]:.3f} "
                      f"box={np.round(boxes[i, best], 3)}")
        return res.text[0]

    conversation = [ConvTurn(args.question, "")]
    answer = run_turn(conversation)
    if args.interactive:
        print("(enter follow-up questions; empty line to quit)")
        for line in sys.stdin:
            q = line.strip()
            if not q:
                break
            conversation = conversation[:-1] + [ConvTurn(conversation[-1].prompt, answer),
                                                ConvTurn(q, "")]
            answer = run_turn(conversation)
    return results


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

    _no_tp(args.tp)
    model, params, tokenizer, cfg = loaded or load_model(args.config, args.adapter,
                                                         args.quantize, args.device)
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
                      help="tensor-parallel serving over N devices (not ported: 1 only)")
    demo.add_argument("--interactive", action="store_true",
                      help="multi-turn: read follow-up questions from stdin")
    demo.add_argument("--device", default="cuda")
    demo.set_defaults(func=cmd_demo)

    pred = sub.add_parser("predict", help="a model's answers over a test set, to CSV")
    pred.add_argument("-c", "--config", required=True)
    pred.add_argument("--adapter")
    pred.add_argument("--quantize", action="store_true", help="W8A16 int8 LLM weights")
    pred.add_argument("--tp", type=int, default=1, metavar="N",
                      help="tensor-parallel serving over N devices (not ported: 1 only)")
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
    return parser.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
