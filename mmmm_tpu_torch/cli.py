"""Command-line entry points of the port, the counterparts of the JAX
package's ``scripts/cli.py fit`` and ``scripts/align_sam.py``:

    python -m mmmm_tpu_torch.cli fit -c conf/<phase>/fit.yaml [--no-resume] [--device cpu] [k=v ...]
    python -m mmmm_tpu_torch.cli align-sam -c conf/align-sam/fit.yaml [--instance] [--device cpu] [k=v ...]

The same YAML configs, dotted ``k=v`` overrides (applied before ``${...}``
interpolation) and builders. Both run on the card unless ``--device cpu``.
``fit`` needs ``trainer.mesh_*`` at 1 (one device); ``align-sam`` writes
``metrics.jsonl`` and ``sam_aligned.npz`` (the SAM tree, in the JAX
package's adapter layout) under ``trainer.out_dir``.
"""
from __future__ import annotations

import argparse
import json
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


def main(argv=None):
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
    args = parser.parse_args(argv)
    args.func(args)


if __name__ == "__main__":
    main()
