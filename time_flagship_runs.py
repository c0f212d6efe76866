#!/usr/bin/env python3
"""Run the flagship's serving runs (a)-(d) of one or more checkouts of the
port on one NVIDIA GPU, in turns, to compare two versions on one card:

    python3 time_flagship_runs.py [--out DIR] ROOT [ROOT ...]

Each ROOT (a directory that holds ``mmmm_tpu_torch``) runs in a process of
its own, in the order given (for two versions A and B: A B B A). The process
imports that checkout's package and this checkout's ``chip_smoke.py``, and
runs ``chip_smoke.flagship_phase`` without its launch expectations (another
version launches other kernels): for each run a warm-up, the steady run
(host clock to a synchronise) with the kernels' launch counters, and one
profiled run (``chip_smoke.profile_run``: by stage ``vit``, ``llm_prefill``,
``decode`` and ``sam``, the host time, the device span, the kernel time and
the device launches). The model and inputs come from seed 0 and are the same
for every root. Prints the card's name and power limit, one line a root, and
a table: for each run and root the steady batch, the device's busy share,
the device launches of the profiled batch, and the ``decode`` span's host
ms, kernel ms and launches. With ``--out`` each root's log goes to
``DIR/<i>.txt`` and its whole result to ``DIR/<i>.json`` (i from 1).
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from mmmm_tpu_torch.ops import _cuda

    if not Path(_cuda.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {_cuda.__file__}, not the port under {root}")
    torch.backends.cuda.matmul.allow_tf32 = False  # as chip_smoke.py runs them
    torch.backends.cudnn.allow_tf32 = False
    _cuda.library()
    out, _ = cs.flagship_phase(torch.Generator(device="cuda").manual_seed(0), expect=False)
    return {"root": str(root), **out}


def summary(run: dict) -> dict:
    prof = run["profile"]
    decode = prof["stages"]["decode"]
    return {"steady_s": run["steady_run_s"], "busy": run["busy_share_steady"],
            "launches": sum(g["launches"] for g in prof["groups"].values()),
            "decode_host_ms": decode["host_ms"], "decode_kernels_ms": decode["kernels_ms"],
            "decode_launches": decode["launches"], "counters": {
                k: n for k, n in run["launches"].items() if n}}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", type=Path, default=None)
    ap.add_argument("roots", nargs="+")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    if args.out is not None:
        args.out.mkdir(parents=True, exist_ok=True)
    results = []
    for i, root in enumerate(args.roots, 1):
        p = subprocess.run([sys.executable, __file__, "--worker", root], capture_output=True,
                           text=True, check=False)
        if args.out is not None:
            (args.out / f"{i}.txt").write_text(p.stdout + p.stderr)
        if p.returncode != 0:
            print(p.stdout[-4000:] + p.stderr[-4000:], file=sys.stderr)
            raise RuntimeError(f"root {root}: exit code {p.returncode}")
        res = json.loads(p.stdout.strip().splitlines()[-1])
        if args.out is not None:
            (args.out / f"{i}.json").write_text(json.dumps(res, indent=1))
        short = {label: summary(r) for label, r in res["runs"].items()}
        results.append((root, short))
        print(json.dumps({"root": root, "runs": short}), flush=True)
    print("run                 root  steady s  busy    launches  decode host ms  "
          "decode kernels ms  decode launches")
    for label in cs.RUNS:
        for i, (root, short) in enumerate(results, 1):
            r = short[label]
            print(f"{label:18s} {i}:{Path(root).name or '.':4s} {r['steady_s']:8.3f}  "
                  f"{r['busy']:.4f} {r['launches']:10d}  {r['decode_host_ms']:14.3f}  "
                  f"{r['decode_kernels_ms']:17.3f}  {r['decode_launches']:15d}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
