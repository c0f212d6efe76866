#!/usr/bin/env python3
"""Time the int8-cache decode reads K9 and K10 of one or more checkouts of
the port on one NVIDIA GPU, in turns, to compare two versions on one card:

    python3 time_q8_reads.py ROOT [ROOT ...]

Each ROOT (a directory that holds ``mmmm_tpu_torch``) runs in a process of
its own, in the order given (for two versions A and B: A B B A). It builds
that checkout's kernels and times K9 and K10 at the flagship's decode shape
(H = 32, D = 128, Smax 320) at kv_len 193, 256 and 320 with B = 4 and at
kv_len 256 with B = 1, as ``chip_smoke.py`` phase 3 times them
(``chip_smoke.time_ms``: CUDA events, median of 7 runs of 10 calls behind a
sleep kernel; 8 caches in turn, so a call finds its cache outside L2). The
inputs come from seed 0 and are the same for every root. Prints the card's
name and power limit, one JSON line a root, and a table of the times.
"""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

H, D, SMAX = 32, 128, cs.PROMPT + cs.NEW
CASES = ((cs.B, cs.PROMPT + 1), (cs.B, 256), (cs.B, cs.PROMPT + cs.NEW), (1, 256))


def worker(root: Path) -> dict:
    sys.path.insert(0, str(root))
    from mmmm_tpu_torch.ops import _cuda
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops.quant import quantize_kv

    if not Path(dk.__file__).resolve().is_relative_to(root):
        raise RuntimeError(f"imported {dk.__file__}, not the port under {root}")
    _cuda.library()
    gen = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    rows = []
    for b, n in CASES:
        caches = []
        for _ in range(8):
            kq, ks = quantize_kv(rnd(b, H, SMAX, D))
            vq, vs = quantize_kv(rnd(b, H, SMAX, D))
            caches.append((kq, ks, vq, vs))
        rot = cs.Rotating(caches)
        q = rnd(b, 1, H, D)
        lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
        for kid, fn, plain in (
                ("K9", dk.decode_attention_q8, dk.decode_attention_q8_plain),
                ("K10", dk.decode_attention_q8_mxu, dk.decode_attention_q8_mxu_plain)):
            err = cs.max_err(fn(q, *caches[0], lens), plain(q, *caches[0], lens))
            if not err <= 2e-2:
                raise AssertionError(f"{kid} under {root}: max_abs_err {err}")
            rows.append({"kernel": kid, "b": b, "kv_len": n, "max_abs_err": err,
                         "ms": cs.time_ms(lambda: fn(q, *rot.next(), lens))})
    return {"root": str(root), "rows": rows}


def main() -> int:
    if len(sys.argv) > 2 and sys.argv[1] == "--worker":
        print(json.dumps(worker(Path(sys.argv[2]).resolve())), flush=True)
        return 0
    if len(sys.argv) < 2 or not torch.cuda.is_available():
        print(__doc__, file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    runs = []
    for root in sys.argv[1:]:
        p = subprocess.run([sys.executable, __file__, "--worker", root], capture_output=True,
                           text=True, check=True)
        runs.append(json.loads(p.stdout.strip().splitlines()[-1]))
        print(json.dumps(runs[-1]), flush=True)
    print("kernel  B  kv_len  " + "  ".join(f"{i}:{Path(r['root']).name or '.'}"
                                            for i, r in enumerate(runs)))
    for i, row in enumerate(runs[0]["rows"]):
        print(f"{row['kernel']:6s} {row['b']:2d} {row['kv_len']:6d}  "
              + "  ".join(f"{r['rows'][i]['ms']:.4f}" for r in runs), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
