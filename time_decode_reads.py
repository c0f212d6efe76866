#!/usr/bin/env python3
"""Time the decode reads K1 (and its fused append form, where the checkout
has it), K9 and K10 of one or more checkouts of the port on one NVIDIA GPU,
in turns, to compare two versions on one card:

    python3 time_decode_reads.py ROOT [ROOT ...]

Each ROOT (a directory that holds ``mmmm_tpu_torch``) runs in a process of
its own, in the order given (for two versions A and B: A B B A). It builds
that checkout's kernels and times each read at the flagship's decode shape
(H = 32, D = 128, Smax 320) at kv_len 193, 256 and 320 with B = 4 and at
kv_len 256 with B = 1, as ``chip_smoke.py`` phase 3 times them
(``chip_smoke.time_ms``: CUDA events, median of 7 runs of 10 calls behind a
sleep kernel; 8 caches in turn, so a call finds its cache outside L2). K1 is
bf16 over a bf16 cache; K9 and K10 read an int8 cache. The inputs come from
seed 0 and are the same for every root, so each row's ``digest`` (a hash of
the output on the first cache) shows whether two checkouts give the same
bits. Prints the card's name and power limit, one JSON line a root, and a
table of the times and digests.
"""
from __future__ import annotations

import hashlib
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
    digest = lambda t: hashlib.sha256(t.cpu().view(torch.uint8).numpy().tobytes()).hexdigest()[:12]
    fused = getattr(dk, "decode_attention_append", None)
    rows = []
    for b, n in CASES:
        bf16 = [(rnd(b, H, SMAX, D), rnd(b, H, SMAX, D)) for _ in range(8)]
        q8 = []
        for kc, vc in bf16:
            q8.append((*quantize_kv(kc), *quantize_kv(vc)))
        q = rnd(b, 1, H, D)
        kn, vn = rnd(b, H, 1, D), rnd(b, H, 1, D)
        lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
        widx = lens - 1
        reads = [("K1", bf16, dk.decode_attention, dk.decode_attention_plain),
                 ("K9", q8, dk.decode_attention_q8, dk.decode_attention_q8_plain),
                 ("K10", q8, dk.decode_attention_q8_mxu, dk.decode_attention_q8_mxu_plain)]
        if fused is not None:
            reads.insert(1, ("K1append", bf16,
                             lambda q, kc, vc, n: fused(q, kc, vc, kn, vn, widx, n),
                             lambda q, kc, vc, n: dk.decode_attention_append_plain(
                                 q, kc.clone(), vc.clone(), kn, vn, widx, n)))
        for kid, caches, fn, plain in reads:
            first = tuple(c.clone() for c in caches[0])
            got = fn(q, *first, lens)
            err = cs.max_err(got, plain(q, *caches[0], lens))
            if not err <= 2e-2:
                raise AssertionError(f"{kid} under {root}: max_abs_err {err}")
            rot = cs.Rotating(caches)
            rows.append({"kernel": kid, "b": b, "kv_len": n, "max_abs_err": err,
                         "digest": digest(got), "ms": cs.time_ms(lambda: fn(q, *rot.next(), lens))})
        del bf16, q8
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
    print("kernel    B  kv_len  " + "  ".join(f"{i}:{Path(r['root']).name or '.'}"
                                              for i, r in enumerate(runs)))
    keys = []
    for r in runs:
        keys += [(x["kernel"], x["b"], x["kv_len"]) for x in r["rows"]
                 if (x["kernel"], x["b"], x["kv_len"]) not in keys]
    for key in keys:
        cells = []
        for r in runs:
            x = next((x for x in r["rows"] if (x["kernel"], x["b"], x["kv_len"]) == key), None)
            cells.append("-" if x is None else f"{x['ms']:.4f} {x['digest']}")
        print(f"{key[0]:9s} {key[1]:2d} {key[2]:6d}  " + "  ".join(cells), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
