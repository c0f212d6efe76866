#!/usr/bin/env python3
"""Time the decode reads K1, K9, K10 and K6, and the decode steps built on
them, of one or more checkouts of the port on one NVIDIA GPU, in turns, to
compare two versions on one card:

    python3 time_decode_reads.py ROOT [ROOT ...]

Each ROOT (a directory that holds ``mmmm_tpu_torch``) runs in a process of
its own, in the order given (for two versions A and B: A B B A). It builds
that checkout's kernels and times each read at the flagship's decode shape
(H = 32, D = 128, Smax 320; K6 over run (b)'s Smax 328 with a window of 8
at write index kv_len - 1) at kv_len 193, 256 and 320 with B = 4 and at
kv_len 256 with B = 1, as ``chip_smoke.py`` phase 3 times them
(``chip_smoke.time_ms``: CUDA events, median of 7 runs of 10 calls behind a
sleep kernel; 8 caches in turn, so a call finds its cache outside L2). K1
and K6 are bf16 over a bf16 cache; K9 and K10 read an int8 cache. Beside
the reads, each decode step with its append (write index kv_len - 1, new
rows that are views of one fused projection) twice: ``*step``, as that
checkout's decoder runs it (the fused forms K1append, K9append, K10append
and K6append where it has them, else the appends and the read in
sequence), and ``*seq``, the sequence (K2 then K1; ``quantize_kv`` twice, K8
then K9 or K10; K5 then K6). The inputs come from seed 0 and are the same
for every root, so each row's ``digest`` (a hash of the output on the first
cache) shows whether two checkouts, or a fused form and its sequence, give
the same bits. Prints the card's name and power limit, one JSON line a
root, and a table of the times and digests.
"""
from __future__ import annotations

import hashlib
import json
import subprocess
import sys
from pathlib import Path

import torch

import chip_smoke as cs

H, D, SMAX, WINDOW = 32, 128, cs.PROMPT + cs.NEW, cs.WINDOW
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
    k1_fused = getattr(dk, "decode_attention_append", None)
    q8_fused = getattr(dk, "decode_attention_q8_append", None)
    win_fused = getattr(dk, "decode_attention_window_append", None)
    leaves = lambda c: dict(zip(dk.Q8_LEAVES, c))
    rows = []
    for b, n in CASES:
        bf16 = [(rnd(b, H, SMAX, D), rnd(b, H, SMAX, D)) for _ in range(8)]
        q8 = []
        for kc, vc in bf16:
            q8.append((*quantize_kv(kc), *quantize_kv(vc)))
        win = [(rnd(b, H, SMAX + WINDOW, D), rnd(b, H, SMAX + WINDOW, D)) for _ in range(8)]
        q = rnd(b, 1, H, D)
        qkv = rnd(b, 1, 3 * H, D)  # this step's projection: new K and V rows are views of it
        kn, vn = qkv[:, :, H:2 * H], qkv[:, :, 2 * H:]
        kt, vt = kn.transpose(1, 2).contiguous(), vn.transpose(1, 2).contiguous()
        qw = rnd(b, WINDOW, H, D)
        wkv = rnd(b, WINDOW, 3 * H, D)
        wk, wv = wkv[:, :, H:2 * H], wkv[:, :, 2 * H:]
        wkt, wvt = wk.transpose(1, 2).contiguous(), wv.transpose(1, 2).contiguous()
        lens = torch.full((b,), n, dtype=torch.int32, device="cuda")
        widx = lens - 1

        def k1_seq(q, kc, vc, n):
            dk.kv_append(kc, vc, kt, vt, widx)
            return dk.decode_attention(q, kc, vc, n)

        def q8_seq(mxu):
            def run(q, kq, ks, vq, vs, n):
                dk.kv_append_q8(leaves((kq, ks, vq, vs)), *quantize_kv(kn.transpose(1, 2)),
                                *quantize_kv(vn.transpose(1, 2)), widx)
                return dk.decode_attention_q8(q, kq, ks, vq, vs, n, q8_mxu=mxu)
            return run

        def q8_plain(mxu):
            read = dk.decode_attention_q8_mxu_plain if mxu else dk.decode_attention_q8_plain

            def run(q, kq, ks, vq, vs, n):
                c = {k: t.clone() for k, t in leaves((kq, ks, vq, vs)).items()}
                dk.kv_append_q8_plain(c, *quantize_kv(kn.transpose(1, 2)),
                                      *quantize_kv(vn.transpose(1, 2)), widx)
                return read(q, *(c[k] for k in dk.Q8_LEAVES), n)
            return run

        def q8_step(mxu):
            if q8_fused is None:
                return q8_seq(mxu)
            return lambda q, kq, ks, vq, vs, n: q8_fused(q, leaves((kq, ks, vq, vs)), kn, vn,
                                                         widx, n, q8_mxu=mxu)

        def k6_seq(q, kc, vc, n):
            dk.kv_append_multi(kc, vc, wkt, wvt, widx)
            return dk.decode_attention_window(q, kc, vc, widx)

        def k6_plain(q, kc, vc, n):
            kc, vc = dk.kv_append_plain(kc.clone(), vc.clone(), wkt, wvt, widx)
            return dk.decode_attention_window_plain(q, kc, vc, widx)

        k6_step = k6_seq if win_fused is None else (
            lambda q, kc, vc, n: win_fused(q, kc, vc, wk, wv, widx))
        k1_step = k1_seq if k1_fused is None else (
            lambda q, kc, vc, n: k1_fused(q, kc, vc, kt, vt, widx, n))
        k1_plain = lambda q, kc, vc, n: dk.decode_attention_plain(
            q, *dk.kv_append_plain(kc.clone(), vc.clone(), kt, vt, widx), n)
        reads = [("K1", q, bf16, dk.decode_attention, dk.decode_attention_plain),
                 ("K1step", q, bf16, k1_step, k1_plain), ("K1seq", q, bf16, k1_seq, k1_plain),
                 ("K9", q, q8, dk.decode_attention_q8, dk.decode_attention_q8_plain),
                 ("K9step", q, q8, q8_step(False), q8_plain(False)),
                 ("K9seq", q, q8, q8_seq(False), q8_plain(False)),
                 ("K10", q, q8, dk.decode_attention_q8_mxu, dk.decode_attention_q8_mxu_plain),
                 ("K10step", q, q8, q8_step(True), q8_plain(True)),
                 ("K10seq", q, q8, q8_seq(True), q8_plain(True)),
                 ("K6", qw, win, lambda q, kc, vc, n: dk.decode_attention_window(q, kc, vc, widx),
                  lambda q, kc, vc, n: dk.decode_attention_window_plain(q, kc, vc, widx)),
                 ("K6step", qw, win, k6_step, k6_plain), ("K6seq", qw, win, k6_seq, k6_plain)]
        for kid, qq, caches, fn, plain in reads:
            first = tuple(c.clone() for c in caches[0])
            got = fn(qq, *first, lens)
            err = cs.max_err(got, plain(qq, *caches[0], lens))
            if not err <= 2e-2:
                raise AssertionError(f"{kid} under {root}: max_abs_err {err}")
            rot = cs.Rotating(caches)
            rows.append({"kernel": kid, "b": b, "kv_len": n, "max_abs_err": err,
                         "digest": digest(got),
                         "ms": cs.time_ms(lambda: fn(qq, *rot.next(), lens))})
        del bf16, q8, win
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
