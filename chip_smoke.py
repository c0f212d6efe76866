#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mmmm_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py [--log-dir DIR]

Phases, in order; any failure exits non-zero before the result lines:

 1. print the card's name and power limit (``nvidia-smi``);
 2. build the CUDA kernels from ``mmmm_tpu_torch/csrc`` (``nvcc``, sm_90a)
    and print the registers, shared memory and spill bytes of every K11mma
    and K7 kernel (failing if one spills);
 3. hold each kernel (K1-K11, K7delta, K12 = K4's kernel, probe P1) against
    its plain PyTorch version on the card, at the grounded path's and the
    training step's shapes and at edge cases (K11mma at every row count
    W4A16 serving passes, and both of its tile widths timed at the
    prefill's shapes; K7 at every head dim it serves over a ragged S, and
    twice at the LLM site, bit for bit), and time the kernel, the plain
    version and one PyTorch library call (CUDA events, medians); time
    the W8A16, W8A8 and W4A16 ``qdot`` against a bf16 ``torch.matmul`` at
    decode rows;
 4. run ``generate_grounded`` on the card and on the CPU (plain versions)
    and require the same tokens, masks, boxes and presence logits: at
    ``MMMMConfig.tiny()`` in fp32 greedy and n-gram speculative, bf16 and
    int8 KV, plain, W8A16 and W8A8 (decode, prefill) weights, chunked
    prefill in both modes; at the W4-capable small widths W4A16 with the
    split-int8 read, instance SAM and chunked prefill;
 5. run the grounded report path at the flagship width (CogVLM-17B +
    SegVol SAM, bf16 LLM/ViT, fp32 SAM, random weights from a seed): B=4,
    prompt 192 with 146 vision tokens, 128 new tokens, 4 targets, as four
    runs: (a) greedy, bf16 weights and KV cache; then, with the LLM
    quantized in place to W8A16, (b) speculative with 7 drafts and a bf16
    KV cache (the reference bench's default decode) and (c) greedy with an
    int8 KV cache; then, with the LLM made again from the seed and
    quantized to W4A16, (d) capacity serving: greedy over an int8 KV cache
    read by the split-int8 kernel, prefill in chunks of 2, instance SAM.
    Each is warmed up once, then run with every launch counter at 0 and
    checked for its outputs and its exact launch counts, then profiled
    (device time by kernel group and by stage, busy share);
 6. the LoRA training step (``make_train_step``, ``attn_impl="pallas"``:
    K3 forward, K7delta, K7dq and K7dkv backward at every flash site) at the
    tiny config in fp32, 3 steps in each grounding mode, on the card and the
    CPU, held to the CPU tests' tolerances; then at the flagship's full
    width and depth (frozen bf16 CogVLM, LoRA r=64, ``remat=True``): B=4,
    S=1024 with 146 vision tokens from an fp32 image (the ViT in fp32), 4
    grounding targets, 3 steps in each ``vg_mode`` with exact launch
    counts per step, the third profiled by stage (vit, llm_forward, ce,
    sam_loss, backward, optimizer), peak memory; and one ``"xla"`` step
    from the semantic state before step 3, whose loss and gradient norm
    must agree; then, at full width and 8 LLM and ViT layers and
    over four seeds, the gradients of the ``"pallas"`` and ``"xla"`` routes
    held to each other in fp32, and each route's bf16 gradients measured
    against fp32, the kernels' route held to the plain route's distance;
 7. print the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

``--log-dir`` keeps the build log and the results as JSON there.
No JAX and nothing of ``mmmm_tpu`` is imported.
"""
from __future__ import annotations

import argparse
import bisect
import gc
import json
import re
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

# Data-sheet peaks (dense): HBM bytes/s, bf16 tensor FLOP/s, fp32 CUDA-core
# FLOP/s, int8 tensor OP/s.
PEAKS = {
    "H100 SXM": (3.35e12, 989e12, 67e12, 1979e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
    "H100 NVL": (3.9e12, 835e12, 60e12, 1671e12),
}
B, PROMPT, N_VIS, NEW, TARGETS = 4, 192, 146, 128, 4
# the training step's flash sites at the flagship: (B, S, H, D, dtype, causal);
# the ViT runs in fp32 over an fp32 image (scripts/bench_train.py's batch, the
# data loaders') and in bf16 over a bf16 one
TRAIN_SITES = {"llm": (4, 1024, 32, 128, torch.bfloat16, True),
               "vit": (4, 577, 16, 112, torch.bfloat16, False),
               "vit_fp32": (4, 577, 16, 112, torch.float32, False),
               "sam": (4, 512, 12, 64, torch.float32, False)}
TRAIN_SEQ, TRAIN_STEPS, LMAX = 1024, 3, 6
DRAFT = 7  # the reference bench's spec default: verify windows of 8
WINDOW = DRAFT + 1
LAYERS = 32
VIT_LAYERS, SAM_LAYERS = 63, 12
CHUNK = 2  # run (d)'s prefill chunk: 2 chunks of 2 samples
# run (d)'s int4 products a layer: 5 projections (qkv, dense, gate, up, down)
# per routed span; prefill spans of a chunk: 2 x 1 language rows (GEMV),
# 2 x 145 vision and 2 x 46 language rows (tensor-core tiles); decode: 4 rows
W4_GEMV = LAYERS * 5 * (B // CHUNK) + LAYERS * 5 * NEW
W4_MMA = LAYERS * 10 * (B // CHUNK)
# flagship launches per run; "iters" is scaled by the run's verify steps
RUNS = {
    "a_greedy_bf16": dict(kw={}, launches={"K4": 63 + 12, "K3": LAYERS, "K2": LAYERS * NEW,
                                           "K1": LAYERS * NEW}),
    "b_spec7_w8a16": dict(kw=dict(spec_draft_len=DRAFT),
                          launches={"K4": 63 + 12, "K3": LAYERS, "K5": "iters", "K6": "iters"}),
    "c_int8kv_w8a16": dict(kw=dict(kv_cache_dtype="int8"),
                           launches={"K4": 63 + 12, "K3": LAYERS, "K8": LAYERS * NEW,
                                     "K9": LAYERS * NEW}),
    # chunking runs the ViT, the LLM prefill and the SAM encoder once a chunk
    "d_w4_q8mxu_chunk2": dict(kw=dict(kv_cache_dtype="int8", q8_mxu=True, prefill_chunk=CHUNK,
                                      instance=True),
                              launches={"K4": (VIT_LAYERS + SAM_LAYERS) * (B // CHUNK),
                                        "K3": LAYERS * (B // CHUNK), "K8": LAYERS * NEW,
                                        "K10": LAYERS * NEW, "K11": W4_GEMV, "K11mma": W4_MMA}),
}
# kernel -> (run whose launch count it reports, the counter it reads); K12 is
# K4's kernel; P1 is a probe that no run launches; a train_* run is one
# steady training step
KERNEL_RUN = {"K1": "a_greedy_bf16", "K2": "a_greedy_bf16", "K3": "a_greedy_bf16",
              "K4": "a_greedy_bf16", "K5": "b_spec7_w8a16", "K6": "b_spec7_w8a16",
              "K7dq": "train_semantic", "K7dkv": "train_semantic", "K7delta": "train_semantic",
              "K8": "c_int8kv_w8a16", "K9": "c_int8kv_w8a16", "K10": "d_w4_q8mxu_chunk2",
              "K11": "d_w4_q8mxu_chunk2", "K11mma": "d_w4_q8mxu_chunk2",
              "K12": "d_w4_q8mxu_chunk2", "P1": "d_w4_q8mxu_chunk2"}
COUNTER = {"K12": "K4"}
REPLACES = {"K12": "mmmm_tpu/ops/dense_attn.py:156 _dense_fwd_bshd (pallas_call :177, "
                   "_kernel_bshd :121)"}


def log(msg: str) -> None:
    print(msg, flush=True)


def card_peaks(name: str):
    key = "H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name else "H100 SXM"
    return key, PEAKS[key]


def bound(bytes_moved: float, flops: float, flop_rate: float, bw: float):
    t_bytes, t_ops = bytes_moved / bw, flops / flop_rate
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def time_ms(fn, reps: int = 7, inner: int = 10) -> float:
    """Median over ``reps`` of the mean device time of ``inner`` back-to-back
    calls. A sleep kernel queued ahead of each timed run holds the device
    while the host enqueues the calls, so the host's launch cost (tens of us
    for a ctypes launch on a slow host) is not timed."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(20_000_000)  # ~10 ms of device clock cycles
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def lib_check(name, lib, plain, caches, args):
    """The library yardstick of an append must write what the plain version
    writes (bit-equal) at the timed, in-range write indices."""
    got = lib(tuple(c.clone() for c in caches))
    ref = plain(*(c.clone() for c in caches), *args)
    if not all(torch.equal(g, r) for g, r in zip(got, ref)):
        raise AssertionError(f"{name}: the library yardstick differs from the plain version")


def max_err(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(name: str, err: float, tol: float) -> None:
    log(f"  {name}: max_abs_err {err:.3e} (tol {tol:g})")
    if not err <= tol:
        raise AssertionError(f"{name}: max_abs_err {err} > {tol}")


class Rotating:
    """Cycles through copies of a call's inputs so each timed call finds its
    operands outside the 50 MB L2, as the decode loop does."""

    def __init__(self, copies):
        self.copies, self.i = copies, 0

    def next(self):
        self.i = (self.i + 1) % len(self.copies)
        return self.copies[self.i]


def kernel_phase(peaks, gen):
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops import dense_attn as da
    from mmmm_tpu_torch.ops import flash as fl
    from mmmm_tpu_torch.ops.attention import build_mask

    bw, bf16_rate, fp32_rate, _ = peaks
    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    out = {}

    # ---- K4 dense attention: ViT (bf16) and SAM encoder (fp32) -------------------
    log("K4 dense attention")
    entry = None
    for label, (b, s, h, d, dt, tol) in {
        "vit": (B, 1153, 16, 112, torch.bfloat16, 2e-2),
        "sam": (B, 512, 12, 64, torch.float32, 1e-4),
    }.items():
        q, k, v = (rnd(b, s, h, d, dt=dt) for _ in range(3))
        scale = d ** -0.5
        err = max_err(da.dense_attention(q, k, v, scale), da.dense_attention_plain(q, k, v, scale))
        check(f"K4 {label} {tuple(q.shape)} {dt}", err, tol)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        esz = q.element_size()
        bms, by = bound(4 * q.numel() * esz, 4 * b * h * s * s * d,
                        bf16_rate if dt == torch.bfloat16 else fp32_rate, bw)
        row = {
            "shape": [b, s, h, d], "dtype": str(dt).split(".")[-1], "max_abs_err": err,
            "ms": time_ms(lambda: da.dense_attention(q, k, v, scale)),
            "plain_ms": time_ms(lambda: da.dense_attention_plain(q, k, v, scale), inner=2),
            "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)),
            "bound_ms": bms, "bound_by": by,
        }
        log(f"  K4 {label}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"library {row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
        if entry is None:
            entry = dict(row, variants=[])
        else:
            entry["variants"].append(row)
    for b, s, h, d, dt, tol in [(1, 1153, 16, 88, torch.bfloat16, 2e-2),
                                (2, 77, 4, 64, torch.float32, 1e-4),
                                (2, 33, 2, 8, torch.float32, 1e-4)]:
        q, k, v = (rnd(b, s, h, d, dt=dt) for _ in range(3))
        check(f"K4 edge {tuple(q.shape)} {dt}", max_err(da.dense_attention(q, k, v, d ** -0.5),
              da.dense_attention_plain(q, k, v, d ** -0.5)), tol)
    out["K4"] = entry
    # K12 computes K4's function on (B, S, H, D) blocks, H % 8 == 0: the same
    # kernel; its row is K4's ViT row plus a check at another such shape
    q, k, v = (rnd(2, 300, 8, 88) for _ in range(3))
    err12 = max_err(da.dense_attention(q, k, v, 88 ** -0.5),
                    da.dense_attention_plain(q, k, v, 88 ** -0.5))
    check("K12 (the K4 kernel) (2, 300, 8, 88) bf16", err12, 2e-2)
    out["K12"] = dict({k_: v_ for k_, v_ in entry.items() if k_ != "variants"},
                      same_kernel_as="K4", check_shape=[2, 300, 8, 88], check_err=err12)

    # ---- P1: K4 with the softmax replaced by one multiply (K4's floor) -------------
    log("P1 K4 without softmax")
    b, s, h, d = B, 1153, 16, 112
    q, k, v = (rnd(b, s, h, d) for _ in range(3))
    scale = d ** -0.5
    ref = da.dense_attention_nosm_plain(q, k, v, scale)
    err = max_err(da.dense_attention_nosm(q, k, v, scale), ref)
    # probabilities ~1e-4 make outputs ~1e-2: the tolerance is one bf16 step
    # at the largest output
    top = ref.abs().max().item()
    check(f"P1 {tuple(q.shape)} bf16 (output max {top:.3e})", err, 2 ** -7 * top)
    bms, by = bound(4 * q.numel() * 2, 4 * b * h * s * s * d, bf16_rate, bw)
    out["P1"] = {
        "shape": [b, s, h, d], "dtype": "bfloat16", "max_abs_err": err,
        "ms": time_ms(lambda: da.dense_attention_nosm(q, k, v, scale)),
        "plain_ms": time_ms(lambda: da.dense_attention_nosm_plain(q, k, v, scale), inner=2),
        "library_ms": None, "k4_ms_same_shape": entry["ms"],
        "bound_ms": bms, "bound_by": by,
    }

    # ---- K3 flash forward (LLM prefill) ------------------------------------------
    log("K3 flash forward")
    b, s, h, d = B, PROMPT, 32, 128
    q, k, v = (rnd(b, s, h, d) for _ in range(3))
    lens = torch.tensor([s, 170, 150, s], device=dev)
    seg = (torch.arange(s, device=dev)[None] < lens[:, None]).to(torch.int32)
    scale = d ** -0.5
    o, lse = fl.flash_segment_attention(q, k, v, seg, seg, causal=True, scale=scale)
    ro, rlse = fl.flash_segment_attention_plain(q, k, v, seg, seg, causal=True, scale=scale)
    err = max_err(o, ro)
    check(f"K3 out {tuple(q.shape)} bf16 causal", err, 2e-2)
    check("K3 lse", max_err(lse, rlse), 1e-3)
    mask = build_mask(seg, seg, True)
    pairs = int(mask.sum().item())
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    amask = mask[:, None]
    bms, by = bound(4 * q.numel() * 2 + 2 * seg.numel() * 4 + lse.numel() * 4,
                    4 * d * h * pairs, bf16_rate, bw)
    out["K3"] = {
        "shape": [b, s, h, d], "dtype": "bfloat16", "max_abs_err": err, "valid_pairs": pairs,
        "ms": time_ms(lambda: fl.flash_segment_attention(q, k, v, seg, seg, causal=True,
                                                         scale=scale)),
        "plain_ms": time_ms(lambda: fl.flash_segment_attention_plain(q, k, v, seg, seg,
                                                                     causal=True, scale=scale)),
        "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=amask,
                                                                     scale=scale)),
        "bound_ms": bms, "bound_by": by,
    }
    for dt, tol in [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)]:
        q, k, v = (rnd(2, 40, 2, 16, dt=dt) for _ in range(3))
        qs = (torch.arange(40, device=dev)[None] < torch.tensor([[40], [29]], device=dev))
        qs = qs.to(torch.int32)
        ks = qs.clone()
        ks[0, :3] = 2  # query rows 0..2 of sample 0 see no key of their segment
        o, lse = fl.flash_segment_attention(q, k, v, qs, ks, causal=True, scale=0.25)
        ro, rlse = fl.flash_segment_attention_plain(q, k, v, qs, ks, causal=True, scale=0.25)
        check(f"K3 edge (masked rows) {dt}", max(max_err(o, ro), max_err(lse, rlse)), tol)
        if not (torch.all(o[0, :3] == 0) and torch.all(lse[0, :, :3] == 0)):
            raise AssertionError("K3: a fully masked row is not zero")

    # ---- K1 decode attention and K2 KV append --------------------------------------
    log("K1 decode attention, K2 KV append")
    b, h, smax, d = B, 32, PROMPT + NEW, 128
    copies = [(rnd(b, h, smax, d), rnd(b, h, smax, d)) for _ in range(8)]
    q = rnd(b, 1, h, d)
    kc, vc = copies[0]
    kv_len = torch.tensor([1, 150, smax, 0], dtype=torch.int32, device=dev)
    check("K1 edge kv_len (1, 150, Smax, 0)",
          max_err(dk.decode_attention(q, kc, vc, kv_len), dk.decode_attention_plain(q, kc, vc, kv_len)),
          2e-2)
    mid = torch.full((b,), (PROMPT + 1 + smax) // 2, dtype=torch.int32, device=dev)
    err = max_err(dk.decode_attention(q, kc, vc, mid), dk.decode_attention_plain(q, kc, vc, mid))
    check(f"K1 {tuple(kc.shape)} bf16 kv_len {int(mid[0])}", err, 2e-2)
    rot = Rotating(copies)
    valid = (torch.arange(smax, device=dev)[None] < mid[:, None])[:, None, None, :]
    qh = q.transpose(1, 2).contiguous()

    def lib_k1():
        kk, vv = rot.next()
        return F.scaled_dot_product_attention(qh, kk, vv, attn_mask=valid)

    n_read = int(mid.sum().item())
    bms, by = bound(2 * n_read * h * d * 2 + 2 * q.numel() * 2, 4 * n_read * h * d, bf16_rate, bw)
    out["K1"] = {
        "shape": [b, h, smax, d], "kv_len": int(mid[0]), "dtype": "bfloat16", "max_abs_err": err,
        "ms": time_ms(lambda: dk.decode_attention(q, *rot.next(), mid)),
        "plain_ms": time_ms(lambda: dk.decode_attention_plain(q, *rot.next(), mid)),
        "library_ms": time_ms(lib_k1),
        "bound_ms": bms, "bound_by": by,
    }

    kn, vn = rnd(b, h, 1, d), rnd(b, h, 1, d)
    for widx in ([PROMPT, 0, smax - 1, smax + 7], [-1, 5, 300, -400]):
        w = torch.tensor(widx, dtype=torch.int32, device=dev)
        rk, rv = dk.kv_append_plain(kc.clone(), vc.clone(), kn, vn, w)
        gk, gv = dk.kv_append(kc.clone(), vc.clone(), kn, vn, w)
        if not (torch.equal(gk, rk) and torch.equal(gv, rv)):
            raise AssertionError(f"K2: not bit-equal to the plain version at write_index {widx}")
        log(f"  K2 write_index {widx}: bit-equal")
    w = torch.tensor([PROMPT, PROMPT + 1, PROMPT + 2, PROMPT + 3], dtype=torch.int32, device=dev)
    bms, by = bound(4 * kn.numel() * 2, 0, bf16_rate, bw)
    bi = torch.arange(b, device=dev)

    def lib_k2(caches):  # the same in-range append, one index_put_ a cache
        for cache, new in zip(caches, (kn, vn)):
            cache[bi, :, w.long()] = new[:, :, 0]
        return caches

    lib_check("K2", lib_k2, dk.kv_append_plain, (kc, vc), (kn, vn, w))
    out["K2"] = {
        "shape": [b, h, smax, d], "dtype": "bfloat16", "max_abs_err": 0.0,
        "ms": time_ms(lambda: dk.kv_append(*rot.next(), kn, vn, w)),
        "plain_ms": time_ms(lambda: dk.kv_append_plain(*rot.next(), kn, vn, w)),
        "library_ms": time_ms(lambda: lib_k2(rot.next())),
        "library_call": "Tensor.index_put_ (2 calls: K and V)",
        "bound_ms": bms, "bound_by": by,
    }
    spec_kernel_phase(peaks, gen, out)
    capacity_kernel_phase(peaks, gen, out)
    train_kernel_phase(peaks, gen, out)
    torch.cuda.synchronize()
    for name in ("K4", "K3", "K1", "K2", "K5", "K6", "K7dq", "K7dkv", "K7delta", "K8", "K9",
                 "K10", "K11", "K11mma", "K12", "P1"):
        r = out[name]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return out


def spec_kernel_phase(peaks, gen, out):
    """K5, K6 (speculative verify, Smax = prompt + new + window) and K8, K9
    (int8 KV greedy, Smax = prompt + new) at the flagship's shapes."""
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops.quant import quantize_kv

    bw, bf16_rate, fp32_rate, _ = peaks
    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    h, d = 32, 128

    # ---- K5 window append, K6 window attention ------------------------------------
    log("K5 window append, K6 window attention")
    smax = PROMPT + NEW + WINDOW
    copies = [(rnd(B, h, smax, d), rnd(B, h, smax, d)) for _ in range(8)]
    rot = Rotating(copies)
    kc, vc = copies[0]
    kn, vn = rnd(B, h, WINDOW, d), rnd(B, h, WINDOW, d)
    for widx in ([PROMPT, 13, smax - WINDOW, smax - 3], [-1, 0, 400, -400]):
        w = torch.tensor(widx, dtype=torch.int32, device=dev)
        rk, rv = dk.kv_append_plain(kc.clone(), vc.clone(), kn, vn, w)
        gk, gv = dk.kv_append_multi(kc.clone(), vc.clone(), kn, vn, w)
        if not (torch.equal(gk, rk) and torch.equal(gv, rv)):
            raise AssertionError(f"K5: not bit-equal to the plain version at write_index {widx}")
        log(f"  K5 write_index {widx}: bit-equal")
    a, b_, new = (rnd(2, 4, n, 64, dt=torch.float32) for n in (40, 40, 5))
    w = torch.tensor([-2, 35], dtype=torch.int32, device=dev)
    ra, rb = dk.kv_append_plain(a.clone(), b_.clone(), new, new, w)
    ga, gb = dk.kv_append_multi(a.clone(), b_.clone(), new, new, w)
    if not (torch.equal(ga, ra) and torch.equal(gb, rb)):
        raise AssertionError("K5: fp32 window not bit-equal")
    log("  K5 fp32 (2, 4, 40, 64) window 5: bit-equal")
    t_mid = (PROMPT + smax - WINDOW) // 2
    w_mid = torch.full((B,), t_mid, dtype=torch.int32, device=dev)
    q = rnd(B, WINDOW, h, d)
    err = 0.0
    for widx in ([t_mid] * B, [0, 150, smax - WINDOW, smax - 1]):
        w = torch.tensor(widx, dtype=torch.int32, device=dev)
        e = max_err(dk.decode_attention_window(q, kc, vc, w),
                    dk.decode_attention_window_plain(q, kc, vc, w))
        check(f"K6 {tuple(q.shape)} over {tuple(kc.shape)} bf16 write_index {widx}", e, 2e-2)
        err = max(err, e)
    for nq, dt, tol in [(2, torch.bfloat16, 2e-2), (5, torch.float32, 1e-4),
                        (8, torch.float32, 1e-4)]:
        qq, ka, va = rnd(3, nq, 4, 64, dt=dt), rnd(3, 4, 50, 64, dt=dt), rnd(3, 4, 50, 64, dt=dt)
        w = torch.tensor([0, 20, 50 - nq], dtype=torch.int32, device=dev)
        check(f"K6 edge window {nq} {dt}", max_err(dk.decode_attention_window(qq, ka, va, w),
              dk.decode_attention_window_plain(qq, ka, va, w)), tol)
    slot = torch.arange(smax, device=dev)
    lens = w_mid[:, None] + torch.arange(1, WINDOW + 1, device=dev)  # (B, K)
    amask = (slot[None, None] < lens[..., None])[:, None]  # (B, 1, K, Smax)
    qh = q.transpose(1, 2).contiguous()

    def lib_k6():
        kk, vv = rot.next()
        return F.scaled_dot_product_attention(qh, kk, vv, attn_mask=amask)

    n_read = B * (t_mid + WINDOW)  # slots read for all queries of a (b, h)
    pairs = int(lens.sum().item())  # (query, slot) pairs per head
    k5_bms, k5_by = bound(4 * kn.numel() * 2, 0, bf16_rate, bw)
    bi = torch.arange(B, device=dev)[:, None]
    si = w_mid.long()[:, None] + torch.arange(WINDOW, device=dev)

    def lib_k5(caches):  # the same in-range window append, one index_put_ a cache
        for cache, new in zip(caches, (kn, vn)):
            cache[bi, :, si] = new.transpose(1, 2)
        return caches

    lib_check("K5", lib_k5, dk.kv_append_plain, (kc, vc), (kn, vn, w_mid))
    out["K5"] = {
        "shape": [B, h, smax, d], "window": WINDOW, "dtype": "bfloat16", "max_abs_err": 0.0,
        "ms": time_ms(lambda: dk.kv_append_multi(*rot.next(), kn, vn, w_mid)),
        "plain_ms": time_ms(lambda: dk.kv_append_plain(*rot.next(), kn, vn, w_mid)),
        "library_ms": time_ms(lambda: lib_k5(rot.next())),
        "library_call": "Tensor.index_put_ (2 calls: K and V)",
        "bound_ms": k5_bms, "bound_by": k5_by,
    }
    bms, by = bound(2 * n_read * h * d * 2 + 2 * q.numel() * 2, 4 * pairs * h * d, bf16_rate, bw)
    out["K6"] = {
        "shape": [B, h, smax, d], "window": WINDOW, "write_index": t_mid, "dtype": "bfloat16",
        "max_abs_err": err,
        "ms": time_ms(lambda: dk.decode_attention_window(q, *rot.next(), w_mid)),
        "plain_ms": time_ms(lambda: dk.decode_attention_window_plain(q, *rot.next(), w_mid)),
        "library_ms": time_ms(lib_k6), "bound_ms": bms, "bound_by": by,
    }
    del copies, rot, kc, vc

    # ---- K8 int8 append, K9 int8 decode attention ------------------------------------
    log("K8 int8 append, K9 int8 decode attention")
    smax = PROMPT + NEW

    def q8_cache():
        kq, ks = quantize_kv(rnd(B, h, smax, d))
        vq, vs = quantize_kv(rnd(B, h, smax, d))
        return {"kq": kq, "ks": ks, "vq": vq, "vs": vs}

    caches = [q8_cache() for _ in range(8)]
    rot = Rotating(caches)
    cache = caches[0]
    new = [*quantize_kv(rnd(B, h, 1, d)), *quantize_kv(rnd(B, h, 1, d))]
    for widx in ([PROMPT, 0, smax - 1, smax + 7], [-1, 5, 300, -400]):
        w = torch.tensor(widx, dtype=torch.int32, device=dev)
        ref = dk.kv_append_q8_plain({k: v.clone() for k, v in cache.items()}, *new, w)
        got = dk.kv_append_q8({k: v.clone() for k, v in cache.items()}, *new, w)
        if not all(torch.equal(got[k], ref[k]) for k in dk.Q8_LEAVES):
            raise AssertionError(f"K8: not bit-equal to the plain version at write_index {widx}")
        log(f"  K8 write_index {widx}: bit-equal")
    leaves = lambda c: [c[k] for k in dk.Q8_LEAVES]
    q = rnd(B, 1, h, d)
    kv_len = torch.tensor([1, 150, smax, 0], dtype=torch.int32, device=dev)
    check("K9 edge kv_len (1, 150, Smax, 0)",
          max_err(dk.decode_attention_q8(q, *leaves(cache), kv_len),
                  dk.decode_attention_q8_plain(q, *leaves(cache), kv_len)), 2e-2)
    mid = torch.full((B,), (PROMPT + 1 + smax) // 2, dtype=torch.int32, device=dev)
    err = max_err(dk.decode_attention_q8(q, *leaves(cache), mid),
                  dk.decode_attention_q8_plain(q, *leaves(cache), mid))
    check(f"K9 {tuple(cache['kq'].shape)} int8, q bf16, kv_len {int(mid[0])}", err, 2e-2)
    for dd in (16, 64):
        kq, ks = quantize_kv(rnd(3, 4, 40, dd))
        vq, vs = quantize_kv(rnd(3, 4, 40, dd))
        qq = rnd(3, 1, 4, dd, dt=torch.float32)
        ln = torch.tensor([0, 17, 40], dtype=torch.int32, device=dev)
        check(f"K9 edge D={dd} q fp32", max_err(dk.decode_attention_q8(qq, kq, ks, vq, vs, ln),
              dk.decode_attention_q8_plain(qq, kq, ks, vq, vs, ln)), 1e-4)
    n_read = int(mid.sum().item())
    k8_bms, k8_by = bound(2 * 2 * B * h * (d + 2), 0, bf16_rate, bw)
    bi = torch.arange(B, device=dev)

    def lib_k8(c):  # the same in-range append, one index_put_ a leaf
        for key, t in zip(dk.Q8_LEAVES, new):
            c[key][bi, :, mid.long()] = t[:, :, 0]
        return c

    got = lib_k8({k: v.clone() for k, v in cache.items()})
    ref = dk.kv_append_q8_plain({k: v.clone() for k, v in cache.items()}, *new, mid)
    if not all(torch.equal(got[k], ref[k]) for k in dk.Q8_LEAVES):
        raise AssertionError("K8: the library yardstick differs from the plain version")
    out["K8"] = {
        "shape": [B, h, smax, d], "dtype": "int8", "max_abs_err": 0.0,
        "ms": time_ms(lambda: dk.kv_append_q8(rot.next(), *new, mid)),
        "plain_ms": time_ms(lambda: dk.kv_append_q8_plain(rot.next(), *new, mid)),
        "library_ms": time_ms(lambda: lib_k8(rot.next())),
        "library_call": "Tensor.index_put_ (4 calls: kq, ks, vq, vs)",
        "bound_ms": k8_bms, "bound_by": k8_by,
    }
    bms, by = bound(2 * n_read * h * (d + 2) + 2 * q.numel() * 2, 4 * n_read * h * d,
                    bf16_rate, bw)
    out["K9"] = {
        "shape": [B, h, smax, d], "kv_len": int(mid[0]), "dtype": "int8 KV, bf16 q",
        "max_abs_err": err,
        "ms": time_ms(lambda: dk.decode_attention_q8(q, *leaves(rot.next()), mid)),
        "plain_ms": time_ms(lambda: dk.decode_attention_q8_plain(q, *leaves(rot.next()), mid)),
        "library_ms": None, "bound_ms": bms, "bound_by": by,
    }


def capacity_kernel_phase(peaks, gen, out):
    """K10 (the split-int8 read, at K9's shape) and K11 (W4A16: the GEMV at
    greedy decode rows, the tensor-core tile at a batch's 4 x 146 vision
    rows) at the flagship's shapes."""
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops import w4_matmul as w4
    from mmmm_tpu_torch.ops.quant import quantize_int4, quantize_kv

    bw, bf16_rate, _, int8_rate = peaks
    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)

    # ---- K10 split-int8 decode attention -------------------------------------------
    log("K10 split-int8 decode attention")
    h, d, smax = 32, 128, PROMPT + NEW

    def q8_cache():
        kq, ks = quantize_kv(rnd(B, h, smax, d))
        vq, vs = quantize_kv(rnd(B, h, smax, d))
        return {"kq": kq, "ks": ks, "vq": vq, "vs": vs}

    caches = [q8_cache() for _ in range(8)]
    rot = Rotating(caches)
    leaves = lambda c: [c[k] for k in dk.Q8_LEAVES]
    cache = caches[0]
    q = rnd(B, 1, h, d)
    kv_len = torch.tensor([1, 150, smax, 0], dtype=torch.int32, device=dev)
    check("K10 edge kv_len (1, 150, Smax, 0)",
          max_err(dk.decode_attention_q8_mxu(q, *leaves(cache), kv_len),
                  dk.decode_attention_q8_mxu_plain(q, *leaves(cache), kv_len)), 2e-2)
    mid = torch.full((B,), (PROMPT + 1 + smax) // 2, dtype=torch.int32, device=dev)
    err = max_err(dk.decode_attention_q8_mxu(q, *leaves(cache), mid),
                  dk.decode_attention_q8_mxu_plain(q, *leaves(cache), mid))
    check(f"K10 {tuple(cache['kq'].shape)} int8, q bf16, kv_len {int(mid[0])}", err, 2e-2)
    for dd in (16, 64):
        kq, ks = quantize_kv(rnd(3, 4, 40, dd))
        vq, vs = quantize_kv(rnd(3, 4, 40, dd))
        qq = rnd(3, 1, 4, dd, dt=torch.float32)
        ln = torch.tensor([0, 17, 40], dtype=torch.int32, device=dev)
        check(f"K10 edge D={dd} q fp32", max_err(dk.decode_attention_q8_mxu(qq, kq, ks, vq, vs, ln),
              dk.decode_attention_q8_mxu_plain(qq, kq, ks, vq, vs, ln)), 1e-4)
    # the int32 band: uniform attention over rows of 127 at kv_len 1100 wraps
    k127 = torch.full((1, 2, 1100, 16), 127, dtype=torch.int8, device=dev)
    s1 = torch.ones((1, 2, 1100, 1), dtype=torch.bfloat16, device=dev)
    q0, n1100 = torch.zeros((1, 1, 2, 16), device=dev), torch.tensor([1100], dtype=torch.int32,
                                                                      device=dev)
    got = dk.decode_attention_q8_mxu(q0, k127, s1, k127, s1, n1100)
    if not (torch.equal(got, dk.decode_attention_q8_mxu_plain(q0, k127, s1, k127, s1, n1100))
            and bool((got < 0).all())):
        raise AssertionError("K10: the int32 wrap at kv_len 1100 differs from the plain version")
    log("  K10 int32 wrap band (kv_len 1100, uniform): bit-equal, wrapped")
    n_read = int(mid.sum().item())
    bms, by = bound(2 * n_read * h * (d + 2) + 2 * q.numel() * 2, 8 * n_read * h * d,
                    int8_rate, bw)
    out["K10"] = {
        "shape": [B, h, smax, d], "kv_len": int(mid[0]), "dtype": "int8 KV, bf16 q",
        "max_abs_err": err,
        "ms": time_ms(lambda: dk.decode_attention_q8_mxu(q, *leaves(rot.next()), mid)),
        "plain_ms": time_ms(lambda: dk.decode_attention_q8_mxu_plain(q, *leaves(rot.next()), mid)),
        "library_ms": None, "k9_ms_same_shape": out["K9"]["ms"],
        "bound_ms": bms, "bound_by": by,
    }
    del caches, rot, cache

    # ---- K11 W4A16 product -------------------------------------------------------
    log("K11 W4A16 product")

    def w4_check(label, x, w):
        got = w4.w4_matmul(x, w["q4"], w["s4"])
        ref = w4.w4_matmul_plain(x, w["q4"], w["s4"])
        # bf16: one bf16 step at the largest output; fp32: sums in another order
        tol = (2 ** -7 if x.dtype == torch.bfloat16 else 1e-5) * max(1.0, ref.abs().max().item())
        e = max_err(got, ref)
        check(label, e, tol)
        return e

    # the GEMV at decode rows; K11mma at the row counts W4A16 serving passes
    # (text rows 4 x 46 and vision rows 4 x 145, whole and in chunks of 2),
    # at 4 x 146 and 2 x 146, and at tile edges
    for kk, nn in ((4096, 12288), (4096, 4096), (11008, 4096)):
        w = quantize_int4(rnd(kk, nn, dt=torch.float32).mul_(0.02))
        for m, dt in ((4, torch.bfloat16), (4, torch.float32), (17, torch.bfloat16),
                      (64, torch.bfloat16), (65, torch.bfloat16), (92, torch.bfloat16),
                      (184, torch.bfloat16), (290, torch.bfloat16), (292, torch.bfloat16),
                      (580, torch.bfloat16), (584, torch.bfloat16)):
            w4_check(f"K11 ({m}, {kk}) x {kk}x{nn} {dt} -> {w4.route(m, kk, nn, 128, dt)}",
                     rnd(m, kk, dt=dt), w)
    # K11mma's two tile widths at the W4A16 prefill's shapes (4 x 145 vision
    # and 4 x 46 text rows, in run (d)'s chunks of 2 and whole, on each of
    # the five products' weights): each checked, then timed against the
    # other; mma_tpw picks one
    log("K11mma tile widths at the prefill's shapes (TPW 64-column tiles a warpgroup)")
    tpw_rows = []
    for kk, nn in ((4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096)):
        wset = Rotating([quantize_int4(rnd(kk, nn, dt=torch.float32).mul_(0.02))
                         for _ in range(4)])
        for m in (B * (N_VIS - 1) // CHUNK, B * (PROMPT - N_VIS) // CHUNK, B * (N_VIS - 1),
                  B * (PROMPT - N_VIS)):
            x = rnd(m, kk)
            stream = w4._cuda.stream_of(x)

            def forced(tpw, w):
                y = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
                w4.K11MMA(x.data_ptr(), w["q4"].data_ptr(), w["s4"].data_ptr(), y.data_ptr(),
                          m, kk, nn, 128, tpw, stream)
                return y

            ref = w4.w4_matmul_plain(x, wset.copies[0]["q4"], wset.copies[0]["s4"])
            row = {"shape": [m, kk, nn], "picked": w4.mma_tpw(m, nn)}
            for tpw in (1, 2):
                check(f"K11mma TPW={tpw} ({m}, {kk}) x {kk}x{nn}",
                      max_err(forced(tpw, wset.copies[0]), ref),
                      2 ** -7 * max(1.0, ref.abs().max().item()))
                row[f"tpw{tpw}_ms"] = time_ms(lambda: forced(tpw, wset.next()))
            tpw_rows.append(row)
            log(f"  K11mma ({m}, {kk}) x {kk}x{nn}: TPW=1 {row['tpw1_ms']:.4f} ms, TPW=2 "
                f"{row['tpw2_ms']:.4f} ms, mma_tpw picks {row['picked']}")
        del wset
    k, n = 4096, 11008
    wts = [quantize_int4(rnd(k, n, dt=torch.float32).mul_(0.02)) for _ in range(4)]
    wrot = Rotating(wts)  # 4 x 23 MB: each timed call reads its weight from memory
    bts = Rotating([rnd(k, n).mul_(0.02) for _ in range(2)])
    w4_bytes = lambda m: k // 2 * n + k // 128 * n * 4 + m * k * 2 + m * n * 2

    def w4_next():
        w = wrot.next()
        return w["q4"], w["s4"]

    # 4 x 146 and 2 x 146 rows, then run (d)'s chunk of vision and of text rows
    for name, m in (("K11", 4), ("K11mma", B * N_VIS), ("K11mma", B * N_VIS // 2),
                    ("K11mma", B * (N_VIS - 1) // CHUNK),
                    ("K11mma", B * (PROMPT - N_VIS) // CHUNK)):
        x = rnd(m, k)
        err = w4_check(f"{name} ({m}, {k}) x {k}x{n} bf16", x, wts[0])
        if name == "K11":
            w4_check(f"{name} ({m}, {k}) x {k}x{n} fp32", x.float(), wts[0])
        bms, by = bound(w4_bytes(m), 2 * m * k * n, bf16_rate, bw)
        row = {
            "shape": [m, k, n], "dtype": "bf16 x, int4 W (group 128)", "max_abs_err": err,
            "ms": time_ms(lambda: w4.w4_matmul(x, *w4_next())),
            "plain_ms": time_ms(lambda: w4.w4_matmul_plain(x, *w4_next())),
            "library_ms": time_ms(lambda: x @ bts.next()),
            "bound_ms": bms, "bound_by": by,
        }
        log(f"  {name} M={m}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"bf16 matmul {row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
        if name in out:
            out[name].setdefault("variants", []).append(row)
        else:
            out[name] = row
    out["K11mma"]["tile_widths"] = tpw_rows


def train_kernel_phase(peaks, gen, out):
    """At each of the training step's flash sites: K3's forward against its
    plain version (its output feeds K7, so a K3 fault would cancel out of
    K7's comparison), timed with its plain version and SDPA's forward; then
    K7dq and K7dkv (the flash backward) against the plain backward, and at a
    masked small shape; timed per kernel (their operands prepared as the
    wrapper prepares them), the whole backward through the wrapper (delta,
    then both kernels), the plain backward and, as a yardstick, SDPA's
    backward at the same shape."""
    from mmmm_tpu_torch.ops import flash as fl
    from mmmm_tpu_torch.ops.attention import build_mask

    bw, bf16_rate, fp32_rate, _ = peaks
    dev = torch.device("cuda")
    log("K7 flash backward (K7dq, K7dkv, K7delta)")
    rows = {}
    n_bytes = lambda t: t.numel() * t.element_size()
    rate_of = lambda dt: bf16_rate if dt == torch.bfloat16 else fp32_rate
    for label, (b, s, h, d, dt, causal) in TRAIN_SITES.items():
        q, k, v, dout = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dt)
                         for _ in range(4))
        seg = torch.ones(b, s, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        frac = 2e-2 if dt == torch.bfloat16 else 1e-4
        o, lse = fl.flash_segment_attention(q, k, v, seg, seg, causal=causal, scale=scale)
        ro, rlse = fl.flash_segment_attention_plain(q, k, v, seg, seg, causal=causal, scale=scale)
        err3 = max_err(o, ro)
        check(f"K3 {label} {tuple(q.shape)} {dt} causal={causal} out (of largest "
              f"{ro.float().abs().max().item():.3e})", err3, frac * ro.float().abs().max().item())
        check(f"K3 {label} lse", max_err(lse, rlse), 1e-3)
        del ro, rlse
        got = fl.flash_segment_attention_bwd(q, k, v, seg, seg, o, lse, dout, causal=causal,
                                             scale=scale)
        ref = fl.flash_segment_attention_bwd_plain(q, k, v, seg, seg, o, lse, dout,
                                                   causal=causal, scale=scale)
        errs = {}
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            errs[name] = max_err(a, r)
            check(f"K7 {label} {tuple(q.shape)} {dt} causal={causal} {name} (of largest "
                  f"{r.float().abs().max().item():.3e})", errs[name],
                  frac * r.float().abs().max().item())
        pairs = int(build_mask(seg, seg, causal).sum().item())
        esz = q.element_size()
        rate = bf16_rate if dt == torch.bfloat16 else fp32_rate
        n = q.numel() * esz  # one (B, S, H, D) operand
        lse_bytes = 2 * lse.numel() * 4  # lse and delta
        delta = fl._delta(o, dout)
        bf16 = int(dt == torch.bfloat16)
        stream = fl._cuda.stream_of(q)
        kdelta = torch.empty_like(delta)
        fl.K7DELTA(o.data_ptr(), dout.data_ptr(), kdelta.data_ptr(), b, s, h, d, bf16, stream)
        err_delta = max_err(kdelta, delta)
        check(f"K7delta {label} (relative to the largest |delta| "
              f"{delta.abs().max().item():.3e})", err_delta / delta.abs().max().item(), 1e-5)
        bms, by = bound(2 * n_bytes(o) + delta.numel() * 4, 2 * o.numel(), rate_of(dt), bw)
        # one PyTorch call of the same rowsum: exact in fp32; in bf16 its
        # output is rounded to bf16, so there it is a yardstick of time only
        lib_delta = lambda: torch.einsum("bshd,bshd->bhs", o, dout)
        lib_err = max_err(lib_delta(), delta) / delta.abs().max().item()
        if dt == torch.float32:
            check(f"K7delta library call {label} (einsum, relative)", lib_err, 1e-5)
        rows.setdefault("K7delta", {})[label] = {
            "shape": [b, s, h, d], "dtype": str(dt).split(".")[-1], "max_abs_err": err_delta,
            "ms": time_ms(lambda: fl.K7DELTA(o.data_ptr(), dout.data_ptr(), kdelta.data_ptr(), b,
                                             s, h, d, bf16, stream)),
            "plain_ms": time_ms(lambda: fl._delta(o, dout)), "library_ms": time_ms(lib_delta),
            "library_call": "torch.einsum('bshd,bshd->bhs', out, dout)" + (
                ", output rounded to bf16" if bf16 else ""),
            "library_rel_err": lib_err, "bound_ms": bms, "bound_by": by}
        r = rows["K7delta"][label]
        log(f"  K7delta {label}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, einsum "
            f"{r['library_ms']:.4f} ms (relative difference {lib_err:.2e}), bound {bms:.4f} ms "
            f"({by})")
        dq, dk, dv = (torch.empty_like(t) for t in (q, k, v))
        ptrs = [t.data_ptr() for t in (q, k, v, dout, seg, seg, lse, delta)]
        tail = (b, s, s, h, d, float(scale), int(causal), bf16, stream)
        if label == "llm":  # no atomics: two runs give the same bits
            again = [torch.empty_like(t) for t in (q, k, k)]
            fl.K7DQ(*ptrs, dq.data_ptr(), *tail)
            fl.K7DQ(*ptrs, again[0].data_ptr(), *tail)
            fl.K7DKV(*ptrs, dk.data_ptr(), dv.data_ptr(), *tail)
            fl.K7DKV(*ptrs, again[1].data_ptr(), again[2].data_ptr(), *tail)
            if not all(torch.equal(x, y) for x, y in zip((dq, dk, dv), again)):
                raise AssertionError("K7: two runs at the LLM site differ")
            log("  K7dq, K7dkv llm: two runs bit-equal")
            del again
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        # K3: q, k, v read, out and lse written; QK^T and PV on the valid pairs
        bms, by = bound(4 * n + 2 * seg.numel() * 4 + lse.numel() * 4, 4 * pairs * h * d, rate,
                        bw)
        k3 = {"shape": [b, s, h, d], "dtype": str(dt).split(".")[-1], "causal": causal,
              "valid_pairs": pairs, "max_abs_err": err3, "bound_ms": bms, "bound_by": by,
              "ms": time_ms(lambda: fl.flash_segment_attention(q, k, v, seg, seg, causal=causal,
                                                               scale=scale)),
              "plain_ms": time_ms(lambda: fl.flash_segment_attention_plain(
                  q, k, v, seg, seg, causal=causal, scale=scale), inner=2),
              "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                  qt, kt, vt, is_causal=causal, scale=scale)), "site": f"train_{label}"}
        out["K3"].setdefault("variants", []).append(k3)
        log(f"  K3 {label}: kernel {k3['ms']:.4f} ms, plain {k3['plain_ms']:.4f} ms, SDPA "
            f"{k3['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=causal, scale=scale)
        gt = dout.transpose(1, 2).contiguous()
        common = {
            "shape": [b, s, h, d], "dtype": str(dt).split(".")[-1], "causal": causal,
            "valid_pairs": pairs,
            "bwd_ms": time_ms(lambda: fl.flash_segment_attention_bwd(
                q, k, v, seg, seg, o, lse, dout, causal=causal, scale=scale)),
            "plain_ms": time_ms(lambda: fl.flash_segment_attention_bwd_plain(
                q, k, v, seg, seg, o, lse, dout, causal=causal, scale=scale), inner=2),
            "library_ms": time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt,
                                                              retain_graph=True)),
        }
        # K7dq: S, dP, dQ (3 products); K7dkv: S^T, dP^T, dV, dK (4 products)
        for kid, kern, outs, n_prod, write in (
                ("K7dq", fl.K7DQ, (dq.data_ptr(),), 3, n),
                ("K7dkv", fl.K7DKV, (dk.data_ptr(), dv.data_ptr()), 4, 2 * n)):
            bms, by = bound(4 * n + lse_bytes + write, 2 * n_prod * pairs * h * d, rate, bw)
            row = dict(common, max_abs_err=(max(errs["dk"], errs["dv"]) if kid == "K7dkv"
                                            else errs["dq"]),
                       ms=time_ms(lambda: kern(*ptrs, *outs, *tail)), bound_ms=bms, bound_by=by)
            rows.setdefault(kid, {})[label] = row
            log(f"  {kid} {label}: kernel {row['ms']:.4f} ms, bound {bms:.4f} ms ({by}); "
                f"whole backward {common['bwd_ms']:.4f} ms, plain {common['plain_ms']:.4f} ms, "
                f"SDPA backward {common['library_ms']:.4f} ms")
        del q, k, v, dout, o, lse, got, ref, delta, dq, dk, dv, qt, kt, vt, lib_out, gt
    # a masked small shape: packed segments, a padded tail, a query whose
    # segment has no key
    for dt, causal in ((torch.bfloat16, True), (torch.bfloat16, False), (torch.float32, True)):
        b, s, h, d = 2, 150, 2, 88
        q, k, v, dout = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dt)
                         for _ in range(4))
        seg = torch.ones(b, s, dtype=torch.int32, device=dev)
        seg[0, 75:] = 2
        seg[1, 120:] = 0
        kv_seg = seg.clone()
        kv_seg[0, 75:78] = 3
        o, lse = fl.flash_segment_attention(q, k, v, seg, kv_seg, causal=causal, scale=0.1)
        got = fl.flash_segment_attention_bwd(q, k, v, seg, kv_seg, o, lse, dout, causal=causal,
                                             scale=0.1)
        ref = fl.flash_segment_attention_bwd_plain(q, k, v, seg, kv_seg, o, lse, dout,
                                                   causal=causal, scale=0.1)
        frac = 2e-2 if dt == torch.bfloat16 else 1e-4
        for name, a, r in zip(("dq", "dk", "dv"), got, ref):
            check(f"K7 masked {(b, s, h, d)} {dt} causal={causal} {name}", max_err(a, r),
                  frac * r.float().abs().max().item())
        if causal and not (torch.all(got[0][0, 75] == 0) and torch.all(got[0][1, 120:] == 0)):
            raise AssertionError("K7: a row with no valid key has a nonzero gradient")
    # every head dim K7 serves, over a ragged S, masked and causal
    for dt in (torch.bfloat16, torch.float32):
        for d in (64, 88, 112, 128):
            for s in (150, 577):
                b, h = 1, 2
                q, k, v, dout = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dt)
                                 for _ in range(4))
                seg = torch.ones(b, s, dtype=torch.int32, device=dev)
                seg[0, s // 2:] = 2
                seg[0, s - s // 5:] = 0
                kv_seg = seg.clone()
                kv_seg[0, s // 2:s // 2 + 3] = 3
                o, lse = fl.flash_segment_attention(q, k, v, seg, kv_seg, causal=True,
                                                    scale=d ** -0.5)
                got = fl.flash_segment_attention_bwd(q, k, v, seg, kv_seg, o, lse, dout,
                                                     causal=True, scale=d ** -0.5)
                ref = fl.flash_segment_attention_bwd_plain(q, k, v, seg, kv_seg, o, lse, dout,
                                                           causal=True, scale=d ** -0.5)
                frac = 2e-2 if dt == torch.bfloat16 else 1e-4
                worst = max(max_err(a, r) / r.float().abs().max().item()
                            for a, r in zip(got, ref))
                check(f"K7 {(b, s, h, d)} {dt} masked causal, worst of dq/dk/dv (relative)",
                      worst, frac)
                if not (torch.all(got[0][0, s // 2] == 0) and torch.all(got[0][0, s - s // 5:] == 0)):
                    raise AssertionError("K7: a row with no valid key has a nonzero gradient")
    for kid in ("K7dq", "K7dkv", "K7delta"):
        first = rows[kid]["llm"]
        out[kid] = dict(first, site="llm",
                        variants=[dict(r, site=lb) for lb, r in rows[kid].items() if lb != "llm"])


def qdot_phase(peaks, gen):
    """The quantized products as the port runs them against a bf16
    ``torch.matmul``, at decode rows (4: greedy, 32: a verify window of 8
    for 4 samples): W8A16 (the int8 weight cast to bf16, a cuBLAS product,
    the scale after it), W8A8 (per-row int8 x, ``torch._int_mm``) and W4A16
    (kernel K11; int4 needs 256 | N, so not on the 32008-column head). The
    int4 weights rotate through 4 copies, past the L2; the others are timed
    on one copy, as the earlier rows of this table were."""
    from mmmm_tpu_torch.ops.quant import qdot, quantize_int4, quantize_int8

    bw = peaks[0]
    log("W8A16, W8A8, W4A16 qdot vs bf16 matmul")
    rows = []
    for k, n in ((4096, 11008), (4096, 32008)):
        w = torch.randn(k, n, generator=gen, device="cuda").mul_(0.02).to(torch.bfloat16)
        wq = quantize_int8(w)
        w4s = Rotating([quantize_int4(w) for _ in range(4)]) if n % 256 == 0 else None
        for m in (4, 32):
            x = torch.randn(m, k, generator=gen, device="cuda").to(torch.bfloat16)
            row = {"m": m, "k": k, "n": n,
                   "w8a16_ms": time_ms(lambda: qdot(x, wq)),
                   "w8a8_ms": time_ms(lambda: qdot(x, wq, act_quant=True)),
                   "w4a16_ms": time_ms(lambda: qdot(x, w4s.next())) if w4s else None,
                   "bf16_ms": time_ms(lambda: x @ w),
                   "w8a16_bound_ms": (k * n + 4 * n + 2 * m * (k + n)) / bw * 1e3,
                   "w8a8_bound_ms": (k * n + 4 * n + 2 * m * (k + n)) / bw * 1e3,
                   "w4a16_bound_ms": (k * n // 2 + k // 128 * n * 4 + 2 * m * (k + n)) / bw * 1e3,
                   "bf16_bound_ms": (2 * k * n + 2 * m * (k + n)) / bw * 1e3}
            w4_txt = "n/a" if w4s is None else f"{row['w4a16_ms']:.4f}"
            log(f"  M={m} {k}x{n}: W8A16 {row['w8a16_ms']:.4f} ms (bound "
                f"{row['w8a16_bound_ms']:.4f}), W8A8 {row['w8a8_ms']:.4f}, W4A16 {w4_txt} "
                f"(bound {row['w4a16_bound_ms']:.4f}), bf16 {row['bf16_ms']:.4f} ms (bound "
                f"{row['bf16_bound_ms']:.4f})")
            rows.append(row)
        del w, wq, w4s
    return rows


def _tree_to(tree, device):
    return {k: _tree_to(v, device) if isinstance(v, dict) else v.to(device)
            for k, v in tree.items()}


def tiny_reference_phase():
    """The same fp32 runs on the card (kernels) and on the CPU (plain
    versions) must give the same tokens (and verify steps), masks within
    2e-4 (2**-4 of the largest with the SAM head in bf16) and boxes and
    presence logits within 1e-4. At the tiny config: greedy over bf16-path
    caches, then over W8A16 weights speculative, greedy with an int8 KV
    cache, both together, W8A8 decode and prefill, the SAM head in bf16,
    chunked prefill greedy and speculative in both modes. At the W4-capable
    widths (hidden 256, intermediate 512, 2 layers, 4 heads; tiny ViT and
    SAM): W4A16 with the split-int8 read, instance SAM and chunked prefill."""
    from mmmm_tpu_torch import MMMMConfig, generate_grounded, init_params
    from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
    from mmmm_tpu_torch.models.cogvlm.config import CogVLMConfig, VisionConfig
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops.quant import quantize_llm_for_serving

    log("tiny reference: card vs CPU")
    tok = MMMMTokenizer.byte_fallback()
    cfg = MMMMConfig.tiny(vocab_size=len(tok))
    params = init_params(cfg, 0, torch.float32, "cpu")
    qparams = dict(params, cogvlm=quantize_llm_for_serving(params["cogvlm"],
                                                           release_originals=False))
    rng = np.random.default_rng(0)
    n_vis, b = 18, 3
    lens = [1 + n_vis + t for t in (5, 9, 7)]
    s = max(lens)
    ids, tt, pos = (np.zeros((b, s), np.int32) for _ in range(3))
    for i, n in enumerate(lens):
        text = n - 1 - n_vis
        ids[i, :n] = np.concatenate([[1], np.full(n_vis, 3), rng.integers(4, 250, size=text)])
        tt[i, 1:1 + n_vis] = 1
        pos[i, :n] = np.concatenate([[0, 1], np.full(n_vis - 2, 2), [3], np.arange(4, 4 + text)])
    img = rng.normal(size=(b, 3, 4, 16, 16)).astype(np.float32)
    gimg = rng.normal(size=(b, 3, 4, 16, 16)).astype(np.float32)
    args = (cfg, tok, ids, tt, pos, np.asarray(lens), img, (4, 4, 4), (1, 1, 1))
    kw = dict(max_new_tokens=8, max_targets=2, grounding_image=gimg, force_grounding=True,
              vis_span=(1, 1 + n_vis))
    w4cfg = MMMMConfig(vlm=CogVLMConfig(vocab_size=len(tok), hidden_size=256,
                                        intermediate_size=512, num_hidden_layers=2,
                                        num_attention_heads=4, max_position_embeddings=256,
                                        vision=VisionConfig.tiny()),
                       sam=SamConfig.tiny())
    w4params = init_params(w4cfg, 0, torch.float32, "cpu")
    w4params["cogvlm"] = quantize_llm_for_serving(w4params["cogvlm"], bits=4)
    out = {}
    for label, c, tree, extra in [
            ("greedy bf16 weights", cfg, params, {}),
            ("spec 3, W8A16", cfg, qparams, dict(spec_draft_len=3)),
            ("greedy int8 KV, W8A16", cfg, qparams, dict(kv_cache_dtype="int8")),
            ("spec 7 int8 KV, W8A16", cfg, qparams, dict(spec_draft_len=7, kv_cache_dtype="int8")),
            ("greedy int8 KV, W8A8 decode", cfg, qparams, dict(kv_cache_dtype="int8", w8a8=True)),
            ("greedy, W8A8 prefill", cfg, qparams, dict(w8a8_prefill=True)),
            ("greedy, SAM head in bf16", cfg, params, dict(sam_bf16=True)),
            ("greedy chunk 2 all, W8A16", cfg, qparams, dict(prefill_chunk=2)),
            ("greedy chunk 2 vit, W8A16", cfg, qparams, dict(prefill_chunk=2, chunk_mode="vit")),
            ("spec 3 chunk 2 all, W8A16", cfg, qparams, dict(spec_draft_len=3, prefill_chunk=2)),
            ("spec 3 chunk 2 vit, W8A16", cfg, qparams, dict(spec_draft_len=3, prefill_chunk=2,
                                                             chunk_mode="vit")),
            ("W4A16, split-int8 KV read, instance, chunk 2", w4cfg, w4params,
             dict(kv_cache_dtype="int8", q8_mxu=True, instance=True, prefill_chunk=2))]:
        run_args = (c, *args[1:])
        ref = generate_grounded(tree, *run_args, device="cpu", **kw, **extra)
        got = generate_grounded(_tree_to(tree, "cuda"), *run_args, device="cuda", **kw, **extra)
        if not np.array_equal(got.tokens, ref.tokens):
            raise AssertionError(f"tiny {label}: tokens differ\n{got.tokens}\n{ref.tokens}")
        if (got.spec_stats or {}).get("iters") != (ref.spec_stats or {}).get("iters"):
            raise AssertionError(f"tiny {label}: {got.spec_stats} vs {ref.spec_stats}")
        r = {"tokens_equal": True, "spec_stats": got.spec_stats}
        if extra.get("instance"):
            r["boxes_max_abs_err"] = max_err(got.boxes.cpu(), ref.boxes)
            r["disc_logit_max_abs_err"] = max_err(got.disc_logit.cpu(), ref.disc_logit)
            check(f"tiny {label}: tokens equal, boxes (card vs CPU)", r["boxes_max_abs_err"],
                  1e-4)
            check(f"tiny {label}: presence logits (card vs CPU)", r["disc_logit_max_abs_err"],
                  1e-4)
        else:
            r["masks_max_abs_err"] = max_err(got.masks.cpu(), ref.masks)
            # a bf16 head rounds at other places on the card: 2**-4 of the
            # largest mask logit (about eight bf16 steps there)
            tol = 2 ** -4 * ref.masks.float().abs().max().item() if extra.get("sam_bf16") else 2e-4
            check(f"tiny {label}: tokens equal, masks (card vs CPU)", r["masks_max_abs_err"], tol)
        out[label] = r
    return out


def _tiny_train_batch(mode: str, b: int = 2, s: int = 32, n_vis: int = 18, targets: int = 2,
                      lmax: int = 6) -> dict:
    """The training batch of ``scripts/bench_train.py --config tiny``'s layout
    at B=2, S=32: a (3, 4, 16, 16) image whose 18 vision tokens sit at
    [1, 19), 2 grounding targets, instance boxes with Lmax 6."""
    rng = np.random.default_rng(0)
    tt = np.zeros((b, s), np.int32)
    tt[:, 1:1 + n_vis] = 1
    labels = np.full((b, s), -100, np.int32)
    labels[:, n_vis + 2:] = rng.integers(4, 120, size=(b, s - n_vis - 2))
    batch = {"input_ids": rng.integers(4, 120, size=(b, s)).astype(np.int32),
             "token_type_ids": tt, "position_ids": np.tile(np.arange(s, dtype=np.int32), (b, 1)),
             "attention_mask": np.ones((b, s), np.int32), "labels": labels,
             "weight": rng.uniform(0.5, 1.5, size=(b, s)).astype(np.float32),
             "image": rng.normal(size=(b, 3, 4, 16, 16)).astype(np.float32),
             "patch_size": (4, 4, 4), "pool_size": (1, 1, 1)}
    if mode != "none":
        batch["grounding_image"] = rng.normal(size=(b, 3, 4, 16, 16)).astype(np.float32)
        batch["vg_positions"] = rng.integers(n_vis + 2, s - 1, size=(b, targets)).astype(np.int32)
        batch["vg_valid"] = np.ones((b, targets), bool)
    if mode == "semantic":
        batch["masks"] = rng.uniform(size=(b, targets, 4, 16, 16)) > 0.8
    if mode == "instance":
        batch["boxes_label"] = rng.uniform(0.2, 0.8, size=(b, lmax, 6)).astype(np.float32)
        offs = np.zeros((b, targets, 2), np.int32)
        offs[:, 0] = (0, 2)
        offs[:, 1:] = (2, 2)
        batch["index_offsets"] = offs
    return batch


def _state_to(state, device):
    """A copy of a port TrainState on ``device``."""
    from mmmm_tpu_torch.train import TrainState

    copy = lambda tree: {k: copy(v) if isinstance(v, dict) else
                         v.detach().to(device, copy=True) for k, v in tree.items()}
    trainable = copy(state.trainable)
    for t in _flat_values(trainable):
        t.requires_grad_(True)
    opt = {"count": state.opt_state["count"], "mu": copy(state.opt_state["mu"]),
           "nu": copy(state.opt_state["nu"])}
    return TrainState(state.step, trainable, opt)


def tiny_train_phase():
    """The LoRA training step at ``MMMMConfig.tiny()`` in fp32 under
    ``attn_impl="pallas"`` (K3 forward, K7 backward on the card), 3 steps in
    each ``vg_mode`` from one CPU-made state, on the card and on the CPU
    (plain versions), with LoRA dropout and warmup 1. Along each trajectory
    the loss within 1e-5 relative; one card step from the CPU state before
    each step: every parameter within 2 * lr, the gradient norm within 1e-5
    relative and every leaf of Adam's first moment within 1e-4 of its
    largest magnitude plus 1e-6 of the largest over all leaves (the
    tolerances of tests/test_torch_port_train.py)."""
    from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, init_params,
                                init_train_state, make_optimizer, make_train_step)
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.peft.lora import flatten

    log("tiny training step: card vs CPU")
    cfg = MMMMConfig.tiny()
    lr = 1e-3
    opt = make_optimizer(OptimizerConfig(lr=lr, warmup_steps=1, max_steps=10))
    lcfg = LoraConfig(r=4, alpha=8.0)
    params = init_params(cfg, 0, torch.float32, "cpu")
    out = {}
    for mode in ("none", "semantic", "instance"):
        batch = _tiny_train_batch(mode)
        steps = {d: make_train_step(cfg, opt, lcfg, vg_mode=mode, attn_impl="pallas", remat=True,
                                    vis_span="auto", device=d) for d in ("cpu", "cuda")}
        cpu, _ = init_train_state(cfg, opt, lcfg, device="cpu", params=params)
        frozen = {"cpu": init_train_state(cfg, opt, lcfg, device="cpu", params=params)[1]}
        frozen["cuda"] = _tree_to(frozen["cpu"], "cuda")
        card = _state_to(cpu, "cuda")
        before = {n: k.launches for n, k in KERNELS.items()}
        r = {"loss_rel_err": [], "grad_norm_rel_err": [], "param_max_abs_err": [],
             "mu_err_over_tol": []}
        for i in range(3):
            start = _state_to(cpu, "cuda")
            cpu, lc = steps["cpu"](cpu, frozen["cpu"], batch)
            card, lg = steps["cuda"](card, frozen["cuda"], batch)
            fresh, lf = steps["cuda"](start, frozen["cuda"], batch)
            key = "loss" if "loss" in lc else "lm_loss"
            rel = lambda a, b: abs(float(a) - float(b)) / abs(float(b))
            r["loss_rel_err"].append(rel(lg[key], lc[key]))
            r["grad_norm_rel_err"].append(rel(lf["grad_norm"], lc["grad_norm"]))
            pc, pg = flatten(cpu.trainable), flatten(fresh.trainable)
            r["param_max_abs_err"].append(max(max_err(pg[p].detach().cpu(), t.detach())
                                              for p, t in pc.items()))
            mu = cpu.opt_state["mu"]
            floor = 1e-6 * max(t.abs().max().item() for t in mu.values())
            err = {p: max_err(fresh.opt_state["mu"][p].cpu(), t) for p, t in mu.items()}
            ratio = {p: err[p] / (1e-4 * t.abs().max().item() + floor) for p, t in mu.items()}
            worst = max(ratio, key=ratio.get)
            r["mu_err_over_tol"].append(ratio[worst])
            r.setdefault("mu_worst_leaf", []).append(worst)
            # the readings without the floor (none where the CPU leaf is all
            # 0), and the leaves that pass only with it
            bare = {p: err[p] / (1e-4 * t.abs().max().item()) for p, t in mu.items()
                    if t.abs().max().item() > 0}
            bare_worst = max(bare, key=bare.get)
            r.setdefault("mu_worst_leaf_no_floor", []).append(bare.get(worst))
            r.setdefault("mu_over_1_no_floor", []).append(
                {p: bare.get(p) for p in mu if bare.get(p, 2.0) > 1})
            log(f"  tiny train {mode} step {i + 1}: Adam mu without the floor, worst "
                f"{bare_worst} at {bare[bare_worst]:.4e} of 1e-4 of its largest; {worst} at "
                f"{bare.get(worst, float('nan')):.4e}")
            check(f"tiny train {mode} step {i + 1} loss (relative)", r["loss_rel_err"][-1], 1e-5)
            check(f"tiny train {mode} step {i + 1} grad_norm (relative)",
                  r["grad_norm_rel_err"][-1], 1e-5)
            check(f"tiny train {mode} step {i + 1} Adam mu (error over tolerance; worst "
                  f"{worst})", r["mu_err_over_tol"][-1], 1.0)
            check(f"tiny train {mode} step {i + 1} parameters", r["param_max_abs_err"][-1],
                  2 * lr)
        r["launches"] = {n: k.launches - before[n] for n, k in KERNELS.items()
                         if k.launches != before[n]}
        log(f"  tiny train {mode}: launches {r['launches']}")
        for name in ("K3", "K7dq", "K7dkv", "K7delta"):
            if not r["launches"].get(name):
                raise AssertionError(f"tiny train {mode}: {name} was not launched")
        out[mode] = r
    return out


def flagship_phase(gen):
    """Runs (a)-(d) at the flagship width; returns their results and each
    run's launch counts."""
    from mmmm_tpu_torch import MMMMConfig, generate_grounded, init_params
    from mmmm_tpu_torch.data.tokenizer import SPECIAL_TOKENS, MMMMTokenizer, _ByteBackend
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.ops.quant import quantize_llm_for_serving

    log("flagship grounded report path")
    cfg = MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())
    tok = MMMMTokenizer(_ByteBackend(), {t: 32000 + i for i, t in enumerate(SPECIAL_TOKENS)})
    def make_params():
        params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
        # bias the <p>/</p> head columns so the random model writes tag pairs
        head = params["cogvlm"]["llm"]["lm_head"]
        head[:, tok.bop_token_id] += 3.8
        head[:, tok.eop_token_id] += 3.6
        return params

    t0 = time.perf_counter()
    params = make_params()
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in _flat_values(params))
    init_s = time.perf_counter() - t0
    log(f"  init_params: {n_params / 1e9:.3f} B params in {init_s:.3f} s, "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")

    dev = torch.device("cuda")
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 32000, size=(B, PROMPT)).astype(np.int32)
    tt = np.zeros((B, PROMPT), np.int32)
    tt[:, 1:1 + N_VIS] = 1
    pos = np.concatenate([[0, 1], np.full(N_VIS - 2, 2), [3, 4],
                          5 + np.arange(PROMPT - N_VIS - 2)]).astype(np.int32)
    pos = np.broadcast_to(pos, (B, PROMPT)).copy()
    lens = np.full((B,), PROMPT, np.int32)
    image = torch.randn((B, 3, 32, 384, 384), generator=gen, device=dev).to(torch.bfloat16)
    gimg = torch.randn((B, 3, 32, 256, 256), generator=gen, device=dev)
    out = {"init_s": init_s, "params_b": n_params / 1e9, "runs": {}}
    all_launches = {}

    for label, spec in RUNS.items():
        if label == "b_spec7_w8a16":
            t0 = time.perf_counter()
            params["cogvlm"] = quantize_llm_for_serving(params["cogvlm"])
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            out["quantize_s"] = time.perf_counter() - t0
            log(f"  LLM quantized in place to W8A16 in {out['quantize_s']:.3f} s, "
                f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        if label == "d_w4_q8mxu_chunk2":
            # int4 needs the bf16 originals, which the W8A16 transform released:
            # make the model again from the seed, then quantize it to 4 bits
            t0 = time.perf_counter()
            params = None
            torch.cuda.empty_cache()
            params = make_params()
            params["cogvlm"] = quantize_llm_for_serving(params["cogvlm"], bits=4)
            torch.cuda.synchronize()
            torch.cuda.empty_cache()
            out["quantize4_s"] = time.perf_counter() - t0
            log(f"  model made again and its LLM quantized to W4A16 in {out['quantize4_s']:.3f} "
                f"s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")

        def run(kw=spec["kw"]):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = generate_grounded(params, cfg, tok, ids, tt, pos, lens, image, (16, 16, 16),
                                    (2, 2, 2), max_new_tokens=NEW, max_targets=TARGETS,
                                    grounding_image=gimg, force_grounding=True,
                                    vis_span=(1, 1 + N_VIS), device="cuda", **kw)
            torch.cuda.synchronize()
            return res, time.perf_counter() - t

        log(f"  run {label} {spec['kw']}")
        _, first_s = run()
        log(f"    first run (warm-up): {first_s:.3f} s")
        torch.cuda.reset_peak_memory_stats()
        for kern in KERNELS.values():
            kern.launches = 0
        res, steady_s = run()
        launches = {name: kern.launches for name, kern in KERNELS.items()}
        peak = torch.cuda.max_memory_allocated()
        iters = res.spec_stats["iters"] if res.spec_stats else NEW
        tps = res.spec_stats["tokens_per_step"] if res.spec_stats else 1.0
        log(f"    steady run: {steady_s:.3f} s, {B / steady_s:.4f} reports/s, "
            f"tokens_per_step {tps:.4f} ({iters} decode steps), peak memory "
            f"{peak / 2**30:.2f} GiB, launches {launches}")
        want = {name: 0 for name in KERNELS}
        want.update({k: LAYERS * iters if v == "iters" else v
                     for k, v in spec["launches"].items()})
        for name, n in want.items():
            if launches[name] != n:
                raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                     f"expected {n}")
        if spec["kw"].get("instance"):
            k = cfg.sam.num_mask_tokens - 1
            bx, dl = res.boxes, res.disc_logit
            if (tuple(bx.shape) != (B, TARGETS, k, 6) or tuple(dl.shape) != (B, TARGETS, k)
                    or not torch.isfinite(dl).all() or not ((bx >= 0) & (bx <= 1)).all()):
                raise AssertionError(f"{label} boxes {tuple(bx.shape)} / presence logits "
                                     f"{tuple(dl.shape)}: bad shape or values")
        else:
            m = res.masks
            if tuple(m.shape) != (B, TARGETS, 32, 256, 256) or not torch.isfinite(m).all():
                raise AssertionError(f"{label} masks: shape {tuple(m.shape)} or non-finite values")
        if (res.tokens.shape != (B, NEW) or not (res.tokens >= 0).all()
                or not (res.tokens < 32008).all()):
            raise AssertionError(f"{label} tokens: bad shape or ids {res.tokens.shape}")
        log(f"    tokens[0][:24] {res.tokens[0][:24].tolist()} num_generated "
            f"{res.num_generated.tolist()} targets "
            f"{[None if t is None else len(t) for t in res.targets]}")
        r = {"first_run_s": first_s, "steady_run_s": steady_s, "reports_per_s": B / steady_s,
             "tokens_per_step": tps, "decode_steps": iters, "peak_mem_gib": peak / 2**30,
             "launches": launches, "num_generated": res.num_generated.tolist()}
        r["profile"] = profile_run(run)
        r["profile"].pop("result")
        # device busy time over the profiled run's wall, and over the steady
        # (unprofiled) run's wall, which the profiler does not slow
        r["busy_share_profiled"] = r["profile"]["kernels_busy_s"] / r["profile"]["wall_s"]
        r["busy_share_steady"] = r["profile"]["kernels_busy_s"] / steady_s
        log(f"    device busy share: {r['busy_share_steady']:.4f} of the steady run, "
            f"{r['busy_share_profiled']:.4f} of the profiled run")
        out["runs"][label] = r
        all_launches[label] = launches
    return out, all_launches


def flagship_train_batch(mode: str, gen) -> dict:
    """``scripts/bench_train.py``'s batch at the flagship: B=4, S=1024, 146
    vision tokens at [1, 147) from a constant (3, 16, 384, 384) fp32 image
    (patch 16, pool (1, 2, 2)), so the ViT runs in fp32 over its bf16
    weights as the reference promotes them, labels past the vision span;
    grounding: a constant (3, 32, 256, 256) fp32 image, 4 targets, random
    semantic masks or instance boxes with Lmax 6 (target 0 two boxes, the
    rest none). Token ids and labels are random."""
    dev = torch.device("cuda")
    b, s, nv = B, TRAIN_SEQ, N_VIS
    rng = np.random.default_rng(0)
    tt = torch.zeros((b, s), dtype=torch.int32, device=dev)
    tt[:, 1:1 + nv] = 1
    labels = torch.full((b, s), -100, dtype=torch.int32, device=dev)
    labels[:, nv + 2:] = torch.from_numpy(rng.integers(4, 32000, size=(b, s - nv - 2))
                                          .astype(np.int32)).to(dev)
    batch = {
        "input_ids": torch.from_numpy(rng.integers(4, 32000, size=(b, s)).astype(np.int32)).to(dev),
        "token_type_ids": tt,
        "position_ids": torch.arange(s, dtype=torch.int32, device=dev).expand(b, s).contiguous(),
        "attention_mask": torch.ones((b, s), dtype=torch.int32, device=dev),
        "labels": labels, "weight": torch.ones((b, s), device=dev),
        # bench_train.py's constant image: over a random image the random
        # 63-layer post-norm ViT's gradients grow layer by layer and explode
        "image": torch.ones((b, 3, 16, 384, 384), device=dev),
        "patch_size": (16, 16, 16), "pool_size": (1, 2, 2),
    }
    if mode == "none":
        return batch
    batch["grounding_image"] = torch.ones((b, 3, 32, 256, 256), device=dev)
    batch["vg_positions"] = torch.from_numpy(
        rng.integers(nv + 2, s - 1, size=(b, TARGETS)).astype(np.int32)).to(dev)
    batch["vg_valid"] = torch.ones((b, TARGETS), dtype=torch.bool, device=dev)
    if mode == "semantic":
        batch["masks"] = torch.rand((b, TARGETS, 32, 256, 256), generator=gen, device=dev) > 0.8
    else:
        batch["boxes_label"] = 0.2 + 0.6 * torch.rand((b, LMAX, 6), generator=gen, device=dev)
        offs = torch.zeros((b, TARGETS, 2), dtype=torch.int32, device=dev)
        offs[:, 0, 1] = 2
        offs[:, 1:] = 2
        batch["index_offsets"] = offs
    return batch


TRAIN_STAGES = ("vit", "llm_forward", "ce", "sam_loss", "backward", "optimizer")


def flagship_train_phase(gen):
    """The LoRA training step at the flagship's full width and depth (32 LLM,
    63 ViT, 12 SAM encoder layers) from seed 0: frozen CogVLM in bf16,
    ``bf16_vlm`` (the LLM in bf16; the ViT in fp32 over the batch's fp32
    image), LoRA r=64 alpha 8 rsLoRA (dropout 0.05), AdamW lr 5e-5
    with warmup 1, ``remat=True``, ``vis_span="auto"``,
    ``attn_impl="pallas"``. Three steps in each ``vg_mode``, each with
    exact launch counts (K3 twice and K7dq, K7dkv once a flash site: 32 +
    63, plus 12 with grounding); the third profiled by stage. In semantic
    mode one ``"xla"`` step from the state before step 3 must give its loss
    within 1e-2 and its gradient norm within 5e-2, relative."""
    from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, init_train_state,
                                make_optimizer, make_train_step)
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.peft.lora import flatten

    log("flagship LoRA training step")
    cfg = MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())
    opt = make_optimizer(OptimizerConfig(lr=5e-5, warmup_steps=1, max_steps=1000))
    lcfg = LoraConfig(r=64, alpha=8.0)
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    state, frozen = init_train_state(cfg, opt, lcfg, seed=0, frozen_vlm_bf16=True, device="cuda")
    torch.cuda.synchronize()
    nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
    sizes = {"frozen_gib": nbytes(_flat_values(frozen)) / 2**30,
             "trainable_gib": nbytes(_flat_values(state.trainable)) / 2**30,
             "grads_gib": nbytes(_flat_values(state.trainable)) / 2**30,
             "adam_gib": nbytes([*state.opt_state["mu"].values(),
                                 *state.opt_state["nu"].values()]) / 2**30,
             "trainable_params_m": sum(t.numel() for t in _flat_values(state.trainable)) / 1e6,
             "lora_params_m": sum(t.numel() for t in _flat_values(state.trainable["lora"])) / 1e6}
    out = {"init_s": time.perf_counter() - t0, "sizes": sizes, "modes": {}}
    log(f"  init_train_state: {out['init_s']:.3f} s; {sizes}; allocated "
        f"{torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    launches_by_mode = {}
    for mode in ("none", "semantic", "instance"):
        batch = flagship_train_batch(mode, gen)
        step = make_train_step(cfg, opt, lcfg, vg_mode=mode, bf16_vlm=True, attn_impl="pallas",
                               remat=True, vis_span="auto", device="cuda")
        sites = LAYERS + VIT_LAYERS + (SAM_LAYERS if mode != "none" else 0)
        want = {name: 0 for name in KERNELS}
        want.update({"K3": 2 * sites, "K7dq": sites, "K7dkv": sites, "K7delta": sites})
        r = {"steps": [], "sites": sites}
        torch.cuda.reset_peak_memory_stats()
        for i in range(TRAIN_STEPS):
            if mode == "semantic" and i == TRAIN_STEPS - 1:
                snapshot = _state_to(state, "cuda")
            for kern in KERNELS.values():
                kern.launches = 0
            run = lambda: _timed_step(step, state, frozen, batch)
            if i < TRAIN_STEPS - 1:
                logs, wall = run()
                prof = None
            else:
                prof = profile_run(run, stages=TRAIN_STAGES)
                logs, wall = prof.pop("result"), prof["wall_s"]
            launches = {name: kern.launches for name, kern in KERNELS.items()}
            for name, n in want.items():
                if launches[name] != n:
                    raise AssertionError(f"train {mode} step {i + 1}: {name} launched "
                                         f"{launches[name]} times, expected {n}")
            vals = {k: float(v) for k, v in logs.items()}
            if not all(np.isfinite(list(vals.values()))) or vals["grad_norm"] <= 0:
                raise AssertionError(f"train {mode} step {i + 1}: bad logs {vals}")
            r["steps"].append({"wall_s": wall, "logs": vals, "launches": {
                k: v for k, v in launches.items() if v}, "profiled": prof is not None})
            log(f"  train {mode} step {i + 1}: {wall:.3f} s{' (profiled)' if prof else ''}, "
                f"{vals}, launches {r['steps'][-1]['launches']}")
        r["steady_step_s"] = r["steps"][1]["wall_s"]
        r["tokens_per_s"] = B * TRAIN_SEQ / r["steady_step_s"]
        r["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        # the autograd engine runs the backward on its own thread, outside the
        # "backward" span on the device: its kernels are the rest of the busy time
        st = prof["stages"]
        prof["backward_kernels_ms"] = prof["kernels_busy_s"] * 1e3 - sum(
            st[n]["kernels_ms"] or 0.0 for n in TRAIN_STAGES if n != "backward")
        r["profile"] = prof
        r["busy_share_steady"] = prof["kernels_busy_s"] / r["steady_step_s"]
        r["busy_share_profiled"] = prof["kernels_busy_s"] / prof["wall_s"]
        log(f"  train {mode}: steady step {r['steady_step_s']:.3f} s "
            f"({r['tokens_per_s']:.1f} tokens/s), peak {r['peak_mem_gib']:.2f} GiB, busy share "
            f"{r['busy_share_steady']:.4f} of the steady step, backward kernels "
            f"{prof['backward_kernels_ms']:.1f} ms")
        if mode == "semantic":
            xla_step = make_train_step(cfg, opt, lcfg, vg_mode=mode, bf16_vlm=True,
                                       attn_impl="xla", remat=True, vis_span="auto",
                                       device="cuda")
            for kern in KERNELS.values():
                kern.launches = 0
            torch.cuda.reset_peak_memory_stats()
            xlogs, xwall = _timed_step(xla_step, snapshot, frozen, batch)
            xlaunch = {k: v.launches for k, v in KERNELS.items() if v.launches}
            ref = r["steps"][-1]["logs"]
            xv = {k: float(v) for k, v in xlogs.items()}
            r["xla_step"] = {"wall_s": xwall, "logs": xv, "launches": xlaunch,
                             "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                             "loss_rel_err": abs(xv["loss"] - ref["loss"]) / abs(ref["loss"]),
                             "grad_norm_rel_err": abs(xv["grad_norm"] - ref["grad_norm"])
                             / abs(ref["grad_norm"])}
            log(f"  train semantic, one \"xla\" step from the state before step 3: "
                f"{xwall:.3f} s, peak {r['xla_step']['peak_mem_gib']:.2f} GiB, {xv}, "
                f"launches {xlaunch}")
            check("xla vs pallas step loss (relative)", r["xla_step"]["loss_rel_err"], 1e-2)
            check("xla vs pallas step gradient norm (relative)",
                  r["xla_step"]["grad_norm_rel_err"], 5e-2)
            del snapshot
        out["modes"][mode] = r
        launches_by_mode[f"train_{mode}"] = r["steps"][1]["launches"]
        del batch
        torch.cuda.empty_cache()
    return out, launches_by_mode


ROUTE_LAYERS = 8  # LLM and ViT layers of train_route_phase's cut-depth flagship
# the seeds of the route phase's models and batches, and the most the kernels'
# bf16 gradients may stand from fp32 over the plain route's distance: just
# above the largest of these seeds' readings (PERF.md, PR 4)
ROUTE_SEEDS, ROUTE_RATIO_LIMIT = (0, 1, 2, 3), 1.05


def train_route_phase():
    """``train_route_phase_seed`` over ``ROUTE_SEEDS``; the bf16 distance
    ratio of each seed is recorded and held to ``ROUTE_RATIO_LIMIT``."""
    out = {"seeds": {}}
    for seed in ROUTE_SEEDS:
        out["seeds"][seed] = train_route_phase_seed(seed)
        torch.cuda.empty_cache()
    out["ratios"] = [r["bf16_distance_ratio"] for r in out["seeds"].values()]
    log(f"  bf16 distance ratios (pallas over xla) by seed: {out['ratios']}")
    return out


def train_route_phase_seed(seed: int):
    """The attention routes held to each other in fp32, where rounding does
    not hide a fault: the flagship at full width with its depth cut to 8 LLM
    and 8 ViT layers (all 12 SAM encoder layers), the semantic training
    batch of the flagship run, LoRA ``b`` set nonzero so every factor takes
    a gradient, the frozen weights bf16 values. The loss and the gradients
    of every trainable leaf are taken four ways: fp32 (frozen weights cast
    up, fp32 image) and bf16 (``bf16_vlm``, a bf16 image, so the ViT sites
    run the bf16 kernels that the flagship run's fp32 image does not), each
    under ``"xla"`` (plain PyTorch) and ``"pallas"`` (K3 and K7 at every site),
    ``remat=True``. fp32 ``"pallas"`` must give the fp32 ``"xla"`` loss
    within 1e-5 and each group's gradient (LLM LoRA, ViT LoRA, GLU LoRA,
    ``lm_head`` LoRA, ``embed_tokens``, SAM, ``vg_proj``) within 1e-3 of its
    norm; each bf16 route's distance from the fp32 gradients is recorded,
    and the kernels' route may stand at most ``ROUTE_RATIO_LIMIT`` times as
    far as the plain route. Launches: exact, K3 twice and K7 once a site.
    ``seed`` makes the model, the LoRA ``b`` and the masks."""
    import dataclasses
    from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, init_train_state,
                                make_optimizer)
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.mmmm import training_step
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.peft.lora import flatten, unflatten
    from mmmm_tpu_torch.train.step import effective_params

    log(f"attention routes in fp32 and bf16 (flagship width, {ROUTE_LAYERS} LLM and ViT layers, "
        f"seed {seed})")
    base = CogVLMConfig.cogvlm17b()
    cfg = MMMMConfig(vlm=dataclasses.replace(
        base, num_hidden_layers=ROUTE_LAYERS,
        vision=dataclasses.replace(base.vision, num_hidden_layers=ROUTE_LAYERS)), sam=SamConfig())
    lcfg = LoraConfig(r=64, alpha=8.0)
    state, frozen = init_train_state(cfg, make_optimizer(OptimizerConfig()), lcfg, seed=seed,
                                     frozen_vlm_bf16=True, device="cuda")
    gen = torch.Generator(device="cuda").manual_seed(seed + 1)
    with torch.no_grad():
        for path, t in flatten(state.trainable["lora"]).items():
            if path.endswith("/b"):
                t.copy_(torch.randn(t.shape, generator=gen, device="cuda") * 1e-3)
        emb = state.trainable["ft"]["cogvlm"]["llm"]["embed_tokens"]
        emb.copy_(emb.to(torch.bfloat16).float())  # a bf16 value, as the frozen weights
    frozen32 = dict(frozen, cogvlm=unflatten({p: t.float() if t.is_floating_point() else t
                                              for p, t in flatten(frozen["cogvlm"]).items()}))
    batch = flagship_train_batch("semantic", torch.Generator(device="cuda").manual_seed(seed))
    flat = flatten(state.trainable)
    sites = 2 * ROUTE_LAYERS + SAM_LAYERS
    group = lambda p: "/".join(p.split("/")[:4 if p.startswith("lora/") else 3])

    def grads(bf16: bool, impl: str):
        params = effective_params(state.trainable, frozen if bf16 else frozen32, lcfg, bf16)
        b = dict(batch, image=batch["image"].to(torch.bfloat16 if bf16 else torch.float32))
        for kern in KERNELS.values():
            kern.launches = 0
        loss, _ = training_step(params, cfg, b, vg_mode="semantic", attn_impl=impl, remat=True,
                                vis_span="auto")
        g = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
        want = ({"K3": 2 * sites, "K7dq": sites, "K7dkv": sites, "K7delta": sites}
                if impl == "pallas" else {})
        if launches != want:
            raise AssertionError(f"routes {impl}: launches {launches}, expected {want}")
        return float(loss.detach()), {p: torch.zeros_like(t) if x is None else x.detach().float()
                             for (p, t), x in zip(flat.items(), g)}

    def distance(got, ref):
        """Per group and over all leaves: |got - ref| / |ref|."""
        acc = {}
        for p, r in ref.items():
            d = acc.setdefault(group(p), [0.0, 0.0])
            d[0] += (got[p] - r).square().sum().item()
            d[1] += r.square().sum().item()
        out = {k: (d / n) ** 0.5 for k, (d, n) in acc.items() if n > 0}
        out["all"] = (sum(d for d, _ in acc.values()) / sum(n for _, n in acc.values())) ** 0.5
        return out

    loss32, ref = grads(False, "xla")
    r = {"layers": ROUTE_LAYERS, "sites": sites, "seed": seed, "loss": {"fp32_xla": loss32},
         "grad_distance": {}}
    for bf16, impl in ((False, "pallas"), (True, "xla"), (True, "pallas")):
        key = f"{'bf16' if bf16 else 'fp32'}_{impl}"
        r["loss"][key], g = grads(bf16, impl)
        r["grad_distance"][key] = distance(g, ref)
        del g
        log(f"  {key}: loss {r['loss'][key]:.6f} (fp32 xla {loss32:.6f}); gradient distance "
            f"from fp32 xla " + ", ".join(f"{k} {v:.3e}" for k, v in
                                          sorted(r["grad_distance"][key].items())))
    check("routes fp32 pallas vs xla loss (relative)",
          abs(r["loss"]["fp32_pallas"] - loss32) / abs(loss32), 1e-5)
    check("routes fp32 pallas vs xla gradient (worst group, relative to its norm)",
          max(r["grad_distance"]["fp32_pallas"].values()), 1e-3)
    dist = r["grad_distance"]
    r["bf16_distance_ratio"] = dist["bf16_pallas"]["all"] / dist["bf16_xla"]["all"]
    check("routes bf16: pallas's gradient distance from fp32 over xla's",
          r["bf16_distance_ratio"], ROUTE_RATIO_LIMIT)
    return r


def _timed_step(step, state, frozen, batch):
    gc.collect()  # the serving phase's garbage is not the step's cost
    torch.cuda.synchronize()
    t = time.perf_counter()
    _, logs = step(state, frozen, batch)
    torch.cuda.synchronize()
    return logs, time.perf_counter() - t


def _flat_values(tree):
    for v in tree.values():
        if isinstance(v, dict):
            yield from _flat_values(v)
        else:
            yield v


# profiler spans of generate_grounded's stages (record_function names)
STAGES = ("vit", "llm_prefill", "decode", "sam")
KERNEL_GROUPS = (  # (label, substrings of a kernel name), first match wins
    ("K4 dense attention", ("attn_mma_kernel<112, false", "attn_tile_kernel<float, 8, false>")),
    ("K3 flash forward", ("attn_mma_kernel<128, true", "attn_mma_kernel<112, true",
                          "attn_tile_kernel<float, 8, true>", "attn_tile_kernel<float, 14, true>")),
    ("K7delta rowsum", ("flash_bwd_delta",)),
    ("K7dq flash backward", ("flash_bwd_dq",)),
    ("K7dkv flash backward", ("flash_bwd_dkv",)),
    ("K1 decode attention", ("decode_attn_kernel",)),
    ("K6 window attention", ("decode_window_kernel",)),
    ("K9 int8 decode attention", ("decode_q8_kernel",)),
    ("K10 split-int8 decode attention", ("decode_q8_mxu_kernel",)),
    ("K11 W4A16 GEMV", ("w4_gemv_kernel", "w4_sum_groups_kernel")),
    ("K11mma W4A16 tiles", ("w4_mma_kernel",)),
    ("K5 window append", ("kv_append_multi_kernel",)),
    ("K8 int8 append", ("kv_append_q8_kernel",)),
    ("K2 KV append", ("kv_append_kernel",)),
    ("GEMM (cuBLAS)", ("nvjet", "gemm", "cutlass", "sm90_xmma", "splitK")),
    ("elementwise / reduce / copy", ("at::native",)),
)


def profile_run(run, stages=STAGES):
    """Device time by kernel group; host time, device span and kernel time by
    stage (``record_function`` spans named ``stages``); and the device's
    busy share of the run's wall time, over one more run (``run()`` returns
    ``(result, wall seconds)``; the result is kept under ``"result"``).
    Reads the profiler's raw events: building its per-op event tree takes
    about a minute a million events, the raw list a second."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result, wall_s = run()
    t0 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    # (name, device type, start us, duration us) of every event
    events = [(e.name(), e.device_type(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
              for e in raw]
    kernels = [e for e in events if e[1] == DeviceType.CUDA and e[0] not in stages]
    by_name: dict[str, list] = {}
    for name, _, _, us in kernels:
        acc = by_name.setdefault(name, [0.0, 0])
        acc[0] += us
        acc[1] += 1
    busy_us = sum(us for us, _ in by_name.values())
    groups: dict[str, list] = {}
    for name, (us, n) in by_name.items():
        label = next((g for g, keys in KERNEL_GROUPS if any(k in name for k in keys)), "other")
        acc = groups.setdefault(label, [0.0, 0])
        acc[0] += us
        acc[1] += n
    log(f"  profile: wall {wall_s:.3f} s (profiled run), kernels busy {busy_us / 1e6:.3f} s "
        f"({100 * busy_us / 1e6 / wall_s:.1f}% of wall), {len(events)} events")
    # a stage's span is recorded on the host (its CPU time) and on the device
    # timeline (first to last of its kernels); the kernels that start inside
    # the device span give the stage's busy time
    host_span = {e[0]: e for e in events if e[0] in stages and e[1] == DeviceType.CPU}
    device_span = {e[0]: e for e in events if e[0] in stages and e[1] == DeviceType.CUDA}
    starts = sorted((start, us) for _, _, start, us in kernels)
    stage_times = {}
    for name in stages:
        h, d = host_span.get(name), device_span.get(name)
        stage = {"host_ms": None if h is None else h[3] / 1e3,
                 "device_span_ms": None, "kernels_ms": None}
        if d is not None:
            lo = bisect.bisect_left(starts, (d[2], -1.0))
            hi = bisect.bisect_left(starts, (d[2] + d[3], -1.0))
            stage["device_span_ms"] = d[3] / 1e3
            stage["kernels_ms"] = sum(us for _, us in starts[lo:hi]) / 1e3
        stage_times[name] = stage
        log(f"    stage {name:12s} " + ", ".join(
            f"{k} {'n/a' if v is None else f'{v:.3f}'}" for k, v in stage.items()))
    for label, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {us / 1e3:10.3f} ms  {n:7d} launches  {label}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        log(f"    {us / 1e3:10.3f} ms  {n:7d}x  {name[:90]}")
    log(f"    (profile read in {time.perf_counter() - t0:.3f} s)")
    return {"result": result, "wall_s": wall_s, "kernels_busy_s": busy_us / 1e6,
            "stages": stage_times,
            "groups": {k: {"ms": v[0] / 1e3, "launches": v[1]} for k, v in groups.items()},
            "top": [{"ms": us / 1e3, "count": n, "name": name[:160]} for name, (us, n) in top]}


def ptxas_entries(build_log: str) -> list:
    """Registers, static shared memory and spill bytes of every kernel, from
    ``nvcc -Xptxas -v``'s output."""
    rows, cur = [], None
    for line in build_log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"symbol": m.group(1)}
            rows.append(cur)
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m:
            cur["spill_stores"], cur["spill_loads"] = int(m.group(1)), int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["static_smem"] = int(m.group(1))
    return rows


def redesigned_kernel_resources(build_log: str, lib) -> list:
    """Registers, shared memory (static, and the dynamic bytes the launcher
    asks for) and spill bytes of every K11mma and K7 kernel; fails if one
    spills."""
    rows = []
    for e in ptxas_entries(build_log):
        m = re.search(r"(flash_bwd_(?:dq|dkv)_(?:wgmma|f32)|flash_bwd_delta|w4_mma_kernel)",
                      e["symbol"])
        if not m:
            continue
        kname = m.group(1)
        t = re.search(r"ILi(\d+)E", e["symbol"])
        targ = int(t.group(1)) if t else None
        if kname == "w4_mma_kernel":
            dyn = lib.mmmm_w4_mma_smem(targ)
        elif kname.endswith("_wgmma"):
            dyn = lib.mmmm_flash_bwd_smem(1, targ, int("dkv" in kname))
        elif kname.endswith("_f32"):
            dyn = lib.mmmm_flash_bwd_smem(0, 16 * targ, int("dkv" in kname))
        else:
            dyn = 0
        label = kname if targ is None else f"{kname}<{targ}>"
        if kname == "flash_bwd_delta":
            label += "<bf16>" if "bfloat16" in e["symbol"] else "<fp32>"
        row = {"kernel": label, "registers": e.get("registers"),
               "static_smem": e.get("static_smem", 0), "dynamic_smem": dyn,
               "spill_stores": e.get("spill_stores", 0), "spill_loads": e.get("spill_loads", 0)}
        rows.append(row)
        log(f"  {label}: {row['registers']} registers, shared {row['static_smem']} + "
            f"{dyn} bytes, spill stores {row['spill_stores']}, loads {row['spill_loads']}")
        if row["spill_stores"] or row["spill_loads"]:
            raise AssertionError(f"{label} spills to local memory")
    if not rows:
        raise AssertionError("no K11mma or K7 kernel in the build log")
    return rows


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--log-dir", type=Path, default=None)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this needs an NVIDIA GPU",
              file=sys.stderr)
        return 2
    try:
        from mmmm_tpu_torch.ops import _cuda
    except ImportError as e:
        print(f"chip_smoke: cannot import mmmm_tpu_torch ({e}); run from the repository root",
              file=sys.stderr)
        return 2
    t_start = time.perf_counter()
    torch.backends.cuda.matmul.allow_tf32 = False  # the fp32 SAM path is full fp32
    torch.backends.cudnn.allow_tf32 = False

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip().splitlines()[0]
    log(card)
    name = torch.cuda.get_device_name(0)
    peak_key, peaks = card_peaks(name)
    log(f"device {name}, count {torch.cuda.device_count()}, torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}; bounds use the {peak_key} data sheet {peaks}")

    t0 = time.perf_counter()
    so = _cuda.build()
    _cuda.library()
    build_s = time.perf_counter() - t0
    build_log = so.with_suffix(".log").read_text() if so.with_suffix(".log").exists() else ""
    regs = [int(x) for x in re.findall(r"Used (\d+) registers", build_log)]
    spills = [int(x) for x in re.findall(r"(\d+) bytes spill stores", build_log)]
    log(f"build: {build_s:.3f} s -> {so.name}; {len(regs)} kernels, max registers "
        f"{max(regs, default=0)}, spill stores {sum(spills)} bytes")
    if args.log_dir is not None:
        args.log_dir.mkdir(parents=True, exist_ok=True)
        shutil.copy(so.with_suffix(".log"), args.log_dir / "kernel_build.log")
    redesigned = redesigned_kernel_resources(build_log, _cuda.library())

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"card": card, "device": name, "bounds_from": peak_key, "build_s": build_s,
               "redesigned_kernels": redesigned, "phase_s": {}}

    def phase(label, fn, *a):
        t = time.perf_counter()
        r = fn(*a)
        results["phase_s"][label] = time.perf_counter() - t
        log(f"[{label}: {results['phase_s'][label]:.1f} s, "
            f"{time.perf_counter() - t_start:.1f} s since start]")
        return r

    results["kernels"] = phase("kernels", kernel_phase, peaks, gen)
    results["qdot"] = phase("qdot", qdot_phase, peaks, gen)
    results["tiny_reference"] = phase("tiny_reference", tiny_reference_phase)
    # the flagship's inputs come from a generator of their own, so that the
    # checks above do not change them
    results["flagship"], launches = phase("flagship", flagship_phase,
                                          torch.Generator(device="cuda").manual_seed(0))
    torch.cuda.empty_cache()
    results["tiny_train"] = phase("tiny_train", tiny_train_phase)
    results["flagship_train"], train_launches = phase(
        "flagship_train", flagship_train_phase, torch.Generator(device="cuda").manual_seed(0))
    launches.update(train_launches)
    torch.cuda.empty_cache()
    results["train_routes"] = phase("train_routes", train_route_phase)

    kernels = []
    for kid, run in KERNEL_RUN.items():
        counter = COUNTER.get(kid, kid)
        kern, r = _cuda.KERNELS[counter], results["kernels"][kid]
        entry = {"name": kid, "route": "cuda", "source": kern.source,
                 "replaces": REPLACES.get(kid, kern.replaces),
                 "launches": launches[run].get(counter, 0), "launches_in_run": run,
                 "kernel_ms": r["ms"]}
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")})
        entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    if args.log_dir is not None:
        (args.log_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
