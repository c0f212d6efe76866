#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mmmm_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py [--log-dir DIR]

Phases, in order; any failure exits non-zero before the result lines:

 1. print the card's name and power limit (``nvidia-smi``);
 2. build the CUDA kernels from ``mmmm_tpu_torch/csrc`` (``nvcc``, sm_90a);
 3. hold each kernel (K1-K6, K8-K11, K12 = K4's kernel, probe P1) against
    its plain PyTorch version on the card, at the grounded path's shapes and
    at edge cases, and time the kernel, the plain version and one PyTorch
    library call (CUDA events, medians); time the W8A16, W8A8 and W4A16
    ``qdot`` against a bf16 ``torch.matmul`` at decode rows;
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
 6. print the ``{"kernels": [...]}`` line, then the ``{"ok": true, ...}`` line.

``--log-dir`` keeps the build log and the results as JSON there.
No JAX and nothing of ``mmmm_tpu`` is imported.
"""
from __future__ import annotations

import argparse
import bisect
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
# K4's kernel; P1 is a probe that no run launches
KERNEL_RUN = {"K1": "a_greedy_bf16", "K2": "a_greedy_bf16", "K3": "a_greedy_bf16",
              "K4": "a_greedy_bf16", "K5": "b_spec7_w8a16", "K6": "b_spec7_w8a16",
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
    out["K2"] = {
        "shape": [b, h, smax, d], "dtype": "bfloat16", "max_abs_err": 0.0,
        "ms": time_ms(lambda: dk.kv_append(*rot.next(), kn, vn, w)),
        "plain_ms": time_ms(lambda: dk.kv_append_plain(*rot.next(), kn, vn, w)),
        "library_ms": None,
        "bound_ms": bms, "bound_by": by,
    }
    spec_kernel_phase(peaks, gen, out)
    capacity_kernel_phase(peaks, gen, out)
    torch.cuda.synchronize()
    for name in ("K4", "K3", "K1", "K2", "K5", "K6", "K8", "K9", "K10", "K11", "K11mma",
                 "K12", "P1"):
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
    out["K5"] = {
        "shape": [B, h, smax, d], "window": WINDOW, "dtype": "bfloat16", "max_abs_err": 0.0,
        "ms": time_ms(lambda: dk.kv_append_multi(*rot.next(), kn, vn, w_mid)),
        "plain_ms": time_ms(lambda: dk.kv_append_plain(*rot.next(), kn, vn, w_mid)),
        "library_ms": None, "bound_ms": k5_bms, "bound_by": k5_by,
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
    out["K8"] = {
        "shape": [B, h, smax, d], "dtype": "int8", "max_abs_err": 0.0,
        "ms": time_ms(lambda: dk.kv_append_q8(rot.next(), *new, mid)),
        "plain_ms": time_ms(lambda: dk.kv_append_q8_plain(rot.next(), *new, mid)),
        "library_ms": None, "bound_ms": k8_bms, "bound_by": k8_by,
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

    for kk, nn in ((4096, 12288), (4096, 4096), (11008, 4096)):
        w = quantize_int4(rnd(kk, nn, dt=torch.float32).mul_(0.02))
        for m, dt in ((4, torch.bfloat16), (4, torch.float32), (290, torch.bfloat16),
                      (92, torch.bfloat16)):
            w4_check(f"K11 ({m}, {kk}) x {kk}x{nn} {dt}", rnd(m, kk, dt=dt), w)
    k, n = 4096, 11008
    wts = [quantize_int4(rnd(k, n, dt=torch.float32).mul_(0.02)) for _ in range(4)]
    wrot = Rotating(wts)  # 4 x 23 MB: each timed call reads its weight from memory
    bts = Rotating([rnd(k, n).mul_(0.02) for _ in range(2)])
    w4_bytes = lambda m: k // 2 * n + k // 128 * n * 4 + m * k * 2 + m * n * 2

    def w4_next():
        w = wrot.next()
        return w["q4"], w["s4"]

    for name, m in (("K11", 4), ("K11mma", B * N_VIS)):
        x = rnd(m, k)
        err = w4_check(f"{name} ({m}, {k}) x {k}x{n} bf16", x, wts[0])
        if name == "K11":
            w4_check(f"{name} ({m}, {k}) x {k}x{n} fp32", x.float(), wts[0])
        bms, by = bound(w4_bytes(m), 2 * m * k * n, bf16_rate, bw)
        out[name] = {
            "shape": [m, k, n], "dtype": "bf16 x, int4 W (group 128)", "max_abs_err": err,
            "ms": time_ms(lambda: w4.w4_matmul(x, *w4_next())),
            "plain_ms": time_ms(lambda: w4.w4_matmul_plain(x, *w4_next())),
            "library_ms": time_ms(lambda: x @ bts.next()),
            "bound_ms": bms, "bound_by": by,
        }


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
        # device busy time over the profiled run's wall, and over the steady
        # (unprofiled) run's wall, which the profiler does not slow
        r["busy_share_profiled"] = r["profile"]["kernels_busy_s"] / r["profile"]["wall_s"]
        r["busy_share_steady"] = r["profile"]["kernels_busy_s"] / steady_s
        log(f"    device busy share: {r['busy_share_steady']:.4f} of the steady run, "
            f"{r['busy_share_profiled']:.4f} of the profiled run")
        out["runs"][label] = r
        all_launches[label] = launches
    return out, all_launches


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
    ("K3 flash forward", ("attn_mma_kernel<128, true",)),
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


def profile_run(run):
    """Device time by kernel group; host time, device span and kernel time by
    stage; and the device's busy share of the run's wall time, over one more
    flagship run. Reads the profiler's raw events: building its per-op
    event tree takes about a minute a million events, the raw list a
    second."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall_s = run()
    t0 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    # (name, device type, start us, duration us) of every event
    events = [(e.name(), e.device_type(), e.start_ns() / 1e3, e.duration_ns() / 1e3)
              for e in raw]
    kernels = [e for e in events if e[1] == DeviceType.CUDA and e[0] not in STAGES]
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
    host_span = {e[0]: e for e in events if e[0] in STAGES and e[1] == DeviceType.CPU}
    device_span = {e[0]: e for e in events if e[0] in STAGES and e[1] == DeviceType.CUDA}
    starts = sorted((start, us) for _, _, start, us in kernels)
    stages = {}
    for name in STAGES:
        h, d = host_span.get(name), device_span.get(name)
        stage = {"host_ms": None if h is None else h[3] / 1e3,
                 "device_span_ms": None, "kernels_ms": None}
        if d is not None:
            lo = bisect.bisect_left(starts, (d[2], -1.0))
            hi = bisect.bisect_left(starts, (d[2] + d[3], -1.0))
            stage["device_span_ms"] = d[3] / 1e3
            stage["kernels_ms"] = sum(us for _, us in starts[lo:hi]) / 1e3
        stages[name] = stage
        log(f"    stage {name:12s} " + ", ".join(
            f"{k} {'n/a' if v is None else f'{v:.3f}'}" for k, v in stage.items()))
    for label, (us, n) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        log(f"    {us / 1e3:10.3f} ms  {n:7d} launches  {label}")
    top = sorted(by_name.items(), key=lambda kv: -kv[1][0])[:15]
    for name, (us, n) in top:
        log(f"    {us / 1e3:10.3f} ms  {n:7d}x  {name[:90]}")
    log(f"    (profile read in {time.perf_counter() - t0:.3f} s)")
    return {"wall_s": wall_s, "kernels_busy_s": busy_us / 1e6, "stages": stages,
            "groups": {k: {"ms": v[0] / 1e3, "launches": v[1]} for k, v in groups.items()},
            "top": [{"ms": us / 1e3, "count": n, "name": name[:160]} for name, (us, n) in top]}


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

    gen = torch.Generator(device="cuda").manual_seed(0)
    results = {"card": card, "device": name, "bounds_from": peak_key, "build_s": build_s,
               "phase_s": {}}

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

    kernels = []
    for kid, run in KERNEL_RUN.items():
        counter = COUNTER.get(kid, kid)
        kern, r = _cuda.KERNELS[counter], results["kernels"][kid]
        entry = {"name": kid, "route": "cuda", "source": kern.source,
                 "replaces": REPLACES.get(kid, kern.replaces),
                 "launches": launches[run][counter], "launches_in_run": run,
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
