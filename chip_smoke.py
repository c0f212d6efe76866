#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port (``mmmm_tpu_torch``) on one NVIDIA GPU.

Run from the repository root on a machine with a card:

    python3 chip_smoke.py [--log-dir DIR]

Phases, in order; any failure exits non-zero before the result lines:

 1. print the card's name and power limit (``nvidia-smi``);
 2. build the CUDA kernels from ``mmmm_tpu_torch/csrc`` (``nvcc``, sm_90a)
    and print the registers, shared memory and spill bytes of every K3/K4
    (``attn_fwd_*``, with P1's form and K4's fast softmax), K6 tensor-core,
    K11 decode-row, K11mma, K7, K9 (its bf16-cast form too), K10 and K1
    kernel (failing if one spills);
 3. hold each kernel (K1-K11, K7delta, K12 = K4's kernel, probe P1) against
    its plain PyTorch version on the card, at the grounded path's and the
    training step's shapes and at edge cases (K1 and its fused form with
    K2's append at H = 32 for kv_len 1, 193, 256, 320 and 0 at B = 4 and 1,
    over Smax 320 and 321, at D = 128, 64 and 90 in bf16 and fp32, over a
    cache past a block's shared memory, twice bit for bit, the fused form's
    caches bit-equal to ``kv_append_plain``'s at write indices in range,
    past either end and past kv_len; timed at kv_len 193, 256, 320 and at
    B = 1, the fused form beside K2 then K1 and ``index_put_`` + SDPA; K6
    for windows of 1 to 8 at write indices from 0, mid-cache, at the end and
    negative, with warps' tiles that hold no valid slot, at D = 128, 64 and
    90 in bf16 and in fp32, over a long cache, and twice bit for bit, timed
    at run (b)'s first, middle and last verify steps; K9 and K10 at the
    flagship's H and D for
    kv_len 1, 193, 256, 320 and 0 over Smax 320 and 321, through their
    staged read's ring twice bit for bit, and timed at kv_len 193, 256 and
    320 and at B = 1; K10 at D = 8, 16, 48, 64, 90 and 100 and over a cache
    past its shared memory; the fused forms of K9 and K10 (``quantize_kv``
    and K8's append inside the read's launch) and of K6 (K5's append inside
    its launch) at every write-index edge, over Smax 320/321 (K6: 328 and
    2100), D = 128 and 90 (K6 also 64), bf16 and fp32, B = 4 and 1, through
    the ring and K10's workspace, their caches bit-equal to the appends'
    and their outputs bit-equal to the appends then the reads, each timed
    at the decode step beside the read alone, the launches in sequence and
    the plain version; K11 at 1, 4 and 16 bf16 rows and
    4 fp32 rows on run (d)'s four weight shapes, twice bit for bit, timed
    at 4 rows on each with its launches a batch; K11mma at every row count
    W4A16 serving passes, and both of its tile widths timed at the
    prefill's shapes; K3 and K7 at every head dim they serve over a ragged
    S, K3 over packed segments with fully masked rows, both twice at the
    LLM site, bit for bit; K3, K4 and K7 at head dims 100 in bf16 and 90 in
    fp32, which they take through zero lanes, and K1, K6, K9 and K10 at
    90, K1 and K6 there beside SDPA; the kernel forms of the reference's
    numeric switches: K4's fast softmax at the ViT's and the SAM encoder's
    shapes, K9's bf16 cast at kv_len 1, 193, 256, 320 and 0 over Smax 320
    and 321 and its fused form at every write-index edge, each twice bit
    for bit and timed beside its default form), and time the kernel, the
    plain version and one PyTorch library call (CUDA events, medians); time
    the W8A16, W8A8 and W4A16 ``qdot`` against a bf16 ``torch.matmul`` at
    decode rows;
 4. run ``generate_grounded`` on the card and on the CPU (plain versions)
    and require the same tokens, masks, boxes and presence logits: at
    ``MMMMConfig.tiny()`` in fp32 greedy and n-gram speculative (3, 7 and
    8 drafts: windows of 9 take the decoder's plain route), bf16 and int8
    KV, plain, W8A16 and W8A8 (decode, prefill) weights, chunked prefill in
    both modes; at the W4-capable small widths W4A16 with the split-int8
    read, instance SAM and chunked prefill; then the continuous-batching
    servers card vs CPU at the tiny config (``TextServer`` greedy with
    refills mid-flight, with the prefix cache's suffix windows of 16-32
    tokens, speculative over W8A16; ``GroundedServer`` greedy and
    speculative): the same texts, stats and masks; and at the tiny config over an int8 KV
    cache the switches ``q8_cast="bf16"``, ``dense_fast_softmax=True`` and
    ``gelu_mode`` ``"tanh"`` then ``"erf"``, card vs CPU, every K4 launch
    in its form "fast" and every K9 launch in "bf16";
 5. run the grounded report path at the flagship width (CogVLM-17B +
    SegVol SAM, bf16 LLM/ViT, fp32 SAM, random weights from a seed; the
    LLM cut to its first ``FLAGSHIP_LAYERS`` = 16 of 32 layers, the ViT and
    SAM whole, to keep the script inside its time): B=4,
    prompt 192 with 146 vision tokens, 128 new tokens, 4 targets, as four
    runs: (a) greedy, bf16 weights and KV cache; then, with the LLM
    quantized in place to W8A16, (b) speculative with 7 drafts and a bf16
    KV cache (the reference bench's default decode) and (c) greedy with an
    int8 KV cache; then, with the LLM made again from the seed and
    quantized to W4A16, (d) capacity serving: greedy over an int8 KV cache
    read by the split-int8 kernel, prefill in chunks of 2, instance SAM.
    Every decode step appends inside its read's launch (K2, K5 and K8
    launch 0 times; K1, K6, K9 and K10 only in their "append" form).
    Each is warmed up once, then run with every launch counter at 0 and
    checked for its outputs and its exact launch counts, then profiled
    (device time by kernel group; host time, device span, kernel time and
    launches by stage; busy share). Between (a) and (b), over (a)'s bf16
    weights, the servers: (s1) ``GroundedServer`` greedy, 4 slots, 8
    requests of (a)'s shape; (s2) the same with 7 drafts; (s3)
    ``TextServer``, 8 slots, 16 prompts on a shared 128-token template with
    budgets of 16-128; each warmed up, then timed (requests/s, stats,
    tokens a verify step, peak memory) with launch counts exact against
    the server's stats, then profiled; (s1)'s tokens are compared with
    ``generate_grounded``'s and (s2)'s over the same requests (reported,
    not gated); then, over the same bf16 weights, ``clean-reports`` and
    ``tag-reports`` (``data_prep_llm_phase``): MIMIC's two cleaning passes
    over 8 synthetic studies, then the two tagging passes over their
    output, 64 new tokens, static, ``--continuous`` and ``--continuous
    --speculate 7``, every generator call's launches exact (K3 a prefill,
    K1 or K6 a decode step a layer, fused with their appends), tag offsets
    inside their reports; the routes' texts compared (reported: they part
    in bf16); each route's first-token logits of its first call, as the
    route computed them, held to an fp32 static prefill at the same depth
    (the layers cast one at a time): a bound on each row's largest and
    relative distance, the argmax equal where fp32's top-2 gap is wide;
    the same three routes over the first 2 LLM layers cast to fp32,
    tagging the raw reports too, must give the same texts and files;
    and the ``clean-reports`` and ``tag-reports`` commands over a
    ``--params`` file of those layers with ``--config``, their JSON that
    of ``clean_dataset`` and ``tag_dataset``;
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
    must agree; three semantic steps under ``remat="attn"`` from the state
    before step 3 (K3 182, each K7 107; the loss and gradient norm those of
    ``remat=True``; step time and peak memory beside it); then, at full
    width and 8 LLM and ViT layers and
    over four seeds, the gradients of the ``"pallas"`` and ``"xla"`` routes
    held to each other in fp32, and each route's bf16 gradients measured
    against fp32, the kernels' route held to the plain route's distance;
    one semantic step under ``remat="dots"`` at 8 LLM and ViT layers (at
    full depth its kept products pass 80 GB) beside ``remat=True`` from one
    state; the ``finetune`` command warm-started from an ``adapter.npz``
    under ``remat="attn"``: at the tiny config card vs CPU, and at full
    width with 2 LLM and 2 ViT layers over a VQA set of CT volumes (step
    time, exact launches, the export);
 7. the training loop (``Trainer.fit``): at conf/tiny/fit.yaml's values in
    fp32 over a synthetic vision-language dataset of ``.pt`` volumes, 4
    steps then a resumed run to 6, on the card and on the CPU from one
    state: each step's ``lm_loss`` and ``grad_norm`` within 1e-5 relative,
    the checkpoint restored bit for bit, ``adapter.npz`` read back, launches
    exact at every bucket; 3 stage-0 ``align_training_step`` steps
    (semantic, instance) card vs CPU; then ``Trainer.fit`` at the flagship's
    full width and depth over conf/phase-vlm/data.yaml's data settings
    (8 constant (1, 64, 320, 320) CT volumes, S = 1024, B = 4, 6 steps, a
    checkpoint at step 6 and the adapter export): step time, data host time
    a step, tokens/s, peak memory, checkpoint and export bytes and seconds,
    exact launches every step; then (7b, ``data_parallel_phase``) the
    data-parallel route at world size 1: NCCL through ``init_distributed``
    from the three variables on a loopback port, ZeRO's gather and
    reduce-scatter over it bit-equal to plain indexing,
    ``make_train_step(mesh=make_mesh(data=1))`` at full width with 4 LLM
    and 4 ViT layers against the route without a mesh from one state (3
    semantic steps each: loss and gradient norm within 1e-6, K3 and K7
    launches exact and equal), and ``Trainer.fit`` at conf/tiny/fit.yaml
    with ``trainer.mesh_data=1`` against the same fit without a mesh
    (every metric within 1e-6); the group is destroyed after; then (7c,
    ``tensor_parallel_phase``) tensor parallelism over the ``model`` axis:
    two worker processes on the one card, joined over gloo (their tensors
    on the card; gloo's collectives on CUDA tensors checked and an
    all-reduce timed), ``generate_grounded`` greedy and speculative (7
    drafts) over ``tp_serving_params(.., 2)`` pieces of the flagship at full
    width with 4 LLM and 4 ViT layers in bf16 against the route without
    them (first-token logits of both held to an fp32 prefill by
    ``first_token_gate``'s bounds), at 2 layers in fp32 (tokens equal,
    masks within 2e-4), W4A16 greedy over int4 pieces (K11 and K11mma a
    rank as one rank's; first-token logits within 0.2 relative of one
    rank's; phase 3 holds both kernels at a rank's piece shapes over 2 and
    over 4 ranks, ``W4_TP_SHAPES``: over 4, gate/up's 2,752 columns end in
    a partial K11mma tile and down's piece holds 22 scale groups), and one
    fp32 ``make_train_step(mesh=(1, 2))`` step against
    the step without a mesh (loss and gradient norm within 1e-5), each
    rank's K4, K3, K1, K6 and K7 launches exact; then (7d,
    ``seq_pipe_phase``) sequence and pipeline parallelism, two workers on
    the one card over gloo again: ring attention at the flagship LLM's
    (4, 1024, 32, 128) bf16 causal over ``seq=2`` against K3 and K7 on the
    whole sequence (output and dq, dk, dv within 0.05; rank 0 launches K3
    and each K7 kernel once, rank 1 twice), one hop of a (4, 512, 32, 128)
    K/V shard timed, and one fp32 ``make_train_step`` at full width with 2
    LLM and 2 ViT layers on ``make_mesh(data=1, seq=2)`` (``"ring"``) and
    on ``make_mesh(data=1, pipe=2)`` (1 layer a stage, 2 microbatches)
    against the step without a mesh (loss, gradient norm and the norm of
    each rank's chunk of each leaf's gradient within 1e-5), each rank's K3,
    K4 and K7 launches exact;
 8. the entry points at the flagship's full width: the checkpoint
    importers (``train/import_torch.py``) on seeded HF CogVLM and SegVol
    state dicts at 2 LLM and 2 ViT layers into a fresh tree on the card
    (copied leaves bit-equal, resampled ones within 1e-6 of
    ``F.interpolate``); the flagship at full depth loaded by
    ``build.load_model_with_adapter`` from a dict of conf/phase-vlm/fit.yaml
    with phase 7's ``adapter.npz``; the HF PEFT round trip
    (``train/peft_export.py``) of a LoRA tree at conf/lora.yaml's rank,
    bit for bit; the CLI's ``demo`` on a ``.pt`` CT volume (greedy, 128 new
    tokens; then ``--speculate 7 --quantize``), its tokens those of
    ``generate_grounded``; ``predict`` over 8 ``.pt`` report items batched
    and ``--continuous`` and ``evaluate --suite all`` on each; the ViT with
    ``pad_attention_heads`` against the unpadded and fp32 towers, and K4 at
    D = 128 beside D = 112; ``sam_forward_prompted`` with a point, a box
    and a mask prompt, card vs CPU. Each run counted from 0, launches
    exact;
 9. the pseudo-box detector and the segmentation ablation: LAP (the
    rectangular assignment kernel) against its plain version on the card,
    ``col4row`` bit-equal twice, at the matcher's (32, 24, 100), with
    padded rows of flat zero, integer costs with ties, K = Q = 8, K = 1
    and (8, 32, 900), each summed cost scipy's optimum within 1e-5
    relative, timed beside the plain version and scipy on the host; the
    detector at ``tests/test_detector.py``'s tiny config card vs CPU
    (outputs, loss, gradients, three ``train_detector`` steps within 1e-4
    relative, one LAP launch a loss call); ``train_detector`` at
    ``DetectorConfig()`` and the command's defaults (image 512, batch 8,
    20 steps over 32 in-memory cases, LAP launched exactly 20 times) and
    ``infer_images`` over 32 ``.pt`` images writing ``_box.json``;
    ``ms_deform_attn`` timed at the encoder's and the decoder's shapes
    beside ``F.grid_sample``'s formulation; the UNet card vs CPU at a small
    odd size, then ``run_seg_exp`` at conf/seg-exp/unet.yaml's width (3
    steps; the largest batch of 8, 6, 4, 2 that fits); the SAM arm at
    conf/seg-exp/sam.yaml's width (3 steps, K4 launched 6 times a step) and
    K4 at its (8, 1176, 8, 32) fp32 shape beside SDPA. The ``process``
    command runs no device work, so it is held on the CPU only;
10. data preparation (``data_prep_phase``): the port's native host
    library built from ``mmmm_tpu_torch/native/mmmm_native.cpp`` with the
    host's ``g++`` (build time and compiler logged); zstd frames with and
    without a content size, concatenated with a skippable frame,
    ``.pt.zst`` and ``.arr.zst`` files and the prefetcher round-trip;
    ``resize_trilinear_u8`` within 2e-3 of ``F.interpolate``; bench.py's
    input gauge (decode + resize of (1, 48, 420, 420) uint8 volumes to
    (32, 384, 384) through the prefetcher: volumes/s, a host figure); then
    the ``self-label`` command at ``SamConfig()`` with its defaults over 4
    (1, 48, 320, 320) CT volumes written as ``.pt.zst``, on the card (K4
    exactly 12 a case) and at ``--device cpu``: probabilities within ``masks_tol``,
    masks equal wherever |p - 0.5| exceeds it, and ``data/grg.py`` reads
    the masks back;
11. print the ``{"kernels": [...]}`` line (each kernel's launches on the
    named runs, ``launches_mesh`` those of phase 7b's steady mesh step beside
    ``launches_no_mesh_same_depth``, ``launches_tensor_parallel_rank`` a
    rank's in phase 7c's runs, ``launches_data_prep`` those of the
    data-preparation runs), then the ``{"ok": true, ...}`` line.

``--log-dir`` keeps the build log and the results as JSON there.
No JAX and nothing of ``mmmm_tpu`` is imported.
"""
from __future__ import annotations

import argparse
import bisect
import contextlib
import dataclasses
import gc
import io
import json
import math
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
# the LLM layers of phase 5 (runs (a)-(d), the servers, clean/tag-reports):
# the flagship's first 16, at full width; its host-bound decode loops took
# a third of the script at 32
FLAGSHIP_LAYERS = 16
VIT_LAYERS, SAM_LAYERS = 63, 12
CHUNK = 2  # run (d)'s prefill chunk: 2 chunks of 2 samples
# run (d)'s int4 products a layer: 5 projections (qkv, dense, gate, up, down)
# per routed span; prefill spans of a chunk: 2 x 1 language rows (GEMV),
# 2 x 145 vision and 2 x 46 language rows (tensor-core tiles); decode: 4 rows
W4_GEMV = FLAGSHIP_LAYERS * 5 * (B // CHUNK) + FLAGSHIP_LAYERS * 5 * NEW
W4_MMA = FLAGSHIP_LAYERS * 10 * (B // CHUNK)
# run (d)'s int4 weight shapes (K, N): qkv, dense, gate and up, down; the K11
# launches a batch should count on each (gate and up share a shape)
W4_SHAPES = ((4096, 12288), (4096, 4096), (4096, 11008), (11008, 4096))
W4_DECODE_CALLS = {s: (2 if s == (4096, 11008) else 1) * FLAGSHIP_LAYERS
                   * ((B // CHUNK) + NEW) for s in W4_SHAPES}
# the int4 shapes (K, N) a rank multiplies by under tensor parallelism, over
# two ranks (phase 7c's W4A16 run, ``tp_serving_params(.., 2)``) and over
# four, each with the whole weight it is cut from, the leaf's rule (qkv's and
# gate/up's columns, dense's and down's rows), the ranks and the rank whose
# piece is checked: over two, down's 43 scale groups are repacked with a 44th
# of zero weights; over four, gate/up's 2,752 columns end in a partial
# 128-column tile of K11mma, and rank 1's piece of down holds the 22 scale
# groups its 2,752 rows touch, 64 zero rows in front
W4_TP_SHAPES = {(4096, 6144): ((4096, 12288), "lang_qkv", 2, 1),
                (2048, 4096): ((4096, 4096), "lang_dense", 2, 1),
                (4096, 5504): ((4096, 11008), "lang_mlp/gate", 2, 1),
                (5632, 4096): ((11008, 4096), "lang_mlp/down", 2, 1),
                (4096, 3072): ((4096, 12288), "lang_qkv", 4, 1),
                (1024, 4096): ((4096, 4096), "lang_dense", 4, 1),
                (4096, 2752): ((4096, 11008), "lang_mlp/gate", 4, 1),
                (2816, 4096): ((11008, 4096), "lang_mlp/down", 4, 1)}
# flagship launches per run; "iters" is scaled by the run's verify steps;
# "forms": the launches of a kernel's named forms (every other form count 0).
# Each decode step appends inside its read's launch (the read's "append"
# form): run (a)'s K/V row inside K1's, run (b)'s verify window inside K6's,
# runs (c) and (d) quantize their row and append it inside K9's and K10's;
# so the stand-alone appends K2, K5 and K8 launch 0 times
RUNS = {
    "a_greedy_bf16": dict(kw={}, launches={"K4": 63 + 12, "K3": FLAGSHIP_LAYERS,
                                           "K1": FLAGSHIP_LAYERS * NEW},
                          forms={"K1": {"append": FLAGSHIP_LAYERS * NEW}}),
    "b_spec7_w8a16": dict(kw=dict(spec_draft_len=DRAFT),
                          launches={"K4": 63 + 12, "K3": FLAGSHIP_LAYERS, "K6": "iters"},
                          forms={"K6": {"append": "iters"}}),
    "c_int8kv_w8a16": dict(kw=dict(kv_cache_dtype="int8"),
                           launches={"K4": 63 + 12, "K3": FLAGSHIP_LAYERS,
                                     "K9": FLAGSHIP_LAYERS * NEW},
                           forms={"K9": {"append": FLAGSHIP_LAYERS * NEW}}),
    # chunking runs the ViT, the LLM prefill and the SAM encoder once a chunk
    "d_w4_q8mxu_chunk2": dict(kw=dict(kv_cache_dtype="int8", q8_mxu=True, prefill_chunk=CHUNK,
                                      instance=True),
                              launches={"K4": (VIT_LAYERS + SAM_LAYERS) * (B // CHUNK),
                                        "K3": FLAGSHIP_LAYERS * (B // CHUNK),
                                        "K10": FLAGSHIP_LAYERS * NEW,
                                        "K11": W4_GEMV, "K11mma": W4_MMA},
                              forms={"K10": {"append": FLAGSHIP_LAYERS * NEW}}),
}
# kernel -> (run whose launch count it reports, the counter it reads); K12 is
# K4's kernel; P1 is a probe that no run launches; a train_* run is one
# steady training step. The stand-alone appends report their launches on
# the run whose read does their work, 0: K2 on run (a) (inside K1's launch),
# K5 on run (b) (inside K6's), K8 on run (c) (quantized and appended inside
# K9's; run (d): K10's). Each stays as the port of its TPU kernel
# (kv_append_pallas, _multi, _q8), checked and timed in phase 3
KERNEL_RUN = {"K1": "a_greedy_bf16", "K2": "a_greedy_bf16", "K3": "a_greedy_bf16",
              "K4": "a_greedy_bf16", "K5": "b_spec7_w8a16", "K6": "b_spec7_w8a16",
              "K7dq": "train_semantic", "K7dkv": "train_semantic", "K7delta": "train_semantic",
              "K8": "c_int8kv_w8a16", "K9": "c_int8kv_w8a16", "K10": "d_w4_q8mxu_chunk2",
              "K11": "d_w4_q8mxu_chunk2", "K11mma": "d_w4_q8mxu_chunk2",
              "K12": "d_w4_q8mxu_chunk2", "P1": "d_w4_q8mxu_chunk2", "LAP": "detector_train"}
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
    from mmmm_tpu_torch.ops.attention import build_mask, kernel_head_dim

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
                                (2, 75, 12, 64, torch.float32, 1e-4),
                                (2, 577, 16, 112, torch.float32, 1e-4),
                                (2, 33, 2, 8, torch.float32, 1e-4),
                                (2, 33, 2, 8, torch.bfloat16, 2e-2)]:
        q, k, v = (rnd(b, s, h, d, dt=dt) for _ in range(3))
        check(f"K4 edge {tuple(q.shape)} {dt}", max_err(da.dense_attention(q, k, v, d ** -0.5),
              da.dense_attention_plain(q, k, v, d ** -0.5)), tol)
    # head dims the kernel takes only through zero lanes (ops/attention.py
    # kernel_head_dim): one padded copy, the kernel, a slice; timed whole
    for b, s, h, d, dt, tol in [(B, 1153, 16, 100, torch.bfloat16, 2e-2),
                                (B, 512, 12, 90, torch.float32, 1e-4)]:
        q, k, v = (rnd(b, s, h, d, dt=dt) for _ in range(3))
        scale = d ** -0.5
        err = max_err(da.dense_attention(q, k, v, scale), da.dense_attention_plain(q, k, v, scale))
        dp = kernel_head_dim(d, dt)
        check(f"K4 padded {tuple(q.shape)} {dt} (the kernel at D = {dp})", err, tol)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bms, by = bound(4 * q.numel() * q.element_size(), 4 * b * h * s * s * d,
                        bf16_rate if dt == torch.bfloat16 else fp32_rate, bw)
        row = {"shape": [b, s, h, d], "dtype": str(dt).split(".")[-1], "padded_to": dp,
               "max_abs_err": err, "ms": time_ms(lambda: da.dense_attention(q, k, v, scale)),
               "plain_ms": time_ms(lambda: da.dense_attention_plain(q, k, v, scale), inner=2),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                            scale=scale)),
               "bound_ms": bms, "bound_by": by}
        log(f"  K4 padded D={d}: kernel {row['ms']:.4f} ms (pad and slice included), plain "
            f"{row['plain_ms']:.4f} ms, library {row['library_ms']:.4f} ms, bound {bms:.4f} ms")
        entry["variants"].append(row)
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
    # causal over two packed segments, a padded tail and query rows whose
    # segment has no key, at the sites' head dims and dtypes
    for d, dt, tol in [(128, torch.bfloat16, 2e-2), (112, torch.bfloat16, 2e-2),
                       (112, torch.float32, 1e-4), (64, torch.float32, 1e-4)]:
        q, k, v = (rnd(2, 600, 3, d, dt=dt) for _ in range(3))
        qs = torch.ones(2, 600, dtype=torch.int32, device=dev)
        qs[0, 130:] = 2
        qs[1, 550:] = 0
        ks = qs.clone()
        ks[0, 130:140] = 3
        o, lse = fl.flash_segment_attention(q, k, v, qs, ks, causal=True, scale=d ** -0.5)
        ro, rlse = fl.flash_segment_attention_plain(q, k, v, qs, ks, causal=True, scale=d ** -0.5)
        check(f"K3 masked rows, two segments (2, 600, 3, {d}) {dt}",
              max(max_err(o, ro), max_err(lse, rlse)), tol)
        if not (torch.all(o[0, 130:140] == 0) and torch.all(lse[0, :, 130:140] == 0)
                and torch.all(o[1, 550:] == 0) and torch.all(lse[1, :, 550:] == 0)):
            raise AssertionError("K3: a fully masked row is not zero")

    # ---- K1 decode attention (the read, and its fused form), K2 KV append ---------------
    log("K1 decode attention and its fused form with K2's append, K2 KV append")
    k1_checks(gen)
    b, h, smax, d = B, 32, PROMPT + NEW, 128
    copies = [(rnd(b, h, smax, d), rnd(b, h, smax, d)) for _ in range(8)]
    q = rnd(b, 1, h, d)
    kc, vc = copies[0]
    rot = Rotating(copies)
    mid = torch.full((b,), (PROMPT + 1 + smax) // 2, dtype=torch.int32, device=dev)
    out["K1"] = k1_timed_row(peaks, q, rot, mid)
    rows = [k1_timed_row(peaks, q, rot, torch.full((b,), n, dtype=torch.int32, device=dev))
            for n in (PROMPT + 1, PROMPT + NEW)]
    rows.append(k1_timed_row(peaks, q[:1].contiguous(), Rotating(
        [(rnd(1, h, smax, d), rnd(1, h, smax, d)) for _ in range(8)]),
        torch.full((1,), 256, dtype=torch.int32, device=dev)))
    rows.append(k1_fused_row(peaks, gen, q, rot, mid))
    rows.append(decode_d90_row(
        "K1", peaks, gen, lambda q, kc, vc, n: dk.decode_attention(q, kc, vc, n),
        lambda q, kc, vc, n: dk.decode_attention_plain(q, kc, vc, n), sdpa=True))
    out["K1"]["variants"] = rows

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
        "launches_note": "run (a) appends inside K1's launch (decode_attention_append), so "
                         "the stand-alone K2 launches 0 times there",
    }
    spec_kernel_phase(peaks, gen, out)
    capacity_kernel_phase(peaks, gen, out)
    train_kernel_phase(peaks, gen, out)
    switch_kernel_rows(peaks, gen, out)
    torch.cuda.synchronize()
    for name in ("K4", "K3", "K1", "K2", "K5", "K6", "K7dq", "K7dkv", "K7delta", "K8", "K9",
                 "K10", "K11", "K11mma", "K12", "P1"):
        r = out[name]
        lib = "n/a" if r["library_ms"] is None else f"{r['library_ms']:.4f} ms"
        log(f"{name}: kernel {r['ms']:.4f} ms, plain {r['plain_ms']:.4f} ms, library {lib}, "
            f"bound {r['bound_ms']:.5f} ms ({r['bound_by']})")
    return out


def k1_checks(gen) -> None:
    """K1 against its plain version (2e-2 bf16, 1e-4 fp32) at H = 32 over
    Smax 320 and 321, for kv_len 1, 193, 256, 320 and 0 at B = 4 and B = 1,
    at D = 128, 64 and 90 in bf16 and fp32, twice bit for bit; its fused
    form at the same points and write indices [192, 0, Smax - 1, Smax + 7],
    [-1, 5, 300, -400] and past kv_len: the caches bit-equal to
    ``kv_append_plain``'s, the output within the tolerance of the plain
    fused version, twice bit for bit; both over a cache past one block's
    shared memory (Smax 8192: a split's run of 1,024 slots through the
    ring) and over caches whose plan fills the shared memory to within a
    few KiB of the card's limit."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    ints = lambda x: torch.tensor(x, dtype=torch.int32, device=dev)

    def read(q, kc, vc, lens, tol, label):
        n = ints(lens)
        got = dk.decode_attention(q, kc, vc, n)
        err = max_err(got, dk.decode_attention_plain(q, kc, vc, n))
        if not torch.all(got[n <= 0] == 0):
            raise AssertionError(f"K1 {label} kv_len {lens}: kv_len 0 does not give zeros")
        if not torch.equal(got, dk.decode_attention(q, kc, vc, n)):
            raise AssertionError(f"K1 {label} kv_len {lens}: two runs differ")
        return err

    def fused(q, kc, vc, kn, vn, widx, lens, label):
        w, n = ints(widx), ints(lens)
        rk, rv = kc.clone(), vc.clone()
        ref = dk.decode_attention_append_plain(q, rk, rv, kn, vn, w, n)
        outs = []
        for _ in range(2):
            gk, gv = kc.clone(), vc.clone()
            outs.append(dk.decode_attention_append(q, gk, gv, kn, vn, w, n))
            if not (torch.equal(gk, rk) and torch.equal(gv, rv)):
                raise AssertionError(f"K1 fused {label} write_index {widx}: caches differ "
                                     "from kv_append_plain's")
        if not torch.equal(outs[0], outs[1]):
            raise AssertionError(f"K1 fused {label} write_index {widx}: two runs differ")
        return max_err(outs[0], ref)

    h = 32
    for smax in (PROMPT + NEW, PROMPT + NEW + 1):
        for d in (128, 64, 90):
            for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
                label = f"(B, {h}, {smax}, {d}) {str(dt).split('.')[-1]}"
                q = rnd(B, 1, h, d, dt=dt)
                kc, vc = rnd(B, h, smax, d, dt=dt), rnd(B, h, smax, d, dt=dt)
                errs = [read(q, kc, vc, lens, tol, label)
                        for lens in ([1, PROMPT + 1, 256, PROMPT + NEW], [0, 256, 0, PROMPT + 1])]
                errs += [read(q[:1], kc[:1], vc[:1], [n], tol, label + " B=1")
                         for n in (1, PROMPT + 1, 256, PROMPT + NEW, 0)]
                check(f"K1 {label} kv_len 1/193/256/320/0, B = 4 and 1, twice", max(errs), tol)
                kn, vn = rnd(B, h, 1, d, dt=dt), rnd(B, h, 1, d, dt=dt)
                errs = [fused(q, kc, vc, kn, vn, widx, lens, label) for widx, lens in (
                    ([PROMPT, 0, smax - 1, smax + 7], [PROMPT + 1, 1, smax, smax]),
                    ([-1, 5, 300, -400], [smax, 6, 301, 256]),
                    ([256, 200, 10, smax - 1], [PROMPT + 1, 0, 5, 256]))]  # t >= kv_len
                check(f"K1 fused {label}: caches bit-equal, twice", max(errs), tol)
    bf16, fp32 = (torch.bfloat16, 2e-2), (torch.float32, 1e-4)
    # Smax 8192 must take the ring; the rest are caches whose ring fills the
    # shared memory to within a few KiB of the card's limit, at run (a)'s
    # heads and at D = 96
    for b, h, smax, d, (dt, tol) in [(2, 8, 8192, 128, bf16), (2, 8, 8192, 128, fp32),
                                     (2, 8, 8192, 90, bf16), (2, 8, 8192, 90, fp32),
                                     (4, 32, 432, 128, bf16), (4, 32, 1024, 96, bf16),
                                     (2, 32, 1296, 128, bf16), (1, 32, 2160, 128, bf16)]:
        splits = dk.decode_splits(b, h, smax, dk.sm_count(dev))
        chunk, stages = dk.decode_stage_plan(smax, splits, d, 2 if dt == torch.bfloat16 else 4)
        if smax == 8192 and stages != dk.Q8_RING_STAGES:
            raise AssertionError(f"K1 at Smax {smax}, D {d}: no ring ({chunk}, {stages})")
        label = f"({b}, {h}, {smax}, {d}) {str(dt).split('.')[-1]}"
        q, kc, vc = rnd(b, 1, h, d, dt=dt), rnd(b, h, smax, d, dt=dt), rnd(b, h, smax, d, dt=dt)
        kn, vn = rnd(b, h, 1, d, dt=dt), rnd(b, h, 1, d, dt=dt)
        lens = [smax, 3 * chunk + 5, smax - 1, 1][:b]
        err = max(read(q, kc, vc, lens, tol, label),
                  fused(q, kc, vc, kn, vn, [smax - 1, 2 * chunk, 0, -1][:b], lens, label))
        check(f"K1 and fused {label} ({splits} split(s), {stages} stages of {chunk} slots), "
              "twice", err, tol)


def k1_timed_row(peaks, q, rot, lens) -> dict:
    """K1 over rotating bf16 caches at one kv_len: checked (2e-2), then
    timed beside its plain version and SDPA with a boolean mask."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    bw, bf16_rate, _, _ = peaks
    kc, vc = rot.copies[0]
    b, h, smax, d = kc.shape
    err = max_err(dk.decode_attention(q, kc, vc, lens), dk.decode_attention_plain(q, kc, vc, lens))
    check(f"K1 timed row B={b} kv_len {int(lens[0])}", err, 2e-2)
    valid = (torch.arange(smax, device=q.device)[None] < lens[:, None])[:, None, None, :]
    qh = q.transpose(1, 2).contiguous()
    n_read = int(lens.sum().item())
    bms, by = bound(2 * n_read * h * d * 2 + 2 * q.numel() * 2, 4 * n_read * h * d, bf16_rate, bw)
    row = {"shape": [b, h, smax, d], "kv_len": int(lens[0]), "dtype": "bfloat16",
           "splits": dk.decode_splits(b, h, smax, dk.sm_count(q.device)), "max_abs_err": err,
           "ms": time_ms(lambda: dk.decode_attention(q, *rot.next(), lens)),
           "plain_ms": time_ms(lambda: dk.decode_attention_plain(q, *rot.next(), lens)),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qh, *rot.next(),
                                                                        attn_mask=valid)),
           "bound_ms": bms, "bound_by": by}
    log(f"  K1 B={b} kv_len {row['kv_len']}: kernel {row['ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, SDPA {row['library_ms']:.4f} ms, bound {bms:.5f} ms ({by})")
    return row


def k1_fused_row(peaks, gen, q, rot, lens) -> dict:
    """K1's fused form at run (a)'s step (write index kv_len - 1) over
    rotating caches: checked against its plain version, then timed beside
    the plain version, ``kv_append`` + ``decode_attention`` (K2 then K1, two
    launches) and ``index_put_`` + SDPA (the library's append and read)."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    bw, bf16_rate, _, _ = peaks
    kc, vc = rot.copies[0]
    b, h, smax, d = kc.shape
    dev = q.device
    kn, vn = (torch.randn(b, h, 1, d, generator=gen, device=dev).to(kc.dtype) for _ in range(2))
    w = lens - 1
    ref = dk.decode_attention_append_plain(q, kc.clone(), vc.clone(), kn, vn, w, lens)
    err = max_err(dk.decode_attention_append(q, kc.clone(), vc.clone(), kn, vn, w, lens), ref)
    check(f"K1 fused timed row B={b} kv_len {int(lens[0])}", err, 2e-2)
    valid = (torch.arange(smax, device=dev)[None] < lens[:, None])[:, None, None, :]
    qh = q.transpose(1, 2).contiguous()
    bi = torch.arange(b, device=dev)

    def lib(caches):  # index_put_ of the new rows into each cache, then SDPA
        for cache, new in zip(caches, (kn, vn)):
            cache[bi, :, w.long()] = new[:, :, 0]
        return F.scaled_dot_product_attention(qh, *caches, attn_mask=valid)

    def k2_then_k1(caches):
        dk.kv_append(*caches, kn, vn, w)
        return dk.decode_attention(q, *caches, lens)

    lib_caches = (kc.clone(), vc.clone())
    lib_out = lib(lib_caches).transpose(1, 2)
    rk, rv = dk.kv_append_plain(kc.clone(), vc.clone(), kn, vn, w)
    if not (torch.equal(lib_caches[0], rk) and torch.equal(lib_caches[1], rv)):
        raise AssertionError("K1 fused: the library yardstick's append differs from the plain one")
    check("K1 fused library yardstick (index_put_ + SDPA)", max_err(lib_out, ref), 2e-2)
    n_read = int(lens.sum().item())
    bms, by = bound(2 * n_read * h * d * 2 + 2 * q.numel() * 2 + 4 * kn.numel() * 2,
                    4 * n_read * h * d, bf16_rate, bw)
    row = {"form": "append", "shape": [b, h, smax, d], "kv_len": int(lens[0]),
           "write_index": int(w[0]), "dtype": "bfloat16", "max_abs_err": err,
           "ms": time_ms(lambda: dk.decode_attention_append(q, *rot.next(), kn, vn, w, lens)),
           "plain_ms": time_ms(lambda: dk.decode_attention_append_plain(q, *rot.next(), kn, vn,
                                                                        w, lens)),
           "k2_then_k1_ms": time_ms(lambda: k2_then_k1(rot.next())),
           "library_ms": time_ms(lambda: lib(rot.next())),
           "library_call": "Tensor.index_put_ (K and V) + SDPA (bool mask)",
           "bound_ms": bms, "bound_by": by}
    log(f"  K1 fused B={b} kv_len {row['kv_len']}: kernel {row['ms']:.4f} ms, K2 then K1 "
        f"{row['k2_then_k1_ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, index_put_ + SDPA "
        f"{row['library_ms']:.4f} ms, bound {bms:.5f} ms")
    return row


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
    err = k6_checks(gen, kc, vc, q, t_mid)
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
    log(f"  K6 write_index {t_mid}: kernel {out['K6']['ms']:.4f} ms, plain "
        f"{out['K6']['plain_ms']:.4f} ms, SDPA {out['K6']['library_ms']:.4f} ms, bound "
        f"{bms:.5f} ms ({dk.window_warps(smax)} warps, tiles a warp)")
    # run (b)'s first and last verify steps
    variants = []
    for t0 in (PROMPT, PROMPT + NEW):
        wt = torch.full((B,), t0, dtype=torch.int32, device=dev)
        lens_t = wt[:, None] + torch.arange(1, WINDOW + 1, device=dev)
        mask_t = (slot[None, None] < lens_t[..., None])[:, None]
        b_t, by_t = bound(2 * B * (t0 + WINDOW) * h * d * 2 + 2 * q.numel() * 2,
                          4 * int(lens_t.sum().item()) * h * d, bf16_rate, bw)
        row = {"shape": [B, h, smax, d], "window": WINDOW, "write_index": t0,
               "dtype": "bfloat16",
               "max_abs_err": max_err(dk.decode_attention_window(q, kc, vc, wt),
                                      dk.decode_attention_window_plain(q, kc, vc, wt)),
               "ms": time_ms(lambda: dk.decode_attention_window(q, *rot.next(), wt)),
               "plain_ms": time_ms(lambda: dk.decode_attention_window_plain(q, *rot.next(), wt)),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(
                   qh, *rot.next(), attn_mask=mask_t)),
               "bound_ms": b_t, "bound_by": by_t}
        check(f"K6 write_index {t0} (timed row)", row["max_abs_err"], 2e-2)
        log(f"  K6 write_index {t0}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, "
            f"SDPA {row['library_ms']:.4f} ms, bound {b_t:.5f} ms")
        variants.append(row)
    variants.append(decode_d90_row(
        "K6", peaks, gen, lambda q, kc, vc, w: dk.decode_attention_window(q, kc, vc, w),
        lambda q, kc, vc, w: dk.decode_attention_window_plain(q, kc, vc, w), window=WINDOW,
        sdpa=True))
    window_fused_checks(gen)
    variants += [window_fused_row(peaks, gen, q, rot, t0) for t0 in (t_mid, PROMPT)]
    out["K6"]["variants"] = variants
    out["K5"]["launches_note"] = ("run (b) appends each verify window inside K6's launch "
                                  "(decode_attention_window_append), so the stand-alone K5 "
                                  "launches 0 times there")
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

    def q8_read(q, kc, vc, n, plain=False):
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        fn = dk.decode_attention_q8_plain if plain else dk.decode_attention_q8
        return fn(q, kq, ks, vq, vs, n)

    out["K9"]["variants"] = q8_read_rows("K9", peaks, gen) + [decode_d90_row(
        "K9", peaks, gen, q8_read, lambda *a: q8_read(*a, plain=True), int8=True)]
    out["K9"]["variants"] += q8_fused_rows("K9", peaks, gen)
    out["K8"]["launches_note"] = ("runs (c) and (d) quantize each step's row and append it "
                                  "inside K9's and K10's launch (decode_attention_q8_append), "
                                  "so the stand-alone K8 launches 0 times there")


def k6_checks(gen, kc, vc, q, t_mid) -> float:
    """K6 against its plain version: at the flagship's shape (bf16, D = 128,
    the tensor-core form, a warp for each 32-slot tile) for windows of 1
    to 8 at write indices from 0, mid-cache, at Smax - NQ and Smax - 1, and
    negative, across the warps' 32-slot tiles and with tiles (warps) that
    hold no valid slot; at D = 64 in bf16 and at D = 128 and 64 in fp32 (the
    CUDA-core form); over a cache long enough for several tiles a warp; and
    twice, bit for bit. Returns the largest error at the flagship's shape."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    smax = kc.shape[2]
    err = 0.0
    for nq in range(1, WINDOW + 1):
        qq = q[:, :nq].contiguous()
        for widx in ([t_mid] * B, [0, 150, smax - nq, smax - 1], [-1, -nq - 3, 127, 128 - nq],
                     [128, 256 - nq, 251, 5]):
            w = torch.tensor(widx, dtype=torch.int32, device=dev)
            e = max_err(dk.decode_attention_window(qq, kc, vc, w),
                        dk.decode_attention_window_plain(qq, kc, vc, w))
            check(f"K6 window {nq} over {tuple(kc.shape)} bf16 write_index {widx}", e, 2e-2)
            err = max(err, e)
    w_mid = torch.full((B,), t_mid, dtype=torch.int32, device=dev)
    if not torch.equal(dk.decode_attention_window(q, kc, vc, w_mid),
                       dk.decode_attention_window(q, kc, vc, w_mid)):
        raise AssertionError("K6: two runs at the flagship's shape differ")
    log("  K6 twice at the flagship's shape: bit-equal")
    for dd, dt, tol in [(64, torch.bfloat16, 2e-2), (128, torch.float32, 1e-4),
                        (64, torch.float32, 1e-4)]:
        for nq in (1, 5, 8):
            qq, ka, va = rnd(3, nq, 4, dd, dt=dt), rnd(3, 4, 300, dd, dt=dt), rnd(3, 4, 300, dd, dt=dt)
            w = torch.tensor([0, 130, 300 - nq], dtype=torch.int32, device=dev)
            check(f"K6 D={dd} {dt} window {nq} over Smax 300",
                  max_err(dk.decode_attention_window(qq, ka, va, w),
                          dk.decode_attention_window_plain(qq, ka, va, w)), tol)
    qq, ka, va = rnd(2, WINDOW, 2, 128), rnd(2, 2, 2100, 128), rnd(2, 2, 2100, 128)
    w = torch.tensor([2100 - WINDOW, 700], dtype=torch.int32, device=dev)
    check(f"K6 over Smax 2100 ({dk.window_warps(2100)} warps, tiles a warp)",
          max_err(dk.decode_attention_window(qq, ka, va, w),
                  dk.decode_attention_window_plain(qq, ka, va, w)), 2e-2)
    return err


def q8_read_rows(kid, peaks, gen) -> list:
    """K9 or K10 (``kid``) beyond its main row (B = 4, Smax 320, kv_len 256),
    at the flagship's H = 32 and D = 128: checked against its plain version
    for kv_len 1, 193, 256, 320 and 0 over Smax 320 and 321 (the staged
    read's slabs all aligned, then scales off 16-byte boundaries), in bf16
    (2e-2) and fp32 (1e-4); over a cache long enough for the staged read's
    ring (K9: Smax 4096; K10: 1536, the reference's longest at this width),
    twice bit for bit; then timed at kv_len 193 and 320 and at B = 1
    (kv_len 256) beside its plain version and bound. Returns the timed rows."""
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops.quant import quantize_kv

    bw, bf16_rate, _, int8_rate = peaks
    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    mxu = kid == "K10"
    fn = dk.decode_attention_q8_mxu if mxu else dk.decode_attention_q8
    plain = dk.decode_attention_q8_mxu_plain if mxu else dk.decode_attention_q8_plain
    h, d = 32, 128

    def cache(b, smax):
        kq, ks = quantize_kv(rnd(b, h, smax, d))
        vq, vs = quantize_kv(rnd(b, h, smax, d))
        return [kq, ks, vq, vs]

    for smax in (PROMPT + NEW, PROMPT + NEW + 1):
        leaves = cache(5, smax)
        lens = torch.tensor([1, PROMPT + 1, 256, PROMPT + NEW, 0], dtype=torch.int32, device=dev)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = rnd(5, 1, h, d, dt=dt)
            got = fn(q, *leaves, lens)
            check(f"{kid} (5, {h}, {smax}, {d}) q {dt} kv_len {lens.tolist()}",
                  max_err(got, plain(q, *leaves, lens)), tol)
            if not torch.all(got[4] == 0):
                raise AssertionError(f"{kid}: kv_len 0 does not give zeros")
    smax = 1536 if mxu else 4096
    chunk, stages = dk.q8_stage_plan(smax, d, mxu=mxu)
    leaves = [t[:, :8].contiguous() for t in cache(2, smax)]
    lens = torch.tensor([chunk - 5, smax], dtype=torch.int32, device=dev)
    q = rnd(2, 1, 8, d, dt=torch.float32)
    got = fn(q, *leaves, lens)
    check(f"{kid} Smax {smax} (a ring of {stages} stages of {chunk} slots) q fp32",
          max_err(got, plain(q, *leaves, lens)), 1e-4)
    if not torch.equal(got, fn(q, *leaves, lens)):
        raise AssertionError(f"{kid}: two runs through the ring differ")
    log(f"  {kid} through the ring twice: bit-equal")

    rows = []
    for b, n in ((B, PROMPT + 1), (B, PROMPT + NEW), (1, 256)):
        smax = PROMPT + NEW
        rot = Rotating([cache(b, smax) for _ in range(8)])
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        q = rnd(b, 1, h, d)
        err = max_err(fn(q, *rot.copies[0], lens), plain(q, *rot.copies[0], lens))
        check(f"{kid} timed row B={b} kv_len {n}", err, 2e-2)
        bms, by = bound(2 * b * n * h * (d + 2) + 2 * q.numel() * 2,
                        (8 if mxu else 4) * b * n * h * d, int8_rate if mxu else bf16_rate, bw)
        row = {"shape": [b, h, smax, d], "kv_len": n, "dtype": "int8 KV, bf16 q",
               "max_abs_err": err, "ms": time_ms(lambda: fn(q, *rot.next(), lens)),
               "plain_ms": time_ms(lambda: plain(q, *rot.next(), lens)), "library_ms": None,
               "bound_ms": bms, "bound_by": by}
        log(f"  {kid} B={b} kv_len {n}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} "
            f"ms, bound {bms:.5f} ms ({by})")
        rows.append(row)
        del rot
    return rows


def decode_d90_row(kid, peaks, gen, kernel, plain, *, window=0, sdpa=False, int8=False,
                   mxu=False):
    """K1, K6, K9 or K10 at the flagship's decode shape but head dim 90 (rows
    that are not a whole number of the kernels' vector loads: their scalar
    or byte tail) in bf16, checked against the plain version (2e-2) and in
    fp32 (1e-4) at a small shape, then timed in bf16 with the plain version
    and, for K1 and K6, SDPA with a boolean mask. K9 and K10 (``mxu``) read
    an int8 cache quantized from the same rows (its quantization is outside
    the timed call)."""
    from mmmm_tpu_torch.ops.quant import quantize_kv

    bw, bf16_rate, _, _ = peaks
    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    h, d, smax = 32, 90, PROMPT + NEW + window
    nq = window or 1
    for b, s_, dt, tol in ((3, 50, torch.float32, 1e-4), (B, smax, torch.bfloat16, 2e-2)):
        q, kc, vc = rnd(b, nq, h, d, dt=dt), rnd(b, h, s_, d, dt=dt), rnd(b, h, s_, d, dt=dt)
        n = torch.tensor([0, s_ // 2, s_ - nq, s_ - nq][:b], dtype=torch.int32, device=dev)
        if window == 0:
            n[-1] = s_
        err = max_err(kernel(q, kc, vc, n), plain(q, kc, vc, n))
        check(f"{kid} D=90 {(b, h, s_, d)} {dt}" + (f" window {nq}" if window else ""), err, tol)
    mid = torch.full((B,), (PROMPT + 1 + PROMPT + NEW) // 2, dtype=torch.int32, device=dev)
    if int8:
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        from mmmm_tpu_torch.ops import decode_kernel as dk

        if mxu:
            fn = lambda: dk.decode_attention_q8_mxu(q, kq, ks, vq, vs, mid)
            pfn = lambda: dk.decode_attention_q8_mxu_plain(q, kq, ks, vq, vs, mid)
        else:
            fn = lambda: dk.decode_attention_q8(q, kq, ks, vq, vs, mid)
            pfn = lambda: dk.decode_attention_q8_plain(q, kq, ks, vq, vs, mid)
    else:
        fn, pfn = (lambda: kernel(q, kc, vc, mid)), (lambda: plain(q, kc, vc, mid))
    n_read = int(mid.sum().item()) + (B * nq if window else 0)  # slots read
    elem = 1 if int8 else 2
    bms, by = bound(2 * n_read * h * (d * elem + (2 if int8 else 0)) + 2 * q.numel() * 2,
                    4 * n_read * h * d * nq, bf16_rate, bw)
    row = {"shape": [B, h, smax, d], "dtype": "int8 KV, bf16 q" if int8 else "bfloat16",
           "max_abs_err": err, "ms": time_ms(fn), "plain_ms": time_ms(pfn), "library_ms": None,
           "bound_ms": bms, "bound_by": by}
    if sdpa:  # a boolean mask: query j of a window sees the slots < mid + j + 1
        qh = q.transpose(1, 2).contiguous()
        lens = mid[:, None] + (torch.arange(1, nq + 1, device=dev) if window else 0)
        valid = (torch.arange(smax, device=dev)[None, None] < lens[..., None])[:, None]
        row["library_ms"] = time_ms(lambda: F.scaled_dot_product_attention(qh, kc, vc,
                                                                           attn_mask=valid))
    lib = "" if row["library_ms"] is None else f", SDPA {row['library_ms']:.4f} ms"
    log(f"  {kid} D=90: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms{lib}, bound "
        f"{bms:.4f} ms")
    return row


def q8_append_check(kid, cache, q, kn, vn, widx, lens, cast="f32"):
    """K9's or K10's (``kid``) fused form at one set of write indices and
    lengths: the caches bit-equal to the plain sequence's (``quantize_kv``,
    ``kv_append_q8_plain``) and to ``quantize_kv`` then K8's, so the
    in-launch quantization gives ``quantize_kv``'s bits; the output
    bit-equal to K8 then the read's, twice; one launch of the read in its
    form "append", none of K8. K9 with its products in ``cast``. Returns the
    error against the plain version."""
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops.quant import quantize_kv

    mxu = kid == "K10"
    kern = dk.K10 if mxu else dk.K9
    dev = q.device
    w = torch.tensor(widx, dtype=torch.int32, device=dev)
    n = torch.tensor(lens, dtype=torch.int32, device=dev)
    plain = {k: t.clone() for k, t in cache.items()}
    ref = dk.decode_attention_q8_append_plain(q, plain, kn, vn, w, n, q8_mxu=mxu, cast=cast)
    seq = {k: t.clone() for k, t in cache.items()}
    dk.kv_append_q8(seq, *quantize_kv(kn.transpose(1, 2)), *quantize_kv(vn.transpose(1, 2)), w)
    want = dk.decode_attention_q8(q, *(seq[k] for k in dk.Q8_LEAVES), n, q8_mxu=mxu, cast=cast)
    outs = []
    for _ in range(2):
        got = {k: t.clone() for k, t in cache.items()}
        before = (kern.launches, kern.forms.get("append", 0), dk.K8.launches)
        outs.append(dk.decode_attention_q8_append(q, got, kn, vn, w, n, q8_mxu=mxu, cast=cast))
        if (kern.launches, kern.forms.get("append", 0), dk.K8.launches) != (
                before[0] + 1, before[1] + 1, before[2]):
            raise AssertionError(f"{kid} fused: not one launch of its form 'append'")
        for k in dk.Q8_LEAVES:
            if not torch.equal(got[k], plain[k]) or not torch.equal(got[k], seq[k]):
                bad = (got[k] != plain[k]).sum().item()
                raise AssertionError(f"{kid} fused write_index {widx}: leaf {k} differs from "
                                     f"quantize_kv then K8's in {bad} elements")
    if not torch.equal(outs[0], want):
        raise AssertionError(f"{kid} fused write_index {widx}: output not K8 then {kid}'s bits "
                             f"(max {max_err(outs[0], want):.3e})")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"{kid} fused write_index {widx}: two runs differ")
    if not torch.all(outs[0][n <= 0] == 0):
        raise AssertionError(f"{kid} fused: kv_len 0 does not give zeros")
    return max_err(outs[0], ref)


def q8_fused_rows(kid, peaks, gen) -> list:
    """K9's or K10's (``kid``) fused form (``quantize_kv`` of the step's new
    row and K8's append inside the read's launch), checked by
    ``q8_append_check`` at the flagship's H = 32 and D = 128 and 90 over
    Smax 320 and 321, q in bf16 and fp32, B = 4 and 1, at write indices in
    range, at either end, past Smax, negative and at or past kv_len, over
    new rows that are views of one (B, 1, 3H, D) projection; through the
    staged read's ring (K9 Smax 4096, K10 1536); K10 past its shared
    memory. Then timed at runs (c)'s and (d)'s step (write index kv_len - 1)
    at kv_len 256, B = 4 and B = 1, beside the read alone, K8 then the read
    (two launches, the rows quantized before), ``quantize_kv`` twice, K8
    and the read (the step before this form) and the plain version; the
    bound counts the cache's slots other than the written one, q and the
    output, the new rows read and the int8 rows and scales written. Returns
    the timed rows."""
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops.quant import quantize_kv

    bw, bf16_rate, _, int8_rate = peaks
    dev = torch.device("cuda")
    mxu = kid == "K10"
    h = 32

    def step(b, h, smax, d, dt):
        kq, ks = quantize_kv(torch.randn(b, h, smax, d, generator=gen, device=dev))
        vq, vs = quantize_kv(torch.randn(b, h, smax, d, generator=gen, device=dev))
        qkv = torch.randn(b, 1, 3 * h, d, generator=gen, device=dev).to(dt)
        return (qkv[:, :, :h].contiguous(), {"kq": kq, "ks": ks, "vq": vq, "vs": vs},
                qkv[:, :, h:2 * h], qkv[:, :, 2 * h:])

    for smax in (PROMPT + NEW, PROMPT + NEW + 1):
        for d in (128, 90):
            for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
                q, cache, kn, vn = step(B, h, smax, d, dt)
                errs = [q8_append_check(kid, cache, q, kn, vn, widx, lens) for widx, lens in (
                    ([PROMPT, 0, smax - 1, smax + 7], [PROMPT + 1, 1, smax, smax]),
                    ([-1, 5, 300, -400], [smax, 6, 301, 256]),
                    ([256, 200, 10, smax - 1], [PROMPT + 1, 0, 5, 256]))]
                one = {k: t[:1] for k, t in cache.items()}
                errs += [q8_append_check(kid, one, q[:1], kn[:1], vn[:1], [w], [n])
                         for w, n in ((255, 256), (smax - 1, 0), (-3, smax))]
                check(f"{kid} fused (B, {h}, {smax}, {d}) q {str(dt).split('.')[-1]}: caches "
                      "as quantize_kv then K8, output as K8 then the read, bit for bit", max(errs),
                      tol)
    smax = 1536 if mxu else 4096
    for d in (128, 90):
        chunk, stages = dk.q8_stage_plan(smax, d, mxu=mxu)
        q, cache, kn, vn = step(4, 8, smax, d, torch.float32)
        err = max(q8_append_check(kid, cache, q, kn, vn, [chunk - 6, 2 * chunk, smax - 1, -1],
                                  [chunk - 5, 2 * chunk + 1, smax - 100, smax]),
                  q8_append_check(kid, cache, q, kn, vn, [0, chunk + 3, 5, smax + 2],
                                  [0, chunk + 1, 2 * chunk + 1, smax]))
        check(f"{kid} fused through the ring (Smax {smax}, D {d}, {stages} stages of {chunk} "
              "slots)", err, 1e-4)
    if mxu:
        big = dk.Q8_MXU_SHARED_SLOTS + 7232
        q, cache, kn, vn = step(1, 3, big, 16, torch.float32)
        check(f"K10 fused Smax {big} (workspace)", max(
            q8_append_check(kid, cache, q, kn, vn, [big - 4], [big - 3]),
            q8_append_check(kid, cache, q, kn, vn, [-1], [big])), 1e-4)

    read = dk.decode_attention_q8_mxu if mxu else dk.decode_attention_q8
    rows = []
    for b, n in ((B, 256), (1, 256)):
        smax, d = PROMPT + NEW, 128
        steps = [step(b, h, smax, d, torch.bfloat16) for _ in range(8)]
        q, _, kn, vn = steps[0]
        caches = Rotating([c for _, c, _, _ in steps])
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        w = lens - 1
        new = [*quantize_kv(kn.transpose(1, 2)), *quantize_kv(vn.transpose(1, 2))]
        leaves = lambda c: [c[k] for k in dk.Q8_LEAVES]
        fused = lambda: dk.decode_attention_q8_append(q, caches.next(), kn, vn, w, lens,
                                                      q8_mxu=mxu)

        def k8_then_read():
            c = caches.next()
            dk.kv_append_q8(c, *new, w)
            return read(q, *leaves(c), lens)

        def quantize_k8_read():  # the step as the decoder ran it before this form
            c = caches.next()
            dk.kv_append_q8(c, *quantize_kv(kn.transpose(1, 2)), *quantize_kv(vn.transpose(1, 2)),
                            w)
            return read(q, *leaves(c), lens)

        err = q8_append_check(kid, steps[0][1], q, kn, vn, w.tolist(), lens.tolist())
        check(f"{kid} fused timed row B={b} kv_len {n}", err, 2e-2)
        # slot n - 1 comes from the new rows, so the cache gives n - 1 slots
        n_read = b * (n - 1)
        new_bytes = 2 * b * h * d * 2 + 2 * b * h * (d + 2)  # bf16 rows in, int8 rows + scales out
        bms, by = bound(2 * n_read * h * (d + 2) + 2 * q.numel() * 2 + new_bytes,
                        (8 if mxu else 4) * b * n * h * d, int8_rate if mxu else bf16_rate, bw)
        row = {"form": "append", "shape": [b, h, smax, d], "kv_len": n, "write_index": n - 1,
               "dtype": "int8 KV, bf16 q and new rows", "max_abs_err": err,
               "ms": time_ms(fused),
               "read_ms": time_ms(lambda: read(q, *leaves(caches.next()), lens)),
               "k8_then_read_ms": time_ms(k8_then_read),
               "quantize_k8_read_ms": time_ms(quantize_k8_read),
               "plain_ms": time_ms(lambda: dk.decode_attention_q8_append_plain(
                   q, caches.next(), kn, vn, w, lens, q8_mxu=mxu)),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        log(f"  {kid} fused B={b} kv_len {n}: kernel {row['ms']:.4f} ms, the read alone "
            f"{row['read_ms']:.4f} ms, K8 then {kid} {row['k8_then_read_ms']:.4f} ms, "
            f"quantize_kv x2 + K8 + {kid} {row['quantize_k8_read_ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, bound {bms:.5f} ms ({by})")
        rows.append(row)
        del steps, caches
    return rows


# K4's fast softmax is held to dense_attention_fast_tiles: the same roundings
# in the kernel's order of key tiles (its running max). What is left: fp32
# sums in other orders, and a logit within fp32 noise of a bf16 boundary of
# s - m that rounds to the other neighbour (one probability moves by up to
# 2^-8 |s - m| p). On the CPU, fp64 against fp32 logits moved the outputs by
# 1.4e-7 / 2.1e-7 in the mean and 9.8e-4 (one bf16 step) / 2.3e-4 at most,
# bf16 / fp32, at these shapes. The limits: 1e-5 in the mean, and 2^-7 (two
# steps of the largest bf16 output) / 1e-3 of the largest output at most.
# The exact softmax sits 1.3e-4 to 3.8e-4 away in the mean, so the default
# form fails the mean limit: checked on the default K4's own output.
FAST_TOL = {torch.bfloat16: 2 ** -7, torch.float32: 1e-3}
FAST_MEAN_TOL = 1e-5


def switch_kernel_rows(peaks, gen, out) -> None:
    """The kernel forms of the reference's non-default numeric switches,
    each held to its plain version and timed beside its default form:
    K4's fast softmax (``MMMM_DENSE_FAST_SOFTMAX``; K12 is the same kernel;
    held to the plain fast form in the kernel's order of key tiles, and the
    default form shown to miss that check)
    at the ViT's (B, 1153, 16, 112) bf16 and the SAM encoder's (B, 512, 12,
    64) fp32 shapes, twice bit for bit; K9's bf16 cast (``MMMM_Q8_CAST``)
    at H = 32, D = 128 for kv_len 1, 193, 256, 320 and 0 over Smax 320 and
    321, q in bf16 and fp32, twice bit for bit, its fused form at every
    write-index edge (caches bit-equal to the appends', the output K8 then
    the bf16 read's), both timed at kv_len 256, B = 4 and 1. The rows go to
    ``out["K4"]["variants"]`` and ``out["K9"]["variants"]``."""
    from mmmm_tpu_torch.ops import decode_kernel as dk
    from mmmm_tpu_torch.ops import dense_attn as da
    from mmmm_tpu_torch.ops.quant import quantize_kv

    bw, bf16_rate, fp32_rate, _ = peaks
    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    log("K4 fast softmax (the reference's MMMM_DENSE_FAST_SOFTMAX; K12 runs the same kernel)")
    for label, (b, s, h, d, dt) in {"vit": (B, 1153, 16, 112, torch.bfloat16),
                                    "sam": (B, 512, 12, 64, torch.float32)}.items():
        q, k, v = (rnd(b, s, h, d, dt=dt) for _ in range(3))
        scale = d ** -0.5
        fast = lambda: da.dense_attention(q, k, v, scale, fast_softmax=True)
        got = fast()
        ref = da.dense_attention_fast_tiles(q, k, v, scale)
        top = ref.float().abs().max().item()
        err = max_err(got, ref)
        check(f"K4 fast {label} {tuple(q.shape)} {dt} (largest output {top:.3f})", err,
              FAST_TOL[dt] * top)
        mean = (got.float() - ref.float()).abs().mean().item()
        default_mean = (da.dense_attention(q, k, v, scale).float()
                        - ref.float()).abs().mean().item()
        log(f"  K4 fast {label}: mean_abs_err {mean:.3e} (tol {FAST_MEAN_TOL:g}); the default "
            f"form's {default_mean:.3e}")
        if not mean <= FAST_MEAN_TOL:
            raise AssertionError(f"K4 fast {label}: mean_abs_err {mean} > {FAST_MEAN_TOL}")
        if not default_mean > 4 * FAST_MEAN_TOL:
            raise AssertionError(f"K4 fast {label}: the default form is {default_mean} from the "
                                 "fast form, too close for the check to tell them apart")
        if not torch.equal(got, fast()):
            raise AssertionError(f"K4 fast {label}: two runs differ")
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bms, by = bound(4 * q.numel() * q.element_size(), 4 * b * h * s * s * d,
                        bf16_rate if dt == torch.bfloat16 else fp32_rate, bw)
        row = {"form": "fast", "site": label, "shape": [b, s, h, d],
               "dtype": str(dt).split(".")[-1], "max_abs_err": err, "mean_abs_err": mean,
               "default_form_mean_abs_err": default_mean, "ms": time_ms(fast),
               "default_form_ms": time_ms(lambda: da.dense_attention(q, k, v, scale)),
               "plain_ms": time_ms(lambda: da.dense_attention_plain(q, k, v, scale,
                                                                    fast_softmax=True), inner=2),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                            scale=scale)),
               "bound_ms": bms, "bound_by": by}
        log(f"  K4 fast {label}: kernel {row['ms']:.4f} ms (default form "
            f"{row['default_form_ms']:.4f}), plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
        out["K4"]["variants"].append(row)

    log("K9 bf16 cast (the reference's MMMM_Q8_CAST=bf16 on its ragged route)")
    h, d = 32, 128

    def cache(b, smax):
        kq, ks = quantize_kv(rnd(b, h, smax, d))
        vq, vs = quantize_kv(rnd(b, h, smax, d))
        return [kq, ks, vq, vs]

    for smax in (PROMPT + NEW, PROMPT + NEW + 1):
        leaves = cache(5, smax)
        lens = torch.tensor([1, PROMPT + 1, 256, PROMPT + NEW, 0], dtype=torch.int32, device=dev)
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            q = rnd(5, 1, h, d, dt=dt)
            got = dk.decode_attention_q8(q, *leaves, lens, cast="bf16")
            check(f"K9 bf16 (5, {h}, {smax}, {d}) q {dt} kv_len {lens.tolist()}",
                  max_err(got, dk.decode_attention_q8_plain(q, *leaves, lens, cast="bf16")), tol)
            if not torch.all(got[4] == 0) or not torch.equal(
                    got, dk.decode_attention_q8(q, *leaves, lens, cast="bf16")):
                raise AssertionError("K9 bf16: kv_len 0 is not zeros, or two runs differ")
        kq, ks = quantize_kv(rnd(B, h, smax, d))
        vq, vs = quantize_kv(rnd(B, h, smax, d))
        qkv = rnd(B, 1, 3 * h, d)
        q, kn, vn = qkv[:, :, :h].contiguous(), qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
        step = {"kq": kq, "ks": ks, "vq": vq, "vs": vs}
        errs = [q8_append_check("K9", step, q, kn, vn, widx, n, cast="bf16") for widx, n in (
            ([PROMPT, 0, smax - 1, smax + 7], [PROMPT + 1, 1, smax, smax]),
            ([-1, 5, 300, -400], [smax, 6, 301, 256]),
            ([256, 200, 10, smax - 1], [PROMPT + 1, 0, 5, 256]))]
        one = {k: t[:1] for k, t in step.items()}
        errs += [q8_append_check("K9", one, q[:1], kn[:1], vn[:1], [w], [n], cast="bf16")
                 for w, n in ((255, 256), (smax - 1, 0), (-3, smax))]
        check(f"K9 bf16 fused (B, {h}, {smax}, {d}): caches as quantize_kv then K8, output as "
              "K8 then the bf16 read, bit for bit", max(errs), 2e-2)
    for b in (B, 1):
        smax, n = PROMPT + NEW, 256
        rot = Rotating([cache(b, smax) for _ in range(8)])
        lens = torch.full((b,), n, dtype=torch.int32, device=dev)
        q = rnd(b, 1, h, d)
        err = max_err(dk.decode_attention_q8(q, *rot.copies[0], lens, cast="bf16"),
                      dk.decode_attention_q8_plain(q, *rot.copies[0], lens, cast="bf16"))
        check(f"K9 bf16 timed row B={b} kv_len {n}", err, 2e-2)
        bms, by = bound(2 * b * n * h * (d + 2) + 2 * q.numel() * 2, 4 * b * n * h * d,
                        bf16_rate, bw)
        row = {"form": "bf16", "shape": [b, h, smax, d], "kv_len": n,
               "dtype": "int8 KV, bf16 q, bf16 products", "max_abs_err": err,
               "ms": time_ms(lambda: dk.decode_attention_q8(q, *rot.next(), lens, cast="bf16")),
               "default_form_ms": time_ms(lambda: dk.decode_attention_q8(q, *rot.next(), lens)),
               "plain_ms": time_ms(lambda: dk.decode_attention_q8_plain(q, *rot.next(), lens,
                                                                        cast="bf16")),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        log(f"  K9 bf16 B={b} kv_len {n}: kernel {row['ms']:.4f} ms (fp32 form "
            f"{row['default_form_ms']:.4f}), plain {row['plain_ms']:.4f} ms, bound {bms:.5f} ms")
        out["K9"]["variants"].append(row)
        steps = [{k: t for k, t in zip(dk.Q8_LEAVES, c)} for c in rot.copies]
        caches = Rotating(steps)
        qkv = rnd(b, 1, 3 * h, d)
        q, kn, vn = qkv[:, :, :h].contiguous(), qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
        w = lens - 1
        fused = lambda cast: (lambda: dk.decode_attention_q8_append(q, caches.next(), kn, vn, w,
                                                                     lens, cast=cast))
        err = q8_append_check("K9", steps[0], q, kn, vn, w.tolist(), lens.tolist(), cast="bf16")
        new_bytes = 2 * b * h * d * 2 + 2 * b * h * (d + 2)
        bms, by = bound(2 * b * (n - 1) * h * (d + 2) + 2 * q.numel() * 2 + new_bytes,
                        4 * b * n * h * d, bf16_rate, bw)
        row = {"form": "append, bf16", "shape": [b, h, smax, d], "kv_len": n,
               "write_index": n - 1, "dtype": "int8 KV, bf16 q and new rows, bf16 products",
               "max_abs_err": err, "ms": time_ms(fused("bf16")),
               "default_form_ms": time_ms(fused("f32")),
               "plain_ms": time_ms(lambda: dk.decode_attention_q8_append_plain(
                   q, caches.next(), kn, vn, w, lens, cast="bf16")),
               "library_ms": None, "bound_ms": bms, "bound_by": by}
        log(f"  K9 bf16 fused B={b} kv_len {n}: kernel {row['ms']:.4f} ms (fp32 form "
            f"{row['default_form_ms']:.4f}), plain {row['plain_ms']:.4f} ms, bound {bms:.5f} ms")
        out["K9"]["variants"].append(row)
        del rot, steps, caches


def window_append_check(kc, vc, q, kn, vn, widx) -> float:
    """K6's fused form at one set of write indices: the caches bit-equal to
    the plain sequence's and to K5's, the output bit-equal to K5 then K6's,
    twice; one K6 launch in its form "append", none of K5. Returns the
    error against the plain version."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    w = torch.tensor(widx, dtype=torch.int32, device=q.device)
    pk, pv = kc.clone(), vc.clone()
    ref = dk.decode_attention_window_append_plain(q, pk, pv, kn, vn, w)
    sk, sv = kc.clone(), vc.clone()
    dk.kv_append_multi(sk, sv, kn.transpose(1, 2).contiguous(), vn.transpose(1, 2).contiguous(), w)
    want = dk.decode_attention_window(q, sk, sv, w)
    outs = []
    for _ in range(2):
        gk, gv = kc.clone(), vc.clone()
        before = (dk.K6.launches, dk.K6.forms.get("append", 0), dk.K5.launches)
        outs.append(dk.decode_attention_window_append(q, gk, gv, kn, vn, w))
        if (dk.K6.launches, dk.K6.forms.get("append", 0), dk.K5.launches) != (
                before[0] + 1, before[1] + 1, before[2]):
            raise AssertionError("K6 fused: not one launch of its form 'append'")
        if not all(torch.equal(a, b_) for a, b_ in ((gk, pk), (gv, pv), (gk, sk), (gv, sv))):
            raise AssertionError(f"K6 fused write_index {widx}: caches differ from K5's")
    if not torch.equal(outs[0], want):
        raise AssertionError(f"K6 fused write_index {widx}: output not K5 then K6's bits "
                             f"(max {max_err(outs[0], want):.3e})")
    if not torch.equal(outs[0], outs[1]):
        raise AssertionError(f"K6 fused write_index {widx}: two runs differ")
    return max_err(outs[0], ref)


def window_fused_checks(gen) -> None:
    """K6's fused form (K5's append inside K6's launch) by
    ``window_append_check`` at run (b)'s cache (4, 32, 328, D), windows of
    1, 3 and 8 rows that are views of one (B, K, 3H, D) projection, D = 128
    and 64 (bf16: the tensor-core form) and 90 (the CUDA-core form), in
    bf16 and fp32, at write indices in the middle, at a tile's edge, at
    Smax - K, past it (the rows shift back whole, the mask keeps the raw
    index), negative, and at B = 1; over Smax 2100 (several tiles a warp),
    windows straddling two tiles."""
    dev = torch.device("cuda")
    h, smax = 32, PROMPT + NEW + WINDOW

    def step(b, nq, h, smax, d, dt):
        kc, vc = (torch.randn(b, h, smax, d, generator=gen, device=dev).to(dt) for _ in range(2))
        qkv = torch.randn(b, nq, 3 * h, d, generator=gen, device=dev).to(dt)
        return kc, vc, qkv[:, :, :h].contiguous(), qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]

    for d in (128, 64, 90):
        for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
            errs = []
            for nq in (1, 3, WINDOW):
                kc, vc, q, kn, vn = step(B, nq, h, smax, d, dt)
                errs += [window_append_check(kc, vc, q, kn, vn, widx) for widx in (
                    [256, 31 - nq // 2, smax - nq, smax - 1], [-1, -nq - 3, smax + 12, 128 - nq],
                    [-smax, 0, 95, 5])]
                errs.append(window_append_check(kc[:1], vc[:1], q[:1], kn[:1], vn[:1], [200]))
            check(f"K6 fused (B, {h}, {smax}, {d}) {str(dt).split('.')[-1]}, windows 1, 3, 8: "
                  "caches as K5, output as K5 then K6, bit for bit", max(errs), tol)
    for dt, tol in ((torch.bfloat16, 2e-2), (torch.float32, 1e-4)):
        kc, vc, q, kn, vn = step(2, WINDOW, 2, 2100, 128, dt)
        check(f"K6 fused over Smax 2100 {str(dt).split('.')[-1]}", max(
            window_append_check(kc, vc, q, kn, vn, widx)
            for widx in ([2092, 700], [28, 1000], [-1, 2099], [-2000, 222])), tol)


def window_fused_row(peaks, gen, q, rot, t0) -> dict:
    """K6's fused form at a run-(b) verify step (write index ``t0``, bf16,
    D = 128) over rotating caches: checked, then timed beside the read
    alone, K5 then K6 (two launches) and the plain version; the bound
    counts the cache's slots before the window, q and the output, and the
    window's rows read and written."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    bw, bf16_rate, _, _ = peaks
    kc, vc = rot.copies[0]
    b, h, smax, d = kc.shape
    dev = q.device
    qkv = torch.randn(b, WINDOW, 3 * h, d, generator=gen, device=dev).to(kc.dtype)
    kn, vn = qkv[:, :, h:2 * h], qkv[:, :, 2 * h:]
    kt, vt = kn.transpose(1, 2).contiguous(), vn.transpose(1, 2).contiguous()
    w = torch.full((b,), t0, dtype=torch.int32, device=dev)
    err = window_append_check(kc, vc, q, kn, vn, w.tolist())
    check(f"K6 fused timed row write_index {t0}", err, 2e-2)

    def k5_then_k6():
        caches = rot.next()
        dk.kv_append_multi(*caches, kt, vt, w)
        return dk.decode_attention_window(q, *caches, w)

    lens = t0 + torch.arange(1, WINDOW + 1, device=dev)
    # the window's slots come from its new rows: the caches give the t0 before them
    new_bytes = 4 * b * h * WINDOW * d * 2  # K and V rows read, then written
    bms, by = bound(2 * b * t0 * h * d * 2 + 2 * q.numel() * 2 + new_bytes,
                    4 * b * int(lens.sum().item()) * h * d, bf16_rate, bw)
    row = {"form": "append", "shape": [b, h, smax, d], "window": WINDOW, "write_index": t0,
           "dtype": "bfloat16", "max_abs_err": err,
           "ms": time_ms(lambda: dk.decode_attention_window_append(q, *rot.next(), kn, vn, w)),
           "read_ms": time_ms(lambda: dk.decode_attention_window(q, *rot.next(), w)),
           "k5_then_k6_ms": time_ms(k5_then_k6),
           "plain_ms": time_ms(lambda: dk.decode_attention_window_append_plain(
               q, *rot.next(), kn, vn, w)),
           "library_ms": None, "bound_ms": bms, "bound_by": by}
    log(f"  K6 fused write_index {t0}: kernel {row['ms']:.4f} ms, the read alone "
        f"{row['read_ms']:.4f} ms, K5 then K6 {row['k5_then_k6_ms']:.4f} ms, plain "
        f"{row['plain_ms']:.4f} ms, bound {bms:.5f} ms ({by})")
    return row


def w4_weight(kk: int, nn: int, rnd) -> dict:
    """A random int4 weight multiplied as (kk, nn): one of run (d)'s, or, at
    a shape of ``W4_TP_SHAPES``, a rank's piece (``local_params``) of a
    whole one over its ranks."""
    from mmmm_tpu_torch.ops.quant import quantize_int4
    from mmmm_tpu_torch.parallel.sharding import local_params

    if (kk, nn) not in W4_TP_SHAPES:
        return quantize_int4(rnd(kk, nn, dt=torch.float32).mul_(0.02))
    (wk, wn), leaf, tp, rank = W4_TP_SHAPES[(kk, nn)]
    keys = ("llm", "layers", *leaf.split("/"))
    tree = node = {}
    for key in keys[:-1]:
        node = node.setdefault(key, {})
    node[keys[-1]] = quantize_int4(rnd(1, wk, wn, dt=torch.float32).mul_(0.02))
    piece = local_params(tree, ({"model": tp}, rank))
    for key in keys:
        piece = piece[key]
    w = {k: v[0] for k, v in piece.items()}
    if w["q4"].shape != (kk // 2, nn):
        raise AssertionError(f"the piece of {leaf} is {tuple(w['q4'].shape)}, not "
                             f"({kk // 2}, {nn})")
    return w


def capacity_kernel_phase(peaks, gen, out):
    """K10 (the split-int8 read, at K9's shape, at head dims off its 16-byte
    lanes and past its shared memory) and K11 (W4A16: the decode-row kernel
    at greedy decode rows on each of run (d)'s weight shapes, the
    tensor-core tile K11mma at a batch's 4 x 146 vision rows) at the
    flagship's shapes."""
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
    # every head dim up to 128: whole 16-byte lanes (16, 64), lanes rounded
    # up (48), and rows read a byte at a time (90, 100, 8)
    for dd in (16, 64, 48, 90, 100, 8):
        kq, ks = quantize_kv(rnd(3, 4, 40, dd))
        vq, vs = quantize_kv(rnd(3, 4, 40, dd))
        ln = torch.tensor([0, 17, 40], dtype=torch.int32, device=dev)
        for qdt, tol in ((torch.float32, 1e-4), (torch.bfloat16, 2e-2)):
            qq = rnd(3, 1, 4, dd, dt=qdt)
            check(f"K10 edge D={dd} q {qdt}",
                  max_err(dk.decode_attention_q8_mxu(qq, kq, ks, vq, vs, ln),
                          dk.decode_attention_q8_mxu_plain(qq, kq, ks, vq, vs, ln)), tol)
    # Smax past what shared memory holds (the logits in a workspace), where the
    # reference's gate admits it: H % 4 != 0 (head chunk 1), D = 16
    big = dk.Q8_MXU_SHARED_SLOTS + 7232
    assert dk._q8_mxu_eligible(3, big, 16) and not dk.q8_mxu_in_shared(big)
    kq, ks = quantize_kv(rnd(1, 3, big, 16))
    vq, vs = quantize_kv(rnd(1, 3, big, 16))
    qq = rnd(1, 1, 3, 16, dt=torch.float32)
    ln = torch.tensor([big - 5], dtype=torch.int32, device=dev)
    check(f"K10 Smax {big} (workspace) q fp32",
          max_err(dk.decode_attention_q8(qq, kq, ks, vq, vs, ln, q8_mxu=True),
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

    def mxu_read(q, kc, vc, n, plain=False):
        kq, ks = quantize_kv(kc)
        vq, vs = quantize_kv(vc)
        fn = dk.decode_attention_q8_mxu_plain if plain else dk.decode_attention_q8_mxu
        return fn(q, kq, ks, vq, vs, n)

    row = decode_d90_row("K10", peaks, gen, mxu_read, lambda *a: mxu_read(*a, plain=True),
                         int8=True, mxu=True)
    row["k9_ms_same_shape"] = next(r["ms"] for r in out["K9"]["variants"]
                                   if r["shape"][3] == 90 and r.get("form") is None)
    out["K10"]["variants"] = q8_read_rows("K10", peaks, gen) + [row]
    out["K10"]["variants"] += q8_fused_rows("K10", peaks, gen)
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

    # K11 at decode rows (1, 4, 16 in bf16, 4 in fp32), twice bit for bit;
    # K11mma at the row counts W4A16 serving passes (text rows 4 x 46 and
    # vision rows 4 x 145, whole and in chunks of 2), at 4 x 146 and 2 x 146,
    # and at tile edges; on each of run (d)'s four weight shapes and each
    # rank's pieces of them in phase 7c
    for kk, nn in (*W4_SHAPES, *W4_TP_SHAPES):
        w = w4_weight(kk, nn, rnd)
        for m, dt in ((1, torch.bfloat16), (4, torch.bfloat16), (16, torch.bfloat16),
                      (4, torch.float32), (17, torch.bfloat16),
                      (64, torch.bfloat16), (65, torch.bfloat16), (92, torch.bfloat16),
                      (184, torch.bfloat16), (290, torch.bfloat16), (292, torch.bfloat16),
                      (580, torch.bfloat16), (584, torch.bfloat16)):
            x = rnd(m, kk, dt=dt)
            kern = w4.route(m, kk, nn, 128, dt)
            w4_check(f"K11 ({m}, {kk}) x {kk}x{nn} {dt} -> {kern}", x, w)
            if kern == "K11" and not torch.equal(w4.w4_matmul(x, w["q4"], w["s4"]),
                                                 w4.w4_matmul(x, w["q4"], w["s4"])):
                raise AssertionError(f"K11: two runs at ({m}, {kk}) x {kk}x{nn} {dt} differ")
        log(f"  K11 {kk}x{nn}: two runs bit-equal at every decode row count")
    # K11mma's two tile widths at the W4A16 prefill's shapes (4 x 145 vision
    # and 4 x 46 text rows, in run (d)'s chunks of 2 and whole, on each of
    # the five products' weights and a rank's pieces of them in phase 7c):
    # each checked, then timed against the other; mma_tpw picks one
    log("K11mma tile widths at the prefill's shapes (TPW 64-column tiles a warpgroup)")
    tpw_rows = []
    for kk, nn in (*W4_SHAPES, *W4_TP_SHAPES):
        wset = Rotating([w4_weight(kk, nn, rnd) for _ in range(4)])
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
            row = {"shape": [m, kk, nn], "picked": w4.mma_tpw(m, nn), "tpw2_ms": None}
            for tpw in (1, 2) if nn % (2 * w4.MMA_BN) == 0 else (1,):  # TPW 2: N % 256
                check(f"K11mma TPW={tpw} ({m}, {kk}) x {kk}x{nn}",
                      max_err(forced(tpw, wset.copies[0]), ref),
                      2 ** -7 * max(1.0, ref.abs().max().item()))
                row[f"tpw{tpw}_ms"] = time_ms(lambda: forced(tpw, wset.next()))
            row["bound_ms"], row["bound_by"] = bound(
                m * kk * 2 + kk // 2 * nn + kk // 128 * nn * 4 + m * nn * 2, 2 * m * kk * nn,
                bf16_rate, bw)
            tpw_rows.append(row)
            two = "not taken (N % 256)" if row["tpw2_ms"] is None else f"{row['tpw2_ms']:.4f} ms"
            log(f"  K11mma ({m}, {kk}) x {kk}x{nn}: TPW=1 {row['tpw1_ms']:.4f} ms, TPW=2 "
                f"{two}, mma_tpw picks {row['picked']}, bound {row['bound_ms']:.4f} ms "
                f"({row['bound_by']})")
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
    for name, m in (("K11mma", B * N_VIS), ("K11mma", B * N_VIS // 2),
                    ("K11mma", B * (N_VIS - 1) // CHUNK),
                    ("K11mma", B * (PROMPT - N_VIS) // CHUNK)):
        x = rnd(m, k)
        err = w4_check(f"{name} ({m}, {k}) x {k}x{n} bf16", x, wts[0])
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
    k11_decode_rows(peaks, gen, out)


def k11_decode_rows(peaks, gen, out):
    """K11 at run (d)'s decode rows (M = 4) on each of its four weight
    shapes, each with its bound, bf16 ``torch.matmul`` time and launches a
    run-(d) batch; and, as a data point, K11mma called directly at M = 4
    (the router sends it only more than 16 rows)."""
    from mmmm_tpu_torch.ops import w4_matmul as w4
    from mmmm_tpu_torch.ops.quant import quantize_int4

    bw, bf16_rate, _, _ = peaks
    dev = torch.device("cuda")
    rnd = lambda *s, dt=torch.bfloat16: torch.randn(*s, generator=gen, device=dev).to(dt)
    m = B
    rows = []
    for kk, nn in W4_SHAPES:
        wset = Rotating([quantize_int4(rnd(kk, nn, dt=torch.float32).mul_(0.02))
                         for _ in range(4)])
        bts = Rotating([rnd(kk, nn).mul_(0.02) for _ in range(2)])
        x = rnd(m, kk)
        w0 = wset.copies[0]
        ref = w4.w4_matmul_plain(x, w0["q4"], w0["s4"])
        err = max_err(w4.w4_matmul(x, w0["q4"], w0["s4"]), ref)
        check(f"K11 ({m}, {kk}) x {kk}x{nn} bf16 (timed row)", err,
              2 ** -7 * max(1.0, ref.abs().max().item()))
        stream = w4._cuda.stream_of(x)
        call = lambda w: w4.w4_matmul(x, w["q4"], w["s4"])

        def mma_m4(w):
            y = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
            w4.K11MMA(x.data_ptr(), w["q4"].data_ptr(), w["s4"].data_ptr(), y.data_ptr(), m, kk,
                      nn, 128, w4.mma_tpw(m, nn), stream)
            return y

        check(f"K11mma called at M={m} on {kk}x{nn}", max_err(mma_m4(w0), ref),
              2 ** -7 * max(1.0, ref.abs().max().item()))

        def gemv(w, cluster):  # the decode-row kernel at a given cluster size
            y = torch.empty((m, nn), dtype=torch.bfloat16, device=dev)
            w4.K11(x.data_ptr(), w["q4"].data_ptr(), w["s4"].data_ptr(), y.data_ptr(), None, m,
                   kk, nn, 128, 1, cluster, stream)
            return y

        for c in (1, 2):
            check(f"K11 with clusters of {c} on {kk}x{nn}", max_err(gemv(w0, c), ref),
                  2 ** -7 * max(1.0, ref.abs().max().item()))
        nbytes = kk // 2 * nn + kk // 128 * nn * 4 + m * kk * 2 + m * nn * 2
        bms, by = bound(nbytes, 2 * m * kk * nn, bf16_rate, bw)
        row = {"shape": [m, kk, nn], "dtype": "bf16 x, int4 W (group 128)", "max_abs_err": err,
               "ms": time_ms(lambda: call(wset.next())),
               "plain_ms": time_ms(lambda: w4.w4_matmul_plain(x, w0["q4"], w0["s4"]), inner=2),
               "library_ms": time_ms(lambda: x @ bts.next()),
               "k11mma_ms": time_ms(lambda: mma_m4(wset.next())),
               "cluster1_ms": time_ms(lambda: gemv(wset.next(), 1)),
               "cluster2_ms": time_ms(lambda: gemv(wset.next(), 2)),
               "bound_ms": bms, "bound_by": by}
        log(f"  K11 M={m} on {kk}x{nn}: kernel {row['ms']:.4f} ms (clusters of "
            f"{w4.gemv_cluster(kk, nn)}; of 1 {row['cluster1_ms']:.4f} ms, of 2 "
            f"{row['cluster2_ms']:.4f} ms), plain {row['plain_ms']:.4f} ms, bf16 matmul "
            f"{row['library_ms']:.4f} ms, K11mma {row['k11mma_ms']:.4f} ms, bound {bms:.5f} ms "
            f"({by})")
        rows.append(row)
        del wset, bts
    main = next(r for r in rows if r["shape"][1:] == [4096, 11008])
    out["K11"] = dict(main, variants=[r for r in rows if r is not main])


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
    from mmmm_tpu_torch.ops.attention import build_mask, kernel_head_dim

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
        if label == "llm":  # no atomics: two runs of K3 give the same bits
            again = fl.flash_segment_attention(q, k, v, seg, seg, causal=causal, scale=scale)
            if not (torch.equal(again[0], o) and torch.equal(again[1], lse)):
                raise AssertionError("K3: two runs at the LLM site differ")
            log("  K3 llm: two runs bit-equal")
            del again
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
    # head dims K3 and K7 take only through zero lanes: the wrappers pad one
    # copy of each operand, run the kernels at kernel_head_dim, and slice;
    # timed whole, at the ViT training site's other widths
    padded = []
    for d, dt in ((100, torch.bfloat16), (90, torch.float32)):
        b, s, h = 4, 577, 16
        q, k, v, dout = (torch.randn(b, s, h, d, generator=gen, device=dev).to(dt)
                         for _ in range(4))
        seg = torch.ones(b, s, dtype=torch.int32, device=dev)
        scale = d ** -0.5
        frac = 2e-2 if dt == torch.bfloat16 else 1e-4
        o, lse = fl.flash_segment_attention(q, k, v, seg, seg, causal=False, scale=scale)
        ro, rlse = fl.flash_segment_attention_plain(q, k, v, seg, seg, causal=False, scale=scale)
        err3 = max_err(o, ro)
        dp = kernel_head_dim(d, dt)
        check(f"K3 padded {(b, s, h, d)} {dt} (the kernel at D = {dp}) out", err3,
              frac * ro.float().abs().max().item())
        check(f"K3 padded {(b, s, h, d)} lse", max_err(lse, rlse), 1e-3)
        got = fl.flash_segment_attention_bwd(q, k, v, seg, seg, o, lse, dout, causal=False,
                                             scale=scale)
        ref = fl.flash_segment_attention_bwd_plain(q, k, v, seg, seg, o, lse, dout, causal=False,
                                                   scale=scale)
        err7 = max(max_err(a, r_) / r_.float().abs().max().item() for a, r_ in zip(got, ref))
        check(f"K7 padded {(b, s, h, d)} {dt}, worst of dq/dk/dv (relative)", err7, frac)
        rate = bf16_rate if dt == torch.bfloat16 else fp32_rate
        n = q.numel() * q.element_size()
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        bms, by = bound(4 * n + lse.numel() * 4, 4 * b * h * s * s * d, rate, bw)
        k3 = {"shape": [b, s, h, d], "dtype": str(dt).split(".")[-1], "causal": False,
              "padded_to": dp, "max_abs_err": err3, "bound_ms": bms, "bound_by": by,
              "ms": time_ms(lambda: fl.flash_segment_attention(q, k, v, seg, seg, causal=False,
                                                               scale=scale)),
              "plain_ms": time_ms(lambda: fl.flash_segment_attention_plain(
                  q, k, v, seg, seg, causal=False, scale=scale), inner=2),
              "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                           scale=scale)),
              "site": "train_vit_padded"}
        out["K3"]["variants"].append(k3)
        lib_out = F.scaled_dot_product_attention(qt, kt, vt, scale=scale)
        gt = dout.transpose(1, 2).contiguous()
        bms7, by7 = bound(6 * n + 2 * lse.numel() * 4 + 3 * n, 2 * 7 * b * h * s * s * d, rate, bw)
        row = {"shape": [b, s, h, d], "dtype": str(dt).split(".")[-1], "padded_to": dp,
               "max_rel_err": err7, "bound_ms": bms7, "bound_by": by7,
               "bwd_ms": time_ms(lambda: fl.flash_segment_attention_bwd(
                   q, k, v, seg, seg, o, lse, dout, causal=False, scale=scale)),
               "plain_ms": time_ms(lambda: fl.flash_segment_attention_bwd_plain(
                   q, k, v, seg, seg, o, lse, dout, causal=False, scale=scale), inner=2),
               "library_ms": time_ms(lambda: torch.autograd.grad(lib_out, (qt, kt, vt), gt,
                                                                 retain_graph=True))}
        padded.append(row)
        log(f"  K3 padded D={d}: kernel {k3['ms']:.4f} ms (pad and slice included), plain "
            f"{k3['plain_ms']:.4f}, SDPA {k3['library_ms']:.4f}; K7 whole backward "
            f"{row['bwd_ms']:.4f} ms, plain {row['plain_ms']:.4f}, SDPA backward "
            f"{row['library_ms']:.4f}")
        del q, k, v, dout, o, lse, got, ref, qt, kt, vt, lib_out, gt
    for kid in ("K7dq", "K7dkv", "K7delta"):
        first = rows[kid]["llm"]
        out[kid] = dict(first, site="llm",
                        variants=[dict(r, site=lb) for lb, r in rows[kid].items() if lb != "llm"])
    out["K7dq"]["padded_whole_backward"] = padded


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
            ("spec 8 (windows of 9), W8A16", cfg, qparams, dict(spec_draft_len=8)),
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
    out["greedy B = 1, split decode"] = tiny_split_decode(cfg, params, args, kw)
    out["switches"] = tiny_switches(params, args, kw)
    return out


SWITCHES_RUN = "int8 KV, q8_cast bf16, fast softmax, gelu tanh"


def tiny_switches(params, args, kw) -> dict:
    """The reference's non-default numeric switches through
    ``generate_grounded`` at the tiny config over an int8 KV cache, card
    vs CPU: ``q8_cast="bf16"``, ``dense_fast_softmax=True`` and
    ``gelu_mode`` ``"tanh"``, then ``"erf"``: the same tokens, masks within
    2e-4. Each card run is counted from 0: it launches K4 and K9 as often as
    the run with the switches off, every K4 launch in its form "fast" and
    every K9 launch in its forms "append" and "bf16"."""
    from mmmm_tpu_torch import generate_grounded
    from mmmm_tpu_torch.ops._cuda import KERNELS

    gparams = _tree_to(params, "cuda")
    out, base = {}, None
    for label, extra in [("int8 KV, switches off", {}),
                         (SWITCHES_RUN,
                          dict(q8_cast="bf16", dense_fast_softmax=True, gelu_mode="tanh")),
                         ("int8 KV, q8_cast bf16, fast softmax, gelu erf",
                          dict(q8_cast="bf16", dense_fast_softmax=True, gelu_mode="erf"))]:
        ref = generate_grounded(params, *args, device="cpu", kv_cache_dtype="int8", **kw,
                                **extra)
        for kern in KERNELS.values():
            kern.reset()
        got = generate_grounded(gparams, *args, device="cuda", kv_cache_dtype="int8", **kw,
                                **extra)
        torch.cuda.synchronize()
        launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
        forms = {n: dict(k.forms) for n, k in KERNELS.items() if k.forms}
        if not np.array_equal(got.tokens, ref.tokens):
            raise AssertionError(f"tiny {label}: tokens differ\n{got.tokens}\n{ref.tokens}")
        err = max_err(got.masks.cpu(), ref.masks)
        check(f"tiny {label}: tokens equal, masks (card vs CPU)", err, 2e-4)
        if base is None:
            base = launches
            if not (base.get("K4") and base.get("K9")):
                raise AssertionError(f"tiny {label}: K4 or K9 not launched: {launches}")
        elif (launches != base or forms.get("K4") != {"fast": base["K4"]} or
              forms.get("K9") != {"append": base["K9"], "bf16": base["K9"]}):
            raise AssertionError(f"tiny {label}: launches {launches}, forms {forms}; with the "
                                 f"switches off {base}")
        out[label] = {"tokens_equal": True, "masks_max_abs_err": err, "launches": launches,
                      "launches_by_form": forms}
        log(f"  tiny {label}: launches {launches}, by form {forms}")
    return out


def tiny_split_decode(cfg, params, args, kw) -> dict:
    """Greedy decode of one sample (B = 1) over a cache of 128 slots, where
    the tiny config's 4 heads leave K1 splitting each head over a cluster:
    the same tokens and masks (2e-4) on the card and on the CPU, every K1
    launch of the card's run in its fused form."""
    from mmmm_tpu_torch import generate_grounded
    from mmmm_tpu_torch.ops import decode_kernel as dk

    _, tok, ids, tt, pos, lens, img, patch, stride = args
    new = 128 - ids.shape[1]
    one = (cfg, tok, ids[:1], tt[:1], pos[:1], lens[:1], img[:1], patch, stride)
    kw1 = dict(kw, max_new_tokens=new, grounding_image=kw["grounding_image"][:1])
    splits = dk.decode_splits(1, cfg.vlm.num_attention_heads, 128, dk.sm_count(torch.device("cuda")))
    if splits < 2:
        raise AssertionError(f"tiny B = 1: K1 takes {splits} split(s), not a cluster")
    ref = generate_grounded(params, *one, device="cpu", **kw1)
    dk.K1.reset()
    got = generate_grounded(_tree_to(params, "cuda"), *one, device="cuda", **kw1)
    launches, fused = dk.K1.launches, dk.K1.forms.get("append", 0)
    if not np.array_equal(got.tokens, ref.tokens):
        raise AssertionError(f"tiny B = 1: tokens differ\n{got.tokens}\n{ref.tokens}")
    if launches == 0 or fused != launches:
        raise AssertionError(f"tiny B = 1: {launches} K1 launches, {fused} fused")
    err = max_err(got.masks.cpu(), ref.masks)
    check(f"tiny B = 1 ({splits} splits a head, {launches} K1 launches): tokens equal, masks "
          "(card vs CPU)", err, 2e-4)
    return {"tokens_equal": True, "splits": splits, "k1_launches": launches,
            "masks_max_abs_err": err}


def masks_tol(ref: torch.Tensor) -> float:
    """2e-4, or 1e-2 of the largest mask logit where that is smaller (the
    random tiny model's logits are about 1e-4, which 2e-4 alone would pass
    whatever the masks)."""
    return min(2e-4, 1e-2 * ref.float().abs().max().item())


def grounded_requests(rng, gen, lens, n_vis, image, g_image, vocab, device, dtype):
    """GroundedServer requests of the prompt lengths ``lens``: a bos, ``n_vis``
    vision tokens and random text ids below ``vocab``, the layout's token
    types and position ids, an image in ``dtype`` and an fp32 grounding
    image, made on ``device`` from ``gen``."""
    reqs = []
    for n in lens:
        text = n - 1 - n_vis
        tt = np.zeros(n, np.int32)
        tt[1:1 + n_vis] = 1
        reqs.append({
            "input_ids": np.concatenate([[1], np.full(n_vis, 3),
                                         rng.integers(4, vocab, size=text)]).astype(np.int32),
            "token_type_ids": tt,
            "position_ids": np.concatenate([[0, 1], np.full(n_vis - 2, 2), [3],
                                            np.arange(4, 4 + text)]).astype(np.int32),
            "image": torch.randn(image, generator=gen, device=device).to(dtype),
            "grounding_image": torch.randn(g_image, generator=gen, device=device)})
    return reqs


def tiny_serving_phase():
    """The continuous-batching servers on the card and on the CPU at
    ``MMMMConfig.tiny()`` in fp32: the same texts and ``stats`` (and tokens,
    targets, masks within ``masks_tol``) for ``TextServer`` greedy with two
    slots and seven requests (refilled mid-flight), with the prefix cache
    (suffix windows of 16 and 32 tokens, the decoder's plain route: no K6
    launch), speculative with 4 drafts over W8A16 weights, and
    ``GroundedServer`` greedy and speculative with 3 drafts. The card's runs
    launch K1 only in its fused form, K6 only in its fused form, K2 and K5
    never."""
    from mmmm_tpu_torch import GroundedServer, MMMMConfig, TextServer, init_params
    from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.ops.quant import quantize_llm_for_serving

    log("tiny servers: card vs CPU")
    tok = MMMMTokenizer.byte_fallback()
    cfg = MMMMConfig.tiny(vocab_size=len(tok))
    params = init_params(cfg, 0, torch.float32, "cpu")
    qllm = quantize_llm_for_serving(params["cogvlm"], release_originals=False)
    template = "You are a radiology assistant. Extract findings from: "
    words = ["a", "the quick brown fox", "mid", "another prompt here",
             "yet another much longer prompt for the pool", "zz", "last one"]
    text_kw = dict(n_slots=2, max_new_tokens=6, chunk=3, seq_quant=16)
    budgets = [6, 3, 5, 2, 6, 4, 3]
    out = {}
    for label, llm, prompts, extra, spec in [
            ("TextServer greedy, 2 slots, 7 requests", params["cogvlm"], words,
             dict(max_prompt_len=64, prefix_cache=False), False),
            # a refill of 3 requests: a sub-batch padded to 4 (K3 over a
            # row of prompt_len 1)
            ("TextServer greedy, 4 slots, a padded refill", params["cogvlm"], words,
             dict(max_prompt_len=64, prefix_cache=False, n_slots=4), False),
            ("TextServer prefix cache, suffix windows of 16-32", params["cogvlm"],
             [template + w for w in words], dict(max_prompt_len=128), False),
            ("TextServer speculate 4, W8A16, prefix cache", qllm,
             [template + w for w in words], dict(max_prompt_len=128, speculate=4), True)]:
        runs = {}
        for dev in ("cpu", "cuda"):
            tree = llm if dev == "cpu" else _tree_to(llm, dev)
            server = TextServer(tree, cfg.vlm, tok, device=dev, **{**text_kw, **extra})
            for kern in KERNELS.values():
                kern.reset()
            runs[dev] = (server.generate(prompts, max_new=budgets), dict(server.stats))
        launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
        forms = {n: dict(k.forms) for n, k in KERNELS.items() if k.forms}
        if runs["cuda"] != runs["cpu"]:
            raise AssertionError(f"tiny {label}: card {runs['cuda']} vs CPU {runs['cpu']}")
        stats = runs["cuda"][1]
        read = "K6" if spec else "K1"
        if (launches.get("K2") or launches.get("K5") or not launches.get(read)
                or forms.get(read) != {"append": launches[read]}
                or launches.get("K6" if not spec else "K1")):
            raise AssertionError(f"tiny {label}: launches {launches}, by form {forms}")
        if stats["refilled_mid_flight"] < 1 or (extra.get("prefix_cache", True)
                                                and stats["prefix_len"] < 32):
            raise AssertionError(f"tiny {label}: stats {stats}")
        log(f"  tiny {label}: texts and stats equal (card vs CPU); stats {stats}; launches "
            f"{launches}")
        out[label] = {"texts_equal": True, "stats": stats, "launches": launches}

    reqs = grounded_requests(np.random.default_rng(0), torch.Generator().manual_seed(0),
                             (25, 22, 28, 20, 31), 18, (3, 4, 16, 16), (3, 4, 16, 16), 250,
                             "cpu", torch.float32)
    g_kw = dict(patch_size=(4, 4, 4), pool_size=(1, 1, 1), n_vis=18, n_slots=2,
                max_new_tokens=6, chunk=3, seq_quant=16, max_prompt_len=31, max_targets=2)
    for label, extra in [("GroundedServer greedy", {}),
                         ("GroundedServer speculate 3", dict(speculate=3))]:
        runs = {}
        for dev in ("cpu", "cuda"):
            tree = params if dev == "cpu" else _tree_to(params, dev)
            server = GroundedServer(tree, cfg, tok, device=dev, **g_kw, **extra)
            runs[dev] = (server.generate(reqs), dict(server.stats))
        (ref, ref_stats), (got, stats) = runs["cpu"], runs["cuda"]
        if stats != ref_stats or any(
                g["text"] != r["text"] or not np.array_equal(g["tokens"], r["tokens"])
                or g["targets"] != r["targets"] for g, r in zip(got, ref)):
            raise AssertionError(f"tiny {label}: card {stats} vs CPU {ref_stats}, texts "
                                 f"{[g['text'] for g in got]} vs {[r['text'] for r in ref]}")
        err = max(max_err(g["masks"].cpu(), r["masks"]) for g, r in zip(got, ref))
        tol = min(masks_tol(r["masks"]) for r in ref)
        check(f"tiny {label}: texts, tokens, stats equal; masks (card vs CPU)", err, tol)
        out[label] = {"texts_equal": True, "stats": stats, "masks_max_abs_err": err}
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


def flagship_phase(gen, expect: bool = True, serving: bool = False):
    """Runs (a)-(d) at the flagship width; returns their results and each
    run's launch counts. ``expect=False`` skips the launch counts' checks
    against ``RUNS`` (time_flagship_runs.py runs other versions of the
    port, which launch other kernels); the outputs are checked either way.
    ``serving`` runs ``flagship_serving_phase`` over run (a)'s bf16 params
    before the LLM is quantized."""
    from mmmm_tpu_torch import MMMMConfig, generate_grounded, init_params
    from mmmm_tpu_torch.data.tokenizer import SPECIAL_TOKENS, MMMMTokenizer, _ByteBackend
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops import w4_matmul as w4
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.ops.quant import quantize_llm_for_serving

    log("flagship grounded report path")
    cfg = MMMMConfig(vlm=dataclasses.replace(CogVLMConfig.cogvlm17b(),
                                             num_hidden_layers=FLAGSHIP_LAYERS), sam=SamConfig())
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
            kern.reset()
        w4.K11_BY_SHAPE.clear()
        res, steady_s = run()
        launches = {name: kern.launches for name, kern in KERNELS.items()}
        forms = {name: dict(kern.forms) for name, kern in KERNELS.items() if kern.forms}
        by_shape = {f"{k}x{n}": c for (k, n), c in sorted(w4.K11_BY_SHAPE.items())}
        peak = torch.cuda.max_memory_allocated()
        iters = res.spec_stats["iters"] if res.spec_stats else NEW
        tps = res.spec_stats["tokens_per_step"] if res.spec_stats else 1.0
        log(f"    steady run: {steady_s:.3f} s, {B / steady_s:.4f} reports/s, "
            f"tokens_per_step {tps:.4f} ({iters} decode steps), peak memory "
            f"{peak / 2**30:.2f} GiB, launches {launches}, by form {forms}")
        per_run = lambda v: FLAGSHIP_LAYERS * iters if v == "iters" else v
        want = {name: 0 for name in KERNELS}
        want.update({k: per_run(v) for k, v in spec["launches"].items()})
        for name, n in want.items():
            if expect and launches[name] != n:
                raise AssertionError(f"{label}: {name} launched {launches[name]} times, "
                                     f"expected {n}")
        want_forms = {k: {f: per_run(v) for f, v in fs.items()}
                      for k, fs in spec.get("forms", {}).items()}
        if expect and forms != want_forms:
            raise AssertionError(f"{label}: launches by form {forms}, expected {want_forms}")
        want_shapes = ({f"{k}x{n}": c for (k, n), c in sorted(W4_DECODE_CALLS.items())}
                       if launches["K11"] else {})
        if expect and (by_shape != want_shapes or sum(by_shape.values()) != launches["K11"]):
            raise AssertionError(f"{label}: K11 launches by weight shape {by_shape}, "
                                 f"expected {want_shapes}")
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
             "launches": launches, "launches_by_form": forms, "k11_launches_by_shape": by_shape,
             "num_generated": res.num_generated.tolist()}
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
        if serving and label == "a_greedy_bf16":
            out["serving"] = flagship_serving_phase(params, cfg, tok, gen)
            out["data_prep"] = data_prep_llm_phase(params, cfg)
    return out, all_launches


SERVE_SLOTS, SERVE_REQS, SERVE_CHUNK = 4, 8, 16  # (s1), (s2): the grounded pool
SERVE_STAGES = ("vit", "llm_prefill", "prefix_refill", "decode", "sam")  # the servers' spans
TEXT_SLOTS, TEXT_REQS = 8, 16  # (s3): the text pool over the flagship LLM
SERVE_TEMPLATE = ("You are a radiology assistant. Read the findings of this CT report and "
                  "list every abnormal structure with its location. Report: ")


def _serve_run(label, server, inputs, want):
    """A warm-up run, then a steady run with every launch counter at 0:
    its wall time, requests/s, stats, peak memory and launches, checked
    against ``want(stats, results)`` (the exact counts of every kernel,
    and K1's or K6's launches all of form "append")."""
    from mmmm_tpu_torch.ops._cuda import KERNELS

    log(f"  serving {label}")
    torch.cuda.synchronize()
    t = time.perf_counter()
    server.generate(*inputs)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t
    server.stats = dict.fromkeys(server.stats, 0)
    for kern in KERNELS.values():
        kern.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = server.generate(*inputs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    stats = dict(server.stats)
    launches = {n: k.launches for n, k in KERNELS.items()}
    forms = {n: dict(k.forms) for n, k in KERNELS.items() if k.forms}
    want_launches, want_forms = want(stats, res)
    expected = dict.fromkeys(KERNELS, 0)
    expected.update(want_launches)
    if launches != expected or forms != want_forms:
        raise AssertionError(f"{label}: launches {launches} by form {forms}, expected "
                             f"{expected} by form {want_forms}")
    n = len(inputs[0])
    r = {"first_run_s": first_s, "steady_run_s": wall, "requests_per_s": n / wall,
         "stats": stats, "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
         "launches": {k: v for k, v in launches.items() if v}, "launches_by_form": forms}
    if stats.get("spec_steps"):
        r["tokens_per_verify_step"] = stats["spec_committed"] / stats["spec_steps"]
    log(f"    steady run: {wall:.3f} s, {r['requests_per_s']:.4f} requests/s (first run "
        f"{first_s:.3f} s), peak memory {r['peak_mem_gib']:.2f} GiB, stats {stats}, tokens a "
        f"verify step {r.get('tokens_per_verify_step', 'n/a')}, launches {r['launches']}, "
        f"by form {forms}")

    def run():
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = server.generate(*inputs)
        torch.cuda.synchronize()
        return out, time.perf_counter() - t

    r["profile"] = profile_run(run, SERVE_STAGES)
    r["profile"].pop("result")
    r["busy_share_steady"] = r["profile"]["kernels_busy_s"] / wall
    log(f"    device busy share: {r['busy_share_steady']:.4f} of the steady run")
    return res, r


def first_difference(a, b) -> int:
    """The first index where two token sequences differ (-1: equal)."""
    a, b = [int(t) for t in a], [int(t) for t in b]
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def flagship_serving_phase(params, cfg, tok, gen) -> dict:
    """The servers at the flagship's full width (FLAGSHIP_LAYERS) over run (a)'s
    bf16 params: (s1) ``GroundedServer`` greedy, 4 slots, 8 requests of run
    (a)'s shape, 128 new tokens, chunks of 16, 4 targets; (s2) the same
    with 7 drafts a step; (s3) ``TextServer`` with 8 slots over 16 prompts
    that share a template of more than 96 tokens, suffixes of 20-60 tokens
    (a refill runs them as one 64-token window: the decoder's plain route)
    and budgets of 16-128. Exact launches from the servers' stats: K3 32 a
    sub-batch prefill (or the shared prefix), K4 63 a ViT prefill and 12 a
    SAM pass, K1 (greedy) or K6 (speculative) 32 x 16 a chunk, all fused
    with their appends; every other kernel 0. Also reports where (s1)'s
    texts part from ``generate_grounded``'s and (s2)'s over the same
    inputs, and the one-shot path's greedy from its speculative (not gated:
    the pool's batch and Smax change K1's split plan, K6 rounds otherwise
    than K1, and bf16 rounding may turn an argmax at random weights)."""
    from mmmm_tpu_torch import GroundedServer, TextServer, generate_grounded

    log("flagship servers")
    t0 = time.perf_counter()
    rng = np.random.default_rng(1)
    reqs = grounded_requests(rng, gen, [PROMPT] * SERVE_REQS, N_VIS, (3, 32, 384, 384),
                             (3, 32, 256, 256), 32000, "cuda", torch.bfloat16)
    kw = dict(patch_size=(16, 16, 16), pool_size=(2, 2, 2), n_vis=N_VIS, n_slots=SERVE_SLOTS,
              max_new_tokens=NEW, chunk=SERVE_CHUNK, seq_quant=32, max_prompt_len=PROMPT,
              max_targets=TARGETS, device="cuda")
    out = {}

    def grounded_want(read):
        def want(stats, res):
            # each SAM pass's masks are rows of one tensor
            passes = len({r["masks"].untyped_storage().data_ptr() for r in res})
            n = FLAGSHIP_LAYERS * SERVE_CHUNK * stats["chunks"]
            return ({"K3": FLAGSHIP_LAYERS * stats["refills"],
                     "K4": VIT_LAYERS * stats["refills"] + SAM_LAYERS * passes, read: n},
                    {read: {"append": n}})
        return want

    tokens = {}
    for label, extra, read in [("s1_grounded_greedy", {}, "K1"),
                               ("s2_grounded_spec7", dict(speculate=DRAFT), "K6")]:
        server = GroundedServer(params, cfg, tok, **kw, **extra)
        res, r = _serve_run(label, server, (reqs,), grounded_want(read))
        for o in res:
            m = o["masks"]
            if tuple(m.shape) != (TARGETS, 32, 256, 256) or not torch.isfinite(m).all():
                raise AssertionError(f"{label} masks: shape {tuple(m.shape)} or non-finite")
            if len(o["tokens"]) > NEW or not ((o["tokens"] >= 0) & (o["tokens"] < 32008)).all():
                raise AssertionError(f"{label} tokens: {o['tokens']}")
        r["smax"] = server.smax
        r["targets"] = [None if o["targets"] is None else len(o["targets"]) for o in res]
        tokens[label] = [o["tokens"] for o in res]
        out[label] = r
    stack = lambda key: np.stack([q[key] for q in reqs])
    batch = {}
    for draft in (0, DRAFT):  # the one-shot path over the same requests, greedy and spec
        res = generate_grounded(params, cfg, tok, stack("input_ids"), stack("token_type_ids"),
                                stack("position_ids"), np.full(SERVE_REQS, PROMPT, np.int32),
                                torch.stack([q["image"] for q in reqs]), (16, 16, 16),
                                (2, 2, 2), max_new_tokens=NEW, max_targets=TARGETS,
                                grounding_image=torch.stack([q["grounding_image"] for q in reqs]),
                                force_grounding=True, vis_span=(1, 1 + N_VIS),
                                spec_draft_len=draft, device="cuda")
        batch[draft] = [row[row != tok.eos_token_id] for row in res.tokens]
    # the first token where two runs' texts part (-1: never); bf16 rounding
    # differs between K1 and K6 and between batch shapes, and at random
    # weights may turn an argmax
    for key, a, b in (("s1_vs_generate_grounded", tokens["s1_grounded_greedy"], batch[0]),
                      ("s1_vs_s2", tokens["s1_grounded_greedy"], tokens["s2_grounded_spec7"]),
                      ("generate_grounded_greedy_vs_spec7", batch[0], batch[DRAFT])):
        first = [first_difference(x, y) for x, y in zip(a, b)]
        out[f"{key}_first_difference"] = first
        log(f"  {key}: {first.count(-1)} of {SERVE_REQS} texts equal; first differing token "
            f"{first}")

    letters = np.array(list("abcdefghijklmnopqrstuvwxyz     "))
    prompts = [SERVE_TEMPLATE + chr(ord("A") + i) + "".join(rng.choice(letters, n - 1))
               for i, n in enumerate(rng.integers(20, 61, TEXT_REQS))]
    budgets = [int(x) for x in rng.integers(16, NEW + 1, TEXT_REQS)]
    server = TextServer(params["cogvlm"], cfg.vlm, tok, n_slots=TEXT_SLOTS, max_new_tokens=NEW,
                        chunk=SERVE_CHUNK, seq_quant=64, max_prompt_len=PROMPT, device="cuda")

    def text_want(stats, res):
        n = FLAGSHIP_LAYERS * SERVE_CHUNK * stats["chunks"]
        return {"K3": FLAGSHIP_LAYERS, "K1": n}, {"K1": {"append": n}}

    res, r = _serve_run("s3_text_prefix_cache", server, (prompts, budgets), text_want)
    if (len(res) != TEXT_REQS or r["stats"]["refilled_mid_flight"] < 1
            or r["stats"]["prefix_len"] < 96):
        raise AssertionError(f"s3: {len(res)} texts, stats {r['stats']}")
    r["smax"], r["budgets"] = server.smax, budgets
    r["prompt_tokens"] = [1 + len(tok.encode(p)) for p in prompts]
    out["s3_text_prefix_cache"] = r
    out["seconds"] = time.perf_counter() - t0
    return out


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
                kern.reset()
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
            attn_state = _state_to(snapshot, "cuda")
            xla_step = make_train_step(cfg, opt, lcfg, vg_mode=mode, bf16_vlm=True,
                                       attn_impl="xla", remat=True, vis_span="auto",
                                       device="cuda")
            for kern in KERNELS.values():
                kern.reset()
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
            r["remat_attn"] = remat_attn_steps(cfg, opt, lcfg, attn_state, frozen, batch,
                                               r["steps"][-1]["logs"], r)
            del attn_state
        out["modes"][mode] = r
        launches_by_mode[f"train_{mode}"] = r["steps"][1]["launches"]
        del batch
        torch.cuda.empty_cache()
    return out, launches_by_mode


def remat_attn_steps(cfg, opt, lcfg, state, frozen, batch, true_logs, true_run) -> dict:
    """Three semantic steps under ``remat="attn"`` from the state before
    ``remat=True``'s third step: launches exact every step (K3 once at each
    of the 32 LLM sites and twice at the 63 + 12 others: 182; K7dq, K7dkv
    and K7delta 107 each); the first step's loss and gradient norm those of
    the ``remat=True`` step from the same state (a policy only decides what
    the backward keeps: the loss within 1e-6, the gradient norm within 1e-5,
    room for CUDA's atomic sums in backward kernels such as the
    upsamplings'); the steady (second) step's time and the peak memory
    beside ``remat=True``'s."""
    from mmmm_tpu_torch import make_train_step
    from mmmm_tpu_torch.ops._cuda import KERNELS

    step = make_train_step(cfg, opt, lcfg, vg_mode="semantic", bf16_vlm=True,
                           attn_impl="pallas", remat="attn", vis_span="auto", device="cuda")
    want = fit_launches_expected(cfg, "semantic", "attn")
    out = {"steps": []}
    torch.cuda.reset_peak_memory_stats()
    for i in range(TRAIN_STEPS):
        for kern in KERNELS.values():
            kern.reset()
        logs, wall = _timed_step(step, state, frozen, batch)
        launches = {name: kern.launches for name, kern in KERNELS.items()}
        if {n: launches[n] for n in want} != want:
            raise AssertionError(f"train semantic, remat attn, step {i + 1}: launches "
                                 f"{launches}, expected {want}")
        vals = {k: float(v) for k, v in logs.items()}
        out["steps"].append({"wall_s": wall, "logs": vals,
                             "launches": {k: v for k, v in launches.items() if v}})
        log(f"  train semantic, remat \"attn\", step {i + 1}: {wall:.3f} s, {vals}, launches "
            f"{out['steps'][-1]['launches']}")
    first = out["steps"][0]["logs"]
    out["loss_rel_err"] = abs(first["loss"] - true_logs["loss"]) / abs(true_logs["loss"])
    out["grad_norm_rel_err"] = (abs(first["grad_norm"] - true_logs["grad_norm"])
                                / abs(true_logs["grad_norm"]))
    check("remat attn vs True step loss (relative)", out["loss_rel_err"], 1e-6)
    check("remat attn vs True step gradient norm (relative)", out["grad_norm_rel_err"], 1e-5)
    out["steady_step_s"] = out["steps"][1]["wall_s"]
    out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
    out["true_steady_step_s"] = true_run["steady_step_s"]
    out["true_peak_mem_gib"] = true_run["peak_mem_gib"]
    log(f"  remat \"attn\": steady step {out['steady_step_s']:.3f} s (True "
        f"{out['true_steady_step_s']:.3f} s), peak {out['peak_mem_gib']:.2f} GiB (True "
        f"{out['true_peak_mem_gib']:.2f} GiB)")
    return out


def remat_dots_phase() -> dict:
    """One semantic step under ``remat="dots"`` at the flagship's full width
    with its depth cut to 8 LLM and 8 ViT layers (all 12 SAM encoder
    layers): ``"dots"`` keeps every product with no batch dimension, the
    per-layer LoRA merges' ``a @ b`` included, which at full depth is about
    69 GB of fp32 deltas on top of the 45.6 GiB state (``PERF.md``; 15 GB
    at 8 layers). From one state, a ``remat=True`` step then a ``"dots"``
    step (the trainable tree and Adam's state copied back between them):
    the loss within 1e-6 and the gradient norm within 1e-5 (as
    ``remat_attn_steps``), launches exact (K3 twice a site under both),
    step time and peak memory of each."""
    import dataclasses
    from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, init_train_state,
                                make_optimizer, make_train_step)
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS

    log(f"remat \"dots\" at full width, {ROUTE_LAYERS} LLM and ViT layers")
    v = CogVLMConfig.cogvlm17b()
    cfg = MMMMConfig(vlm=dataclasses.replace(
        v, num_hidden_layers=ROUTE_LAYERS,
        vision=dataclasses.replace(v.vision, num_hidden_layers=ROUTE_LAYERS)), sam=SamConfig())
    opt = make_optimizer(OptimizerConfig(lr=5e-5, warmup_steps=1, max_steps=1000))
    lcfg = LoraConfig(r=64, alpha=8.0)
    state, frozen = init_train_state(cfg, opt, lcfg, seed=0, frozen_vlm_bf16=True, device="cuda")
    start = _state_to(state, "cuda")
    batch = flagship_train_batch("semantic", torch.Generator(device="cuda").manual_seed(0))
    out = {"layers": ROUTE_LAYERS}
    for remat in (True, "dots"):
        run = _state_to(start, "cuda")
        step = make_train_step(cfg, opt, lcfg, vg_mode="semantic", bf16_vlm=True,
                               attn_impl="pallas", remat=remat, vis_span="auto", device="cuda")
        for kern in KERNELS.values():
            kern.reset()
        torch.cuda.reset_peak_memory_stats()
        logs, wall = _timed_step(step, run, frozen, batch)
        launches = {name: kern.launches for name, kern in KERNELS.items()}
        want = fit_launches_expected(cfg, "semantic", remat)
        if {n: launches[n] for n in want} != want:
            raise AssertionError(f"remat {remat} step: launches {launches}, expected {want}")
        out[str(remat)] = {"wall_s": wall, "logs": {k: float(x) for k, x in logs.items()},
                           "peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                           "launches": {k: n for k, n in launches.items() if n}}
        log(f"  remat {remat!r}: {wall:.3f} s, peak {out[str(remat)]['peak_mem_gib']:.2f} GiB, "
            f"{out[str(remat)]['logs']}, launches {out[str(remat)]['launches']}")
        del run, step
        torch.cuda.empty_cache()
    a, b = out["True"]["logs"], out["dots"]["logs"]
    for key, tol in (("loss", 1e-6), ("grad_norm", 1e-5)):
        check(f"remat dots vs True step {key} (relative)", abs(b[key] - a[key]) / abs(a[key]),
              tol)
    del state, frozen, start, batch
    return out


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
            kern.reset()
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



# ---- the training loop (Trainer.fit) over a vision-language dataset ----
# chip_smoke.py builds its run configs as Python dicts (the card has no
# PyYAML); tests/test_torch_port_trainer.py holds these to the YAML files
# they mirror. TINY_FIT is conf/tiny/fit.yaml as load_yaml resolves it.
TINY_FIT = {
    "model": {
        "vlm": {"vocab_size": 267, "hidden_size": 64, "intermediate_size": 128,
                "num_hidden_layers": 2, "num_attention_heads": 4,
                "max_position_embeddings": 1024,
                "vision": {"hidden_size": 32, "intermediate_size": 64, "num_hidden_layers": 2,
                           "num_heads": 4, "patch_size": [4, 4, 4], "pos_embed_shape": [2, 4, 4],
                           "pt_pos_embed_shape": [5, 5]}},
        "sam": {"embed_dim": 32, "encoder_num_layers": 2, "encoder_num_heads": 4,
                "patch_size": [4, 4, 4], "pos_embed_shape": [2, 4, 4], "num_instances": 3,
                "decoder_mlp_dim": 64}},
    "lora": {"r": 4, "alpha": 8},
    "tokenizer": {"path": None},
    "data": {"conf": {"base_vit_patch_size_z": 4, "vit_patch_size_xy": 4, "pool_size_xy": 1,
                      "base_pool_size_z": 1, "max_seq_len": 640, "max_targets": 4,
                      "max_instances": 8,
                      "local_trans": {"max_vision_tokens": 64, "max_tokens_z": 4, "num_pos": 2,
                                      "num_neg": 1}},
             "datasets": []},
    "optimizer": {"lr": 1.0e-3, "warmup_steps": 2, "max_steps": 4},
    "trainer": {"max_steps": 4, "log_every": 1, "ckpt_every": 4, "batch_size": 2,
                "mesh_model": 1, "out_dir": "runs/tiny"},
}
# conf/phase-vlm/data.yaml's conf and vl_trans, and conf/lora.yaml
PHASE_VLM_DATA = {"conf": {"base_vit_patch_size_z": 16, "vit_patch_size_xy": 16,
                           "pool_size_xy": 2, "base_pool_size_z": 2, "max_seq_len": 1024,
                           "mimic_cxr_neg_weight": 0.2},
                  "vl_trans": {"max_tokens": 144, "max_tokens_z": 4}}
LORA_YAML = {"r": 64, "alpha": 8, "dropout": 0.05, "use_rslora": True}
FIT_TINY_STEPS, FIT_TINY_RESUME = 4, 6
FIT_STEPS, FIT_BATCH = 6, 4  # the flagship fit: 6 steps of 4, one checkpoint at step 6
FIT_VOLUME = (1, 64, 320, 320)  # the flagship fit's CT volumes (C, D, H, W)
REPORT_WORDS = ("the", "liver", "is", "normal", "in", "size", "and", "attenuation", "no",
                "focal", "lesion", "lungs", "are", "clear", "without", "nodule", "or",
                "effusion", "mild", "cardiomegaly", "heart", "kidneys", "spleen", "unremarkable")


def with_keys(cfg: dict, **dotted) -> dict:
    """A deep copy of ``cfg`` with ``a__b=value`` keyword overrides set at
    ``cfg["a"]["b"]``."""
    out = json.loads(json.dumps(cfg))
    for key, value in dotted.items():
        *parents, leaf = key.split("__")
        node = out
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = value
    return out


def write_vl_dataset(root: Path, n: int, shape, *, report_chars: int, seed: int,
                     constant: bool = False, vqa: bool = True) -> Path:
    """A vision-language dataset of ``n`` cases in the layout of the VL
    converters: ``train-processed.json`` beside ``torch.save``d uint8
    (C, D, H, W) ``.pt`` volumes (random, or each one value with
    ``constant``), each item with its image's shape, modality CT, a report
    of about ``report_chars`` characters and, with ``vqa``, a VQA pair."""
    root.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    items = []
    for i in range(n):
        if constant:
            vol = np.full(shape, int(rng.integers(40, 216)), np.uint8)
        else:
            vol = rng.integers(0, 256, size=shape, dtype=np.uint8)
        path = root / f"case{i}.pt"
        torch.save(torch.from_numpy(vol), path)
        words = []
        while sum(len(w) + 1 for w in words) < report_chars:
            words.append(str(rng.choice(REPORT_WORDS)))
        item = {"key": f"case{i}", "image": [str(path)], "shape": [list(shape)],
                "modality": ["CT"], "processed_report": "Findings: " + " ".join(words) + "."}
        if vqa:
            item["vqa"] = [{"question": "Is there a nodule?", "answer": "No." if i % 2 else "Yes."}]
        items.append(item)
    (root / "train-processed.json").write_text(json.dumps(items))
    return root


def build_trainer(cfg: dict, device: str, model_cfg=None):
    """The port's ``fit`` command's objects from a config dict: tokenizer,
    model (``model_cfg`` in place of the config's ``model`` section), the
    dataset, and the ``Trainer`` on ``device``."""
    import dataclasses
    from mmmm_tpu_torch.build import build_dataset, build_model, build_tokenizer
    from mmmm_tpu_torch.config import build
    from mmmm_tpu_torch.models.mmmm import MMMMModel
    from mmmm_tpu_torch.peft import LoraConfig
    from mmmm_tpu_torch.train import OptimizerConfig
    from mmmm_tpu_torch.train.trainer import Trainer, TrainerConfig

    tok = build_tokenizer(cfg.get("tokenizer"))
    if model_cfg is None:
        model = build_model(cfg["model"], tok)
    else:
        model = MMMMModel(dataclasses.replace(model_cfg, bop_token_id=tok.bop_token_id,
                                              eop_token_id=tok.eop_token_id))
    dataset = build_dataset(cfg["data"], tok, Path("."))
    return Trainer(model, dataset, build(OptimizerConfig, cfg["optimizer"]),
                   build(LoraConfig, cfg["lora"]), build(TrainerConfig, cfg["trainer"]),
                   device=device)


def count_fit_steps(trainer) -> list:
    """Wrap each step of ``trainer`` so that every call records its grounding
    mode, the batch's S, vision tokens and image shape, and the kernel
    launches of that step alone (every counter set to 0 before it)."""
    from mmmm_tpu_torch.ops._cuda import KERNELS

    record = []
    for mode, step in list(trainer.steps.items()):
        def counted(state, frozen, batch, _step=step, _mode=mode):
            for kern in KERNELS.values():
                kern.reset()
            entry = {"mode": _mode, "seq": int(batch["input_ids"].shape[1]),
                     "vision_tokens": int((batch["token_type_ids"][0] == 1).sum()) - 2,
                     "image": list(batch["image"].shape), "patch_size": batch["patch_size"],
                     "pool_size": batch["pool_size"]}
            out = _step(state, frozen, batch)
            entry["launches"] = {n: k.launches for n, k in KERNELS.items() if k.launches}
            record.append(entry)
            return out
        trainer.steps[mode] = counted
    return record


def fit_launches_expected(model_cfg, mode: str, remat=True) -> dict:
    """A step's launches under ``attn_impl="pallas"``: K7dq, K7dkv and
    K7delta once at every flash site (the LLM's and the ViT's layers, and the
    SAM encoder's with grounding), K3 twice under ``remat`` True or
    ``"dots"`` (the forward, then the recompute in the backward), once at
    the LLM's sites and twice at the others' under ``"attn"`` (the LLM
    layers keep K3's output for K7), once under False."""
    from mmmm_tpu_torch.ops._cuda import KERNELS

    llm = model_cfg.vlm.num_hidden_layers
    sites = llm + model_cfg.vlm.vision.num_hidden_layers
    if mode != "none":
        sites += model_cfg.sam.encoder_num_layers
    k3 = {True: 2 * sites, "dots": 2 * sites, "attn": 2 * sites - llm, False: sites}[remat]
    want = {name: 0 for name in KERNELS}
    want.update({"K3": k3, "K7dq": sites, "K7dkv": sites, "K7delta": sites})
    return want


def check_fit_launches(label: str, model_cfg, record: list, remat=True) -> None:
    for i, r in enumerate(record):
        want = fit_launches_expected(model_cfg, r["mode"], remat)
        got = {name: r["launches"].get(name, 0) for name in want}
        if got != want:
            raise AssertionError(f"{label} step {i + 1} ({r['mode']}, S {r['seq']}): launches "
                                 f"{r['launches']}, expected {want}")


def _metrics(out_dir: Path) -> list:
    return [json.loads(line) for line in (out_dir / "metrics.jsonl").read_text().splitlines()]


def tiny_fit_phase():
    """``Trainer.fit`` at conf/tiny/fit.yaml's model, LoRA, data and trainer
    values in fp32 (``bf16_vlm`` off) over a synthetic vision-language
    dataset of six random ``.pt`` volumes with reports and VQA pairs: 4
    steps, then a resumed run to 6, from one CPU-made state, on the card
    and on the CPU (plain versions). Each step's ``lm_loss`` and
    ``grad_norm`` agree within 1e-5 relative; the resumed runs start at
    step 4; the checkpoint restores the 4-step state bit for bit;
    ``adapter.npz`` reads back to the trainable tree; launches are exact
    every step (``fit_launches_expected`` at each bucket). Then 3
    ``align_training_step`` steps, semantic and instance, at
    ``SamConfig.tiny()`` on the card and the CPU: the loss within 1e-5
    relative, launches exact."""
    import tempfile
    from mmmm_tpu_torch import init_train_state
    from mmmm_tpu_torch.peft.lora import flatten
    from mmmm_tpu_torch.train.checkpoint import CheckpointManager, load_adapter

    log("tiny fit: Trainer.fit on the card vs the CPU")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tiny_fit_"))
    out = {"steps": {}}
    try:
        ds = write_vl_dataset(tmp / "VLSet", 6, (1, 8, 32, 32), report_chars=200, seed=0)
        base = with_keys(TINY_FIT, data__vl_trans={"max_tokens": 64, "max_tokens_z": 4},
                         data__datasets=[{"name": "VLSet", "type": "vl", "dir": str(ds)}],
                         trainer__bf16_vlm=False, trainer__frozen_vlm_bf16=False,
                         optimizer__max_steps=FIT_TINY_RESUME)
        made = build_trainer(with_keys(base, trainer__out_dir=str(tmp / "init")), "cpu")
        state0, frozen0 = init_train_state(made.model.cfg, made.optimizer, made.lora_cfg,
                                           seed=made.cfg.seed, device="cpu")
        records, metrics = {}, {}
        for dev in ("cuda", "cpu"):
            run_dir = tmp / f"run_{dev}"
            records[dev] = []
            for max_steps in (FIT_TINY_STEPS, FIT_TINY_RESUME):
                cfg = with_keys(base, trainer__out_dir=str(run_dir),
                                trainer__max_steps=max_steps)
                trainer = build_trainer(cfg, dev)
                rec = count_fit_steps(trainer)
                start = (_state_to(state0, dev), _tree_to(frozen0, dev))
                state = trainer.fit(resume=max_steps == FIT_TINY_RESUME, state=start)
                records[dev] += rec
                if max_steps == FIT_TINY_STEPS:
                    like = {"trainable": state.trainable, "opt_state": state.opt_state}
                    step, restored = CheckpointManager(run_dir / "ckpt", 4).restore(like)
                    got, want = flatten(restored), flatten(like)
                    same = step == FIT_TINY_STEPS and set(got) == set(want) and all(
                        torch.equal(got[p], want[p]) if isinstance(want[p], torch.Tensor)
                        else got[p] == want[p] for p in want)
                    adapter = flatten(load_adapter(run_dir / "adapter.npz"))
                    live = flatten(state.trainable)
                    same_adapter = set(adapter) == set(live) and all(
                        torch.equal(adapter[p], live[p].detach().cpu()) for p in live)
                    log(f"  {dev}: step-4 checkpoint restores bit for bit: {same}; "
                        f"adapter.npz reads back: {same_adapter}")
                    if not (same and same_adapter):
                        raise AssertionError(f"tiny fit {dev}: checkpoint or adapter differs")
            metrics[dev] = _metrics(run_dir)
            if [m["step"] for m in metrics[dev]] != list(range(1, FIT_TINY_RESUME + 1)):
                raise AssertionError(f"tiny fit {dev}: steps {[m['step'] for m in metrics[dev]]}")
        check_fit_launches("tiny fit (card)", made.model.cfg, records["cuda"])
        rel = lambda a, b: abs(a - b) / abs(b)
        for key in ("lm_loss", "grad_norm"):
            errs = [rel(g[key], c[key]) for g, c in zip(metrics["cuda"], metrics["cpu"])]
            out[f"{key}_rel_err"] = errs
            check(f"tiny fit {key} card vs CPU, steps 1-6 (relative)", max(errs), 1e-5)
        out["buckets"] = [{k: r[k] for k in ("mode", "seq", "vision_tokens", "patch_size")}
                          for r in records["cuda"]]
        out["launches"] = [r["launches"] for r in records["cuda"]]
        log(f"  tiny fit buckets {out['buckets']}; launches exact at each")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    out["align"] = tiny_align_check()
    return out


def align_batch(instance: bool, b: int = 2, n: int = 3, lmax: int = 6) -> dict:
    """A stage-0 patch batch at ``SamConfig.tiny()``: (3, 4, 16, 16)
    patches, 3 classes a sample (the last of the second invalid), masks;
    instance: boxes with Lmax 6 and index offsets."""
    rng = np.random.default_rng(1)
    batch = {"image": rng.uniform(size=(b, 3, 4, 16, 16)).astype(np.float32),
             "patch_size": (4, 4, 4),
             "class_idx": rng.integers(0, 5, size=(b, n)),
             "class_valid": np.array([[True] * n, [True] * (n - 1) + [False]]),
             "masks": (rng.uniform(size=(b, n, 4, 16, 16)) > 0.7).astype(np.float32)}
    if instance:
        batch["boxes_label"] = rng.uniform(0.2, 0.8, size=(b, lmax, 6)).astype(np.float32)
        batch["index_offsets"] = np.array([[[0, 2], [2, 3], [3, 3]]] * b, np.int32)
    return batch


def tiny_align_check() -> dict:
    from mmmm_tpu_torch import OptimizerConfig, make_optimizer
    from mmmm_tpu_torch.models.align import AlignConfig, align_training_step
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.params import init_sam_params
    from mmmm_tpu_torch.peft.lora import flatten, unflatten
    from mmmm_tpu_torch.train.step import batch_to

    sam = SamConfig.tiny()
    out = {}
    for instance in (False, True):
        label = "instance" if instance else "semantic"
        cfg = AlignConfig(sam=sam, instance=instance)
        init = flatten(init_sam_params(sam, instance, seed=0, device="cpu"))
        emb = torch.from_numpy(np.random.default_rng(0).normal(size=(5, sam.embed_dim))
                               .astype(np.float32) * 0.02)
        losses = {}
        for dev in ("cuda", "cpu"):
            flat = {p: t.to(dev, copy=True).requires_grad_(True) for p, t in init.items()}
            params, opt = unflatten(flat), make_optimizer(OptimizerConfig(lr=1e-3,
                                                                           warmup_steps=1))
            state = opt.init(flat)
            batch = batch_to(align_batch(instance), torch.device(dev))
            losses[dev] = []
            for i in range(3):
                for kern in KERNELS.values():
                    kern.reset()
                loss, _ = align_training_step(params, cfg, emb.to(dev), batch,
                                              attn_impl="pallas")
                grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
                opt.step(flat, dict(zip(flat, grads)), state)
                launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
                want = ({"K3": sam.encoder_num_layers, "K7dq": sam.encoder_num_layers,
                         "K7dkv": sam.encoder_num_layers, "K7delta": sam.encoder_num_layers}
                        if dev == "cuda" else {})
                if launches != want:
                    raise AssertionError(f"align {label} {dev} step {i + 1}: launches "
                                         f"{launches}, expected {want}")
                losses[dev].append(float(loss.detach()))
        errs = [abs(g - c) / abs(c) for g, c in zip(losses["cuda"], losses["cpu"])]
        check(f"align {label} loss card vs CPU, 3 steps (relative)", max(errs), 1e-5)
        out[label] = {"loss": losses, "rel_err": errs}
    return out


def flagship_fit_phase(train_none_step_s: float | None, keep_adapter: Path | None = None) -> dict:
    """``Trainer.fit`` at the flagship's full width and depth
    (``MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())`` from seed
    0), conf/lora.yaml's LoRA, AdamW lr 5e-5 with warmup 1, ``bf16_vlm``,
    ``frozen_vlm_bf16``, ``remat``, ``"pallas"``, ``vis_span="auto"``; the
    data of conf/phase-vlm/data.yaml (its ``conf`` and ``vl_trans``, with
    ``log2_patch_size_z_std`` 0 so every batch has one shape) over 8
    constant-valued (1, 64, 320, 320) ``.pt`` CT volumes with reports of
    about 850 characters (the 1024 bucket). B = 4, 6 steps, ``log_every``
    1, ``ckpt_every`` 6 (the manager also saves the first step it sees, as
    orbax's does: steps 1 and 6, ``keep_ckpts`` 1), in a temporary directory
    that the phase deletes; ``keep_adapter`` is where the fit's
    ``adapter.npz`` is moved first (phase 8 loads it).
    Gates: every loss finite, launches exact every step (at S = 1024 a
    ``"none"`` step is K3 2 x 95 and K7dq, K7dkv and K7delta 95 each)."""
    import tempfile
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.mmmm import MMMMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig

    log("flagship fit: Trainer.fit at full width and depth")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_fit_"))
    out = {}
    try:
        usage = shutil.disk_usage(tmp)
        log(f"  scratch {tmp}: {usage.free / 2**30:.1f} GiB free")
        ds = write_vl_dataset(tmp / "CT-RATE", 8, FIT_VOLUME, report_chars=850, seed=0,
                              constant=True, vqa=False)
        cfg = {"tokenizer": {"path": None}, "lora": LORA_YAML,
               "data": {"conf": PHASE_VLM_DATA["conf"],
                        "vl_trans": {**PHASE_VLM_DATA["vl_trans"], "log2_patch_size_z_std": 0},
                        "datasets": [{"name": "CT-RATE", "type": "vl", "dir": str(ds)}]},
               "optimizer": {"lr": 5e-5, "warmup_steps": 1, "max_steps": 1000},
               "trainer": {"max_steps": FIT_STEPS, "log_every": 1, "ckpt_every": FIT_STEPS,
                           "batch_size": FIT_BATCH, "seed": 0, "out_dir": str(tmp / "run"),
                           "keep_ckpts": 1,
                           "bf16_vlm": True, "frozen_vlm_bf16": True, "remat": True,
                           "attn_impl": "pallas", "vis_span": "auto"}}
        model_cfg = MMMMConfig(vlm=CogVLMConfig.cogvlm17b(), sam=SamConfig())
        trainer = build_trainer(cfg, "cuda", model_cfg=model_cfg)
        record = count_fit_steps(trainer)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        trainer.fit(resume=False)
        out["fit_s"] = time.perf_counter() - t0
        out["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        metrics = _metrics(tmp / "run")
        check_fit_launches("flagship fit", trainer.model.cfg, record)
        if len(metrics) != FIT_STEPS or not all(np.isfinite(m["lm_loss"]) and
                                                np.isfinite(m["grad_norm"]) for m in metrics):
            raise AssertionError(f"flagship fit: bad metrics {metrics}")
        first = record[0]
        step_s = [1.0 / m["steps_per_sec"] for m in metrics]
        files = lambda d: sum(f.stat().st_size for f in d.rglob("*") if f.is_file())
        ckpts = sorted((p for p in (tmp / "run" / "ckpt").iterdir() if p.name.isdigit()),
                       key=lambda p: int(p.name))
        out.update({
            "seq": first["seq"], "vision_tokens": first["vision_tokens"],
            "image": first["image"], "patch_size": first["patch_size"],
            "pool_size": first["pool_size"], "modes": [r["mode"] for r in record],
            "launches_per_step": first["launches"], "metrics": metrics, "step_s": step_s,
            "steady_step_s": statistics.median(step_s[2:]),
            "data_s": trainer.seconds["data"],
            "checkpoint_steps": [p.name for p in ckpts],
            "checkpoint_bytes": files(ckpts[-1]), "checkpoint_s": trainer.seconds["checkpoint"],
            "adapter_bytes": (tmp / "run" / "adapter.npz").stat().st_size,
            "adapter_s": trainer.seconds["export"],
            "phase6_none_step_s": train_none_step_s})
        out["tokens_per_s"] = FIT_BATCH * out["seq"] / out["steady_step_s"]
        out["data_s_per_step"] = statistics.median(out["data_s"][1:])
        log(f"  S {out['seq']}, vision tokens {out['vision_tokens']}, image {out['image']}, "
            f"patch {out['patch_size']}, pool {out['pool_size']}, modes {out['modes']}")
        log(f"  steps (host clock between log records) {['%.3f' % s for s in step_s]}; "
            f"steady (median of steps 3-6) {out['steady_step_s']:.3f} s, "
            f"{out['tokens_per_s']:.1f} tokens/s; phase 6's \"none\" step at its shapes "
            f"{train_none_step_s} s; peak {out['peak_mem_gib']:.2f} GiB")
        log(f"  data (scheduled_batches: plans, loads, transforms, resize_3d, collation) a "
            f"step {['%.3f' % s for s in out['data_s']]} s")
        log(f"  checkpoint {out['checkpoint_steps']}: {out['checkpoint_bytes'] / 2**30:.3f} GiB "
            f"in {out['checkpoint_s']} s; adapter.npz {out['adapter_bytes'] / 2**30:.3f} GiB in "
            f"{out['adapter_s']:.3f} s; whole fit {out['fit_s']:.1f} s; launches a step "
            f"{out['launches_per_step']}")
        if keep_adapter is not None:
            shutil.move(tmp / "run" / "adapter.npz", keep_adapter)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---- data parallelism (parallel/, make_train_step(mesh=...), Trainer mesh_data) -------
DP_LAYERS = 4  # LLM and ViT layers of the data-parallel phase's full-width model


@contextlib.contextmanager
def one_process_group():
    """NCCL at world size 1, joined through ``init_distributed`` from the
    three variables on a loopback port; the group is destroyed on exit and
    the environment restored."""
    import os
    import socket
    import torch.distributed as dist
    from mmmm_tpu_torch.parallel import init_distributed

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    names = ("COORDINATOR_ADDRESS", "NUM_PROCESSES", "PROCESS_ID")
    saved = {k: os.environ.get(k) for k in names}
    os.environ.update(COORDINATOR_ADDRESS=f"127.0.0.1:{port}", NUM_PROCESSES="1",
                      PROCESS_ID="0")
    try:
        if init_distributed() or dist.get_backend() != "nccl" or dist.get_world_size() != 1:
            raise AssertionError("init_distributed: expected NCCL at world size 1")
        yield
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def data_parallel_phase() -> dict:
    """The data-parallel route (``parallel/``) on the card at world size 1:
    NCCL through ``init_distributed`` (``one_process_group``), then the
    state placed by ``place_state`` and
    ``make_train_step(mesh=make_mesh(data=1))`` at the flagship's full width
    with its depth cut to 4 LLM and 4 ViT layers (all 12 SAM encoder
    layers, ``SamConfig()``), phase 6's recipe and semantic batch: 3 steps
    from one state with the mesh (its collectives: the global counts, the
    logs, the replicated gradients' all-reduce, the sharded norm), then 3
    from a copy without it. Each step's loss and gradient norm within 1e-6
    relative, K3 and K7 launches exact and equal on both routes. Then
    ``Trainer.fit`` at conf/tiny/fit.yaml's values (fp32) with
    ``trainer.mesh_data=1`` against the same fit without a mesh, from one
    state: every metric within 1e-6 relative, launches equal every step.
    Returns the results and the steady mesh step's launches."""
    import dataclasses
    from mmmm_tpu_torch import (LoraConfig, MMMMConfig, OptimizerConfig, init_train_state,
                                make_optimizer, make_train_step)
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.parallel import make_mesh
    from mmmm_tpu_torch.train.step import place_state

    log(f"data parallel at world size 1 (NCCL): full width, {DP_LAYERS} LLM and ViT layers")
    v = CogVLMConfig.cogvlm17b()
    cfg = MMMMConfig(vlm=dataclasses.replace(
        v, num_hidden_layers=DP_LAYERS,
        vision=dataclasses.replace(v.vision, num_hidden_layers=DP_LAYERS)), sam=SamConfig())
    opt = make_optimizer(OptimizerConfig(lr=5e-5, warmup_steps=1, max_steps=1000))
    lcfg = LoraConfig(r=64, alpha=8.0)
    want = fit_launches_expected(cfg, "semantic")
    out = {"layers": DP_LAYERS}
    with one_process_group():
        state, frozen = init_train_state(cfg, opt, lcfg, seed=0, frozen_vlm_bf16=True,
                                         device="cuda")
        plain_state = _state_to(state, "cuda")
        batch = flagship_train_batch("semantic", torch.Generator(device="cuda").manual_seed(0))
        mesh = make_mesh(data=1)
        out["zero_collectives"] = zero_collectives_check(mesh)
        state, mesh_frozen = place_state(state, frozen, mesh)
        runs = {}
        for label, run_state, run_frozen, kw in (("mesh", state, mesh_frozen, {"mesh": mesh}),
                                                 ("no_mesh", plain_state, frozen, {})):
            step = make_train_step(cfg, opt, lcfg, vg_mode="semantic", bf16_vlm=True,
                                   attn_impl="pallas", remat=True, vis_span="auto",
                                   device="cuda", **kw)
            steps = []
            for i in range(TRAIN_STEPS):
                for kern in KERNELS.values():
                    kern.reset()
                logs, wall = _timed_step(step, run_state, run_frozen, batch)
                launches = {n: k.launches for n, k in KERNELS.items()}
                if {n: launches[n] for n in want} != want:
                    raise AssertionError(f"data parallel {label} step {i + 1}: launches "
                                         f"{launches}, expected {want}")
                steps.append({"wall_s": wall, "logs": {k: float(x) for k, x in logs.items()},
                              "launches": {k: n for k, n in launches.items() if n}})
                log(f"  {label} step {i + 1}: {wall:.3f} s, {steps[-1]['logs']}, launches "
                    f"{steps[-1]['launches']}")
            runs[label] = steps
            del step
        del state, plain_state, frozen, mesh_frozen, run_frozen, batch
        torch.cuda.empty_cache()
        errs = {}
        for key in ("loss", "grad_norm"):
            errs[key] = [abs(a["logs"][key] - b["logs"][key]) / abs(b["logs"][key])
                         for a, b in zip(runs["mesh"], runs["no_mesh"])]
            check(f"data parallel mesh vs no mesh {key}, steps 1-3 (relative)", max(errs[key]),
                  1e-6)
        if [r["launches"] for r in runs["mesh"]] != [r["launches"] for r in runs["no_mesh"]]:
            raise AssertionError("data parallel: the routes' launches differ")
        out.update(steps=runs, rel_err=errs, launches_mesh=runs["mesh"][1]["launches"],
                   launches_no_mesh=runs["no_mesh"][1]["launches"])
        out["fit"] = data_parallel_fit()
    return out, runs["mesh"][1]["launches"]


def zero_collectives_check(mesh) -> dict:
    """ZeRO-3's collectives through NCCL on the card: a ``ZeroLeaf`` over the
    mesh's data group (world 1) indexed by layer and gathered whole
    (``all_gather_single``), its backward reduce-scattered
    (``reduce_scatter_single``): the layer and its gradient bit-equal to
    plain indexing's."""
    from mmmm_tpu_torch.parallel import ZeroLeaf

    gen = torch.Generator(device="cuda").manual_seed(1)
    w = torch.randn((3, 64, 256), generator=gen, device="cuda", requires_grad=True)
    g = torch.randn((64, 256), generator=gen, device="cuda")
    zero = ZeroLeaf(w, 2, w.shape, mesh.get_group("data"), 1, 0)
    (zero[1].full() * g).sum().backward()
    got = w.grad.clone()
    w.grad = None
    (w[1] * g).sum().backward()
    same = torch.equal(zero[1].full(), w[1]) and torch.equal(got, w.grad)
    if not same:
        raise AssertionError("ZeroLeaf gather or reduce-scatter differs on the card")
    log("  ZeroLeaf gather and reduce-scatter over NCCL: bit-equal to plain indexing")
    return {"bit_equal": True}


def data_parallel_fit() -> dict:
    """``Trainer.fit`` at conf/tiny/fit.yaml's values in fp32 on the card,
    4 steps with ``trainer.mesh_data=1`` and without a mesh from one
    CPU-made state: every metric (``steps_per_sec`` aside) within 1e-6
    relative, each step's launches equal and exact."""
    import tempfile
    from mmmm_tpu_torch import init_train_state

    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_dp_fit_"))
    try:
        ds = write_vl_dataset(tmp / "VLSet", 6, (1, 8, 32, 32), report_chars=200, seed=0)
        base = with_keys(TINY_FIT, data__vl_trans={"max_tokens": 64, "max_tokens_z": 4},
                         data__datasets=[{"name": "VLSet", "type": "vl", "dir": str(ds)}],
                         trainer__bf16_vlm=False, trainer__frozen_vlm_bf16=False,
                         trainer__max_steps=FIT_TINY_STEPS)
        made = build_trainer(with_keys(base, trainer__out_dir=str(tmp / "init")), "cpu")
        state0, frozen0 = init_train_state(made.model.cfg, made.optimizer, made.lora_cfg,
                                           seed=made.cfg.seed, device="cpu")
        metrics, records = {}, {}
        for label, extra in (("mesh", {"trainer__mesh_data": 1}), ("no_mesh", {})):
            trainer = build_trainer(with_keys(base, trainer__out_dir=str(tmp / label), **extra),
                                    "cuda")
            if (trainer.mesh is None) != (label == "no_mesh"):
                raise AssertionError(f"data parallel fit {label}: mesh {trainer.mesh}")
            records[label] = count_fit_steps(trainer)
            trainer.fit(resume=False, state=(_state_to(state0, "cuda"), _tree_to(frozen0, "cuda")))
            metrics[label] = _metrics(tmp / label)
        check_fit_launches("data parallel fit (mesh)", made.model.cfg, records["mesh"])
        if [r["launches"] for r in records["mesh"]] != [r["launches"] for r in records["no_mesh"]]:
            raise AssertionError("data parallel fit: launches differ between the routes")
        err = max(abs(a[k] - b[k]) / max(abs(b[k]), 1e-30)
                  for a, b in zip(metrics["mesh"], metrics["no_mesh"]) for k in b
                  if k != "steps_per_sec")
        if [m["step"] for m in metrics["mesh"]] != list(range(1, FIT_TINY_STEPS + 1)):
            raise AssertionError(f"data parallel fit: steps {metrics['mesh']}")
        check("data parallel fit mesh_data=1 vs no mesh, every metric (relative)", err, 1e-6)
        return {"metrics_rel_err": err, "steps": len(metrics["mesh"]),
                "launches": [r["launches"] for r in records["mesh"]]}
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# ---- tensor parallelism over the model axis: two ranks on one card over gloo ----
TP_LAYERS = 4  # LLM and ViT layers of the tensor-parallel phase's full-width bf16 model
TP_FP32_LAYERS = 2  # LLM and ViT layers of its fp32 serving check
TP_NEW = 64  # new tokens of its serving runs (a decode step's all-reduces cross the host)
TP_TIMEOUT_S = 240


def _tp_model(layers: int):
    import dataclasses as dc
    from mmmm_tpu_torch import MMMMConfig
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig

    v = CogVLMConfig.cogvlm17b()
    return MMMMConfig(vlm=dc.replace(v, num_hidden_layers=layers,
                                     vision=dc.replace(v.vision, num_hidden_layers=layers)),
                      sam=SamConfig())


def _tp_serving_inputs():
    """Phase 5's grounded batch (B = 4, its prompt, image and grounding
    image), from a generator of its own: every rank makes the same."""
    gen = torch.Generator(device="cuda").manual_seed(0)
    rng = np.random.default_rng(0)
    ids = rng.integers(4, 32000, size=(B, PROMPT)).astype(np.int32)
    tt = np.zeros((B, PROMPT), np.int32)
    tt[:, 1:1 + N_VIS] = 1
    pos = np.concatenate([[0, 1], np.full(N_VIS - 2, 2), [3, 4],
                          5 + np.arange(PROMPT - N_VIS - 2)]).astype(np.int32)
    pos = np.broadcast_to(pos, (B, PROMPT)).copy()
    lens = np.full((B,), PROMPT, np.int32)
    image = torch.randn((B, 3, 32, 384, 384), generator=gen, device="cuda").to(torch.bfloat16)
    gimg = torch.randn((B, 3, 32, 256, 256), generator=gen, device="cuda")
    return ids, tt, pos, lens, image, gimg


def tp_worker() -> int:
    """One rank of ``tensor_parallel_phase`` (argv: results directory, rank,
    the store's port). It joins a gloo group over the parent's store before
    any call of the port (``init_distributed`` then returns early), and
    writes what it saw to ``tp_<rank>.pt``; rank 0 also runs the routes
    without tensor parallelism (the references)."""
    import torch.distributed as dist
    from datetime import timedelta
    from unittest import mock
    from mmmm_tpu_torch import (LoraConfig, OptimizerConfig, generate_grounded, init_params,
                                init_train_state, make_optimizer, make_train_step)
    from mmmm_tpu_torch.models import generate as generate_mod
    from mmmm_tpu_torch.data.tokenizer import SPECIAL_TOKENS, MMMMTokenizer, _ByteBackend
    from mmmm_tpu_torch.models.generate import prefill_decode_state
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.ops.quant import qdot, quantize_llm_for_serving
    from mmmm_tpu_torch.parallel import make_mesh
    from mmmm_tpu_torch.parallel.distributed import destroy_distributed
    from mmmm_tpu_torch.parallel.sharding import tp_serving_params
    from mmmm_tpu_torch.parallel.tensor import set_model_group
    from mmmm_tpu_torch.params import map_tree
    from mmmm_tpu_torch.train.step import place_state

    tmp, rank, port = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, 2, False, timedelta(seconds=TP_TIMEOUT_S))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    out = {"rank": rank, "seconds": {}}
    t_all = time.perf_counter()

    def counted(fn):
        """``fn()`` counted and timed, with the first-token logits its route
        computed (the input of its first ``vocab_argmax`` in
        ``models/generate.py``: the prefill's; this rank's columns)."""
        seen = []
        real = generate_mod.vocab_argmax

        def record(logits):
            if not seen:
                seen.append(logits.detach().clone())
            return real(logits)

        for kern in KERNELS.values():
            kern.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with mock.patch.object(generate_mod, "vocab_argmax", record):
            res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, {n: k.launches for n, k in KERNELS.items()
                                               if k.launches}, seen[0].float().cpu() if seen else None

    # the collectives of the route through gloo on CUDA tensors, and an
    # all-reduce's time at a decode step's (B, C)
    dev = torch.device("cuda", 0)
    probe = {}
    t = torch.full((3,), rank + 1.0, device=dev, dtype=torch.bfloat16)
    dist.all_reduce(t)
    probe["sum_bf16"] = t.float().tolist()
    t = torch.tensor([float(rank), -float(rank)], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    probe["max"] = t.tolist()
    t = torch.tensor([rank, 10 - rank], device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MIN)
    probe["min_int64"] = t.tolist()
    g = torch.zeros(4, device=dev)
    dist.all_gather_into_tensor(g, torch.full((2,), float(rank), device=dev))
    probe["all_gather"] = g.tolist()
    for dt in (torch.float32, torch.bfloat16):
        a = torch.randn((B, 4096), device=dev).to(dt)
        dist.all_reduce(a)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(50):
            dist.all_reduce(a)
        torch.cuda.synchronize()
        probe[f"all_reduce_{B}x4096_{str(dt)[6:]}_us"] = (time.perf_counter() - t0) / 50 * 1e6
    out["gloo"] = probe

    tok = MMMMTokenizer(_ByteBackend(), {t: 32000 + i for i, t in enumerate(SPECIAL_TOKENS)})
    ids, tt, pos, lens, image, gimg = _tp_serving_inputs()
    args = (ids, tt, pos, lens, image, (16, 16, 16), (2, 2, 2))
    kw = dict(max_new_tokens=TP_NEW, max_targets=TARGETS, grounding_image=gimg,
              force_grounding=True, vis_span=(1, 1 + N_VIS), device="cuda")
    routes = {"greedy": {}, "spec": {"spec_draft_len": DRAFT}}

    def first_logits(params, cfg):
        with torch.inference_mode():
            _, _, last = prefill_decode_state(
                params["cogvlm"], cfg.vlm, *(torch.as_tensor(x, device=dev) for x in args[:4]),
                image=image, patch_size=(16, 16, 16), pool_size=(2, 2, 2),
                vis_span=(1, 1 + N_VIS), smax=PROMPT + 1, eos_token_id=tok.eos_token_id)
            return qdot(last, params["cogvlm"]["llm"]["lm_head"]).float().cpu()

    def serve(params, cfg, label):
        for name, extra in routes.items():
            res, sec, launches, first = counted(lambda: generate_grounded(params, cfg, tok, *args,
                                                                          **kw, **extra))
            out[f"{label}_{name}"] = {"tokens": torch.as_tensor(res.tokens), "masks":
                                      res.masks.float().cpu(), "seconds": sec,
                                      "launches": launches, "first_logits": first,
                                      "iters": res.spec_stats["iters"] if res.spec_stats
                                      else TP_NEW}

    # serving: the bf16 model at TP_LAYERS, then fp32 at TP_FP32_LAYERS
    for dtype, layers, label in ((torch.bfloat16, TP_LAYERS, "bf16"),
                                 (torch.float32, TP_FP32_LAYERS, "fp32")):
        t0 = time.perf_counter()
        cfg = _tp_model(layers)
        params = init_params(cfg, seed=0, dtype=dtype, device="cuda")
        head = params["cogvlm"]["llm"]["lm_head"]
        head[:, tok.bop_token_id] += 3.8  # phase 5's tag bias
        head[:, tok.eop_token_id] += 3.6
        set_model_group(None)  # the route without tensor parallelism serves whole weights
        if rank == 0:
            serve(params, cfg, f"{label}_tp1")
            if dtype == torch.bfloat16:
                as32 = lambda t: t.float()
                ref = {"cogvlm": map_tree(as32, params["cogvlm"])}
                out["fp32_first_logits"] = first_logits(ref, cfg)
                del ref
        dist.barrier()
        params, impl = tp_serving_params(params, 2)
        torch.cuda.empty_cache()
        serve(params, cfg, f"{label}_tp2")
        out["attn_impl"] = impl
        del params, head
        torch.cuda.empty_cache()
        out["seconds"][f"serving_{label}"] = time.perf_counter() - t0

    # W4A16 at TP_LAYERS: the row-parallel pieces repacked (down: 43 groups
    # a rank, padded to 44), K11 and K11mma on each rank's columns and rows
    t0 = time.perf_counter()
    cfg = _tp_model(TP_LAYERS)
    params = init_params(cfg, seed=0, dtype=torch.bfloat16, device="cuda")
    params["cogvlm"] = quantize_llm_for_serving(params["cogvlm"], bits=4)
    torch.cuda.empty_cache()
    set_model_group(None)
    greedy = lambda p: generate_grounded(p, cfg, tok, *args, **kw)
    if rank == 0:
        res, sec, launches, first = counted(lambda: greedy(params))
        out["w4_tp1"] = {"tokens": torch.as_tensor(res.tokens), "seconds": sec,
                         "launches": launches, "first_logits": first}
    dist.barrier()
    params, _ = tp_serving_params(params, 2)
    torch.cuda.empty_cache()
    res, sec, launches, first = counted(lambda: greedy(params))
    out["w4_tp2"] = {"tokens": torch.as_tensor(res.tokens), "seconds": sec,
                     "launches": launches, "first_logits": first}
    del params
    torch.cuda.empty_cache()
    out["seconds"]["serving_w4"] = time.perf_counter() - t0

    # training: one fp32 step at TP_LAYERS, the semantic batch
    t0 = time.perf_counter()
    cfg = _tp_model(TP_LAYERS)
    opt = make_optimizer(OptimizerConfig(lr=5e-5, warmup_steps=1, max_steps=1000))
    lcfg = LoraConfig(r=64, alpha=8.0)
    batch = flagship_train_batch("semantic", torch.Generator(device="cuda").manual_seed(0))
    step_kw = dict(vg_mode="semantic", attn_impl="pallas", remat=True, vis_span="auto",
                   device="cuda")
    if rank == 0:
        state, frozen = init_train_state(cfg, opt, lcfg, seed=0, device="cuda")
        step = make_train_step(cfg, opt, lcfg, **step_kw)
        (_, logs), sec, launches, _ = counted(lambda: step(state, frozen, batch))
        out["train_tp1"] = {"logs": {k: float(v) for k, v in logs.items()}, "seconds": sec,
                            "launches": launches}
        del state, frozen, step
        torch.cuda.empty_cache()
    dist.barrier()
    mesh = make_mesh(data=1, model=2, device="cuda")
    state, frozen = place_state(*init_train_state(cfg, opt, lcfg, seed=0, device="cuda"), mesh)
    step = make_train_step(cfg, opt, lcfg, mesh=mesh, **step_kw)
    (_, logs), sec, launches, _ = counted(lambda: step(state, frozen, batch))
    out["train_tp2"] = {"logs": {k: float(v) for k, v in logs.items()}, "seconds": sec,
                        "launches": launches}
    del state, frozen, step, mesh
    out["seconds"]["training"] = time.perf_counter() - t0
    out["seconds"]["worker"] = time.perf_counter() - t_all
    torch.save(out, tmp / f"tp_{rank}.pt")
    dist.barrier()
    destroy_distributed()
    return 0


def tensor_parallel_phase() -> tuple[dict, dict]:
    """Tensor parallelism over the ``model`` axis on the card: two worker
    processes (``tp_worker``) on the one H100, each joined to a gloo group
    over a store that this process serves (NCCL does not put two ranks on
    one device), their tensors on the card.

      - gloo carries the route's collectives on CUDA tensors (all-reduce of
        sum, max and min, all-gather), and an all-reduce of a decode step's
        (4, 4096) is timed;
      - serving at the flagship's width with TP_LAYERS LLM and ViT layers in
        bf16 (``SamConfig()``, phase 5's batch of 4): ``generate_grounded``
        greedy and with ``spec_draft_len=7`` over ``tp_serving_params(.., 2)``
        pieces against the same route without them (rank 0, the same seeded
        weights): the first-token logits that each of the four runs
        computed in its own prefill (a rank's columns joined) held to an
        fp32 prefill by ``first_token_gate``'s bounds, each rank's launches exact
        (K4 TP_LAYERS + 12 SAM encoder layers, K3 TP_LAYERS, K1 TP_LAYERS a
        token, K6 TP_LAYERS a verify step); at TP_FP32_LAYERS layers in fp32
        the tokens equal and the masks within 2e-4;
      - training: one fp32 ``make_train_step(mesh=(data 1, model 2))`` step
        (phase 6's semantic batch, LoRA r 64) against the step without a
        mesh: loss and gradient norm within 1e-5 relative, each rank's K3
        and K7 launches exact;
      - W4A16 greedy at TP_LAYERS over pieces of the int4 weights (a row
        piece of 43 scale groups repacked with a 44th of zero weights):
        each rank's K11 / K11mma launches those of one rank, the run's
        first-token logits within ``DP_LOGIT_REL_BOUND`` of one rank's (K11
        and K11mma are held to their plain version at these pieces' shapes
        in phase 3, ``W4_TP_SHAPES``).

    Returns the readings and rank 0's launches of each counted run."""
    import tempfile
    from datetime import timedelta
    import torch.distributed as dist

    log(f"tensor parallel: 2 ranks on one card over gloo, full width, {TP_LAYERS} layers "
        f"(bf16), {TP_FP32_LAYERS} (fp32)")
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_tp_"))
    store = dist.TCPStore("127.0.0.1", 0, 2, True, timedelta(seconds=TP_TIMEOUT_S),
                          wait_for_workers=False)
    here = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import sys, chip_smoke; sys.exit(chip_smoke.tp_worker())",
                               str(tmp), str(r), str(store.port)], cwd=here,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = []
        for p in procs:
            o, e = p.communicate(timeout=TP_TIMEOUT_S)
            if p.returncode != 0:
                errs.append(f"rank {procs.index(p)} exit {p.returncode}: {e[-3000:]}")
        if errs:
            raise AssertionError("tensor parallel workers failed: " + " | ".join(errs))
        ranks = [torch.load(tmp / f"tp_{r}.pt", weights_only=False) for r in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        del store
    r0 = ranks[0]
    res = {"gloo": r0["gloo"], "attn_impl": r0["attn_impl"],
           "worker_s": [r["seconds"] for r in ranks]}
    log(f"  gloo on CUDA tensors: {r0['gloo']}")
    if r0["gloo"]["max"] != [1.0, 0.0] or r0["gloo"]["min_int64"] != [0, 9] or \
            r0["gloo"]["all_gather"] != [0.0, 0.0, 1.0, 1.0] or r0["gloo"]["sum_bf16"] != [3.0] * 3:
        raise AssertionError(f"gloo's collectives on CUDA tensors: {r0['gloo']}")
    if r0["attn_impl"] != "auto":
        raise AssertionError(f"tp_serving_params: attn_impl {r0['attn_impl']}")
    # each rank's launches, exact
    for label, layers in (("bf16", TP_LAYERS), ("fp32", TP_FP32_LAYERS)):
        for name in ("greedy", "spec"):
            for route in ("tp1", "tp2"):
                for r in (ranks if route == "tp2" else ranks[:1]):
                    run = r[f"{label}_{route}_{name}"]
                    want = {"K4": layers + SAM_LAYERS, "K3": layers}
                    want.update({"K1": layers * TP_NEW} if name == "greedy"
                                else {"K6": layers * run["iters"]})
                    if run["launches"] != want:
                        raise AssertionError(f"tensor parallel {label} {route} {name} rank "
                                             f"{r['rank']}: launches {run['launches']}, "
                                             f"expected {want}")
            t1, t2 = r0[f"{label}_tp1_{name}"], r0[f"{label}_tp2_{name}"]
            same = [bool(torch.equal(r[f"{label}_tp2_{name}"]["tokens"], t2["tokens"]))
                    for r in ranks]
            if not all(same):
                raise AssertionError(f"tensor parallel {label} {name}: the ranks' tokens differ")
            equal = (t1["tokens"] == t2["tokens"]).float().mean().item()
            mask_err = max_err(t1["masks"], t2["masks"])
            res[f"{label}_{name}"] = {
                "tp1_s": t1["seconds"], "tp2_s": [r[f"{label}_tp2_{name}"]["seconds"]
                                                  for r in ranks],
                "tokens_equal_share": equal, "masks_max_abs": mask_err,
                "launches_rank": [r[f"{label}_tp2_{name}"]["launches"] for r in ranks],
                "iters": [t1["iters"], t2["iters"]]}
            log(f"  {label} {name}: tp1 {t1['seconds']:.3f} s, tp2 "
                f"{[round(x, 3) for x in res[f'{label}_{name}']['tp2_s']]} s, tokens equal "
                f"{equal:.4f}, masks max |d| {mask_err:.3e}, launches a rank "
                f"{t2['launches']}")
            if label == "fp32":
                if equal != 1.0:
                    raise AssertionError(f"tensor parallel fp32 {name}: tokens differ")
                check(f"tensor parallel fp32 {name} masks vs tp1", mask_err, 2e-4)
    # each bf16 route's first-token logits, as the route computed them in its
    # run (the two ranks' columns joined), held to the fp32 prefill's
    ref = r0["fp32_first_logits"]
    joined = lambda key: torch.cat([r[key]["first_logits"] for r in ranks], dim=-1)
    firsts = {"tp1_greedy": r0["bf16_tp1_greedy"]["first_logits"],
              "tp1_spec": r0["bf16_tp1_spec"]["first_logits"],
              "tp2_greedy": joined("bf16_tp2_greedy"), "tp2_spec": joined("bf16_tp2_spec")}
    gate_runs = {kind: {"record": [{"first_logits": list(l)}]} for kind, l in firsts.items()}
    res["first_token_gate"] = first_token_gate(gate_runs, ref, TP_LAYERS)
    res["first_logits_tp2_vs_tp1_max_abs"] = {
        name: max_err(firsts[f"tp2_{name}"], firsts[f"tp1_{name}"]) for name in ("greedy", "spec")}
    # W4A16 at tp=2: each rank's launches those of one rank, and the first-token
    # logits within the gate's relative bound of one rank's
    w1, w2 = r0["w4_tp1"], [r["w4_tp2"] for r in ranks]
    if any(w["launches"] != w1["launches"] for w in w2) or not w1["launches"].get("K11"):
        raise AssertionError(f"tensor parallel W4A16: launches a rank {[w['launches'] for w in w2]}"
                             f", one rank {w1['launches']}")
    lg1 = w1["first_logits"]
    lg2 = joined("w4_tp2")
    w4_rel = ((lg2 - lg1).norm(dim=-1) / (lg1 - lg1.mean(-1, keepdim=True)).norm(dim=-1)).max()
    res["w4_greedy"] = {"tp1_s": w1["seconds"], "tp2_s": [w["seconds"] for w in w2],
                        "launches_rank": w2[0]["launches"], "first_logits_rel": float(w4_rel),
                        "tokens_equal_share": (w1["tokens"] == w2[0]["tokens"]).float().mean()
                        .item()}
    log(f"  W4A16 greedy: tp1 {w1['seconds']:.3f} s, tp2 {[round(w['seconds'], 3) for w in w2]}"
        f" s, launches a rank {w2[0]['launches']}, first-token logits relative "
        f"{float(w4_rel):.4f}, tokens equal {res['w4_greedy']['tokens_equal_share']:.4f}")
    check("tensor parallel W4A16 first-token logits vs one rank (relative)", float(w4_rel),
          DP_LOGIT_REL_BOUND)
    # training
    a, b = r0["train_tp1"], [r["train_tp2"] for r in ranks]
    if b[0]["logs"] != b[1]["logs"]:
        raise AssertionError(f"tensor parallel step: the ranks' logs differ {b}")
    want = {k: v for k, v in fit_launches_expected(_tp_model(TP_LAYERS), "semantic").items()
            if v}
    for r, run in enumerate(b):
        if run["launches"] != want or a["launches"] != want:
            raise AssertionError(f"tensor parallel step rank {r}: launches {run['launches']} "
                                 f"(tp1 {a['launches']}), expected {want}")
    rel = {k: abs(b[0]["logs"][k] - a["logs"][k]) / abs(a["logs"][k])
           for k in ("loss", "grad_norm")}
    res["train"] = {"tp1": a, "tp2": b, "rel_err": rel}
    log(f"  train step: tp1 {a['seconds']:.3f} s {a['logs']}, tp2 "
        f"{[round(x['seconds'], 3) for x in b]} s {b[0]['logs']}, launches a rank "
        f"{b[0]['launches']}")
    for k, v in rel.items():
        check(f"tensor parallel step {k} vs tp1 (relative)", v, 1e-5)
    launches = {f"{label}_{name}": r0[f"{label}_tp2_{name}"]["launches"]
                for label in ("bf16", "fp32") for name in ("greedy", "spec")}
    launches["w4_greedy"] = r0["w4_tp2"]["launches"]
    launches["train_semantic"] = b[0]["launches"]
    return res, launches


# LLM and ViT layers of the sequence/pipeline phase's full-width fp32 model: 2, not
# 4, so that the phase (whose hops and gathers cross the host under gloo) and
# the script stay inside their time (PERF.md, the sequence/pipeline entry)
SP_LAYERS = 2
SP_RING = (4, 1024, 32, 128)  # the flagship LLM's attention (B, S, H, D), over seq=2
SP_TIMEOUT_S = 240


def _sp_expected(kind: str, rank: int) -> dict:
    """Each rank's launches of phase 7d's fp32 step on ``kind``'s mesh (or
    without one): ``attn_impl`` ``"ring"`` on ``seq``, ``"auto"`` else;
    remat recomputes each layer, so K3 and K4 launch twice a site. The ViT's
    577 tokens do not split over ``seq``: its sites take ``"auto"``, K4
    forward and a plain backward. On ``seq`` the LLM's causal ring runs
    ``rank + 1`` blocks a site; on ``pipe`` a stage runs its SP_LAYERS / 2
    layers once a microbatch (2)."""
    blocks = {"none": SP_LAYERS, "seq": SP_LAYERS * (rank + 1),
              "pipe": SP_LAYERS // 2 * 2}[kind]
    return {"K4": 2 * SP_LAYERS, "K3": 2 * blocks, "K7dq": blocks, "K7dkv": blocks,
            "K7delta": blocks}


def sp_worker() -> int:
    """One rank of ``seq_pipe_phase`` (argv: results directory, rank, the
    store's port): joins a gloo group of two over the parent's store, its
    tensors on the one card, and writes what it saw to ``sp_<rank>.pt``;
    rank 0 also runs the references without a mesh."""
    import torch.distributed as dist
    from datetime import timedelta
    from mmmm_tpu_torch import (LoraConfig, OptimizerConfig, init_train_state, make_optimizer,
                                make_train_step)
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.ops.flash import flash_attention
    from mmmm_tpu_torch.parallel import make_mesh
    from mmmm_tpu_torch.parallel.distributed import destroy_distributed
    from mmmm_tpu_torch.parallel.pipeline import set_pipe_context
    from mmmm_tpu_torch.parallel.ring_attention import (_cut, ring_hop, ring_segment_attention,
                                                        set_ring_context)
    from mmmm_tpu_torch.parallel.zero import PipeLeaf
    from mmmm_tpu_torch.peft.lora import flatten
    from mmmm_tpu_torch.train.step import place_state

    tmp, rank, port = Path(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    store = dist.TCPStore("127.0.0.1", port, 2, False, timedelta(seconds=SP_TIMEOUT_S))
    dist.init_process_group("gloo", store=store, rank=rank, world_size=2)
    out = {"rank": rank, "seconds": {}}
    t_all = time.perf_counter()

    def counted(fn):
        for kern in KERNELS.values():
            kern.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        res = fn()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t, {n: k.launches for n, k in KERNELS.items()
                                               if k.launches}

    # (i) the ring at the flagship LLM's attention, bf16, causal, over seq=2;
    # the last sample's last 100 tokens padding
    t0 = time.perf_counter()
    b, s, h, d = SP_RING
    gen = torch.Generator(device="cuda").manual_seed(0)
    q, k, v, g = (torch.randn((b, s, h, d), generator=gen, device="cuda")
                  .to(torch.bfloat16) for _ in range(4))
    seg = torch.ones((b, s), dtype=torch.int32, device="cuda")
    seg[-1, -100:] = 0
    mesh = make_mesh(data=1, seq=2, device="cuda")
    group = mesh.get_group("seq")
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]

    def ring():
        o = ring_segment_attention(*leaves, seg, group, causal=True)
        return (o.detach(), *torch.autograd.grad(o, leaves, g))

    ring()  # warm
    got, sec, launches = counted(ring)
    out["ring"] = {"out": [t.cpu() for t in got], "seconds": sec, "launches": launches}
    if rank == 0:
        ref_leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        o = flash_attention(*ref_leaves, seg, seg, causal=True, scale=d ** -0.5)
        out["ring_ref"] = [t.cpu() for t in (o.detach(),
                                             *torch.autograd.grad(o, ref_leaves, g))]
    # one hop of a (4, 512, 32, 128) K/V shard and its segment ids
    shard = tuple(_cut(t, rank, 2) for t in (k, v, seg))
    for _ in range(2):
        ring_hop(shard, group, rank, 2)
    dist.barrier()
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(10):
        ring_hop(shard, group, rank, 2)
    torch.cuda.synchronize()
    out["hop_ms"] = (time.perf_counter() - t) / 10 * 1e3
    del q, k, v, g, leaves, got
    out["seconds"]["ring"] = time.perf_counter() - t0

    # (ii)/(iii) one fp32 step at full width, SP_LAYERS layers, on each mesh
    t0 = time.perf_counter()
    cfg = _tp_model(SP_LAYERS)
    opt = make_optimizer(OptimizerConfig(lr=5e-5, warmup_steps=1, max_steps=1000))
    lcfg = LoraConfig(r=64, alpha=8.0)
    batch = flagship_train_batch("none", torch.Generator(device="cuda").manual_seed(0))
    step_kw = dict(vg_mode="none", remat=True, vis_span="auto", device="cuda")
    # the gradients the optimizer is handed: this process's chunk of each leaf
    seen, opt_step = {}, opt.step

    def recording_step(params, grads, state, **kw):
        seen.clear()
        seen.update({p: torch.zeros_like(t) if grads.get(p) is None else grads[p].detach()
                     for p, t in params.items()})
        return opt_step(params, grads, state, **kw)

    opt.step = recording_step

    def run(label, mesh, impl):
        state, frozen = init_train_state(cfg, opt, lcfg, seed=0, device="cuda")
        if mesh is not None:
            state, frozen = place_state(state, frozen, mesh)
        step = make_train_step(cfg, opt, lcfg, attn_impl=impl, mesh=mesh, **step_kw)
        (_, logs), sec, launches = counted(lambda: step(state, frozen, batch))
        # each leaf's cut over pipe (dim, rows a rank; None: whole) and the
        # norm of this rank's chunk of its gradient
        cuts = {p: (leaf.pdim, leaf.shape[leaf.pdim] // leaf.world)
                if isinstance(leaf, PipeLeaf) else (None, 0)
                for p, leaf in flatten(state.trainable).items()}
        out[label] = {"logs": {k: float(v) for k, v in logs.items()}, "seconds": sec,
                      "launches": launches, "cuts": cuts,
                      "chunk_norms": {p: float(g.norm()) for p, g in seen.items()}}
        grads = dict(seen) if mesh is None else None
        seen.clear()
        del state, frozen, step
        torch.cuda.empty_cache()
        return grads

    if rank == 0:
        ref_grads = run("train_none", None, "auto")
    dist.barrier()
    set_ring_context(mesh, "seq")
    run("train_seq", mesh, "ring")
    set_ring_context(None)
    pmesh = make_mesh(data=1, pipe=2, device="cuda")
    set_pipe_context(pmesh, "pipe", 2)
    run("train_pipe", pmesh, "auto")
    set_pipe_context(None)
    del mesh, pmesh
    if rank == 0:  # the step without a mesh's gradients cut as each rank's
        out["ref_chunk_norms"] = {
            label: {p: [float(g.norm() if dim is None else g.narrow(dim, r * k, k).norm())
                        for r in range(2)]
                    for p, g in ref_grads.items() for dim, k in [out[label]["cuts"][p]]}
            for label in ("train_seq", "train_pipe")}
        del ref_grads
    out["seconds"]["training"] = time.perf_counter() - t0
    out["seconds"]["worker"] = time.perf_counter() - t_all
    torch.save(out, tmp / f"sp_{rank}.pt")
    dist.barrier()
    destroy_distributed()
    return 0


def seq_pipe_phase() -> tuple[dict, dict]:
    """Phase 7d: sequence parallelism (ring attention over ``seq``) and
    pipeline parallelism (GPipe over ``pipe``) with two ranks on the one
    card over gloo (one H100 holds one NCCL rank; the ring's hops and the
    pipeline's go through host copies under gloo):

      - the ring at the flagship LLM's attention (SP_RING, bf16, causal, the
        last sample's last 100 tokens padding) against K3 forward and K7
        backward over the whole sequence without a mesh: output, dq, dk and
        dv within 0.05; each rank's K3 and K7 launches exact (rank 0 one
        block, rank 1 two); one hop of a (4, 512, 32, 128) bf16 K/V shard
        timed (both ranks, 10 hops after 2);
      - one fp32 ``make_train_step`` (LoRA r 64, the ``"none"`` batch) at
        full width and SP_LAYERS layers on ``make_mesh(data=1, seq=2)``
        under ``attn_impl="ring"`` and on ``make_mesh(data=1, pipe=2)``
        with 2 microbatches (SP_LAYERS / 2 layers a stage) against the step
        without a mesh (``"auto"``: the same ViT route): loss and gradient
        norm within 1e-5 relative (every log: ``lm_loss``, ``grad_norm``),
        and the norm of each rank's chunk of each leaf's gradient within
        1e-5 of the same rows' in the step without a mesh (relative to the
        larger of that norm and a thousandth of the gradient norm); each
        rank's launches exact (``_sp_expected``).

    Returns the readings and each rank's launches of each counted run."""
    import tempfile
    from datetime import timedelta
    import torch.distributed as dist

    log(f"sequence and pipeline parallel: 2 ranks on one card over gloo, the ring at "
        f"{SP_RING} bf16, an fp32 step at full width, {SP_LAYERS} layers")
    gc.collect()
    torch.cuda.empty_cache()
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_sp_"))
    store = dist.TCPStore("127.0.0.1", 0, 2, True, timedelta(seconds=SP_TIMEOUT_S),
                          wait_for_workers=False)
    here = Path(__file__).resolve().parent
    procs = [subprocess.Popen([sys.executable, "-c",
                               "import sys, chip_smoke; sys.exit(chip_smoke.sp_worker())",
                               str(tmp), str(r), str(store.port)], cwd=here,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for r in range(2)]
    try:
        errs = []
        for p in procs:
            o, e = p.communicate(timeout=SP_TIMEOUT_S)
            if p.returncode != 0:
                errs.append(f"rank {procs.index(p)} exit {p.returncode}: {e[-3000:]}")
        if errs:
            raise AssertionError("sequence/pipeline workers failed: " + " | ".join(errs))
        ranks = [torch.load(tmp / f"sp_{r}.pt", weights_only=False) for r in range(2)]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        shutil.rmtree(tmp, ignore_errors=True)
        del store
    r0 = ranks[0]
    res = {"worker_s": [r["seconds"] for r in ranks], "hop_ms": [r["hop_ms"] for r in ranks]}
    launches = {}
    # (i) the ring
    errs = {name: max(max_err(r["ring"]["out"][i], r0["ring_ref"][i]) for r in ranks)
            for i, name in enumerate(("out", "dq", "dk", "dv"))}
    for r in ranks:
        blocks = r["rank"] + 1
        want = {"K3": blocks, "K7dq": blocks, "K7dkv": blocks, "K7delta": blocks}
        if r["ring"]["launches"] != want:
            raise AssertionError(f"ring rank {r['rank']}: launches {r['ring']['launches']}, "
                                 f"expected {want}")
    launches["ring"] = [r["ring"]["launches"] for r in ranks]
    res["ring"] = {"max_abs_err": errs, "seconds": [r["ring"]["seconds"] for r in ranks]}
    log(f"  ring {SP_RING} bf16 causal over seq=2: "
        f"{[round(r['ring']['seconds'], 4) for r in ranks]} s a forward and backward; one hop "
        f"of a (4, 512, 32, 128) K/V shard "
        f"{[round(x, 3) for x in res['hop_ms']]} ms; launches {launches['ring']}")
    for name, e in errs.items():
        check(f"ring {name} vs K3/K7 on the whole sequence", e, 0.05)
    # (ii) and (iii) the steps
    ref = r0["train_none"]
    if ref["launches"] != {n: c for n, c in _sp_expected("none", 0).items() if c}:
        raise AssertionError(f"step without a mesh: launches {ref['launches']}")
    for kind in ("seq", "pipe"):
        runs = [r[f"train_{kind}"] for r in ranks]
        if runs[0]["logs"] != runs[1]["logs"]:
            raise AssertionError(f"{kind} step: the ranks' logs differ {runs}")
        for r, run in enumerate(runs):
            want = {n: c for n, c in _sp_expected(kind, r).items() if c}
            if run["launches"] != want:
                raise AssertionError(f"{kind} step rank {r}: launches {run['launches']}, "
                                     f"expected {want}")
        rel = {k: abs(runs[0]["logs"][k] - v) / abs(v) for k, v in ref["logs"].items()}
        # each rank's chunk of each leaf's gradient, by its norm, against the
        # same rows of the step without a mesh (a chunk routed to the wrong
        # rank keeps the global norm); relative to the larger of the chunk's
        # norm and a thousandth of the whole gradient's
        ref_norms = r0["ref_chunk_norms"][f"train_{kind}"]
        floor = 1e-3 * ref["logs"]["grad_norm"]
        if any(set(run["chunk_norms"]) != set(ref_norms) for run in runs):
            raise AssertionError(f"{kind} step: the ranks' gradient leaves differ from the "
                                 "step without a mesh's")
        rel["grad_chunk_norms"] = max(abs(run["chunk_norms"][p] - want[r]) / max(want[r], floor)
                                      for r, run in enumerate(runs)
                                      for p, want in ref_norms.items())
        res[f"train_{kind}"] = {"rel_err": rel, "seconds": [x["seconds"] for x in runs],
                                "logs": runs[0]["logs"], "leaves": len(ref_norms),
                                "pipe_cut_leaves": sum(c[0] is not None
                                                       for c in runs[0]["cuts"].values())}
        launches[f"train_{kind}"] = [x["launches"] for x in runs]
        log(f"  {kind} step: {[round(x['seconds'], 3) for x in runs]} s {runs[0]['logs']}, "
            f"no mesh {ref['seconds']:.3f} s {ref['logs']}; launches {launches[f'train_{kind}']}")
        for k, v in rel.items():
            check(f"{kind} step {k} vs the step without a mesh (relative)", v, 1e-5)
    res["train_none"] = {"seconds": ref["seconds"], "logs": ref["logs"]}
    return res, launches


# ---- the finetune command (scripts/finetune/cli.py) ----------------------------------
# conf/finetune/mmmm-vqa.yaml as load_yaml resolves it, less its model and LoRA
# (../model.yaml, ../lora.yaml: the flagship and LORA_YAML), held to the file
# by tests/test_torch_port_finetune.py
FT_VQA = {"tokenizer": {"path": None},
          "data": {"conf": {"max_seq_len": 1024},
                   "vl_trans": {"max_tokens": 256, "max_tokens_z": 4}},
          "optimizer": {"lr": 5.0e-5, "weight_decay": 0.01, "warmup_steps": 0,
                        "max_steps": 2000, "grad_clip_norm": 1.0},
          "trainer": {"max_steps": 2000, "ckpt_every": 500, "batch_size": 8,
                      "out_dir": "runs/finetune-vqa"}}
FT_STEPS, FT_LAYERS = 3, 2


def finetune_phase() -> dict:
    """The ``finetune`` command (``cli.cmd_finetune``) over a synthetic VQA
    set, warm-started (``--init-adapter``) from an ``adapter.npz`` that
    ``save_adapter`` wrote, under ``trainer.remat="attn"``:

      - at conf/tiny/fit.yaml's model in fp32, 3 steps, on the card and on
        the CPU from one CPU-made state: each step's ``lm_loss`` and
        ``grad_norm`` within 1e-5 relative; launches exact (a VQA step is
        ``"none"``: K3 once at the LLM's layers and twice at the ViT's);
      - at the flagship's full width with 2 LLM and 2 ViT layers (bf16
        CogVLM, conf/lora.yaml, conf/finetune/mmmm-vqa.yaml's data,
        optimizer and trainer values at B = 4, one patch depth) over four
        constant (1, 64, 320, 320) CT volumes: step time (median of steps 2-3), launches
        exact, the adapter export's bytes and seconds. The finetuned SAM,
        instance SAM, ``vg_proj`` and ``embed_tokens`` are 396 M fp32
        parameters at any depth, so the adapter is 1.70 GB."""
    import dataclasses
    import tempfile
    from mmmm_tpu_torch import cli, init_train_state
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.mmmm import MMMMConfig
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.peft.lora import flatten
    from mmmm_tpu_torch.train.checkpoint import save_adapter

    log("finetune: the finetune command, warm-started, remat \"attn\"")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_finetune_"))
    out = {}

    def run(cfg, ds, adapter, dev, state):
        args = cli.parse_args(["finetune", "-c", "conf/finetune/mmmm-vqa.yaml", "--dataset-dir",
                               str(ds), "--init-adapter", str(adapter), "--device", dev])
        for kern in KERNELS.values():
            kern.reset()
        t0 = time.perf_counter()
        trainer = cli.cmd_finetune(args, cfg=cfg, state=state)
        wall = time.perf_counter() - t0
        launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
        metrics = _metrics(Path(cfg["trainer"]["out_dir"]))
        if [m["step"] for m in metrics] != list(range(1, FT_STEPS + 1)):
            raise AssertionError(f"finetune {dev}: steps {[m['step'] for m in metrics]}")
        if dev == "cuda":
            want = fit_launches_expected(trainer.model.cfg, "none", "attn")
            want = {n: FT_STEPS * c for n, c in want.items() if c}
            if launches != want:
                raise AssertionError(f"finetune: launches {launches}, {FT_STEPS} VQA steps "
                                     f"under remat attn launch {want}")
        return trainer, metrics, launches, wall

    try:
        ds = write_vl_dataset(tmp / "VQASet", 4, (1, 8, 32, 32), report_chars=120, seed=3)
        tiny = with_keys(TINY_FIT, data__vl_trans={"max_tokens": 64, "max_tokens_z": 4},
                         trainer__bf16_vlm=False, trainer__frozen_vlm_bf16=False,
                         trainer__remat="attn", trainer__max_steps=FT_STEPS,
                         optimizer__max_steps=FT_STEPS)
        made = build_trainer(with_keys(tiny, trainer__out_dir=str(tmp / "init"), data__datasets=[
            {"name": "VQASet", "type": "vl", "dir": str(ds)}]), "cpu")
        state0, frozen0 = init_train_state(made.model.cfg, made.optimizer, made.lora_cfg,
                                           seed=5, device="cpu")
        g = torch.Generator().manual_seed(5)  # a trained-looking adapter: b nonzero
        with torch.no_grad():
            for path, t in flatten(state0.trainable).items():
                if path.endswith("/b"):
                    t.normal_(std=0.02, generator=g)
        save_adapter(tmp / "tiny_adapter.npz", state0.trainable)
        metrics = {}
        for dev in ("cuda", "cpu"):
            cfg = with_keys(tiny, trainer__out_dir=str(tmp / f"tiny_{dev}"))
            _, metrics[dev], launches, _ = run(cfg, ds, tmp / "tiny_adapter.npz", dev,
                                               (_state_to(state0, dev), _tree_to(frozen0, dev)))
            if dev == "cuda":
                out["tiny_launches"] = launches
        rel = lambda a, b: abs(a - b) / abs(b)
        for key in ("lm_loss", "grad_norm"):
            errs = [rel(g_[key], c[key]) for g_, c in zip(metrics["cuda"], metrics["cpu"])]
            out[f"tiny_{key}_rel_err"] = errs
            check(f"finetune tiny {key} card vs CPU, steps 1-{FT_STEPS} (relative)", max(errs),
                  1e-5)
        out["tiny_metrics"] = metrics["cuda"]
        log(f"  finetune tiny: launches {out['tiny_launches']} over {FT_STEPS} steps")

        v = CogVLMConfig.cogvlm17b()
        model = dataclasses.asdict(MMMMConfig(vlm=dataclasses.replace(
            v, num_hidden_layers=FT_LAYERS,
            vision=dataclasses.replace(v.vision, num_hidden_layers=FT_LAYERS)), sam=SamConfig()))
        ds = write_vl_dataset(tmp / "VQA-CT", 4, FIT_VOLUME, report_chars=120, seed=4,
                              constant=True)
        full = with_keys(FT_VQA, model=model, lora=LORA_YAML,
                         data__vl_trans={**FT_VQA["data"]["vl_trans"], "log2_patch_size_z_std": 0},
                         optimizer__max_steps=FT_STEPS, trainer__max_steps=FT_STEPS,
                         trainer__batch_size=4, trainer__log_every=1, trainer__seed=0,
                         trainer__remat="attn", trainer__out_dir=str(tmp / "full"))
        made = build_trainer(with_keys(full, trainer__out_dir=str(tmp / "full_init"),
                                       data__datasets=[]), "cuda")
        state, frozen = init_train_state(made.model.cfg, made.optimizer, made.lora_cfg, seed=0,
                                         frozen_vlm_bf16=True, device="cuda")
        save_adapter(tmp / "full_adapter.npz", state.trainable)
        del made
        torch.cuda.reset_peak_memory_stats()
        trainer, fm, launches, wall = run(full, ds, tmp / "full_adapter.npz", "cuda",
                                          (state, frozen))
        step_s = [1.0 / m["steps_per_sec"] for m in fm]
        out.update({"full_layers": FT_LAYERS, "full_metrics": fm, "full_step_s": step_s,
                    "full_steady_step_s": statistics.median(step_s[1:]),
                    "full_launches": launches, "full_wall_s": wall,
                    "full_peak_mem_gib": torch.cuda.max_memory_allocated() / 2**30,
                    "full_adapter_bytes": (tmp / "full" / "adapter.npz").stat().st_size,
                    "full_export_s": trainer.seconds["export"],
                    "full_checkpoint_s": trainer.seconds["checkpoint"],
                    "full_data_s": trainer.seconds["data"]})
        if not all(np.isfinite(m["lm_loss"]) for m in fm):
            raise AssertionError(f"finetune at full width: bad metrics {fm}")
        log(f"  finetune full width, {FT_LAYERS} LLM and ViT layers: steps "
            f"{['%.3f' % x for x in step_s]} s, launches {launches}, peak "
            f"{out['full_peak_mem_gib']:.2f} GiB, adapter {out['full_adapter_bytes'] / 2**30:.3f} "
            f"GiB in {out['full_export_s']:.3f} s, checkpoints {trainer.seconds['checkpoint']} s, "
            f"whole command {wall:.1f} s")
        del trainer, state, frozen
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
        torch.cuda.empty_cache()
    return out


# ---- phase 8: the entry points (import, PEFT, demo, predict, evaluate) -------------
# conf/model.yaml, and conf/phase-vlm/fit.yaml's model, tokenizer, data conf
# and LoRA as load_yaml resolves them (the card has no PyYAML)
MODEL_YAML = {
    "vlm": {"vocab_size": 32008, "hidden_size": 4096, "intermediate_size": 11008,
            "num_hidden_layers": 32, "num_attention_heads": 32,
            "max_position_embeddings": 2048,
            "vision": {"hidden_size": 1792, "intermediate_size": 15360, "num_hidden_layers": 63,
                       "num_heads": 16, "patch_size": [16, 16, 16], "pos_embed_shape": [8, 32, 32],
                       "pt_pos_embed_shape": [35, 35]}},
    "sam": {"embed_dim": 768, "encoder_num_layers": 12, "encoder_num_heads": 12,
            "patch_size": [16, 16, 16], "pos_embed_shape": [8, 32, 32], "num_instances": 6},
    "lm_loss_weight": 1.0,
    "mask_loss": {"dice_weight": 2, "focal_weight": 2, "focal_gamma": 2},
    "isam_loss": {"use_neg_mask": False, "box_l1_weight": 5, "box_giou_weight": 2,
                  "disc_weight": 2, "disc_focal_gamma": 2, "disc_focal_alpha": 0.85},
}
PHASE_VLM_FIT = {"model": MODEL_YAML, "tokenizer": {"path": None}, "lora": LORA_YAML,
                 "data": {"conf": PHASE_VLM_DATA["conf"]}}
IMPORT_LAYERS = 2  # LLM and ViT layers of the import check (full width)
SEGVOL_PT_PATCH, SEGVOL_PT_POS = (4, 16, 16), (8, 8, 8)
PREDICT_ITEMS, PREDICT_BATCH = 8, 4
# run (a)'s image and grounding image, one sample each, and its patch and pool
ENTRY_IMAGE, ENTRY_GIMAGE = (1, 3, 32, 384, 384), (1, 3, 32, 256, 256)
ENTRY_PATCH, ENTRY_POOL = (16, 16, 16), (2, 2, 2)
# (tree path, HF key format, transposed) of every leaf the importers copy
# layer by layer; {} is the layer
COGVLM_LAYER_COPIES = [
    ("llm/layers/vis_qkv", "model.layers.{}.self_attn.vision_expert_query_key_value.weight", 1),
    ("llm/layers/lang_qkv", "model.layers.{}.self_attn.language_expert_query_key_value.weight",
     1),
    ("llm/layers/vis_dense", "model.layers.{}.self_attn.vision_expert_dense.weight", 1),
    ("llm/layers/lang_dense", "model.layers.{}.self_attn.language_expert_dense.weight", 1),
    *[(f"llm/layers/{ours}/{p}", f"model.layers.{{}}.mlp.{hf}.{p}_proj.weight", 1)
      for ours, hf in (("vis_mlp", "vision_mlp"), ("lang_mlp", "language_mlp"))
      for p in ("gate", "up", "down")],
    ("llm/layers/input_ln", "model.layers.{}.input_layernorm.weight", 0),
    ("llm/layers/post_ln", "model.layers.{}.post_attention_layernorm.weight", 0),
    *[(f"vision/layers/{ours}", f"model.vision.transformer.layers.{{}}.{hf}", t)
      for ours, hf, t in (("qkv_w", "attention.query_key_value.weight", 1),
                          ("qkv_b", "attention.query_key_value.bias", 0),
                          ("dense_w", "attention.dense.weight", 1),
                          ("dense_b", "attention.dense.bias", 0),
                          ("ln1_w", "input_layernorm.weight", 0),
                          ("ln1_b", "input_layernorm.bias", 0),
                          ("ln2_w", "post_attention_layernorm.weight", 0),
                          ("ln2_b", "post_attention_layernorm.bias", 0),
                          ("fc1_w", "mlp.fc1.weight", 1), ("fc1_b", "mlp.fc1.bias", 0),
                          ("fc2_w", "mlp.fc2.weight", 1), ("fc2_b", "mlp.fc2.bias", 0))],
]
COGVLM_COPIES = [("llm/norm", "model.norm.weight", 0),
                 ("vision/patch/proj_b", "model.vision.patch_embedding.proj.bias", 0),
                 ("vision/glu/linear_proj", "model.vision.linear_proj.linear_proj.weight", 1),
                 ("vision/glu/ln_w", "model.vision.linear_proj.norm1.weight", 0),
                 ("vision/glu/ln_b", "model.vision.linear_proj.norm1.bias", 0),
                 ("vision/glu/gate", "model.vision.linear_proj.gate_proj.weight", 1),
                 ("vision/glu/h4h", "model.vision.linear_proj.dense_h_to_4h.weight", 1),
                 ("vision/glu/4hh", "model.vision.linear_proj.dense_4h_to_h.weight", 1)]
SAM_LAYER_COPIES = [(f"encoder/layers/{ours}", f"image_encoder.blocks.{{}}.{hf}", t)
                    for ours, hf, t in (("qkv_w", "attn.qkv.weight", 1),
                                        ("out_w", "attn.out_proj.weight", 1),
                                        ("out_b", "attn.out_proj.bias", 0),
                                        ("ln1_w", "norm1.weight", 0), ("ln1_b", "norm1.bias", 0),
                                        ("ln2_w", "norm2.weight", 0), ("ln2_b", "norm2.bias", 0),
                                        ("fc1_w", "mlp.linear1.weight", 1),
                                        ("fc1_b", "mlp.linear1.bias", 0),
                                        ("fc2_w", "mlp.linear2.weight", 1),
                                        ("fc2_b", "mlp.linear2.bias", 0))]
RESAMPLED_LEAVES = {"cogvlm/vision/patch/pos", "cogvlm/vision/patch/proj_w",
                    "sam/encoder/patch/proj_w", "sam/encoder/patch/pos"}


def hf_cogvlm_state(vcfg, base_vocab: int, gen) -> dict:
    """A seeded HF CogVLM state dict (torch names, Linear weights (out, in),
    a (1 + 35 x 35, C) position table, a 14 x 14 patch conv) at ``vcfg``'s
    width and depth, bf16 in host memory as a loaded checkpoint is."""
    c, i, L = vcfg.hidden_size, vcfg.intermediate_size, vcfg.num_hidden_layers
    v = vcfg.vision
    cv, iv = v.hidden_size, v.intermediate_size
    h0, w0 = v.pt_pos_embed_shape
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda", dtype=torch.bfloat16).mul_(
        0.02).cpu()
    one = lambda n: torch.ones(n, dtype=torch.bfloat16)
    zero = lambda n: torch.zeros(n, dtype=torch.bfloat16)
    vp = "model.vision."
    sd = {"model.embed_tokens.weight": r(base_vocab, c), "model.norm.weight": one(c),
          "lm_head.weight": r(base_vocab, c),
          vp + "patch_embedding.position_embedding.weight": r(1 + h0 * w0, cv),
          vp + "patch_embedding.proj.weight": r(cv, 3, 14, 14),
          vp + "patch_embedding.proj.bias": r(cv), vp + "patch_embedding.cls_embedding": r(cv),
          vp + "boi": r(1, 1, c), vp + "eoi": r(1, 1, c),
          vp + "linear_proj.linear_proj.weight": r(c, cv), vp + "linear_proj.norm1.weight": one(c),
          vp + "linear_proj.norm1.bias": zero(c), vp + "linear_proj.gate_proj.weight": r(i, c),
          vp + "linear_proj.dense_h_to_4h.weight": r(i, c),
          vp + "linear_proj.dense_4h_to_h.weight": r(c, i)}
    for li in range(L):
        p = f"model.layers.{li}."
        for ex in ("vision", "language"):
            sd[p + f"self_attn.{ex}_expert_query_key_value.weight"] = r(3 * c, c)
            sd[p + f"self_attn.{ex}_expert_dense.weight"] = r(c, c)
            sd[p + f"mlp.{ex}_mlp.gate_proj.weight"] = r(i, c)
            sd[p + f"mlp.{ex}_mlp.up_proj.weight"] = r(i, c)
            sd[p + f"mlp.{ex}_mlp.down_proj.weight"] = r(c, i)
        sd[p + "input_layernorm.weight"] = one(c)
        sd[p + "post_attention_layernorm.weight"] = one(c)
    for li in range(v.num_hidden_layers):
        p = vp + f"transformer.layers.{li}."
        sd.update({p + "attention.query_key_value.weight": r(3 * cv, cv),
                   p + "attention.query_key_value.bias": r(3 * cv),
                   p + "attention.dense.weight": r(cv, cv), p + "attention.dense.bias": r(cv),
                   p + "input_layernorm.weight": one(cv), p + "input_layernorm.bias": zero(cv),
                   p + "post_attention_layernorm.weight": one(cv),
                   p + "post_attention_layernorm.bias": zero(cv),
                   p + "mlp.fc1.weight": r(iv, cv), p + "mlp.fc1.bias": r(iv),
                   p + "mlp.fc2.weight": r(cv, iv), p + "mlp.fc2.bias": r(cv)})
    return sd


def hf_segvol_state(cfg, gen) -> dict:
    """A seeded SegVol SAM state dict (keys relative to the sam module, fp32)
    with the released patch (4, 16, 16) flattened, the (8, 8, 8) token grid,
    4 mask tokens, 4-D LayerNormNd stats and the point prompt tables."""
    c, L, md = cfg.embed_dim, cfg.encoder_num_layers, cfg.decoder_mlp_dim
    internal = c // cfg.attention_downsample_rate
    r = lambda *s: torch.randn(*s, generator=gen, device="cuda").mul_(0.02).cpu()
    p0, p1, p2 = SEGVOL_PT_PATCH
    sd = {"image_encoder.patch_embedding.patch_embeddings.1.weight": r(c, p0 * p1 * p2),
          "image_encoder.patch_embedding.patch_embeddings.1.bias": r(c),
          "image_encoder.patch_embedding.position_embeddings": r(1, math.prod(SEGVOL_PT_POS), c),
          "image_encoder.norm.weight": torch.ones(c), "image_encoder.norm.bias": torch.zeros(c),
          "prompt_encoder.pe_layer.positional_encoding_gaussian_matrix": r(3, c // 2) * 50,
          "prompt_encoder.no_mask_embed.weight": r(1, c),
          "prompt_encoder.not_a_point_embed.weight": r(1, c),
          "mask_decoder.iou_token.weight": r(1, c), "mask_decoder.mask_tokens.weight": r(4, c),
          "mask_decoder.output_upscaling.0.weight": r(c, c // 4, 2, 2, 2),
          "mask_decoder.output_upscaling.0.bias": r(c // 4),
          "mask_decoder.output_upscaling.1.weight": 1 + r(c // 4, 3, 3, 3),
          "mask_decoder.output_upscaling.1.bias": r(c // 4, 3, 3, 3),
          "mask_decoder.output_upscaling.3.weight": r(c // 4, c // 8, 2, 2, 2),
          "mask_decoder.output_upscaling.3.bias": r(c // 8),
          "mask_decoder.txt_align_upscaled_embedding.weight": r(c // 8, c),
          "mask_decoder.txt_align_upscaled_embedding.bias": r(c // 8)}
    for i in range(4):
        sd[f"prompt_encoder.point_embeddings.{i}.weight"] = r(1, c)
    for i in range(L):
        p = f"image_encoder.blocks.{i}."
        sd.update({p + "attn.qkv.weight": r(3 * c, c), p + "attn.out_proj.weight": r(c, c),
                   p + "attn.out_proj.bias": r(c), p + "norm1.weight": torch.ones(c),
                   p + "norm1.bias": torch.zeros(c), p + "norm2.weight": torch.ones(c),
                   p + "norm2.bias": torch.zeros(c),
                   p + "mlp.linear1.weight": r(cfg.encoder_mlp_dim, c),
                   p + "mlp.linear1.bias": r(cfg.encoder_mlp_dim),
                   p + "mlp.linear2.weight": r(c, cfg.encoder_mlp_dim), p + "mlp.linear2.bias": r(c)})

    def attn(p, dim):
        for proj in ("q_proj", "k_proj", "v_proj"):
            sd[p + proj + ".weight"], sd[p + proj + ".bias"] = r(dim, c), r(dim)
        sd[p + "out_proj.weight"], sd[p + "out_proj.bias"] = r(c, dim), r(c)

    for i in range(cfg.decoder_depth):
        p = f"mask_decoder.transformer.layers.{i}."
        attn(p + "self_attn.", c)
        attn(p + "cross_attn_token_to_image.", internal)
        attn(p + "cross_attn_image_to_token.", internal)
        for n in ("norm1", "norm2", "norm3", "norm4"):
            sd[p + n + ".weight"], sd[p + n + ".bias"] = torch.ones(c), torch.zeros(c)
        sd.update({p + "mlp.lin1.weight": r(md, c), p + "mlp.lin1.bias": r(md),
                   p + "mlp.lin2.weight": r(c, md), p + "mlp.lin2.bias": r(c)})
    attn("mask_decoder.transformer.final_attn_token_to_image.", internal)
    sd["mask_decoder.transformer.norm_final_attn.weight"] = torch.ones(c)
    sd["mask_decoder.transformer.norm_final_attn.bias"] = torch.zeros(c)
    for mi in range(2):
        p = f"mask_decoder.output_hypernetworks_mlps.{mi}."
        sd.update({p + "layers.0.weight": r(c, c), p + "layers.0.bias": r(c),
                   p + "layers.1.weight": r(c, c), p + "layers.1.bias": r(c),
                   p + "layers.2.weight": r(c // 8, c), p + "layers.2.bias": r(c // 8)})
    return sd


def _plain_resample(x: torch.Tensor, shape, scale: bool = False) -> torch.Tensor:
    """``F.interpolate``'s linear resize (half-pixel centers, no
    anti-aliasing) on the CPU in fp32: the plain resampler the importer's
    matrices are held to."""
    mode = {2: "bilinear", 3: "trilinear"}[len(shape)]
    lead = x.shape[:x.dim() - len(shape)]
    flat = x.float().reshape(1, -1, *x.shape[x.dim() - len(shape):])
    out = F.interpolate(flat, size=tuple(shape), mode=mode, align_corners=False)
    out = out.reshape(*lead, *shape)
    if scale:
        out = out * (math.prod(x.shape[x.dim() - len(shape):]) / math.prod(shape))
    return out


def import_check(cfg) -> dict:
    """``import_cogvlm``, ``import_segvol_sam`` and ``merge_imported`` at the
    flagship's width with ``IMPORT_LAYERS`` LLM and ViT layers (the whole
    tower in host memory would be about 36 GB): seeded HF-layout state dicts
    -> a fresh ``init_params`` tree on the card. Every copied leaf must be
    bit-equal to its source (transposed where the HF layout is (out, in));
    the resampled leaves (the ViT's position grid (35, 35) -> (32, 32) and
    patch conv 14 x 14 -> 16 x 16, mean-inflated over z; SAM's patch
    (4, 16, 16) -> (16, 16, 16) and token grid (8, 8, 8) -> (8, 32, 32))
    within 1e-6 of ``F.interpolate`` on the CPU, and on the card the same
    values in the tree's dtype."""
    import dataclasses
    from mmmm_tpu_torch import init_params
    from mmmm_tpu_torch.params import _flatten
    from mmmm_tpu_torch.train.import_torch import (import_cogvlm, import_segvol_sam,
                                                   merge_imported)

    vlm = dataclasses.replace(cfg.vlm, num_hidden_layers=IMPORT_LAYERS, vision=dataclasses.replace(
        cfg.vlm.vision, num_hidden_layers=IMPORT_LAYERS))
    cut = dataclasses.replace(cfg, vlm=vlm)
    gen = torch.Generator(device="cuda").manual_seed(5)
    base_vocab = vlm.vocab_size - 8  # the released vocabulary, before the grounding tokens
    t0 = time.perf_counter()
    sd = hf_cogvlm_state(vlm, base_vocab, gen)
    sam_sd = hf_segvol_state(cfg.sam, gen)
    make_s = time.perf_counter() - t0
    src_bytes = sum(t.numel() * t.element_size() for t in (*sd.values(), *sam_sd.values()))
    fresh = init_params(cut, seed=0, dtype=torch.bfloat16, device="cuda")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    imported = {"cogvlm": import_cogvlm(sd, vlm),
                "sam": import_segvol_sam(sam_sd, cfg.sam, pt_in_channels=1,
                                         pt_patch_size=SEGVOL_PT_PATCH,
                                         pt_pos_embed_shape=SEGVOL_PT_POS)}
    import_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    params = merge_imported(fresh, imported)
    torch.cuda.synchronize()
    merge_s = time.perf_counter() - t0
    flat, imp = _flatten(params), _flatten(imported)
    out_bytes = sum(flat[p].numel() * flat[p].element_size() for p in imp)

    # the card's leaves are the importer's, in the tree's dtype, bit for bit
    for path, t in imp.items():
        if not torch.equal(flat[path].cpu(), t.to(flat[path].dtype)):
            raise AssertionError(f"import: {path} on the card differs from the importer's")
        if path not in RESAMPLED_LEAVES and t.dtype != flat[path].dtype:
            raise AssertionError(f"import: copied leaf {path} is {t.dtype}, the tree's "
                                 f"{flat[path].dtype}")
    # every copied leaf is its source, transposed where HF stores (out, in)
    copied = 0

    def same(path, src, transpose):
        nonlocal copied
        src = src.T if transpose else src
        if not torch.equal(flat[path].cpu(), src):
            raise AssertionError(f"import: {path} is not bit-equal to its source")
        copied += 1

    for path, fmt, tr in COGVLM_LAYER_COPIES:
        for li in range(IMPORT_LAYERS):
            src = sd[fmt.format(li)]
            if not torch.equal(flat[f"cogvlm/{path}"][li].cpu(), src.T if tr else src):
                raise AssertionError(f"import: cogvlm/{path} layer {li} is not its source")
            copied += 1
    for path, key, tr in COGVLM_COPIES:
        same(f"cogvlm/{path}", sd[key], tr)
    for path, fmt, tr in SAM_LAYER_COPIES:
        for li in range(cfg.sam.encoder_num_layers):
            src = sam_sd[fmt.format(li)]
            if not torch.equal(flat[f"sam/{path}"][li].cpu(), src.T if tr else src):
                raise AssertionError(f"import: sam/{path} layer {li} is not its source")
            copied += 1
    vp = "model.vision.patch_embedding."
    emb, head = flat["cogvlm/llm/embed_tokens"].cpu(), flat["cogvlm/llm/lm_head"].cpu()
    if not (torch.equal(emb[:base_vocab], sd["model.embed_tokens.weight"])
            and torch.equal(head[:, :base_vocab], sd["lm_head.weight"].T)
            and torch.equal(flat["cogvlm/vision/patch/cls_pos"].cpu(),
                            sd[vp + "position_embedding.weight"][:1])
            and torch.equal(flat["cogvlm/vision/patch/cls"].cpu()[0], sd[vp + "cls_embedding"])):
        raise AssertionError("import: the embeddings, head or cls leaves are not their source")
    copied += 4
    # the resampled leaves against F.interpolate
    h0, w0 = vlm.vision.pt_pos_embed_shape
    grid = sd[vp + "position_embedding.weight"][1:].reshape(h0, w0, -1).permute(2, 0, 1)[None]
    want_pos = _plain_resample(grid, vlm.vision.pos_embed_shape[1:])[:, :, None].expand(
        -1, -1, vlm.vision.pos_embed_shape[0], -1, -1)
    want_proj = _plain_resample(sd[vp + "proj.weight"], vlm.vision.patch_size[1:], scale=True)
    want_proj = (want_proj[:, :, None] / vlm.vision.patch_size[0]).expand(
        -1, -1, vlm.vision.patch_size[0], -1, -1)
    c = cfg.sam.embed_dim
    pw = sam_sd["image_encoder.patch_embedding.patch_embeddings.1.weight"].reshape(
        c, *SEGVOL_PT_PATCH, 1).permute(0, 4, 1, 2, 3)
    want_sam_proj = _plain_resample(pw, cfg.sam.patch_size, scale=True).repeat(
        1, cfg.sam.in_channels, 1, 1, 1) / cfg.sam.in_channels
    spos = sam_sd["image_encoder.patch_embedding.position_embeddings"].reshape(
        *SEGVOL_PT_POS, c).permute(3, 0, 1, 2)[None]
    want_sam_pos = _plain_resample(spos, cfg.sam.pos_embed_shape)
    resampled = {}
    for path, want in (("cogvlm/vision/patch/pos", want_pos),
                       ("cogvlm/vision/patch/proj_w", want_proj),
                       ("sam/encoder/patch/proj_w", want_sam_proj),
                       ("sam/encoder/patch/pos", want_sam_pos)):
        resampled[path] = err = max_err(imp[path], want)
        check(f"import {path} {tuple(want.shape)} against F.interpolate", err, 1e-6)
    out = {"layers": IMPORT_LAYERS, "source_bytes": src_bytes, "tree_bytes_imported": out_bytes,
           "make_state_dicts_s": make_s, "import_s": import_s, "merge_to_card_s": merge_s,
           "leaves_imported": len(imp), "copies_checked": copied,
           "resampled_max_abs_err": resampled}
    log(f"  import at full width, {IMPORT_LAYERS} LLM and ViT layers: {src_bytes / 2**30:.3f} GiB "
        f"of HF state dicts ({len(sd)} + {len(sam_sd)} tensors, made in {make_s:.3f} s) -> "
        f"{len(imp)} leaves in {import_s:.3f} s on the host, merged onto the card "
        f"({out_bytes / 2**30:.3f} GiB) in {merge_s:.3f} s; {copied} copies bit-equal")
    return out


def _run_counted(fn, *a, **kw):
    """``fn`` with every launch counter at 0 before it: (result, seconds,
    launches (non-zero), launches by form, peak GiB)."""
    from mmmm_tpu_torch.ops._cuda import KERNELS

    for kern in KERNELS.values():
        kern.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = fn(*a, **kw)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t
    launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
    forms = {n: dict(k.forms) for n, k in KERNELS.items() if k.forms}
    return res, sec, launches, forms, torch.cuda.max_memory_allocated() / 2**30


def _expect(label: str, launches: dict, forms: dict, want: dict, want_forms: dict) -> None:
    if launches != {k: v for k, v in want.items() if v} or forms != want_forms:
        raise AssertionError(f"{label}: launches {launches} by form {forms}, expected {want} "
                             f"by form {want_forms}")


def peft_round_trip(params, tmp: Path) -> dict:
    """``export_peft_adapter`` then ``import_peft_adapter`` of a seeded LoRA
    tree at conf/lora.yaml's rank over the flagship's full depth (``b``
    non-zero); every factor must come back bit for bit."""
    from mmmm_tpu_torch.peft import LoraConfig, lora_init
    from mmmm_tpu_torch.train.peft_export import export_peft_adapter, import_peft_adapter

    lcfg = LoraConfig(**LORA_YAML)
    gen = torch.Generator(device="cuda").manual_seed(7)
    lora = lora_init(gen, params, lcfg)
    def flat(t, pre=""):  # path -> {"a", "b"}
        out = {}
        for k, v in t.items():
            out.update(flat(v, f"{pre}{k}/") if "a" not in v else {f"{pre}{k}": v})
        return out

    for ab in flat(lora).values():
        ab["b"].normal_(generator=gen).mul_(0.01)
    factor_bytes = sum(t.numel() * t.element_size() for ab in flat(lora).values()
                       for t in ab.values())
    t0 = time.perf_counter()
    export_peft_adapter(tmp / "peft", lora, lcfg)
    export_s = time.perf_counter() - t0
    file_bytes = (tmp / "peft" / "adapter_model.safetensors").stat().st_size
    t0 = time.perf_counter()
    back, bcfg = import_peft_adapter(tmp / "peft", MODEL_YAML["vlm"]["num_hidden_layers"],
                                     MODEL_YAML["vlm"]["vision"]["num_hidden_layers"])
    import_s = time.perf_counter() - t0
    mine, theirs = flat(lora["cogvlm"], "cogvlm/"), flat(back)
    if mine.keys() != theirs.keys() or bcfg != lcfg:
        raise AssertionError(f"PEFT round trip: {sorted(set(mine) ^ set(theirs))}, {bcfg}")
    for path, ab in mine.items():
        for k in ("a", "b"):
            if not torch.equal(ab[k].cpu(), theirs[path][k]):
                raise AssertionError(f"PEFT round trip: {path}/{k} changed")
    out = {"factors": len(mine), "factor_bytes": factor_bytes, "file_bytes": file_bytes,
           "export_s": export_s, "import_s": import_s}
    log(f"  PEFT round trip, r {lcfg.r}, {len(mine)} factor pairs at full depth: "
        f"{file_bytes / 2**30:.3f} GiB of safetensors ({factor_bytes} bytes of factors) "
        f"written in {export_s:.3f} s, read in {import_s:.3f} s, bit-equal")
    return out


def _direct_grounded(loaded, args, tokens_of):
    """``generate_grounded`` on the inputs ``cmd_demo`` makes for ``args``."""
    from mmmm_tpu_torch import generate_grounded
    from mmmm_tpu_torch import cli
    from mmmm_tpu_torch.data import ConvTurn, prepare_vlm_inputs

    model, params, tok, cfg = loaded
    image, gimg, patch, pool, n = cli.prepare_image(args.image, cli._data_conf(cfg))
    inputs, _ = prepare_vlm_inputs([ConvTurn(args.question, "")], tok, n, inference=True,
                                   grounding=args.grounding)
    res = generate_grounded(
        params, model.cfg, tok, np.asarray(inputs.input_ids)[None],
        np.asarray(inputs.token_type_ids)[None], np.asarray(inputs.position_ids)[None],
        np.asarray([len(inputs.input_ids)]), image[None], patch, pool,
        max_new_tokens=args.max_new_tokens, grounding_image=gimg[None], instance=args.instance,
        kv_cache_dtype=args.kv_cache, spec_draft_len=args.speculate, device="cuda")
    if not np.array_equal(res.tokens, tokens_of):
        raise AssertionError(f"demo: tokens differ from generate_grounded's at "
                             f"{first_difference(res.tokens[0], tokens_of[0])}")
    return res


def demo_run(label: str, loaded, argv: list) -> dict:
    """``cmd_demo`` over ``loaded`` (counted, timed, its stdout kept), then
    ``generate_grounded`` on the same inputs: the same tokens. Launches
    exact: K4 63 (the ViT) + 12 (the SAM encoder, where a target was
    grounded), K3 32 (the prefill), K1 32 x 128 in its fused form (greedy)
    or K6 32 x the verify steps (speculative)."""
    from mmmm_tpu_torch import cli
    from mmmm_tpu_torch.ops._cuda import KERNELS

    args = cli.parse_args(argv)
    text = io.StringIO()
    with contextlib.redirect_stdout(text):
        (res,), sec, launches, forms, peak = _run_counted(cli.cmd_demo, args, loaded=loaded)
    grounded = bool(res.target_valid is not None and res.target_valid.any())
    want = dict.fromkeys(KERNELS, 0)
    want.update({"K4": VIT_LAYERS + SAM_LAYERS * grounded, "K3": LAYERS})
    if args.speculate:
        n = LAYERS * res.spec_stats["iters"]
        want["K6"], want_forms = n, {"K6": {"append": n}}
    else:
        want["K1"] = LAYERS * args.max_new_tokens
        want_forms = {"K1": {"append": want["K1"]}}
    _expect(f"demo {label}", launches, forms, want, want_forms)
    _direct_grounded(loaded, args, res.tokens)
    lines = text.getvalue().splitlines()
    r = {"argv": argv[1:], "s": sec, "peak_mem_gib": peak, "launches": launches,
         "launches_by_form": forms, "num_generated": int(res.num_generated[0]),
         "targets": None if res.targets[0] is None else len(res.targets[0]),
         "grounded_lines": [ln for ln in lines if ln.startswith("target ")][:8],
         "spec_stats": res.spec_stats}
    log(f"  demo {label}: {sec:.3f} s (B = 1, {args.max_new_tokens} new tokens), peak "
        f"{peak:.2f} GiB, launches {launches}, targets {r['targets']}, "
        f"{r['grounded_lines'][:2]}; tokens equal to generate_grounded's")
    return r


def predict_runs(loaded, tmp: Path) -> dict:
    """``cmd_predict`` over ``PREDICT_ITEMS`` synthetic ``.pt`` report items
    (conf/phase-vlm's image geometry), batched (``--batch 4``: one
    ``generate_grounded`` a batch) and ``--continuous`` (a
    ``GroundedServer`` of 4 slots), counted and timed; then ``cmd_evaluate
    --suite all`` on each CSV."""
    from mmmm_tpu_torch import cli
    from mmmm_tpu_torch.models import serving
    from mmmm_tpu_torch.ops._cuda import KERNELS

    ds = write_vl_dataset(tmp / "CT-RATE", PREDICT_ITEMS, FIT_VOLUME, report_chars=400, seed=1,
                          vqa=False)
    (ds / "train-processed.json").rename(ds / "test-processed.json")
    servers = []

    class Recorded(serving.GroundedServer):  # keeps each server to read its stats
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            servers.append(self)

    out = {}
    real = serving.GroundedServer
    serving.GroundedServer = Recorded
    try:
        for label, extra in (("batched", []), ("continuous", ["--continuous"])):
            csv_path = tmp / f"pred_{label}.csv"
            argv = ["predict", "-c", "conf/phase-vlm/fit.yaml", "--task", "report",
                    "--dataset-dir", str(ds), "--output", str(csv_path), "--max-new-tokens",
                    str(NEW), "--batch", str(PREDICT_BATCH), *extra]
            with contextlib.redirect_stdout(io.StringIO()):  # its progress lines
                rows, sec, launches, forms, peak = _run_counted(
                    cli.cmd_predict, cli.parse_args(argv), loaded=loaded)
            want = dict.fromkeys(KERNELS, 0)
            if label == "batched":
                calls = -(-PREDICT_ITEMS // PREDICT_BATCH)
                want.update({"K4": VIT_LAYERS * calls, "K3": LAYERS * calls,
                             "K1": LAYERS * NEW * calls})
                stats = {"generate_calls": calls}
            else:
                stats = dict(servers[-1].stats)
                want.update({"K4": VIT_LAYERS * stats["refills"],
                             "K3": LAYERS * stats["refills"],
                             "K1": LAYERS * servers[-1].chunk * stats["chunks"]})
            _expect(f"predict {label}", launches, forms, want, {"K1": {"append": want["K1"]}})
            if len(rows) != PREDICT_ITEMS or any(not isinstance(r["prediction"], str)
                                                 for r in rows):
                raise AssertionError(f"predict {label}: rows {rows}")
            ev = cli.parse_args(["evaluate", "--input", str(csv_path), "--suite", "all",
                                 "--output", str(tmp / f"metrics_{label}.json")])
            with contextlib.redirect_stdout(io.StringIO()):  # its progress lines
                t0 = time.perf_counter()
                metrics = cli.cmd_evaluate(ev)
                ev_s = time.perf_counter() - t0
            for k in ("bleu1", "rougeL", "meteor", "chexpert_micro_f1_14", "radgraph_f1"):
                if not np.isfinite(metrics[k]):
                    raise AssertionError(f"evaluate {label}: {k} = {metrics[k]}")
            out[label] = {"s": sec, "requests_per_s": PREDICT_ITEMS / sec, "peak_mem_gib": peak,
                          "launches": launches, "stats": stats,
                          "smax": servers[-1].smax if label == "continuous" else None,
                          "predictions": [r["prediction"] for r in rows],
                          "evaluate_s": ev_s, "metrics": metrics}
            log(f"  predict {label}: {PREDICT_ITEMS} report items in {sec:.3f} s "
                f"({PREDICT_ITEMS / sec:.4f} requests/s), peak {peak:.2f} GiB, launches "
                f"{launches}, {stats}; evaluate --suite all {ev_s:.3f} s: bleu1 "
                f"{metrics['bleu1']}, radgraph_f1 {metrics['radgraph_f1']} "
                f"({metrics['radgraph_annotator']})")
    finally:
        serving.GroundedServer = real
    # bf16 sums round otherwise in the two paths: the server's cache has more
    # slots (K1 gives each warp ceil(Smax / 8) of them) and it routes the
    # vision span statically; tokens near a tie part (the fp32 CPU tests
    # hold the two paths token for token)
    a, b = out["batched"]["predictions"], out["continuous"]["predictions"]
    out["first_difference"] = first = [first_difference(x.encode(), y.encode())
                                       for x, y in zip(a, b)]
    log(f"  predict batched vs continuous: {first.count(-1)} of {PREDICT_ITEMS} predictions "
        f"equal; first differing byte {first} (the server's cache "
        f"{out['continuous']['smax']} slots)")
    return out


def prompted_sam_check(params, cfg, gen) -> dict:
    """``sam_forward_prompted`` at the flagship SAM on a grounding image of
    run (a)'s shape (``ENTRY_GIMAGE``) with a point, a box and a mask
    prompt together: the card against the CPU within ``masks_tol``, 12 K4
    launches (the encoder) and no other."""
    from mmmm_tpu_torch.models.segvol import sam_forward_prompted
    from mmmm_tpu_torch.ops._cuda import KERNELS

    dev = torch.device("cuda")
    gimg = torch.randn(ENTRY_GIMAGE, generator=gen, device=dev)
    d, h, w = ENTRY_GIMAGE[2:]
    grid = tuple(s // p for s, p in zip((d, h, w), ENTRY_PATCH))
    prompts = {"points": (torch.tensor([[w / 2, h * 3 / 8, d / 2], [w / 6, h * 3 / 4, d / 4]],
                                       device=dev), torch.tensor([1, 0], device=dev)),
               "boxes": torch.tensor([[w / 4, h / 4, d / 8, w * 3 / 4, h * 5 / 8, d * 7 / 8]],
                                     device=dev),
               "mask": (torch.rand((1, *(4 * g for g in grid)), generator=gen, device=dev)
                        > 0.5).float()}
    with torch.inference_mode():
        (full, low), sec, launches, forms, _ = _run_counted(
            sam_forward_prompted, params, cfg.sam, gimg, ENTRY_PATCH, **prompts)
        want = dict.fromkeys(KERNELS, 0)
        want["K4"] = SAM_LAYERS
        _expect("sam_forward_prompted", launches, forms, want, {})
        cpu = lambda x: tuple(cpu(t) for t in x) if isinstance(x, tuple) else x.cpu()
        t0 = time.perf_counter()
        cfull, clow = sam_forward_prompted(_tree_to(params, "cpu"), cfg.sam, gimg.cpu(),
                                           ENTRY_PATCH, **{k: cpu(v) for k, v in prompts.items()})
        cpu_s = time.perf_counter() - t0
    if tuple(full.shape) != (d, h, w) or not torch.isfinite(full).all():
        raise AssertionError(f"sam_forward_prompted: {tuple(full.shape)} or non-finite")
    errs = {}
    for name, got, ref in (("full", full, cfull), ("low", low, clow)):
        errs[name] = err = max_err(got.cpu(), ref)
        check(f"sam_forward_prompted {name} {tuple(ref.shape)} card vs CPU", err, masks_tol(ref))
    out = {"s": sec, "cpu_s": cpu_s, "launches": launches, "max_abs_err": errs,
           "tol": masks_tol(cfull), "logit_range": [cfull.min().item(), cfull.max().item()]}
    log(f"  sam_forward_prompted (point, box, mask): {sec:.3f} s on the card, {cpu_s:.3f} s on "
        f"the CPU, launches {launches}")
    return out


def padded_heads_check(params, cfg, gen, peaks) -> dict:
    """The flagship ViT (63 layers, bf16) with ``pad_attention_heads`` (D 112
    -> 128) against itself unpadded, both against the same tower in fp32:
    the padded tower may be no farther from fp32 than 1.5x the unpadded one.
    Launches: 63 K4 each. Then K4 at D = 128 beside D = 112 at run (a)'s
    ViT shape (4, 1153, 16, D), each with its plain version and SDPA."""
    from mmmm_tpu_torch.models.cogvlm.vit import pad_attention_heads, vit_forward
    from mmmm_tpu_torch.ops import dense_attn as da
    from mmmm_tpu_torch.ops._cuda import KERNELS

    bw, bf16_rate, _, _ = peaks
    vis, vcfg = params["cogvlm"]["vision"], cfg.vlm
    heads = vcfg.vision.num_heads
    image = torch.randn(ENTRY_IMAGE, generator=gen, device="cuda")
    padded = pad_attention_heads(vis, heads)
    run = lambda p, img: vit_forward(p, vcfg, img, ENTRY_PATCH, ENTRY_POOL)
    out = {}
    with torch.inference_mode():
        ref, sec_u, l_u, _, _ = _run_counted(run, vis, image.bfloat16())
        pad, sec_p, l_p, _, _ = _run_counted(run, padded, image.bfloat16())
        for label, l in (("unpadded", l_u), ("padded", l_p)):
            want = dict.fromkeys(KERNELS, 0)
            want["K4"] = VIT_LAYERS
            _expect(f"ViT {label}", l, {}, want, {})
        del padded
        fp32 = lambda t: {k: fp32(v) for k, v in t.items()} if isinstance(t, dict) else t.float()
        f32 = fp32(vis)
        want32 = run(f32, image)
        del f32
    d_u, d_p, d_pu = max_err(ref, want32), max_err(pad, want32), max_err(pad, ref)
    scale = want32.abs().max().item()
    out["launches"] = l_p
    out["vit"] = {"unpadded_s": sec_u, "padded_s": sec_p, "max_abs_unpadded_vs_fp32": d_u,
                  "max_abs_padded_vs_fp32": d_p, "max_abs_padded_vs_unpadded": d_pu,
                  "fp32_max_abs": scale, "ratio_limit": 1.5}
    log(f"  ViT {VIT_LAYERS} layers bf16, padded heads vs not: max |padded - unpadded| {d_pu:.4e}; against "
        f"fp32 {d_p:.4e} padded, {d_u:.4e} unpadded (largest |fp32| {scale:.3e}); "
        f"{sec_p:.3f} s padded, {sec_u:.3f} s unpadded")
    if not d_p <= 1.5 * d_u:
        raise AssertionError(f"padded ViT: {d_p} from fp32, > 1.5 x the unpadded {d_u}")
    rows = []
    rnd = lambda *s: torch.randn(*s, generator=gen, device="cuda").to(torch.bfloat16)
    for d in (112, 128):
        q, k, v = (rnd(B, 1153, 16, d) for _ in range(3))
        scale_ = 112 ** -0.5  # the tower keeps the true head dim's scale
        err = max_err(da.dense_attention(q, k, v, scale_), da.dense_attention_plain(q, k, v, scale_))
        check(f"K4 ViT (4, 1153, 16, {d}) bf16", err, 2e-2)
        qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        bms, by = bound(4 * q.numel() * 2, 4 * B * 16 * 1153 * 1153 * d, bf16_rate, bw)
        row = {"shape": [B, 1153, 16, d], "dtype": "bfloat16", "phase": "entry",
               "padded_heads": d == 128, "max_abs_err": err,
               "ms": time_ms(lambda: da.dense_attention(q, k, v, scale_)),
               "plain_ms": time_ms(lambda: da.dense_attention_plain(q, k, v, scale_), inner=2),
               "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt,
                                                                            scale=scale_)),
               "bound_ms": bms, "bound_by": by}
        log(f"  K4 D={d}: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, library "
            f"{row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
        rows.append(row)
    out["k4_rows"] = rows
    return out


def entry_phase(adapter: Path, peaks) -> tuple[dict, dict]:
    """Phase 8, the entry points at the flagship's full width: the import
    check (``import_check``, 2 layers); then the flagship at full depth
    loaded by ``build.load_model_with_adapter`` from ``PHASE_VLM_FIT`` with
    the ``adapter.npz`` that phase 7's fit wrote (``save_adapter``), its
    LLM and ViT in bf16; the PEFT round trip at full depth; ``demo`` on a ``.pt`` CT
    volume, greedy with 128 new tokens; ``predict`` batched and
    continuous and ``evaluate``; ``pad_attention_heads`` with K4 at D = 128;
    ``sam_forward_prompted``; then the LLM quantized in place to W8A16
    (what ``--quantize`` loads) and ``demo --speculate 7 --quantize``.
    Returns the results and each counted run's launches."""
    import tempfile
    from mmmm_tpu_torch.build import load_model_with_adapter
    from mmmm_tpu_torch.ops.quant import quantize_llm_for_serving

    log("entry points: import, PEFT, demo, predict, evaluate, prompted SAM, padded heads")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_entry_"))
    out, launches = {}, {}
    try:
        gen = torch.Generator(device="cuda").manual_seed(3)
        t0 = time.perf_counter()
        loaded = load_model_with_adapter(PHASE_VLM_FIT, str(adapter), device="cuda",
                                         dtype=torch.bfloat16)
        torch.cuda.synchronize()
        out["load_s"] = time.perf_counter() - t0
        model, params, tok, cfg = loaded
        out["adapter_bytes"] = adapter.stat().st_size
        log(f"  flagship loaded with the fit's adapter ({out['adapter_bytes'] / 2**30:.3f} GiB) "
            f"in {out['load_s']:.3f} s, {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
        out["import"] = import_check(model.cfg)
        gc.collect()
        torch.cuda.empty_cache()
        out["peft"] = peft_round_trip(params, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        vol = tmp / "ct.pt"
        torch.save(torch.from_numpy(np.random.default_rng(2).integers(
            0, 256, size=FIT_VOLUME, dtype=np.uint8)), vol)
        demo = ["demo", "-c", "conf/phase-vlm/fit.yaml", "--adapter", str(adapter), "--image",
                str(vol), "--max-new-tokens", str(NEW)]
        out["demo_greedy"] = demo_run("greedy", loaded, demo)
        launches["entry_demo_greedy"] = out["demo_greedy"]["launches"]
        out["predict"] = predict_runs(loaded, tmp)
        for label in ("batched", "continuous"):
            launches[f"entry_predict_{label}"] = out["predict"][label]["launches"]
        out["padded_heads"] = padded_heads_check(params, model.cfg, gen, peaks)
        launches["entry_vit_padded"] = out["padded_heads"]["launches"]
        out["sam_prompted"] = prompted_sam_check(params["sam"], model.cfg, gen)
        launches["entry_sam_prompted"] = out["sam_prompted"]["launches"]
        t0 = time.perf_counter()
        params["cogvlm"] = quantize_llm_for_serving(params["cogvlm"])
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        out["quantize_s"] = time.perf_counter() - t0
        out["demo_spec7_w8a16"] = demo_run("--speculate 7 --quantize", loaded,
                                           demo + ["--speculate", str(DRAFT), "--quantize"])
        launches["entry_demo_spec7_w8a16"] = out["demo_spec7_w8a16"]["launches"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out, launches


# profiler spans of generate_grounded's stages (record_function names)
# ---- phase 9: the pseudo-box detector, the 3-D UNet and the seg-exp SAM arm --------

LAP_PROBLEMS = {  # label -> (N, K, Q, kind); N = 8 images x 4 heads at the defaults
    "detector (32, 24, 100)": (32, 24, 100, "random"),
    "padded rows flat zero": (32, 24, 100, "padded"),
    "integer costs 0..3 (ties)": (32, 24, 100, "int"),
    "K = Q = 8": (32, 8, 8, "random"),
    "K = 1": (32, 1, 100, "random"),
    "DETR regime (8, 32, 900)": (8, 32, 900, "random"),
}
DET_TINY = dict(num_classes=4, d_model=32, n_heads=4, n_points=2, enc_layers=1, dec_layers=2,
                ffn_dim=64, num_queries=12, backbone_dims=(8, 16, 32, 32), image_size=64,
                max_gt=4)  # tests/test_detector.py's tiny config
DET_STEPS, DET_BATCH, DET_CASES = 20, 8, 32  # scripts/data/detector.py's batch
# conf/seg-exp/{unet,sam}.yaml as dicts (the card has no PyYAML); held to the
# files by tests/test_torch_port_preprocess.py
SEG_EXP_UNET = {"model": "unet", "patch": [64, 192, 192], "batch": 8, "steps": 60000,
                "lr": 3.0e-4, "weight_decay": 5.0e-2, "channels": [32, 64, 128, 256, 320]}
SEG_EXP_SAM = {"model": "sam", "patch": [48, 224, 224], "batch": 8, "steps": 60000,
               "lr": 1.0e-4, "weight_decay": 5.0e-2,
               "sam": {"patch_size": [8, 16, 16], "pos_embed_shape": [6, 14, 14]}}
SEG_STEPS = 3


def _lap_costs(n, k, q, kind, gen):
    if kind == "int":
        return torch.randint(0, 4, (n, k, q), generator=gen, device="cuda").float()
    c = torch.randn(n, k, q, generator=gen, device="cuda")
    if kind == "padded":
        c[:, k // 2:] = 0.0
    return c


def lap_phase(peaks, gen) -> dict:
    """LAP against its plain version on the card (bit-equal ``col4row``,
    twice) and scipy's optimum, at the matcher's shapes and edge cases;
    timed at the detector's (32, 24, 100) beside the plain version on the
    card and scipy on the host (copy included)."""
    from scipy.optimize import linear_sum_assignment

    from mmmm_tpu_torch.ops import hungarian as hg

    bw = peaks[0]
    row = None
    for label, (n, k, q, kind) in LAP_PROBLEMS.items():
        c = _lap_costs(n, k, q, kind, gen)
        got, again = hg.lap_rectangular(c), hg.lap_rectangular(c)
        ref = hg.lap_rectangular_plain(c)
        if not (torch.equal(got, again) and torch.equal(got, ref)):
            raise AssertionError(f"LAP {label}: col4row differs from the plain version's "
                                 "or between runs")
        cn, col = c.double().cpu().numpy(), got.cpu().numpy()
        worst = 0.0
        for i in range(n):
            r, sc = linear_sum_assignment(cn[i])
            best = cn[i][r, sc].sum()
            worst = max(worst, abs(cn[i][np.arange(k), col[i]].sum() - best) / max(1.0, abs(best)))
        check(f"LAP {label}: summed cost against scipy's optimum (relative)", worst, 1e-5)
        if row is None:
            def scipy_host():
                a = c.cpu().numpy()
                return [linear_sum_assignment(a[i])[1] for i in range(n)]

            t = time.perf_counter()
            for _ in range(5):
                scipy_host()
            scipy_ms = (time.perf_counter() - t) / 5 * 1e3
            bms, by = bound(c.numel() * 4 + n * k * 4, 0, 1.0, bw)
            row = {"shape": [n, k, q], "dtype": "float32", "max_abs_err": 0.0,
                   "ms": time_ms(lambda: hg.lap_rectangular(c)),
                   "plain_ms": time_ms(lambda: hg.lap_rectangular_plain(c), reps=3, inner=1),
                   "library_ms": None, "library": "none (no PyTorch call solves an assignment)",
                   "scipy_host_ms": scipy_ms, "bound_ms": bms, "bound_by": by,
                   "dijkstra_steps_at_most": k * (k + 1) // 2,
                   "checked": list(LAP_PROBLEMS)}
            log(f"  LAP {label}: kernel {row['ms']:.4f} ms, plain (card) {row['plain_ms']:.3f} "
                f"ms, scipy (host, copy included) {scipy_ms:.3f} ms, byte bound {bms:.5f} ms; "
                f"at most {row['dijkstra_steps_at_most']} dependent Dijkstra steps a problem")
    return row


def _det_tree_to(tree, device):
    from mmmm_tpu_torch.params import map_tree

    return map_tree(lambda t: t.detach().to(device).clone(), tree)


def _rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    """max |a - b| over b's largest entry."""
    return max_err(a, b) / max(b.float().abs().max().item(), 1e-30)


def _grads_rel_err(card: list, cpu: list) -> float:
    """The largest gradient error, each leaf against its largest entry (at
    least a hundredth of the tree's largest); a leaf whose gradient is zero
    by construction (a bias under a norm, a key bias under the softmax)
    holds rounding noise, and is measured against the tree's largest."""
    top = max(g.abs().max().item() for g in cpu)
    errs = []
    for a, b in zip(card, cpu):
        m = b.abs().max().item()
        errs.append(max_err(a.cpu(), b) / (max(m, 1e-2 * top) if m > 1e-5 * top else top))
    return max(errs)


def _det_batch(rng, b, cfg):
    """Noise images (no near-ties for top_k) and 0..max_gt-1 GT boxes each."""
    images = rng.random((b, cfg.image_size, cfg.image_size, 1)).astype(np.float32)
    gb = np.zeros((b, cfg.max_gt, 4), np.float32)
    gc = np.zeros((b, cfg.max_gt), np.int64)
    gv = np.zeros((b, cfg.max_gt), bool)
    for i in range(b):
        n = int(rng.integers(0, cfg.max_gt))
        gb[i, :n] = np.concatenate([rng.uniform(0.2, 0.8, (n, 2)), rng.uniform(0.05, 0.3, (n, 2))],
                                   -1)
        gc[i, :n] = rng.integers(0, cfg.num_classes, n)
        gv[i, :n] = True
    return images, gb, gc, gv


def _grad_errs(params, cfg, batch, device):
    from mmmm_tpu_torch.models.detector import detector_loss
    from mmmm_tpu_torch.params import _flatten

    flat = _flatten(params)
    for t in flat.values():
        t.requires_grad_(True)
    loss = detector_loss(params, cfg, *(torch.from_numpy(a).to(device) for a in batch))
    return loss.detach(), dict(zip(flat, torch.autograd.grad(loss, list(flat.values()))))


def detector_tiny_check() -> dict:
    """The detector at the tiny config, card against CPU from one set of
    parameters: every forward output, the loss and every gradient within
    1e-4 relative (a gradient that is zero by construction against the
    tree's largest), one LAP launch a loss call, and three optimizer steps
    of ``train_detector``: each step's loss within 1e-4 relative."""
    from mmmm_tpu_torch.models import detector as det
    from mmmm_tpu_torch.ops.hungarian import LAP
    from mmmm_tpu_torch.train.detector import train_detector

    cfg = det.DetectorConfig(**DET_TINY)
    cpu = det.init_detector_params(cfg, seed=0, device="cpu")
    card = _det_tree_to(cpu, "cuda")
    rng = np.random.default_rng(0)
    batch = _det_batch(rng, 2, cfg)
    out_c = det.detector_forward(card, cfg, torch.from_numpy(batch[0]).cuda())
    out_h = det.detector_forward(cpu, cfg, torch.from_numpy(batch[0]))
    errs = {k: _rel_err(out_c[k].cpu(), out_h[k]) for k in ("class_logits", "boxes",
                                                             "enc_logits", "enc_boxes")}
    for k, e in errs.items():
        check(f"detector tiny {k}, card vs CPU (relative)", e, 1e-4)
    LAP.reset()
    loss_c, g_c = _grad_errs(card, cfg, batch, "cuda")
    if LAP.launches != 1:
        raise AssertionError(f"detector_loss launched LAP {LAP.launches} times, not once")
    loss_h, g_h = _grad_errs(cpu, cfg, batch, "cpu")
    check("detector tiny loss, card vs CPU (relative)", abs(loss_c.item() - loss_h.item())
          / abs(loss_h.item()), 1e-4)
    gerr = _grads_rel_err([g_c[k] for k in g_h], list(g_h.values()))
    check("detector tiny gradients, card vs CPU (relative)", gerr, 1e-4)
    cases = [tuple(a[0] for a in _det_batch(rng, 1, cfg)) for _ in range(5)]
    runs = {}
    for dev, params in (("cuda", _det_tree_to(cpu, "cuda")), ("cpu", _det_tree_to(cpu, "cpu"))):
        runs[dev] = train_detector(cfg, cases, steps=3, batch=2, lr=1e-3, seed=0, log_every=100,
                                   eval_frac=0, device=dev, params=params, log=lambda m: None)
    lerr = max(abs(a - b) / abs(b) for a, b in zip(runs["cuda"]["losses"], runs["cpu"]["losses"]))
    check("detector tiny 3 train_detector steps: losses, card vs CPU (relative)", lerr, 1e-4)
    return {"forward_rel_err": errs, "loss": [loss_c.item(), loss_h.item()],
            "grad_rel_err": gerr, "train_losses": {d: r["losses"] for d, r in runs.items()},
            "train_loss_rel_err": lerr,
            "lap_launches_a_loss": 1}


def _synthetic_xray(rng, size: int, n_boxes: int, max_gt: int, num_classes: int):
    """A noise X-ray with bright boxes and its case tuple (cxcywh GT)."""
    img = (rng.random((size, size)) * 0.3).astype(np.float32)
    gb = np.zeros((max_gt, 4), np.float32)
    gc = np.zeros((max_gt,), np.int32)
    gv = np.zeros((max_gt,), bool)
    for i in range(n_boxes):
        x0, y0 = rng.integers(0, size * 3 // 4, 2)
        w, h = rng.integers(size // 16, size // 4, 2)
        img[y0:y0 + h, x0:x0 + w] += 0.5
        gb[i] = [(x0 + w / 2) / size, (y0 + h / 2) / size, w / size, h / size]
        gc[i] = rng.integers(0, num_classes)
        gv[i] = True
    return np.clip(img, 0, 1), (np.clip(img, 0, 1)[..., None], gb, gc, gv)


def ms_deform_rows(peaks, gen, cfg) -> dict:
    """``ms_deform_attn`` forward and forward + backward at the encoder's
    and the decoder's shapes, beside ``F.grid_sample``'s formulation of the
    same function (the yardstick, checked against it within 1e-5)."""
    from mmmm_tpu_torch.ops.deform_attn import ms_deform_attn

    bw, _, fp32_rate, _ = peaks
    b, heads, hd, lv, p = DET_BATCH, cfg.n_heads, cfg.d_model // cfg.n_heads, 3, cfg.n_points
    shapes = cfg.level_shapes()
    t_tokens = sum(h * w for h, w in shapes)

    def grid_sample_form(values, locs, weights):
        out = 0
        q = locs.shape[1]
        for lvl, v in enumerate(values):
            _, h, w, _, _ = v.shape
            inp = v.permute(0, 3, 4, 1, 2).reshape(b * heads, hd, h, w)
            grid = 2 * locs[:, :, :, lvl].permute(0, 2, 1, 3, 4).reshape(b * heads, q, p, 2) - 1
            s = F.grid_sample(inp, grid, mode="bilinear", padding_mode="zeros",
                              align_corners=False)  # (B heads, hd, Q, P)
            wl = weights[:, :, :, lvl].permute(0, 2, 1, 3).reshape(b * heads, 1, q, p)
            out = out + (s * wl).sum(-1)
        return out.reshape(b, heads, hd, q).permute(0, 3, 1, 2).reshape(b, q, heads * hd)

    rows = {}
    for label, q in (("encoder", t_tokens), ("decoder", cfg.num_queries)):
        values = [torch.randn(b, h, w, heads, hd, generator=gen, device="cuda") for h, w in shapes]
        locs = torch.rand(b, q, heads, lv, p, 2, generator=gen, device="cuda") * 1.2 - 0.1
        weights = torch.softmax(torch.randn(b, q, heads, lv * p, generator=gen, device="cuda"),
                                -1).reshape(b, q, heads, lv, p)
        err = max_err(ms_deform_attn(values, locs, weights), grid_sample_form(values, locs, weights))
        check(f"ms_deform_attn {label} against the grid_sample formulation", err, 1e-5)
        leaves = [*values, locs, weights]
        for t in leaves:
            t.requires_grad_(True)
        ct = torch.randn(b, q, heads * hd, generator=gen, device="cuda")

        def fb(fn):
            g = torch.autograd.grad((fn(values, locs, weights) * ct).sum(), leaves)
            return g

        with torch.no_grad():
            fwd = time_ms(lambda: ms_deform_attn(values, locs, weights), reps=5, inner=3)
            lib = time_ms(lambda: grid_sample_form(values, locs, weights), reps=5, inner=3)
        # four taps' lerps and the weighted sum: 10 operations a (point, lane)
        n_pts = b * q * heads * lv * p
        bms, by = bound(sum(v.numel() for v in values) * 4 + locs.numel() * 4
                        + weights.numel() * 4 + b * q * heads * hd * 4,
                        n_pts * hd * 10, fp32_rate, bw)
        rows[label] = {"shape": {"B": b, "Q": q, "heads": heads, "head_dim": hd, "levels": shapes,
                                 "points": p},
                       "forward_ms": fwd, "forward_backward_ms": time_ms(lambda: fb(ms_deform_attn),
                                                                         reps=5, inner=2),
                       "grid_sample_forward_ms": lib,
                       "grid_sample_forward_backward_ms": time_ms(lambda: fb(grid_sample_form),
                                                                  reps=5, inner=2),
                       "forward_bound_ms": bms, "forward_bound_by": by, "max_abs_err": err}
        log(f"  ms_deform_attn {label}: forward {fwd:.3f} ms (grid_sample {lib:.3f} ms, bound "
            f"{bms:.4f} ms {by}), forward+backward {rows[label]['forward_backward_ms']:.3f} ms "
            f"(grid_sample {rows[label]['grid_sample_forward_backward_ms']:.3f} ms)")
    return rows


def detector_full_phase(peaks, gen) -> tuple[dict, dict]:
    """``train_detector`` at ``DetectorConfig()`` and the CLI's defaults
    (image 512, 3 + 3 layers, 100 queries, max_gt 24, batch 8): 20 steps over
    32 in-memory cases, LAP launched once a step and exactly 20 times, step
    times and peak memory; then ``infer_images`` over 32 ``.pt`` images,
    writing their ``_box.json`` (no LAP launch); the deformable attention's
    times at the encoder's and the decoder's shapes."""
    import tempfile

    from mmmm_tpu_torch.models.detector import VINDR_CLASSES
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.train.detector import (detector_config, infer_images,
                                               train_detector)

    cfg = detector_config(512, 3, 100)
    rng = np.random.default_rng(0)
    raws, cases = [], []
    for _ in range(DET_CASES):
        raw, case = _synthetic_xray(rng, cfg.image_size, int(rng.integers(0, cfg.max_gt + 1)),
                                    cfg.max_gt, cfg.num_classes)
        raws.append(raw)
        cases.append(case)
    marks = []

    def on_step(it, loss):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), loss.item(), KERNELS["LAP"].launches))

    for kern in KERNELS.values():
        kern.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = train_detector(cfg, cases, steps=DET_STEPS, batch=DET_BATCH, lr=2e-4, seed=0,
                         log_every=10, eval_frac=0.1, device="cuda", log=log, on_step=on_step)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
    peak = torch.cuda.max_memory_allocated() / 2**30
    if launches != {"LAP": DET_STEPS}:
        raise AssertionError(f"detector training launched {launches}, want LAP {DET_STEPS}")
    if [m[2] for m in marks] != list(range(1, DET_STEPS + 1)):
        raise AssertionError("LAP was not launched once every step")
    if not np.isfinite(res["losses"]).all():
        raise AssertionError(f"detector losses not finite: {res['losses']}")
    step_s = [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    log(f"  detector train: {DET_STEPS} steps at batch {DET_BATCH} in {train_s:.2f} s (mAP "
        f"pass included), steady step {statistics.median(step_s) * 1e3:.1f} ms, first "
        f"{(marks[0][0] - t0) * 1e3:.1f} ms, peak {peak:.2f} GiB, losses "
        f"{res['losses'][0]:.4f} -> {res['losses'][-1]:.4f}, mAP@0.5 {res['map']:.4f}, "
        f"LAP launches {launches['LAP']}")
    params = res["params"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_det_") as tmp:
        root = Path(tmp)
        items = []
        for i, raw in enumerate(raws):
            torch.save(torch.from_numpy(np.round(raw * 255).astype(np.uint8))[None, None],
                       root / f"study{i}.pt")
            items.append({"image": [f"study{i}.pt"],
                          "tags": [{"target": VINDR_CLASSES[i % len(VINDR_CLASSES)]},
                                   {"target": "cardiomegaly"}]})
        infer_images(params, cfg, items[:2], root / "boxes", image_root=root,
                     device="cuda")  # warm-up
        for kern in KERNELS.values():
            kern.reset()
        torch.cuda.synchronize()
        t = time.perf_counter()
        n = infer_images(params, cfg, items, root / "boxes", image_root=root, device="cuda")
        torch.cuda.synchronize()
        infer_s = time.perf_counter() - t
        infer_launches = {k: v.launches for k, v in KERNELS.items() if v.launches}
        written = sorted(p.name for p in (root / "boxes").glob("*_box.json"))
        boxes = [json.loads((root / "boxes" / w).read_text()) for w in written]
    if n != DET_CASES or len(written) != DET_CASES or infer_launches:
        raise AssertionError(f"infer wrote {n} files ({len(written)} found), launches "
                             f"{infer_launches}")
    for b in boxes:
        for name, bx in b.items():
            if name not in VINDR_CLASSES or not all(len(x) == 4 and 0 <= x[0] <= x[2] <= 512
                                                    and 0 <= x[1] <= x[3] <= 512 for x in bx):
                raise AssertionError(f"bad _box.json entry {name}: {bx}")
    log(f"  detector infer: {n} images in {infer_s:.3f} s ({n / infer_s:.1f} images/s), "
        f"LAP launches 0")
    import dataclasses

    out = {"config": dataclasses.asdict(cfg), "steps": DET_STEPS, "batch": DET_BATCH,
           "train_s": train_s, "steady_step_ms": statistics.median(step_s) * 1e3,
           "first_step_ms": (marks[0][0] - t0) * 1e3, "step_ms": [s * 1e3 for s in step_s],
           "peak_gib": peak, "losses": res["losses"], "map": res["map"],
           "launches": launches, "infer_images": n, "infer_s": infer_s,
           "images_per_s": n / infer_s, "infer_launches": infer_launches,
           "ms_deform_attn": ms_deform_rows(peaks, gen, cfg)}
    return out, launches


def _seg_cases(rng, n, shape, classes=2):
    """Noise volumes with a bright box a class, and their masks."""
    cases = []
    for _ in range(n):
        img = (rng.random((1, *shape), dtype=np.float32) * 0.3)
        m = np.zeros((classes, *shape), bool)
        for k in range(classes):
            lo = [int(rng.integers(0, s // 2)) for s in shape]
            sl = tuple(slice(a, a + s // 3) for a, s in zip(lo, shape))
            m[(k, *sl)] = True
            img[(0, *sl)] += 0.4 + 0.2 * k
        cases.append((img, m))
    return cases


def _seg_run(cfg, cases, label, kernel=None):
    """``run_seg_exp`` with its steps timed and, with ``kernel``, that
    kernel's launches a step read from its counter."""
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.train.seg_exp import run_seg_exp

    marks = []

    def on_step(it, loss):
        torch.cuda.synchronize()
        marks.append((time.perf_counter(), loss.item(),
                      KERNELS[kernel].launches if kernel else 0))

    for kern in KERNELS.values():
        kern.reset()
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = run_seg_exp(cfg, cases, device="cuda", log=log, on_step=on_step)
    torch.cuda.synchronize()
    total = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
    times = [marks[0][0] - t0] + [b[0] - a[0] for a, b in zip(marks, marks[1:])]
    per_step = [marks[0][2]] + [b[2] - a[2] for a, b in zip(marks, marks[1:])]
    losses = [m[1] for m in marks]
    if not np.isfinite(losses).all():
        raise AssertionError(f"{label}: losses not finite {losses}")
    log(f"  {label}: {len(marks)} steps at batch {cfg['batch']}, patch {cfg['patch']}: step "
        f"{[round(t * 1e3, 1) for t in times]} ms, peak {peak:.2f} GiB, losses "
        f"{[round(x, 4) for x in losses]}, Dice {res['dice']}, launches {launches}")
    return {"results": res, "step_ms": [t * 1e3 for t in times], "peak_gib": peak,
            "losses": losses, "launches": launches, "launches_per_step": per_step,
            "total_s": total}


def unet_phase() -> dict:
    """The UNet card against CPU in fp32 at a small odd size (forward and
    gradients within 1e-4 relative), then ``run_seg_exp`` at
    conf/seg-exp/unet.yaml's width: patch (64, 192, 192), channels (32, 64,
    128, 256, 320), batch 8 (the largest of 8, 6, 4, 2 that fits 80 GB),
    3 steps."""
    from mmmm_tpu_torch.models.unet import init_unet_params, unet_forward
    from mmmm_tpu_torch.params import _flatten

    cpu = init_unet_params(1, 3, (4, 8, 16), seed=0, device="cpu")
    card = _det_tree_to(cpu, "cuda")
    x = torch.from_numpy(np.random.default_rng(0).normal(size=(1, 1, 5, 12, 10))
                         .astype(np.float32))
    grads = {}
    for dev, params in (("cuda", card), ("cpu", cpu)):
        flat = _flatten(params)
        for t in flat.values():
            t.requires_grad_(True)
        out = unet_forward(params, x.to(dev))
        g = torch.autograd.grad((out * out).sum(), list(flat.values()))
        grads[dev] = (out.detach().cpu(), [t.cpu() for t in g])
    ferr = _rel_err(grads["cuda"][0], grads["cpu"][0])
    check("UNet (1, 1, 5, 12, 10) forward, card vs CPU (relative)", ferr, 1e-4)
    gerr = _grads_rel_err(grads["cuda"][1], grads["cpu"][1])
    check("UNet (1, 1, 5, 12, 10) gradients, card vs CPU (relative)", gerr, 1e-4)
    cfg = dict(SEG_EXP_UNET, classes=["liver", "spleen"], steps=SEG_STEPS, val_frac=0.2, seed=0,
               log_every=1)
    cases = _seg_cases(np.random.default_rng(1), 3, (72, 208, 208))
    out = {"small_forward_rel_err": ferr, "small_grad_rel_err": gerr, "cut": None}
    too_big = []
    for batch in (8, 6, 4, 2):
        try:
            out["full"] = _seg_run(dict(cfg, batch=batch), cases, "seg-exp unet")
            break
        except torch.cuda.OutOfMemoryError as e:
            log(f"  seg-exp unet: batch {batch} passes the card's memory ({str(e)[:80]}...)")
            too_big.append(batch)
            gc.collect()
            torch.cuda.empty_cache()
    else:
        raise AssertionError("seg-exp unet: no batch of 8/6/4/2 fits the card's memory")
    if too_big:
        out["cut"] = f"batches {too_big} ran out of memory; ran batch {batch}"
    out["batch"] = batch
    return out


def sam_arm_phase(peaks, gen) -> tuple[dict, dict]:
    """The seg-exp SAM arm at conf/seg-exp/sam.yaml's width (patch (48, 224,
    224), SAM patch (8, 16, 16), pos-embed (6, 14, 14), embed 256, 6 layers,
    8 heads, batch 8), 3 steps with K4 launched 6 times a step (the
    encoder's layers; the backward recomputes through the plain version),
    and K4 at its (8, 1176, 8, 32) fp32 shape against its plain version,
    timed beside SDPA."""
    from mmmm_tpu_torch.ops import dense_attn as da

    bw, _, fp32_rate, _ = peaks
    cfg = dict(SEG_EXP_SAM, classes=["liver", "spleen"], steps=SEG_STEPS, val_frac=0.2, seed=0,
               log_every=1)
    cases = _seg_cases(np.random.default_rng(2), 3, (56, 240, 240))
    run = _seg_run(cfg, cases, "seg-exp sam", kernel="K4")
    layers = 6
    if run["launches_per_step"] != [layers] * SEG_STEPS:
        raise AssertionError(f"seg-exp sam: K4 launches a step {run['launches_per_step']}, "
                             f"want {layers}")
    # the validation pass: one forward a held-out case
    if run["launches"].get("K4") != layers * SEG_STEPS + layers:
        raise AssertionError(f"seg-exp sam: K4 launched {run['launches']}")
    b, s, h, d = 8, 6 * 14 * 14, 8, 32
    q, k, v = (torch.randn(b, s, h, d, generator=gen, device="cuda") for _ in range(3))
    scale = d ** -0.5
    err = max_err(da.dense_attention(q, k, v, scale), da.dense_attention_plain(q, k, v, scale))
    check(f"K4 seg-exp SAM arm {(b, s, h, d)} fp32", err, 1e-4)
    qt, kt, vt = (t.transpose(1, 2).contiguous() for t in (q, k, v))
    bms, by = bound(4 * q.numel() * 4, 4 * b * h * s * s * d, fp32_rate, bw)
    row = {"shape": [b, s, h, d], "dtype": "float32", "site": "seg-exp SAM arm encoder",
           "max_abs_err": err, "ms": time_ms(lambda: da.dense_attention(q, k, v, scale)),
           "plain_ms": time_ms(lambda: da.dense_attention_plain(q, k, v, scale), inner=2),
           "library_ms": time_ms(lambda: F.scaled_dot_product_attention(qt, kt, vt, scale=scale)),
           "bound_ms": bms, "bound_by": by, "launches": layers,
           "launches_in_run": "one seg-exp SAM arm step (phase 9)"}
    log(f"  K4 SAM arm: kernel {row['ms']:.4f} ms, plain {row['plain_ms']:.4f} ms, SDPA "
        f"{row['library_ms']:.4f} ms, bound {bms:.4f} ms ({by})")
    return run, row


def pseudo_box_seg_phase(peaks) -> tuple[dict, dict, dict, dict]:
    """Phase 9: LAP, the detector (tiny card vs CPU, then full width), the
    UNet and the seg-exp SAM arm. Returns (results, the detector run's
    launches, LAP's kernel row, K4's SAM-arm row)."""
    gen = torch.Generator(device="cuda").manual_seed(9)
    log("LAP: rectangular assignment")
    lap_row = lap_phase(peaks, gen)
    log("detector: tiny config, card vs CPU")
    out = {"detector_tiny": detector_tiny_check()}
    log("detector: DetectorConfig() at the CLI's defaults")
    out["detector"], launches = detector_full_phase(peaks, gen)
    lap_row["launches"] = launches["LAP"]
    gc.collect()
    torch.cuda.empty_cache()
    log("UNet: small card vs CPU, then seg-exp at conf/seg-exp/unet.yaml's width")
    out["unet"] = unet_phase()
    gc.collect()
    torch.cuda.empty_cache()
    log("seg-exp SAM arm at conf/seg-exp/sam.yaml's width")
    out["sam_arm"], k4_row = sam_arm_phase(peaks, gen)
    return out, launches, lap_row, k4_row


# ---- data preparation: the native library, clean/tag-reports, self-label ----

DP_REPORTS, DP_NEW, DP_TEXT_CHUNK = 8, 64, 16  # the LLM routes' reports, new tokens, chunk
DP_LAYERS = 2  # LLM layers of the fp32 cut and of the tag-reports CLI's --params file
DP_TAX = ("lung nodule", "left lung", "right lung", "cardiomegaly", "pleural effusion",
          "atelectasis", "pneumothorax", "pulmonary edema", "pulmonary consolidation",
          "emphysema", "aorta", "heart")
DP_WORDS = ("there", "is", "a", "small", "nodule", "in", "the", "left", "lung", "right",
            "pleural", "effusion", "mild", "cardiomegaly", "no", "pneumothorax", "stable",
            "compared", "to", "prior", "portable", "view", "atelectasis", "edema", "heart")
DP_CT_SHAPE = (1, 48, 320, 320)  # self-label's CT volumes (C, D, H, W)
DP_CASES, DP_CLASSES = 4, ("liver", "spleen", "left kidney", "right kidney", "aorta")
SL_GRID, SL_PATCH = (4, 16, 16), (8, 16, 16)  # self-label's default --grid and --patch-size
GAUGE_VOLUME, GAUGE_RESIZE, GAUGE_N = (1, 48, 420, 420), (32, 384, 384), 16  # bench.py:305-347


def _dp_tokenizer():
    """The flagship's ids (specials at 32000-32007) with a decode that is one
    character a token (U+4E00 + id; specials as their strings), so that two
    routes' texts are equal only where their tokens are: the byte decoder
    drops the ids past 258, nearly all of a random model's."""
    from mmmm_tpu_torch.data.tokenizer import SPECIAL_TOKENS, MMMMTokenizer, _ByteBackend

    class IdBackend(_ByteBackend):
        def decode(self, ids):
            return "".join(chr(0x4E00 + i) for i in ids)

    return MMMMTokenizer(IdBackend(), {t: 32000 + i for i, t in enumerate(SPECIAL_TOKENS)})


def write_reports(root: Path, n: int, seed: int) -> None:
    """``n`` MIMIC-style studies (findings and impression) as a processed
    vision-language dataset's ``train.json``."""
    rng = np.random.default_rng(seed)
    words = np.array(DP_WORDS)
    items = []
    for i in range(n):
        findings = " ".join(rng.choice(words, rng.integers(14, 22))).capitalize() + "."
        impression = " ".join(rng.choice(words, rng.integers(4, 8))).capitalize() + "."
        items.append({"key": f"s{i}", "image": [f"s{i}.jpg"], "plane": ["PA"],
                      "findings": findings, "impression": impression})
    root.mkdir(parents=True, exist_ok=True)
    (root / "train.json").write_text(json.dumps(items))


def _text_launches(kind: str, stats: dict, n_prompts: int, batch: int, layers: int):
    """The exact launches of one generator call: static, a K3 prefill and
    ``DP_NEW`` K1 steps a batch; continuous, the shared prefix's K3 prefill
    (or one a refill without one; a refill's suffix window of 128 tokens or
    more is the plain route) and ``DP_TEXT_CHUNK`` K1 steps (K6 verify
    steps under speculation) a chunk, every read fused with its append."""
    if kind == "static":
        n = -(-n_prompts // batch)
        return {"K3": layers * n, "K1": layers * DP_NEW * n}, {"K1": {"append": layers * DP_NEW * n}}
    read = "K6" if kind == "spec" else "K1"
    k3 = layers * (1 if stats["prefix_len"] else stats["refills"])
    n = layers * DP_TEXT_CHUNK * stats["chunks"]
    return {"K3": k3, read: n}, {read: {"append": n}}


def counted_generator(gen, kind: str, layers: int, record: list, tok):
    """``gen`` with every call counted from 0, its launches held to
    :func:`_text_launches`; each call's prompts, texts, seconds, stats,
    launches and the first-token logits its route computed (static: from
    ``prefill_decode_state``'s last hidden rows; continuous: returned by
    ``TextServer._prefix_refill``), one row a prompt in the prompts' order
    (None where a prompt's row was not seen), go to ``record``."""
    from unittest import mock

    from mmmm_tpu_torch.models import generate
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.ops.quant import qdot

    server = getattr(gen, "__self__", None)  # the continuous routes' TextServer
    seen: list = []  # (rows of token ids, their first-token logits), kept on the card

    if server is None:
        prefill = generate.prefill_decode_state

        def recorded(params, cfg, input_ids, token_type_ids, position_ids, prompt_len, **kw):
            st, hidden, last = prefill(params, cfg, input_ids, token_type_ids, position_ids,
                                       prompt_len, **kw)
            seen.append((lambda: [input_ids[r, :n].tolist()
                                  for r, n in enumerate(prompt_len.tolist())],
                         qdot(last, params["llm"]["lm_head"]).float()))
            return st, hidden, last

        patch = lambda: mock.patch.object(generate, "prefill_decode_state", recorded)
    else:
        refill = server._prefix_refill

        def recorded(prefix_caches, ids, suffix_len, p):
            st, logits = refill(prefix_caches, ids, suffix_len, p)
            seen.append((lambda: [(p, ids[r, :n].tolist()) for r, n in enumerate(suffix_len)],
                         logits))
            return st, logits

        server._prefix_refill = recorded
        patch = contextlib.nullcontext

    def first_logits(prompts):
        ids = [[tok.bos_token_id] + tok.encode(x) for x in prompts]
        index = {tuple(x): i for i, x in enumerate(ids)}
        rows = [None] * len(prompts)
        for row_ids, logits in seen:
            for r, x in enumerate(row_ids()):
                if server is not None:  # (prefix length, suffix)
                    x = ids[0][:x[0]] + x[1]
                if tuple(x) in index:
                    rows[index[tuple(x)]] = logits[r].cpu()
        return rows

    def fn(prompts):
        for kern in KERNELS.values():
            kern.reset()
        if server is not None:
            server.stats = dict.fromkeys(server.stats, 0)
        seen.clear()
        torch.cuda.synchronize()
        t = time.perf_counter()
        with patch():
            texts = gen(prompts)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t
        stats = dict(server.stats) if server is not None else {}
        launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
        forms = {n: dict(k.forms) for n, k in KERNELS.items() if k.forms}
        want, want_forms = _text_launches(kind, stats, len(prompts), DP_REPORTS, layers)
        if launches != want or forms != want_forms:
            raise AssertionError(f"{kind} generator call {len(record)}: launches {launches} by "
                                 f"form {forms}, expected {want} by form {want_forms}")
        record.append({"prompts": list(prompts), "texts": list(texts), "s": dt, "stats": stats,
                       "launches": launches, "first_logits": first_logits(prompts)})
        return texts

    return fn


def run_clean_tag(llm, vcfg, tok, root: Path, kind: str, layers: int, tax: dict,
                  tag_raw: bool = False) -> dict:
    """``clean_dataset`` (MIMIC-CXR's two passes) over ``write_reports``'s
    studies, then ``tag_dataset`` over its output (and, with ``tag_raw``,
    over the raw reports too: a random model's cleaned reports hold no
    taxonomy term, the raw ones do), through one route of
    ``make_text_generator``: the written files, each call's record, the
    studies whose tags fell back to the taxonomy matcher, and every tag's
    offsets checked against its report."""
    from mmmm_tpu_torch.models.llm_batch import make_text_generator
    from mmmm_tpu_torch.preprocess.clean_reports import clean_dataset
    from mmmm_tpu_torch.preprocess.tag_reports import tag_dataset
    from mmmm_tpu_torch.preprocess.tagging import parse_linked_report

    write_reports(root, DP_REPORTS, seed=17)
    record: list = []
    gen = counted_generator(make_text_generator(
        llm, vcfg, tok, max_new_tokens=DP_NEW, batch_size=DP_REPORTS,
        continuous=kind != "static", speculate=DRAFT if kind == "spec" else 0, device="cuda"),
        kind, layers, record, tok)
    t = time.perf_counter()
    clean_dataset(root, "MIMIC-CXR", "train", gen, cleaner_name="llm")
    splits = ("train-processed", "train") if tag_raw else ("train-processed",)
    for split in splits:
        tag_dataset(root, split, root / "vg", gen, target_tax=tax)
    wall = time.perf_counter() - t
    n_tags, fell_back = 0, 0
    for i, split in enumerate(splits):
        items = json.loads((root / "vg" / f"{split}.json").read_text())
        for item in items:
            for tag in item["tags"]:
                phrase = item["ref_report"][tag["start"]:tag["end"]]
                if not 0 <= tag["start"] < tag["end"] <= len(item["ref_report"]) or \
                        not phrase.strip():
                    raise AssertionError(f"{kind}: tag {tag} outside its report")
                n_tags += 1
        # the filter pass's outputs (calls 3, 5): a study falls back where
        # its output fails the round trip
        fell_back += sum(parse_linked_report(item["ref_report"], o.strip()) is None
                         for item, o in zip(items, record[3 + 2 * i]["texts"]))
    files = {p.relative_to(root).as_posix(): p.read_bytes()
             for p in sorted(root.rglob("*")) if p.is_file()}
    launches: dict = {}
    for call in record:
        for k, v in call["launches"].items():
            launches[k] = launches.get(k, 0) + v
    return {"files": files, "record": record, "fell_back": fell_back, "n_tags": n_tags,
            "wall_s": wall, "launches": launches,
            "call_s": [c["s"] for c in record], "stats": [c["stats"] for c in record]}


def _first_char_difference(a: str, b: str) -> int:
    """The first index where two texts differ (-1: equal)."""
    for i, (x, y) in enumerate(zip(a, b)):
        if x != y:
            return i
    return -1 if len(a) == len(b) else min(len(a), len(b))


def _routes_compared(runs: dict) -> dict:
    """Each route against the static one: the first differing character of
    every text of every call (-1: equal; one character a token), whether
    the calls' prompts and the written files are equal."""
    out = {}
    for kind in ("continuous", "spec"):
        firsts = [[_first_char_difference(a, b) for a, b in zip(ca["texts"], cb["texts"])]
                  for ca, cb in zip(runs["static"]["record"], runs[kind]["record"])]
        prompts_equal = all(ca["prompts"] == cb["prompts"] for ca, cb in
                            zip(runs["static"]["record"], runs[kind]["record"]))
        out[kind] = {"first_difference": firsts, "prompts_equal": prompts_equal,
                     "files_equal": runs[kind]["files"] == runs["static"]["files"]}
    return out


def _dp_summary(label: str, runs: dict) -> dict:
    out = {kind: {k: r[k] for k in ("wall_s", "call_s", "launches", "fell_back", "n_tags",
                                    "stats")} for kind, r in runs.items()}
    out["compared"] = _routes_compared(runs)
    for kind, r in runs.items():
        log(f"  {label} {kind}: {r['wall_s']:.2f} s (calls {[round(x, 3) for x in r['call_s']]}"
            f" s), launches {r['launches']}, {r['n_tags']} tags, {r['fell_back']} studies fell "
            f"back to the taxonomy matcher")
    for kind, c in out["compared"].items():
        equal = sum(f == -1 for call in c["first_difference"] for f in call)
        total = sum(len(call) for call in c["first_difference"])
        log(f"  {label} {kind} vs static: {equal} of {total} texts equal, files equal "
            f"{c['files_equal']}, prompts equal {c['prompts_equal']}, first differences "
            f"{c['first_difference']}")
    return out


class _Fp32Layer:
    """A stacked (L, ...) weight whose layer ``i`` (``params.layer`` indexes
    each leaf) is read as an fp32 copy: an fp32 pass over the flagship then
    holds one layer in fp32 at a time beside the bf16 model."""

    def __init__(self, t: torch.Tensor):
        self.t = t

    def __getitem__(self, i):
        return self.t[i].float()


def fp32_first_logits(llm: dict, vcfg, tok, prompts: list) -> torch.Tensor:
    """The first-token logits of the static route's prefill
    (``prefill_decode_state`` over the right-padded prompts) with every
    weight in fp32, on the CPU: the reference the bf16 routes are held to."""
    from mmmm_tpu_torch.models.generate import prefill_decode_state
    from mmmm_tpu_torch.ops.quant import qdot
    from mmmm_tpu_torch.params import map_tree

    ref = {"llm": {k: map_tree(_Fp32Layer, v) if k == "layers" else v.float()
                   for k, v in llm["llm"].items()}}
    dev = llm["llm"]["embed_tokens"].device
    ids_list = [[tok.bos_token_id] + tok.encode(x) for x in prompts]
    n, s = len(ids_list), -(-max(map(len, ids_list)) // 128) * 128
    ids = torch.zeros((n, s), dtype=torch.int32)
    for i, x in enumerate(ids_list):
        ids[i, :len(x)] = torch.tensor(x, dtype=torch.int32)
    ids = ids.to(dev)
    lens = torch.tensor([len(x) for x in ids_list], dtype=torch.int32, device=dev)
    pos = torch.arange(s, dtype=torch.int32, device=dev).expand(n, s)
    with torch.inference_mode():
        _, _, last = prefill_decode_state(ref, vcfg, ids, torch.zeros_like(ids), pos, lens,
                                          smax=s, eos_token_id=tok.eos_token_id)
        return qdot(last, ref["llm"]["lm_head"]).float().cpu()


# the most a bf16 route's first-token logit may lie from the fp32 static
# prefill's at the flagship's random layers, and the most its distance
# may be as a share of the fp32 row's spread (the RMS of the difference over
# the RMS of the centred fp32 row); the H100's readings were 15.2 and 0.085
# at 32 layers (PERF.md §6). A route that lost its positions or its prefix would sit
# near 1.4, as two unrelated rows do. DP_ARGMAX_SIGMAS: a route's argmax
# must be fp32's where fp32's top-2 gap exceeds that many times the static
# bf16 route's RMS distance on the row
DP_LOGIT_BOUND, DP_LOGIT_REL_BOUND, DP_ARGMAX_SIGMAS = 24.0, 0.2, 4.0


def first_token_gate(runs: dict, ref: torch.Tensor, layers: int = FLAGSHIP_LAYERS) -> dict:
    """Each bf16 route's first-token logits in its first call (MIMIC's
    first cleaning pass over the studies), as the route computed them, held
    to the fp32 static prefill's ``ref``: every row within
    ``DP_LOGIT_BOUND`` and ``DP_LOGIT_REL_BOUND``; every route's argmax
    equal to fp32's wherever fp32's top-2 gap exceeds ``DP_ARGMAX_SIGMAS``
    times bf16's spread on that row (the first route's RMS distance, the
    static bf16 one's, measured here). Logs the readings before it checks
    them."""
    top2 = ref.topk(2, dim=-1).values
    gap = top2[:, 0] - top2[:, 1]
    centred = (ref - ref.mean(-1, keepdim=True)).norm(dim=-1)
    logits = {}
    for kind in runs:
        rows = runs[kind]["record"][0]["first_logits"]
        if any(r is None for r in rows):
            raise AssertionError(f"{kind}: the route's first-token logits of "
                                 f"{sum(r is None for r in rows)} prompts were not seen")
        logits[kind] = torch.stack(rows)
    out = {"fp32_top2_gap": gap.tolist(), "fp32_argmax": ref.argmax(-1).tolist(),
           "fp32_logit_std": ref.std().item()}
    for kind, l in logits.items():
        out[kind] = {"max_abs_vs_fp32": (l - ref).abs().amax(-1).tolist(),
                     "rel_vs_fp32": ((l - ref).norm(dim=-1) / centred).tolist(),
                     "argmax": l.argmax(-1).tolist()}
    if {"static", "continuous"} <= set(logits):
        out["static_vs_prefix_max_abs"] = (logits["continuous"] - logits["static"]).abs().amax(
            -1).tolist()
    spread = (logits[next(iter(logits))] - ref).pow(2).mean(-1).sqrt()
    out["bf16_rms_spread"] = spread.tolist()
    out["argmax_checked_rows"] = (gap > DP_ARGMAX_SIGMAS * spread).nonzero().flatten().tolist()
    log(f"  first-token logits vs the fp32 static prefill ({layers} layers): {json.dumps(out)}")
    for kind in logits:
        r = out[kind]
        if max(r["max_abs_vs_fp32"]) > DP_LOGIT_BOUND or \
                max(r["rel_vs_fp32"]) > DP_LOGIT_REL_BOUND:
            raise AssertionError(f"{kind}: first-token logits {r['max_abs_vs_fp32']} (relative "
                                 f"{r['rel_vs_fp32']}) from fp32's, bounds {DP_LOGIT_BOUND} "
                                 f"({DP_LOGIT_REL_BOUND})")
        wrong = [i for i in out["argmax_checked_rows"] if r["argmax"][i] != out["fp32_argmax"][i]]
        if wrong:
            raise AssertionError(f"{kind}: argmax differs from fp32's in rows {wrong}, where "
                                 f"fp32's top-2 gap exceeds {DP_ARGMAX_SIGMAS} x bf16's spread")
    return out


def data_prep_llm_phase(params, cfg) -> dict:
    """clean-reports then tag-reports at the flagship's full width
    (FLAGSHIP_LAYERS) over phase 5's bf16 weights (before they are quantized): 8
    MIMIC-style studies, 64 new tokens, static, ``--continuous`` and
    ``--continuous --speculate 7``, each call's launches exact; the routes'
    texts and files compared (recorded: bf16 rounding differs between the
    routes' kernels and batch shapes, PERF.md §6), and their first call's
    first-token logits held to an fp32 static prefill at the same depth
    (:func:`first_token_gate`). Then the same three routes over the first 2
    LLM layers cast to fp32, where the texts and files must be equal; and
    the ``clean-reports`` (static) and ``tag-reports`` (``--continuous``)
    commands end to end (``--params`` written from those fp32 layers,
    ``--config``) against ``clean_dataset`` and ``tag_dataset`` over the
    same generators."""
    import tempfile

    from mmmm_tpu_torch import cli
    from mmmm_tpu_torch.data.target_tax import get_target_tax
    from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
    from mmmm_tpu_torch.models.cogvlm import CogVLMConfig
    from mmmm_tpu_torch.models.llm_batch import make_text_generator
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.params import map_tree
    from mmmm_tpu_torch.preprocess.clean_reports import clean_dataset
    from mmmm_tpu_torch.preprocess.tag_reports import tag_dataset
    from mmmm_tpu_torch.train.checkpoint import save_adapter

    log("data preparation: clean-reports and tag-reports at the flagship")
    t0 = time.perf_counter()
    tok = _dp_tokenizer()
    tax = {k: v for k, v in get_target_tax().items() if v.name in DP_TAX}
    out: dict = {"new_tokens": DP_NEW, "reports": DP_REPORTS, "taxonomy": sorted(DP_TAX)}
    with tempfile.TemporaryDirectory() as td:
        td = Path(td)
        runs = {kind: run_clean_tag(params["cogvlm"], cfg.vlm, tok, td / "bf16" / kind, kind,
                                    cfg.vlm.num_hidden_layers, tax)
                for kind in ("static", "continuous", "spec")}
        out["flagship_bf16"] = _dp_summary("flagship bf16", runs)
        t = time.perf_counter()
        ref = fp32_first_logits(params["cogvlm"], cfg.vlm, tok,
                                runs["static"]["record"][0]["prompts"])
        out["first_token"] = first_token_gate(runs, ref)
        out["first_token"]["fp32_prefill_s"] = time.perf_counter() - t
        del runs, ref
        torch.cuda.empty_cache()
        # the first DP_LAYERS layers in fp32: a copy of 4.3 GB beside the model
        llm = params["cogvlm"]["llm"]
        llm32 = {"llm": {k: (map_tree(lambda t: t[:DP_LAYERS].float(), v) if k == "layers"
                             else v.float()) for k, v in llm.items()}}
        vcfg32 = dataclasses.replace(cfg.vlm, num_hidden_layers=DP_LAYERS)
        runs = {kind: run_clean_tag(llm32, vcfg32, tok, td / "fp32" / kind, kind, DP_LAYERS, tax,
                                    tag_raw=True) for kind in ("static", "continuous", "spec")}
        out["cut_fp32"] = _dp_summary("cut_fp32", runs)
        for kind in ("continuous", "spec"):
            cmp = out["cut_fp32"]["compared"][kind]
            if not (cmp["files_equal"] and cmp["prompts_equal"]
                    and all(f == -1 for call in cmp["first_difference"] for f in call)):
                raise AssertionError(f"fp32 cut: {kind} differs from static: {cmp}")

        # the clean-reports and tag-reports commands over a --params file of
        # the fp32 layers
        t = time.perf_counter()
        save_adapter(td / "lm.npz", llm32)
        default = CogVLMConfig()  # the LLM's fields that differ from the defaults
        conf = {f.name: getattr(vcfg32, f.name) for f in dataclasses.fields(vcfg32)
                if f.name != "vision" and getattr(vcfg32, f.name) != getattr(default, f.name)}
        (td / "lm.json").write_text(json.dumps(conf))
        write_s = time.perf_counter() - t
        lm = ["--params", str(td / "lm.npz"), "--config", str(td / "lm.json"),
              "--max-new-tokens", str(DP_NEW)]
        byte_tok = MMMMTokenizer.byte_fallback()
        commands = {
            "clean_reports": (
                ["clean-reports", "--dir", str(td / "cli_clean"), "--dataset", "MIMIC-CXR", *lm],
                lambda gen: clean_dataset(td / "ref_clean", "MIMIC-CXR", "train", gen,
                                          cleaner_name="llm"),
                False, ("cli_clean", "ref_clean")),
            "tag_reports": (
                ["tag-reports", "--dir", str(td / "fp32" / "static"), "--split",
                 "train-processed", "--out", str(td / "cli"), *lm, "--continuous"],
                lambda gen: tag_dataset(td / "fp32" / "static", "train-processed", td / "ref",
                                        gen),
                True, ("cli", "ref"))}
        write_reports(td / "cli_clean", DP_REPORTS, seed=17)
        write_reports(td / "ref_clean", DP_REPORTS, seed=17)
        out["cli"] = {"params_bytes": (td / "lm.npz").stat().st_size, "write_s": write_s}
        for label, (argv, direct, continuous, (got_dir, want_dir)) in commands.items():
            for kern in KERNELS.values():
                kern.reset()
            t = time.perf_counter()
            cli.main(argv)
            torch.cuda.synchronize()
            cli_s = time.perf_counter() - t
            cli_launches = {n: k.launches for n, k in KERNELS.items() if k.launches}
            direct(make_text_generator(llm32, vcfg32, byte_tok, max_new_tokens=DP_NEW,
                                       continuous=continuous, device="cuda"))
            got, want = [(td / d / "train-processed.json").read_bytes()
                         for d in (got_dir, want_dir)]
            if got != want:
                raise AssertionError(f"{label} --params: its JSON differs from the library "
                                     "call's over the same generator")
            if cli_launches.get("K3", 0) < DP_LAYERS or cli_launches.get("K1", 0) < DP_LAYERS:
                raise AssertionError(f"{label} --params launched {cli_launches}")
            out["cli"][label] = {"command_s": cli_s, "launches": cli_launches,
                                 "studies": len(json.loads(got))}
            log(f"  {label} --params ({out['cli']['params_bytes'] / 2**30:.2f} GiB written in "
                f"{write_s:.1f} s){' --continuous' if continuous else ''}: {cli_s:.1f} s, "
                f"launches {cli_launches}, JSON equal to the library call's")
        del llm32
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t0
    return out


def _gauge_volumes(root: Path, n: int = 4) -> list:
    """bench.py's input-gauge volumes: smooth CT-like (1, 48, 420, 420)
    uint8 ramps with noise (real volumes compress about 2x), as ``.pt.zst``."""
    from mmmm_tpu_torch.utils.io import save_pt_zst

    rng = np.random.default_rng(0)
    z = np.linspace(0, 1, GAUGE_VOLUME[1])[:, None, None]
    y = np.linspace(0, 1, GAUGE_VOLUME[2])[None, :, None]
    x = np.linspace(0, 1, GAUGE_VOLUME[3])[None, None, :]
    base = z * 80 + y * 60 + x * 40
    paths = []
    for k in range(n):
        vol = (base + rng.normal(0, 2, base.shape)).clip(0, 255).astype(np.uint8)[None]
        paths.append(root / f"vol{k}.pt.zst")
        save_pt_zst(vol, paths[-1])
    return paths


def native_phase(tmp: Path) -> dict:
    """The port's native library built on this machine from the checkout's
    source: zstd round trips (a frame with its content size, one without,
    the two concatenated, a skippable frame), ``.pt.zst`` and ``.arr.zst``
    files, ``resize_trilinear_u8`` against ``F.interpolate`` (trilinear,
    ``align_corners=False``) within 2e-3, the prefetcher over a few files;
    then the decode plus resize of (1, 48, 420, 420) volumes to (32, 384,
    384) through the prefetcher, bench.py's input gauge (host time)."""
    from mmmm_tpu_torch.utils import native
    from mmmm_tpu_torch.utils.io import (load_array_zst, load_pt_zst, save_array_zst,
                                         save_pt_zst)

    log("data preparation: the native library")
    t = time.perf_counter()
    so = native.build()
    build_s = time.perf_counter() - t
    cxx = native.compiler()
    version = subprocess.run([cxx, "--version"], capture_output=True, text=True,
                             check=True).stdout.splitlines()[0]
    log(f"  built {so.name} in {build_s:.2f} s with {cxx} ({version})")
    rng = np.random.default_rng(0)
    data = rng.integers(0, 16, 3_000_000, dtype=np.uint8).tobytes()
    sized, unsized = native.zstd_compress(data, 3), native.zstd_compress(data, 19, False)
    skippable = b"\x50\x2a\x4d\x18" + (4).to_bytes(4, "little") + b"skip"
    checks = {"sized": (sized, data), "unsized": (unsized, data),
              "concatenated": (sized + skippable + unsized, data + data)}
    for label, (frame, want) in checks.items():
        if native.zstd_decompress(frame) != want:
            raise AssertionError(f"native zstd: the {label} frame does not round-trip")
    fhd = unsized[4]  # frame header descriptor: no content-size field, not single-segment
    if fhd >> 6 or fhd & 0x20 or not (sized[4] >> 6 or sized[4] & 0x20):
        raise AssertionError("native zstd: a frame's content size is not as asked")
    tree = {"image": rng.integers(0, 255, (1, 8, 32, 32), dtype=np.uint8),
            "meta": {"n": 3, "mask": rng.random((2, 4)) > 0.5}}
    save_pt_zst(tree, tmp / "t.pt.zst")
    got = load_pt_zst(tmp / "t.pt.zst")
    arr = rng.normal(size=(3, 5, 7)).astype(np.float32)
    save_array_zst(arr, tmp / "a.arr.zst")
    if (not np.array_equal(got["image"], tree["image"]) or got["meta"]["n"] != 3
            or not np.array_equal(got["meta"]["mask"], tree["meta"]["mask"])
            or not np.array_equal(load_array_zst(tmp / "a.arr.zst"), arr)):
        raise AssertionError("native zstd: .pt.zst or .arr.zst does not round-trip")
    resize_err = 0.0
    for shape_in, shape_out in (((2, 4, 10, 12), (6, 20, 24)), ((2, 6, 20, 24), (4, 13, 11)),
                                ((1, 48, 64, 64), (32, 96, 96))):
        vol = rng.integers(0, 255, size=shape_in, dtype=np.uint8)
        want = F.interpolate(torch.from_numpy(vol.astype(np.float32) / 255.0)[None],
                             size=shape_out, mode="trilinear", align_corners=False)[0].numpy()
        resize_err = max(resize_err, float(np.abs(native.resize_trilinear_u8(vol, shape_out)
                                                  - want).max()))
    check("native resize_trilinear_u8 vs F.interpolate", resize_err, 2e-3)
    blobs = [rng.integers(0, 255, 50_000 + i, dtype=np.uint8).tobytes() for i in range(6)]
    for i, b in enumerate(blobs):
        (tmp / f"f{i}.zst").write_bytes(native.zstd_compress(b, 3, i % 2 == 0))
    with native.NativePrefetcher(n_threads=3) as pf:
        jobs = [pf.submit(tmp / f"f{i}.zst") for i in range(6)]
        if [pf.wait(j) for j in reversed(jobs)] != blobs[::-1]:
            raise AssertionError("native prefetcher: wrong bytes")

    # bench.py's gauge: read + decode on the prefetcher's threads, unpickle
    # and resize on this one
    paths = _gauge_volumes(tmp)
    with native.NativePrefetcher(n_threads=2) as pf:
        pf.wait(pf.submit(paths[0]))
        t = time.perf_counter()
        jobs = [pf.submit(paths[k % len(paths)]) for k in range(GAUGE_N)]
        for j in jobs:
            vol = torch.load(io.BytesIO(pf.wait(j)), weights_only=False).numpy()
            native.resize_trilinear_u8(vol, GAUGE_RESIZE)
        gauge_s = time.perf_counter() - t
    out = {"build_s": build_s, "compiler": f"{cxx}: {version}", "library": so.name,
           "resize_max_abs_err": resize_err, "gauge_volumes": GAUGE_N,
           "gauge_s": gauge_s, "volumes_per_s": GAUGE_N / gauge_s,
           "gauge_file_bytes": paths[0].stat().st_size}
    log(f"  zstd frames (sized, unsized, concatenated with a skippable one), .pt.zst, .arr.zst "
        f"and the prefetcher round-trip; resize max |err| {resize_err:.3g}; gauge "
        f"{GAUGE_VOLUMES_TEXT}: {GAUGE_N} volumes in {gauge_s:.3f} s, "
        f"{out['volumes_per_s']:.2f} volumes/s (host)")
    return out


GAUGE_VOLUMES_TEXT = (f"decode + resize of {GAUGE_VOLUME} uint8 to {GAUGE_RESIZE} through the "
                      "prefetcher (2 threads)")


def _self_label_cases(vg: Path, rng) -> None:
    """``DP_CASES`` CT volumes of ``DP_CT_SHAPE`` as ``.pt.zst`` (written
    here) and their visual-grounding ``train.json``, 2-4 targets a case."""
    from mmmm_tpu_torch.utils.io import save_pt_zst

    vg.mkdir(parents=True)
    z = np.linspace(0, 1, DP_CT_SHAPE[1])[:, None, None]
    yx = np.hypot(*np.meshgrid(np.linspace(-1, 1, DP_CT_SHAPE[2]),
                               np.linspace(-1, 1, DP_CT_SHAPE[3]), indexing="ij"))
    items = []
    for k in range(DP_CASES):
        vol = (120 + 80 * np.cos(3 * yx + k) * (0.5 + z) + rng.normal(0, 8, (DP_CT_SHAPE[1:])))
        save_pt_zst(vol.clip(0, 255).astype(np.uint8)[None], vg / f"ct{k}.pt.zst")
        names = rng.choice(DP_CLASSES, 2 + k % 3, replace=False)
        report = " ".join(f"The {n} is seen." for n in names)
        tags, pos = [], 0
        for n in names:
            start = report.index(n, pos)
            tags.append({"start": start, "end": start + len(n), "target": str(n)})
            pos = start + len(n)
        items.append({"key": f"ct{k}", "image": [f"ct{k}.pt.zst"], "ref_report": report,
                      "tags": tags})
    (vg / "train.json").write_text(json.dumps(items))


def self_label_phase(tmp: Path) -> tuple[dict, dict]:
    """The ``self-label`` command at ``SamConfig()``'s full width (12
    layers, fp32) with its defaults (patch (8, 16, 16), grid (4, 16, 16),
    threshold 0.5) over 4 (1, 48, 320, 320) CT volumes with 2-4 targets
    each, seeded SAM weights and prompt embeddings saved as the command
    reads them: on the card (K4 exactly 12 a case) and with ``--device
    cpu``, the probabilities (read at the command's resize back to the
    volume's shape) within ``masks_tol`` (2e-4), the written masks equal
    wherever |p - 0.5| exceeds it; then the masks read back through
    ``data/grg.py``'s ``GRGTransform``. Returns the results and the card
    run's launches."""
    from unittest import mock

    from mmmm_tpu_torch import cli
    from mmmm_tpu_torch.data.grg import GRGTransConf, GRGTransform, get_grg_data_list
    from mmmm_tpu_torch.data.local import DatasetConf
    from mmmm_tpu_torch.data.tokenizer import MMMMTokenizer
    from mmmm_tpu_torch.models.segvol import SamConfig
    from mmmm_tpu_torch.ops._cuda import KERNELS
    from mmmm_tpu_torch.params import init_sam_params
    from mmmm_tpu_torch.preprocess import self_label as sl_module
    from mmmm_tpu_torch.train.checkpoint import save_adapter
    from mmmm_tpu_torch.utils.io import load_pt_zst

    log("data preparation: self-label at SamConfig()")
    cfg = SamConfig()
    rng = np.random.default_rng(3)
    save_adapter(tmp / "sam.npz", init_sam_params(cfg, seed=0, device="cpu"))
    np.savez(tmp / "embeds.npz", **{n: rng.normal(size=cfg.embed_dim).astype(np.float32)
                                    for n in DP_CLASSES})
    dirs = {dev: tmp / f"vg_{dev}" for dev in ("cuda", "cpu")}
    for d in dirs.values():
        _self_label_cases(d, np.random.default_rng(5))
    keys = [item["key"] for item in json.loads((dirs["cpu"] / "train.json").read_text())]
    sam_shape = tuple(g * p for g, p in zip(SL_GRID, SL_PATCH))
    probs, secs, launches = {}, {}, {}
    for dev, d in dirs.items():
        got, resize = [], sl_module.resize_3d

        def recorded(x, shape, got=got):
            out = resize(x, shape)
            if tuple(x.shape[1:]) == sam_shape:  # the probabilities, back to the volume's shape
                got.append(np.asarray(out))
            return out

        for kern in KERNELS.values():
            kern.reset()
        t = time.perf_counter()
        with mock.patch.object(sl_module, "resize_3d", recorded):
            cli.main(["self-label", "--vg-dir", str(d), "--sam", str(tmp / "sam.npz"),
                      "--embeddings", str(tmp / "embeds.npz"), "--device", dev])
        if dev == "cuda":
            torch.cuda.synchronize()
        secs[dev] = time.perf_counter() - t
        launches[dev] = {k: v.launches for k, v in KERNELS.items() if v.launches}
        labeled = [k for k in keys if (d / f"{k}_seg.pt.zst").exists()]
        if len(got) != DP_CASES or labeled != keys:
            raise AssertionError(f"self-label on {dev}: {len(labeled)} of {DP_CASES} cases "
                                 f"labeled, {len(got)} probabilities seen")
        probs[dev] = dict(zip(keys, got))
    err, tol_used = 0.0, []
    for key, p_card in probs["cuda"].items():
        p_cpu = torch.from_numpy(probs["cpu"][key])
        tol = masks_tol(p_cpu)
        tol_used.append(tol)
        e = max_err(torch.from_numpy(p_card), p_cpu)
        check(f"self-label {key} probabilities card vs CPU", e, tol)
        err = max(err, e)
        m_card = load_pt_zst(dirs["cuda"] / f"{key}_seg.pt.zst")
        m_cpu = load_pt_zst(dirs["cpu"] / f"{key}_seg.pt.zst")
        far = np.abs(probs["cpu"][key] - 0.5) > tol
        if m_card.dtype != np.bool_ or m_card.shape != p_card.shape or \
                not np.array_equal(m_card[far], m_cpu[far]):
            raise AssertionError(f"self-label {key}: masks differ where |p - 0.5| > {tol}")
        if (dirs["cuda"] / f"{key}_seg.json").read_text() != \
                (dirs["cpu"] / f"{key}_seg.json").read_text():
            raise AssertionError(f"self-label {key}: target lists differ")
    # the written masks feed data/grg.py, as the trainer reads them
    conf = DatasetConf(max_targets=8, max_instances=8)
    conf.grg_trans = GRGTransConf(grounding_prob=1.0)
    tf = GRGTransform(conf, MMMMTokenizer.byte_fallback(), seed=0)
    read = []
    for item in get_grg_data_list(dirs["cuda"]):
        dp = tf(item)
        targets = json.loads((dirs["cuda"] / f"{item['key']}_seg.json").read_text())
        shape = None if dp["masks"] is None else tuple(dp["masks"].shape)
        if shape is None or not dp["grounding"] or shape[0] != len(targets):
            raise AssertionError(f"grg: {item['key']} masks {shape} for {len(targets)} targets")
        read.append([int(s) for s in dp["masks"].shape])
    out = {"cases": DP_CASES, "volume": list(DP_CT_SHAPE), "grid": list(SL_GRID),
           "patch": list(SL_PATCH), "card_s": secs["cuda"], "cpu_s": secs["cpu"],
           "probs_max_abs_err": err, "tol": tol_used, "launches": launches["cuda"],
           "grg_masks": read,
           "fg_voxels": {k: int(load_pt_zst(dirs["cuda"] / f"{k}_seg.pt.zst").sum())
                         for k in probs["cuda"]}}
    log(f"  self-label: {DP_CASES} cases, the command on the card {secs['cuda']:.2f} s (--device cpu "
        f"{secs['cpu']:.2f} s), probabilities max |err| {err:.3g}, launches "
        f"{launches['cuda']}; grg read the masks back {read}")
    return out, launches["cuda"]


def data_prep_phase() -> tuple[dict, dict]:
    """The native library, then ``self-label``, in a temporary directory."""
    import tempfile

    with tempfile.TemporaryDirectory() as td:
        (Path(td) / "native").mkdir()
        native = native_phase(Path(td) / "native")
        label, launches = self_label_phase(Path(td))
    return {"native": native, "self_label": label}, launches


STAGES = ("vit", "llm_prefill", "decode", "sam")
KERNEL_GROUPS = (  # (label, substrings of a kernel name), first match wins
    ("K4 dense attention", ("attn_fwd_wgmma<false", "attn_fwd_f32<false")),
    ("K3 flash forward", ("attn_fwd_wgmma<true", "attn_fwd_f32<true")),
    ("K7delta rowsum", ("flash_bwd_delta",)),
    ("K7dq flash backward", ("flash_bwd_dq",)),
    ("K7dkv flash backward", ("flash_bwd_dkv",)),
    ("K1 decode attention", ("decode_attn_kernel",)),
    ("K6 window attention", ("decode_window_mma_kernel", "decode_window_kernel")),
    ("K9 int8 decode attention", ("decode_q8_kernel",)),
    ("K10 split-int8 decode attention", ("decode_q8_mxu_kernel",)),
    ("K11 W4A16 decode rows", ("w4_gemv_mma_kernel", "w4_gemv_kernel", "w4_sum_groups_kernel")),
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
    about a minute a million events. Over a flagship run's 1.2-1.5 million
    events the profiler's exit took 12-22 s and reading every event's four
    fields 8-15 s on the H100's host, so only the device events and the
    stage spans are read whole."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        result, wall_s = run()
    t0 = time.perf_counter()
    raw = prof.profiler.kineto_results.events()
    # (name, device type, start us, duration us) of every device event and
    # every stage span; any other host event is read for its name alone
    kernels, spans, wanted = [], [], set(stages)
    for e in raw:
        name, dev = e.name(), e.device_type()
        if dev == DeviceType.CUDA or name in wanted:
            row = (name, dev, e.start_ns() / 1e3, e.duration_ns() / 1e3)
            (spans if name in wanted else kernels).append(row)
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
        f"({100 * busy_us / 1e6 / wall_s:.1f}% of wall), {len(raw)} events")
    # a stage's span is recorded on the host (its CPU time) and on the device
    # timeline (first to last of its kernels); the kernels that start inside
    # the device span give the stage's busy time; a stage that runs several
    # times (a chunk of the prefill, a server's decode chunk) sums its spans
    starts = sorted((start, us) for _, _, start, us in kernels)
    stage_times = {}
    for name in stages:
        host = [e for e in spans if e[0] == name and e[1] == DeviceType.CPU]
        dev = [e for e in spans if e[0] == name and e[1] == DeviceType.CUDA]
        stage = {"host_ms": sum(e[3] for e in host) / 1e3 if host else None,
                 "device_span_ms": None, "kernels_ms": None, "launches": None,
                 "spans": len(host)}
        if dev:
            stage.update(device_span_ms=0.0, kernels_ms=0.0, launches=0)
            for d in dev:
                lo = bisect.bisect_left(starts, (d[2], -1.0))
                hi = bisect.bisect_left(starts, (d[2] + d[3], -1.0))
                stage["device_span_ms"] += d[3] / 1e3
                stage["kernels_ms"] += sum(us for _, us in starts[lo:hi]) / 1e3
                stage["launches"] += hi - lo
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
    asks for) and spill bytes of every K3/K4 (``attn_fwd_*``, with P1's
    NOSM form), K6 tensor-core, K11 decode-row, K11mma, K7, K9, K10 and K1
    kernel, the fused forms of K6, K9 and K10 included; fails if one
    spills."""
    rows = []
    for e in ptxas_entries(build_log):
        m = re.search(r"(attn_fwd_(?:wgmma|f32)|flash_bwd_(?:dq|dkv)_(?:wgmma|f32)|flash_bwd_delta"
                      r"|w4_mma_kernel|w4_gemv_mma_kernel|decode_window_mma_kernel"
                      r"|decode_q8_mxu_kernel|decode_q8_kernel|decode_attn_kernel)", e["symbol"])
        if not m:
            continue
        kname = m.group(1)
        if kname.startswith("decode_q8"):  # <T, LPS, VEC, APPEND> at D = 16 LPS, run (c)'s cache
            rows.append(_q8_resource_row(kname, e, lib))
            continue
        if kname == "decode_attn_kernel":  # <T, LPS, VEC> at D = 8 LPS over run (a)'s cache
            rows.append(_k1_resource_row(e, lib))
            continue
        if kname.startswith("attn_fwd"):
            # bf16 <MASKED, DP, KT (keys a tile), NOSM, FAST>, fp32 <MASKED, NJ,
            # stages, FAST>: K3 is the masked form, K4 (and P1) the other; FAST
            # is K4's fast softmax
            t = re.search(r"ILb([01])ELi(\d+)ELi(\d+)E(?:Lb([01])E)?(?:Lb([01])E)?",
                          e["symbol"])
            targ, kt = int(t.group(2)), int(t.group(3))
            bf16 = kname.endswith("_wgmma")
            fast = (t.group(5) if bf16 else t.group(4)) == "1"
            # the smem query takes a key count that selects the tile of kt keys
            dyn = (lib.mmmm_attn_fwd_smem(1, targ, 512 if kt == 128 else 64) if bf16
                   else lib.mmmm_attn_fwd_smem(0, 16 * targ, 64))
            label = (f"{kname}<{'K3' if t.group(1) == '1' else 'K4'}, "
                     + (f"DP={targ}, KT={kt}{', NOSM' if t.group(4) == '1' else ''}" if bf16
                        else f"NJ={targ}, stages={kt}") + (", fast softmax>" if fast else ">"))
            rows.append(_resource_row(label, e, dyn))
            continue
        t = re.search(r"ILi(\d+)E", e["symbol"])
        targ = int(t.group(1)) if t else None
        if kname == "w4_mma_kernel":
            dyn = lib.mmmm_w4_mma_smem(targ)
        elif kname == "w4_gemv_mma_kernel":  # <MT>: M <= 8 MT
            dyn = lib.mmmm_w4_gemv_smem(8 * targ)
        elif kname == "decode_window_mma_kernel":  # <DP, APPEND>, at run (b)'s cache
            from mmmm_tpu_torch.ops.decode_kernel import window_warps

            dyn = lib.mmmm_decode_window_smem(targ, *window_warps(PROMPT + NEW + WINDOW))
        elif kname.endswith("_wgmma"):
            dyn = lib.mmmm_flash_bwd_smem(1, targ, int("dkv" in kname))
        elif kname.endswith("_f32"):
            dyn = lib.mmmm_flash_bwd_smem(0, 16 * targ, int("dkv" in kname))
        else:
            dyn = 0
        label = kname if targ is None else f"{kname}<{targ}>"
        if kname == "decode_window_mma_kernel" and re.search(r"ILi\d+ELb1E", e["symbol"]):
            label = f"{kname}<{targ}, fused: K5's append>"
        if kname == "flash_bwd_delta":
            label += "<bf16>" if "bfloat16" in e["symbol"] else "<fp32>"
        rows.append(_resource_row(label, e, dyn))
    if not any(r["kernel"].startswith("attn_fwd") for r in rows):
        raise AssertionError("no K3/K4 kernel in the build log")
    for prefix in ("flash_bwd", "w4_mma", "w4_gemv_mma", "decode_window_mma", "decode_q8_kernel",
                   "decode_q8_mxu_kernel", "decode_attn_kernel"):
        if not any(r["kernel"].startswith(prefix) for r in rows):
            raise AssertionError(f"no {prefix} kernel in the build log")
    for kname in ("decode_window_mma_kernel", "decode_q8_kernel", "decode_q8_mxu_kernel"):
        if not any(r["kernel"].startswith(kname) and "fused" in r["kernel"] for r in rows):
            raise AssertionError(f"no fused {kname} in the build log")
    for kname in ("attn_fwd_wgmma", "attn_fwd_f32"):
        if not any(r["kernel"].startswith(kname) and "fast softmax" in r["kernel"] for r in rows):
            raise AssertionError(f"no {kname} with the fast softmax in the build log")
    for fused in (False, True):
        if not any(r["kernel"].startswith("decode_q8_kernel") and "bf16 products" in r["kernel"]
                   and ("fused" in r["kernel"]) == fused for r in rows):
            raise AssertionError(f"no decode_q8_kernel in bf16 (fused: {fused}) in the build log")
    return rows


def _q8_resource_row(kname: str, e: dict, lib) -> dict:
    """A K9 or K10 instance's resources (the read alone, or its fused form),
    its dynamic shared memory that of the staged read's plan at D = 16 LPS
    over Smax 320 (run (c)'s and run (d)'s cache), which the kernel's own
    query must give as the wrapper's plan counts it; fails if its static
    shared memory passes the plan's allowance for it, ``Q8_STATIC_SMEM``."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    t = re.search(r"I(13__nv_bfloat16|f)Li(\d+)ELb([01])ELb([01])E(?:Lb([01])E)?", e["symbol"])
    lps, vec, fused = int(t.group(2)), t.group(3) == "1", t.group(4) == "1"
    bf16_cast = t.group(5) == "1"  # K9's <..., BF16>: the reference's cast="bf16"
    d, smax, mxu = 16 * lps, PROMPT + NEW, kname == "decode_q8_mxu_kernel"
    chunk, stages = dk.q8_stage_plan(smax, d, mxu=mxu)
    dyn = (lib.mmmm_decode_q8_mxu_smem(chunk, stages, d, smax, 1) if mxu
           else lib.mmmm_decode_q8_smem(chunk, stages, d))
    if dyn != stages * dk.q8_stage_bytes(chunk, d) + dk.q8_math_smem(smax, chunk, mxu):
        raise AssertionError(f"{kname}: the kernel's shared memory differs from the plan's")
    if e.get("static_smem", 0) > dk.Q8_STATIC_SMEM:
        raise AssertionError(f"{kname}: {e['static_smem']} bytes of static shared memory, past "
                             f"the plan's {dk.Q8_STATIC_SMEM}")
    label = (f"{kname}<{'bf16' if t.group(1) != 'f' else 'fp32'}, LPS={lps}, VEC={int(vec)}"
             f"{', fused: K8 and quantize_kv' if fused else ''}"
             f"{', bf16 products' if bf16_cast else ''}; {stages} stages of {chunk} slots>")
    return _resource_row(label, e, dyn)


def _k1_resource_row(e: dict, lib) -> dict:
    """A K1 instance's resources, its dynamic shared memory that of the
    staged read's plan at D = 8 LPS over run (a)'s cache (B = 4, H = 32,
    Smax 320), which the kernel's own query must give as the plan counts it
    (also split, at B = 1); fails if its static shared memory passes the
    plan's allowance for it, ``K1_STATIC_SMEM``."""
    from mmmm_tpu_torch.ops import decode_kernel as dk

    t = re.search(r"I(13__nv_bfloat16|f)Li(\d+)ELb([01])E", e["symbol"])
    lps, vec, elem = int(t.group(2)), t.group(3) == "1", 2 if t.group(1) != "f" else 4
    d, smax = 8 * lps, PROMPT + NEW
    sms = dk.sm_count(torch.device("cuda"))
    warps = dk.DECODE_WARPS
    for b in (1, B):  # the last, run (a)'s, is reported
        splits = dk.decode_splits(b, 32, smax, sms)
        chunk, stages = dk.decode_stage_plan(smax, splits, d, elem)
        dyn = lib.mmmm_decode_attention_smem(chunk, stages, d, elem, splits)
        if dyn != dk.decode_block_smem(chunk, stages, d, elem, splits):
            raise AssertionError("decode_attn_kernel: the kernel's shared memory differs from "
                                 "the plan's")
    if e.get("static_smem", 0) > dk.K1_STATIC_SMEM:
        raise AssertionError(f"decode_attn_kernel: {e['static_smem']} bytes of static shared "
                             f"memory, past the plan's {dk.K1_STATIC_SMEM}")
    label = (f"decode_attn_kernel<{'bf16' if elem == 2 else 'fp32'}, LPS={lps}, VEC={int(vec)}; "
             f"{splits} split(s) of {warps} warps, {stages} stages of {chunk} slots a warp>")
    return _resource_row(label, e, dyn)


def _resource_row(label: str, e: dict, dyn: int) -> dict:
    row = {"kernel": label, "registers": e.get("registers"),
           "static_smem": e.get("static_smem", 0), "dynamic_smem": dyn,
           "spill_stores": e.get("spill_stores", 0), "spill_loads": e.get("spill_loads", 0)}
    log(f"  {label}: {row['registers']} registers, shared {row['static_smem']} + "
        f"{dyn} bytes, spill stores {row['spill_stores']}, loads {row['spill_loads']}")
    if row["spill_stores"] or row["spill_loads"]:
        raise AssertionError(f"{label} spills to local memory")
    return row


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
    results["tiny_serving"] = phase("tiny_serving", tiny_serving_phase)
    # the flagship's inputs come from a generator of their own, so that the
    # checks above do not change them
    results["flagship"], launches = phase("flagship", flagship_phase,
                                          torch.Generator(device="cuda").manual_seed(0), True,
                                          True)
    results["phase_s"]["flagship_serving (within flagship)"] = \
        results["flagship"]["serving"]["seconds"]
    torch.cuda.empty_cache()
    results["tiny_train"] = phase("tiny_train", tiny_train_phase)
    results["tiny_fit"] = phase("tiny_fit", tiny_fit_phase)
    results["flagship_train"], train_launches = phase(
        "flagship_train", flagship_train_phase, torch.Generator(device="cuda").manual_seed(0))
    launches.update(train_launches)
    torch.cuda.empty_cache()
    results["train_routes"] = phase("train_routes", train_route_phase)
    torch.cuda.empty_cache()
    results["remat_dots"] = phase("remat_dots", remat_dots_phase)
    torch.cuda.empty_cache()
    results["finetune"] = phase("finetune", finetune_phase)
    torch.cuda.empty_cache()
    import tempfile
    keep = Path(tempfile.mkdtemp(prefix="chip_smoke_adapter_"))
    try:
        results["flagship_fit"] = phase(
            "flagship_fit", flagship_fit_phase,
            results["flagship_train"]["modes"]["none"]["steady_step_s"], keep / "adapter.npz")
        gc.collect()
        torch.cuda.empty_cache()
        results["data_parallel"], mesh_launches = phase("data_parallel", data_parallel_phase)
        gc.collect()
        torch.cuda.empty_cache()
        results["tensor_parallel"], tp_launches = phase("tensor_parallel",
                                                        tensor_parallel_phase)
        results["seq_pipe"], sp_launches = phase("seq_pipe", seq_pipe_phase)
        results["entry"], entry_launches = phase("entry", entry_phase, keep / "adapter.npz", peaks)
    finally:
        shutil.rmtree(keep, ignore_errors=True)
    launches.update(entry_launches)
    results["kernels"]["K4"]["variants"].extend(results["entry"]["padded_heads"]["k4_rows"])
    gc.collect()
    torch.cuda.empty_cache()
    results["pseudo_box_seg"], det_launches, lap_row, k4_sam_row = phase(
        "pseudo_box_seg", pseudo_box_seg_phase, peaks)
    launches["detector_train"] = det_launches
    results["kernels"]["LAP"] = lap_row
    results["kernels"]["K4"]["variants"].append(k4_sam_row)
    gc.collect()
    torch.cuda.empty_cache()
    results["data_prep"], self_label_launches = phase("data_prep", data_prep_phase)
    dp_llm = results["flagship"]["data_prep"]
    results["phase_s"]["data_prep_llm (within flagship)"] = dp_llm["seconds"]
    # the data-preparation runs' launches (phase 5's clean/tag routes, the
    # tag-reports command, self-label), each counted from 0
    dp_launches = {f"{label}_{kind}": dp_llm[label][kind]["launches"]
                   for label in ("flagship_bf16", "cut_fp32")
                   for kind in ("static", "continuous", "spec")}
    dp_launches["clean_reports_cli"] = dp_llm["cli"]["clean_reports"]["launches"]
    dp_launches["tag_reports_cli"] = dp_llm["cli"]["tag_reports"]["launches"]
    dp_launches["self_label"] = self_label_launches
    log(f"data preparation launches: {dp_launches}; phase {results['phase_s']['data_prep']:.1f}"
        f" s + {dp_llm['seconds']:.1f} s within phase 5 ({card})")
    # the switches' kernel forms: launches of phase 4's counted run with them on
    switched = results["tiny_reference"]["switches"][SWITCHES_RUN]["launches_by_form"]
    for kid, form in (("K4", "fast"), ("K9", "bf16")):
        for row in results["kernels"][kid]["variants"]:
            if form in row.get("form", ""):
                # the decode step takes K9's fused form: the read alone runs 0 times
                row["launches"] = (switched[kid][form] if row["form"] != "bf16" else 0)
                row["launches_in_run"] = f"tiny {SWITCHES_RUN} (phase 4)"

    # each K11 row's launches on its own weight shape, read from the counter
    by_shape = results["flagship"]["runs"][KERNEL_RUN["K11"]]["k11_launches_by_shape"]
    k11 = results["kernels"]["K11"]
    for row in (k11, *k11["variants"]):
        row["launches_of_shape"] = by_shape.get("{}x{}".format(*row["shape"][1:]), 0)
    kernels = []
    for kid, run in KERNEL_RUN.items():
        counter = COUNTER.get(kid, kid)
        kern, r = _cuda.KERNELS[counter], results["kernels"][kid]
        entry = {"name": kid, "route": "cuda", "source": kern.source,
                 "replaces": REPLACES.get(kid, kern.replaces),
                 "launches": launches[run].get(counter, 0), "launches_in_run": run,
                 "kernel_ms": r["ms"]}
        forms = results["flagship"]["runs"].get(run, {}).get("launches_by_form", {})
        if counter in forms:
            entry["launches_by_form"] = forms[counter]
        # the servers' steady runs (s1)-(s3), each counted from 0
        entry["launches_serving"] = {label: v["launches"].get(counter, 0) for label, v in
                                     results["flagship"]["serving"].items()
                                     if isinstance(v, dict) and "launches" in v}
        # phase 8's counted runs (demo, predict, the padded ViT, prompted SAM)
        entry["launches_entry"] = {label: n.get(counter, 0) for label, n in
                                   entry_launches.items()}
        # a steady semantic step under remat "attn" (phase 6), and the
        # finetune command's three steps at full width (FT_LAYERS layers)
        entry["launches_remat_attn"] = results["flagship_train"]["modes"]["semantic"][
            "remat_attn"]["steps"][1]["launches"].get(counter, 0)
        entry["launches_finetune"] = results["finetune"]["full_launches"].get(counter, 0)
        # a steady semantic step of the data-parallel route (mesh data=1, NCCL)
        # at full width and DP_LAYERS layers, equal to the route without a mesh
        entry["launches_mesh"] = mesh_launches.get(counter, 0)
        entry["launches_no_mesh_same_depth"] = results["data_parallel"]["launches_no_mesh"].get(
            counter, 0)
        # each rank's launches in phase 7c's counted runs (tensor parallel over
        # 2 ranks on one card: the bf16 and fp32 serving routes, the fp32 step)
        entry["launches_tensor_parallel_rank"] = {label: n.get(counter, 0) for label, n in
                                                  tp_launches.items()}
        # each rank's launches in phase 7d's counted runs (the ring alone, the
        # fp32 step on seq=2 and on pipe=2), ranks 0 and 1
        entry["launches_seq_pipe_rank"] = {label: [n.get(counter, 0) for n in per_rank]
                                           for label, per_rank in sp_launches.items()}
        # the data-preparation runs (clean/tag-reports routes, self-label)
        entry["launches_data_prep"] = {label: n.get(counter, 0) for label, n in
                                       dp_launches.items()}
        entry.update({k: r[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                        "bound_by", "library_ms")})
        entry.update({k: v for k, v in r.items() if k not in entry})
        kernels.append(entry)
    results["kernels_line"] = kernels  # the line below, whole (the tool shows its end)
    if args.log_dir is not None:
        (args.log_dir / "chip_smoke.json").write_text(json.dumps(results, indent=1))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
