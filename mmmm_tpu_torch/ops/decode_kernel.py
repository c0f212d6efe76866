"""The decode-step kernels over a (B, H, Smax, D) KV cache, the port of
``mmmm_tpu/ops/decode_kernel.py``:

  - K1 ``decode_attention`` (``decode_attention_pallas``, full and ragged),
    and its fused form ``decode_attention_append``, which does K2's append
    in the same launch (the decode step's route);
  - K2 ``kv_append`` (``kv_append_pallas``);
  - K5 ``kv_append_multi`` (``kv_append_pallas_multi``): a verify window;
  - K6 ``decode_attention_window`` (``decode_attention_pallas_window``):
    tensor cores in bf16 (``window_mma_takes``, ``window_warps``), CUDA
    cores in fp32; and its fused form ``decode_attention_window_append``,
    which does K5's append in the same launch (the verify step's route);
  - K8 ``kv_append_q8`` (``kv_append_pallas_q8``): the int8 cache;
  - K9 ``decode_attention_q8`` (``decode_attention_pallas_q8``, full and
    ragged); ``cast="bf16"`` is the ragged body's ``cast="bf16"``
    (``MMMM_Q8_CAST=bf16``), a compile-time variant of the kernel counted
    under its form ``"bf16"``. The reference applies the cast on its ragged
    route alone, which it takes with ``MMMM_RAGGED_DECODE=1`` (and then not
    the split-int8 read), and the port has one K9 kernel for both routes:
    ``cast="bf16"`` here is the reference run with ``MMMM_RAGGED_DECODE=1
    MMMM_Q8_CAST=bf16``, and it takes K9 whatever ``q8_mxu`` says;
  - K10 ``decode_attention_q8_mxu`` (``decode_attention_pallas_q8_mxu``):
    the int8-cache read as exact split-int8 integer dots, which
    ``decode_attention_q8(q8_mxu=True)`` takes under the reference's own
    condition (its ``MMMM_Q8_MXU`` switch);
  - the fused form of K9 and K10, ``decode_attention_q8_append``, which
    quantizes the step's new K/V row (``quantize_kv``) and does K8's append
    in the same launch (the int8 decode step's route).

Each wrapper takes its plain version for CPU tensors and launches the CUDA
kernel (``csrc/decode_attn.cu``, ``csrc/decode_window.cu``,
``csrc/decode_q8.cu``, ``csrc/decode_q8_mxu.cu``, ``csrc/kv_append.cu``) for
CUDA tensors. The appends work in place with the reference's
``dynamic_update_slice`` edge rule.
"""
from __future__ import annotations

import torch

from . import _cuda
from .attention import NEG_INF
from .quant import quantize_kv

K1 = _cuda.register(_cuda.Kernel(
    "K1", "mmmm_decode_attention",
    [_cuda.P] * 8 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.I, _cuda.I, _cuda.I,
                     _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/decode_attn.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:853 decode_attention_pallas "
             "(pallas_call :886; ragged :828)",
))
K2 = _cuda.register(_cuda.Kernel(
    "K2", "mmmm_kv_append",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
     _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/kv_append.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:48 kv_append_pallas (pallas_call :75)",
))
K5 = _cuda.register(_cuda.Kernel(
    "K5", "mmmm_kv_append_multi",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
     _cuda.I, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/kv_append.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:126 kv_append_pallas_multi (pallas_call :157)",
))
K6 = _cuda.register(_cuda.Kernel(
    "K6", "mmmm_decode_attention_window",
    [_cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.I,
     _cuda.I, _cuda.F, _cuda.I, _cuda.I, _cuda.I, _cuda.P, _cuda.P] + [_cuda.I] * 6 + [_cuda.P],
    source="mmmm_tpu_torch/csrc/decode_window.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:437 decode_attention_pallas_window "
             "(pallas_call :459)",
))
K8 = _cuda.register(_cuda.Kernel(
    "K8", "mmmm_kv_append_q8",
    [_cuda.P] * 9 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/kv_append.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:203 kv_append_pallas_q8 (pallas_call :255)",
))
K9 = _cuda.register(_cuda.Kernel(
    "K9", "mmmm_decode_attention_q8",
    [_cuda.P] * 7 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.I, _cuda.I, _cuda.I,
                     _cuda.P, _cuda.P, _cuda.P] + [_cuda.I] * 5 + [_cuda.P],
    source="mmmm_tpu_torch/csrc/decode_q8.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:328 decode_attention_pallas_q8 "
             "(pallas_call :377 via :370; ragged :704 -> :733)",
))
K10 = _cuda.register(_cuda.Kernel(
    "K10", "mmmm_decode_attention_q8_mxu",
    [_cuda.P] * 8 + [_cuda.I, _cuda.I, _cuda.I, _cuda.I, _cuda.F, _cuda.I, _cuda.I, _cuda.I,
                     _cuda.P, _cuda.P, _cuda.P] + [_cuda.I] * 4 + [_cuda.P],
    source="mmmm_tpu_torch/csrc/decode_q8_mxu.cu",
    replaces="mmmm_tpu/ops/decode_kernel.py:604 decode_attention_pallas_q8_mxu "
             "(pallas_call :624; _decode_kernel_q8_mxu :542, _q14_split :528)",
))
# the reference's VMEM budget for a full (head chunk, Smax) read
# (decode_kernel.py:776); it also gates the split-int8 read (:356)
FULL_READ_BUDGET = 12 * 1024 * 1024
# K10 keeps 6 bytes a slot (fp32 logit, int8 w_hi and w_lo) in shared memory
# up to this many slots, in a global workspace above
Q8_MXU_SHARED_SLOTS = 32768
# K9's and K10's staged read (csrc/decode_q8_stage.cuh): the dynamic shared
# memory a block may take (the H100's 227 KiB less room for the kernels'
# static arrays), and the stages of its ring (K1's too)
SMEM_OPTIN = 227 * 1024
Q8_DYNAMIC_SMEM = 220 * 1024
Q8_STATIC_SMEM = SMEM_OPTIN - Q8_DYNAMIC_SMEM  # K9's and K10's static arrays, at most
Q8_RING_STAGES = 4
# K1's static shared memory, at most (its barriers, the warps' (m, l) and
# partial sums: 4,424 bytes at D > 64; chip_smoke.py holds every instance's
# ptxas figure to it); its dynamic shared memory takes the rest
K1_STATIC_SMEM = 5 * 1024
K1_DYNAMIC_SMEM = SMEM_OPTIN - K1_STATIC_SMEM
# K1 splits a head's valid slots over the blocks of a cluster where the
# heads alone leave SMs idle: at most the portable cluster size, each split
# keeping at least DECODE_SPLIT_SLOTS of a full cache; a block's slots are
# shared by its DECODE_WARPS warps, each with a staged read of its own
DECODE_MAX_SPLITS = 8
DECODE_SPLIT_SLOTS = 32
DECODE_WARPS = 8
_SM_COUNT: dict[int, int] = {}


def dus_rows(cache, new, write_index):
    """Rows ``new[b, :, :K]`` go to slots ``[t, t + K)`` of ``cache[b]``, in
    place, where ``t`` is ``write_index[b]`` after the reference's
    ``dynamic_update_slice`` rule: a negative start counts from the end once,
    then it is clamped to ``[0, Smax - K]`` (the window shifts)."""
    smax, k = cache.shape[2], new.shape[2]
    t = write_index.long()
    t = torch.where(t < 0, t + smax, t).clamp(0, smax - k)
    slots = t[:, None] + torch.arange(k, device=cache.device)
    rows = torch.arange(cache.shape[0], device=cache.device)[:, None]
    cache[rows, :, slots] = new.transpose(1, 2)
    return cache


def kv_append_plain(k_cache, v_cache, k_new, v_new, write_index):
    """Plain version of K2 and K5: rows ``[b, :, :K]`` of the new K/V go to
    slots ``[t, t + K)`` from ``write_index[b]``, in place (``dus_rows``)."""
    return dus_rows(k_cache, k_new, write_index), dus_rows(v_cache, v_new, write_index)


def kv_append(k_cache, v_cache, k_new, v_new, write_index):
    """Append one K/V row per sample into the caches IN PLACE; returns the
    (same) caches. ``k_new``/``v_new``: (B, H, 1, D); ``write_index``: (B,)."""
    if _cuda.on_cpu("kv_append", k_cache):
        return kv_append_plain(k_cache, v_cache, k_new, v_new, write_index)
    _cuda.check_cuda("kv_append", k_cache, v_cache, k_new, v_new,
                     dtypes=(torch.bfloat16, torch.float32), align=4)
    _cuda.check_cuda("kv_append", write_index, dtypes=(torch.int32,), align=4)
    b, h, smax, d = k_cache.shape
    if v_cache.shape != k_cache.shape or k_new.shape != (b, h, 1, d) or v_new.shape != (b, h, 1, d):
        raise ValueError(f"kv_append: cache {k_cache.shape} vs new rows {k_new.shape}")
    if len({k_cache.dtype, v_cache.dtype, k_new.dtype, v_new.dtype}) != 1:
        raise ValueError("kv_append: caches and new rows must share one dtype")
    if write_index.shape != (b,):
        raise ValueError(f"kv_append: write_index must be ({b},), got {tuple(write_index.shape)}")
    K2(k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
       write_index.data_ptr(), b, h, smax, d, k_cache.element_size(),
       _cuda.stream_of(k_cache))
    return k_cache, v_cache


def _masked_softmax(logits, valid):
    """fp32 softmax over the last axis restricted to ``valid``; a row with no
    valid entry gives zeros, as the TPU decode kernels do."""
    logits = torch.where(valid, logits, NEG_INF)
    p = torch.where(valid, torch.exp(logits - logits.amax(dim=-1, keepdim=True)), 0.0)
    return p / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def decode_attention_plain(q, k_cache, v_cache, kv_len, scale: float | None = None):
    """Plain version, all fp32 as the TPU kernel is: slots ``< kv_len[b]``
    are valid; a sample with no valid slot gets zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    smax = k_cache.shape[2]
    valid = (torch.arange(smax, device=q.device)[None, :] < kv_len[:, None].long())
    valid = valid[:, None, None, :]  # (B, 1, 1, Smax)
    qh = q.float().transpose(1, 2)  # (B, H, 1, D)
    logits = torch.einsum("bhqd,bhkd->bhqk", qh, k_cache.float()) * scale
    p = _masked_softmax(logits, valid)
    out = torch.einsum("bhqk,bhkd->bhqd", p, v_cache.float())
    return out.transpose(1, 2).to(q.dtype)  # (B, 1, H, D)


def sm_count(device: torch.device) -> int:
    """The streaming multiprocessors of a CUDA device (132 on an H100 SXM)."""
    i = device.index if device.index is not None else torch.cuda.current_device()
    if i not in _SM_COUNT:
        _SM_COUNT[i] = torch.cuda.get_device_properties(i).multi_processor_count
    return _SM_COUNT[i]


def decode_splits(b: int, h: int, smax: int, sms: int) -> int:
    """Blocks (a cluster) that share each (sample, head)'s valid slots in
    K1, from the shapes and the device's ``sms`` alone (the lengths live on
    the card): one where the ``b * h`` heads cover at least 7/8 of the SMs
    (measured on the H100, a split's merge costs more than the last SMs
    give: PERF.md §6); else enough to cover every SM, at most
    ``DECODE_MAX_SPLITS`` and no more than leave each split
    ``DECODE_SPLIT_SLOTS`` of a full cache. The flagship's decode on an
    H100 (H = 32, Smax 320, 132 SMs): 1 at B = 4 (128 blocks), 5 at B = 1
    (160 blocks)."""
    heads = b * h
    if 8 * heads >= 7 * sms:
        return 1
    return max(1, min(DECODE_MAX_SPLITS, smax // DECODE_SPLIT_SLOTS, -(-sms // heads)))


def decode_stage_bytes(chunk: int, stages: int, d: int, elem_bytes: int) -> int:
    """Shared memory of one K1 warp's staged read: ``stages`` stages of
    ``chunk`` rows of ``d * elem_bytes`` bytes (each with 15 bytes of slack,
    as ``q8_stage_bytes``), then a chunk's fp32 logits and exps."""
    return _round16(stages * _round16(chunk * d * elem_bytes + 15) + 8 * chunk)


def decode_block_smem(chunk: int, stages: int, d: int, elem_bytes: int, splits: int) -> int:
    """A K1 block's dynamic shared memory: its warps' staged reads, then,
    where a head is split, each split's partial (the fp32 sums over the
    ``8 * LPS`` head dims its lane groups cover, with m and l), gathered in
    split 0."""
    lps = 1 if d <= 8 else 2 if d <= 16 else 4 if d <= 32 else 8 if d <= 64 else 16
    parts = 0 if splits == 1 else splits * (8 * lps + 4) * 4
    return DECODE_WARPS * decode_stage_bytes(chunk, stages, d, elem_bytes) + parts


def decode_stage_plan(smax: int, splits: int, d: int, elem_bytes: int) -> tuple[int, int]:
    """(slots a stage, stages) of each K1 warp's staged read of its share of
    a split's run, ``ceil(ceil(smax / splits) / DECODE_WARPS)`` slots at
    most: the whole share, its K rows and its V rows each one stage, both
    requested as the block starts, where the block fits in
    ``K1_DYNAMIC_SMEM`` (``decode_block_smem``); else a ring of 4 stages of
    the most slots that fit. The flagship's cache (Smax 320, D = 128,
    bf16): (40, 2) at B = 4, 163 KiB a block; (8, 2) at B = 1."""
    per = -(-smax // splits)
    share = -(-per // DECODE_WARPS)
    fits = lambda c, ns: decode_block_smem(c, ns, d, elem_bytes, splits) <= K1_DYNAMIC_SMEM
    if fits(share, 2):
        return share, 2
    lo, hi = 1, share  # the most slots a stage of the ring that fit
    while lo < hi:
        mid = (lo + hi + 1) // 2
        lo, hi = (mid, hi) if fits(mid, Q8_RING_STAGES) else (lo, mid - 1)
    return lo, Q8_RING_STAGES


def _k1(name, q, k_cache, v_cache, kv_len, scale, new=None):
    """Checks K1's operands and launches it: the read alone, or with
    ``new = (k_new, v_new, write_index)`` the fused form."""
    _cuda.check_cuda(name, q, k_cache, v_cache, dtypes=(torch.bfloat16, torch.float32))
    _cuda.check_cuda(name, kv_len, dtypes=(torch.int32,), align=4)
    b, h, smax, d = k_cache.shape
    if q.shape != (b, 1, h, d) or v_cache.shape != k_cache.shape:
        raise ValueError(f"{name}: q {q.shape} vs cache {k_cache.shape}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"{name}: q and caches must share one dtype")
    if kv_len.shape != (b,):
        raise ValueError(f"{name}: kv_len must be ({b},), got {tuple(kv_len.shape)}")
    if not 0 < d <= 128:
        raise ValueError(f"{name}: head dim {d} must be in 1..128")
    ptrs = (None, None, None)
    if new is not None:
        k_new, v_new, write_index = new
        _cuda.check_cuda(name, k_new, v_new, dtypes=(q.dtype,), align=4)
        _cuda.check_cuda(name, write_index, dtypes=(torch.int32,), align=4)
        if k_new.shape != (b, h, 1, d) or v_new.shape != k_new.shape:
            raise ValueError(f"{name}: cache {k_cache.shape} vs new rows {k_new.shape}")
        if write_index.shape != (b,):
            raise ValueError(f"{name}: write_index must be ({b},), "
                             f"got {tuple(write_index.shape)}")
        ptrs = (k_new.data_ptr(), v_new.data_ptr(), write_index.data_ptr())
    splits = decode_splits(b, h, smax, sm_count(q.device))
    chunk, stages = decode_stage_plan(smax, splits, d, k_cache.element_size())
    out = torch.empty_like(q)
    K1(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), kv_len.data_ptr(), *ptrs,
       out.data_ptr(), b, h, smax, d, float(scale), int(q.dtype == torch.bfloat16), splits,
       chunk, stages, _cuda.stream_of(q), form=None if new is None else "append")
    return out


def decode_attention(q, k_cache, v_cache, kv_len, scale: float | None = None):
    """One query token per sample against the cache: q (B, 1, H, D), caches
    (B, H, Smax, D), kv_len (B,) -> (B, 1, H, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _cuda.on_cpu("decode_attention", q):
        return decode_attention_plain(q, k_cache, v_cache, kv_len, scale)
    return _k1("decode_attention", q, k_cache, v_cache, kv_len, scale)


def decode_attention_append_plain(q, k_cache, v_cache, k_new, v_new, write_index, kv_len,
                                  scale: float | None = None):
    """Plain version of K1's fused form: ``kv_append_plain``, then
    ``decode_attention_plain`` on the appended caches."""
    kv_append_plain(k_cache, v_cache, k_new, v_new, write_index)
    return decode_attention_plain(q, k_cache, v_cache, kv_len, scale)


def decode_attention_append(q, k_cache, v_cache, k_new, v_new, write_index, kv_len,
                            scale: float | None = None):
    """K2's append and K1's read in one launch: rows ``[b, :, 0]`` of
    ``k_new``/``v_new`` (B, H, 1, D) go into the caches IN PLACE at slot
    ``write_index[b]`` (``dus_rows``' rule), then q (B, 1, H, D) attends to
    the slots ``< kv_len[b]`` -> (B, 1, H, D) in q's dtype, exactly what
    ``kv_append`` then ``decode_attention`` give. One K1 launch, counted
    under its form ``"append"``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _cuda.on_cpu("decode_attention_append", q):
        return decode_attention_append_plain(q, k_cache, v_cache, k_new, v_new, write_index,
                                             kv_len, scale)
    return _k1("decode_attention_append", q, k_cache, v_cache, kv_len, scale,
               (k_new, v_new, write_index))


def kv_append_multi(k_cache, v_cache, k_new, v_new, write_index):
    """Append a K-row window per sample into the caches IN PLACE; returns the
    (same) caches. ``k_new``/``v_new``: (B, H, K, D); ``write_index``: (B,)
    the first slot."""
    if _cuda.on_cpu("kv_append_multi", k_cache):
        return kv_append_plain(k_cache, v_cache, k_new, v_new, write_index)
    _cuda.check_cuda("kv_append_multi", k_cache, v_cache, k_new, v_new,
                     dtypes=(torch.bfloat16, torch.float32), align=4)
    _cuda.check_cuda("kv_append_multi", write_index, dtypes=(torch.int32,), align=4)
    b, h, smax, d = k_cache.shape
    k = k_new.shape[2]
    if (v_cache.shape != k_cache.shape or k_new.shape != (b, h, k, d)
            or v_new.shape != k_new.shape or not 1 <= k <= smax):
        raise ValueError(f"kv_append_multi: cache {k_cache.shape} vs new rows {k_new.shape}")
    if len({k_cache.dtype, v_cache.dtype, k_new.dtype, v_new.dtype}) != 1:
        raise ValueError("kv_append_multi: caches and new rows must share one dtype")
    if write_index.shape != (b,):
        raise ValueError(f"kv_append_multi: write_index must be ({b},), "
                         f"got {tuple(write_index.shape)}")
    K5(k_cache.data_ptr(), v_cache.data_ptr(), k_new.data_ptr(), v_new.data_ptr(),
       write_index.data_ptr(), b, h, smax, k, d, k_cache.element_size(),
       _cuda.stream_of(k_cache))
    return k_cache, v_cache


def decode_attention_window_plain(q, k_cache, v_cache, write_index,
                                  scale: float | None = None):
    """Plain version: ``decode_attention_bhsd`` under the verify mask (query
    j sees slots ``< write_index[b] + j + 1``), fp32 logits and softmax, the
    probabilities cast to the cache dtype before the PV product, as the TPU
    kernel does; a query with no valid slot gets zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    nq, smax = q.shape[1], k_cache.shape[2]
    kv_len = write_index.long()[:, None] + torch.arange(1, nq + 1, device=q.device)
    valid = (torch.arange(smax, device=q.device) < kv_len[..., None])[:, None]  # (B,1,K,S)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float().transpose(1, 2), k_cache.float()) * scale
    p = _masked_softmax(logits, valid)
    out = torch.einsum("bhqk,bhkd->bhqd", p.to(v_cache.dtype), v_cache)
    return out.transpose(1, 2).to(q.dtype)  # (B, K, H, D)


WINDOW_TILE_KEYS = 32  # K6's tensor-core form: the slots of a warp's tile
WINDOW_ONE_PASS_TILES = 12  # up to this many tiles, a warp each, all copied at once
WINDOW_RING_WARPS = 6  # above: 6 warps, each with a double buffer of tiles


def window_mma_takes(dtype: torch.dtype, d: int) -> bool:
    """Whether K6 runs its tensor-core form (bf16 rows that are whole 16-byte
    pieces); otherwise its CUDA-core form (fp32, or D % 8 != 0)."""
    return dtype == torch.bfloat16 and d % 8 == 0 and 0 < d <= 128


def window_warps(smax: int) -> tuple[int, int]:
    """(warps of a block, 32-slot tiles a warp) of K6's tensor-core form over
    a cache of ``smax`` slots, one block per (sample, head): a warp for each
    tile while 12 tiles cover the cache (at D = 128 their K and V fill 204
    KiB of shared memory), else 6 warps that walk the tiles with a double
    buffer. Run (b) at the flagship (Smax = 192 + 128 + 8 = 328): 11 warps
    of one tile."""
    tiles = -(-smax // WINDOW_TILE_KEYS)
    if tiles <= WINDOW_ONE_PASS_TILES:
        return tiles, 1
    return WINDOW_RING_WARPS, -(-tiles // WINDOW_RING_WARPS)


def _k6(name, q, k_cache, v_cache, write_index, scale, new=None):
    """Checks K6's operands and launches it: the read alone, or with ``new =
    (k_new, v_new)`` the fused form."""
    _cuda.check_cuda(name, q, k_cache, v_cache, dtypes=(torch.bfloat16, torch.float32))
    _cuda.check_cuda(name, write_index, dtypes=(torch.int32,), align=4)
    b, h, smax, d = k_cache.shape
    nq = q.shape[1]
    if q.shape != (b, nq, h, d) or v_cache.shape != k_cache.shape or not 1 <= nq <= 8:
        raise ValueError(f"{name}: q {q.shape} vs cache {k_cache.shape}")
    if not q.dtype == k_cache.dtype == v_cache.dtype:
        raise ValueError(f"{name}: q and caches must share one dtype")
    if write_index.shape != (b,):
        raise ValueError(f"{name}: write_index must be ({b},), got {tuple(write_index.shape)}")
    if not 0 < d <= 128:
        raise ValueError(f"{name}: head dim {d} must be in 1..128")
    mma = window_mma_takes(q.dtype, d)
    warps, per = window_warps(smax) if mma else (0, 0)
    ptrs, strides = (None, None), (0,) * 6
    if new is not None:
        # the tensor-core form copies new rows by 16-byte pieces; rows in
        # another layout are copied once into an aligned one
        new = tuple(_new_rows(name, t, q, (b, nq, h, d), 16 if mma else 1) for t in new)
        if nq > smax:
            raise ValueError(f"{name}: a window of {nq} rows does not fit {smax} slots")
        ptrs = tuple(t.data_ptr() for t in new)
        strides = (*new[0].stride()[:3], *new[1].stride()[:3])
    out = torch.empty_like(q)
    K6(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(), write_index.data_ptr(),
       out.data_ptr(), b, nq, h, smax, d, float(scale), int(q.dtype == torch.bfloat16),
       warps, per, *ptrs, *strides, _cuda.stream_of(q), form=None if new is None else "append")
    return out


def _new_rows(name, t, q, shape, align):
    """A step's new K or V rows as a kernel reads them: ``shape`` on q's
    device in q's dtype, unit stride over D, any strides over the rest;
    copied once into a contiguous tensor only where its rows are not
    ``align``-byte aligned."""
    if t.device != q.device or t.dtype != q.dtype or tuple(t.shape) != shape:
        raise ValueError(f"{name}: new rows {tuple(t.shape)} {t.dtype} on {t.device}, "
                         f"expected {shape} {q.dtype} on {q.device}")
    if t.stride(-1) != 1:
        raise ValueError(f"{name}: new rows need unit stride over D, got {t.stride()}")
    n = max(1, align // t.element_size())
    if t.data_ptr() % align or any(st % n for st in t.stride()[:-1]):
        t = torch.empty(shape, dtype=t.dtype, device=t.device).copy_(t)
    return t


def decode_attention_window(q, k_cache, v_cache, write_index, scale: float | None = None):
    """Verify-window attention: q (B, K, H, D) with 1 <= K <= 8, caches
    (B, H, Smax, D) that already hold the window, write_index (B,) the
    window's first slot -> (B, K, H, D) in q's dtype."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _cuda.on_cpu("decode_attention_window", q):
        return decode_attention_window_plain(q, k_cache, v_cache, write_index, scale)
    return _k6("decode_attention_window", q, k_cache, v_cache, write_index, scale)


def decode_attention_window_append_plain(q, k_cache, v_cache, k_new, v_new, write_index,
                                         scale: float | None = None):
    """Plain version of K6's fused form: ``kv_append_plain`` of the window's
    rows (B, K, H, D), then ``decode_attention_window_plain``."""
    kv_append_plain(k_cache, v_cache, k_new.transpose(1, 2), v_new.transpose(1, 2), write_index)
    return decode_attention_window_plain(q, k_cache, v_cache, write_index, scale)


def decode_attention_window_append(q, k_cache, v_cache, k_new, v_new, write_index,
                                   scale: float | None = None):
    """K5's append and K6's read in one launch: the verify window's rows
    ``k_new``/``v_new`` (B, K, H, D), 1 <= K <= 8, as the projection gives
    them (read with their strides), go into the caches IN PLACE at slots
    ``[tc, tc + K)``, ``tc`` = ``write_index[b]`` by ``dus_rows``' rule (a
    window that would pass Smax shifts back whole); then q (B, K, H, D)
    attends with query j seeing the slots ``< write_index[b] + j + 1`` (the
    raw index) -> (B, K, H, D) in q's dtype, exactly what
    ``kv_append_multi`` then ``decode_attention_window`` give. One K6
    launch, counted under its form ``"append"``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _cuda.on_cpu("decode_attention_window_append", q):
        return decode_attention_window_append_plain(q, k_cache, v_cache, k_new, v_new,
                                                    write_index, scale)
    return _k6("decode_attention_window_append", q, k_cache, v_cache, write_index, scale,
               (k_new, v_new))


Q8_LEAVES = ("kq", "ks", "vq", "vs")


def kv_append_q8_plain(cache: dict, kq_new, ks_new, vq_new, vs_new, write_index) -> dict:
    """Plain version: the new int8 rows and their scales go to slot
    ``write_index[b]`` of the four leaves, in place (``dus_rows``)."""
    for key, new in zip(Q8_LEAVES, (kq_new, ks_new, vq_new, vs_new)):
        dus_rows(cache[key], new, write_index)
    return cache


def kv_append_q8(cache: dict, kq_new, ks_new, vq_new, vs_new, write_index) -> dict:
    """Append one quantized K/V row per sample into an int8 cache
    ``{"kq", "ks", "vq", "vs"}`` ((B, H, Smax, D) int8, (B, H, Smax, 1) bf16)
    IN PLACE; returns the (same) cache. New rows (B, H, 1, D) int8 and
    scales (B, H, 1, 1) bf16; ``write_index`` (B,)."""
    if _cuda.on_cpu("kv_append_q8", cache["kq"]):
        return kv_append_q8_plain(cache, kq_new, ks_new, vq_new, vs_new, write_index)
    kq, ks, vq, vs = (cache[k] for k in Q8_LEAVES)
    _cuda.check_cuda("kv_append_q8", kq, vq, kq_new, vq_new, dtypes=(torch.int8,), align=4)
    _cuda.check_cuda("kv_append_q8", ks, vs, ks_new, vs_new, dtypes=(torch.bfloat16,), align=2)
    _cuda.check_cuda("kv_append_q8", write_index, dtypes=(torch.int32,), align=4)
    b, h, smax, d = kq.shape
    if (vq.shape != kq.shape or ks.shape != (b, h, smax, 1) or vs.shape != ks.shape
            or kq_new.shape != (b, h, 1, d) or vq_new.shape != kq_new.shape
            or ks_new.shape != (b, h, 1, 1) or vs_new.shape != ks_new.shape):
        raise ValueError(f"kv_append_q8: cache {kq.shape} vs new rows {kq_new.shape}")
    if write_index.shape != (b,):
        raise ValueError(f"kv_append_q8: write_index must be ({b},), "
                         f"got {tuple(write_index.shape)}")
    K8(kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(), kq_new.data_ptr(),
       ks_new.data_ptr(), vq_new.data_ptr(), vs_new.data_ptr(), write_index.data_ptr(),
       b, h, smax, d, _cuda.stream_of(kq))
    return cache


def decode_attention_q8_plain(q, kq, ks, vq, vs, kv_len, scale: float | None = None, *,
                              cast: str = "f32"):
    """Plain version, all fp32 as the TPU kernel is: logits
    ``(q . k_q) * k_s * scale`` over the slots ``< kv_len[b]``, output
    ``sum_j p_j * v_s[j] * v_q[j]``; a sample with no valid slot gets zeros.

    ``cast="bf16"`` (the ragged body's ``cast="bf16"``, with the row's max
    as the reference's one block of the whole cache has it): q rounded to
    bf16, each product ``q_d k_q[j, d]`` rounded to bf16 and summed in fp32;
    ``p_j = exp(s_j - m)``, ``w_j = bf16(p_j v_s[j])``, each ``w_j v_q[j, d]``
    rounded to bf16 and summed in fp32, over ``sum_j p_j``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    smax = kq.shape[2]
    valid = (torch.arange(smax, device=q.device)[None, :] < kv_len[:, None].long())
    valid = valid[:, None, None, :]  # (B, 1, 1, Smax)
    qh = q.float().transpose(1, 2)  # (B, H, 1, D)
    if cast == "f32":
        logits = torch.einsum("bhqd,bhkd->bhqk", qh, kq.float())
        logits = logits * ks.float().transpose(-1, -2) * scale
        w = _masked_softmax(logits, valid) * vs.float().transpose(-1, -2)
        out = torch.einsum("bhqk,bhkd->bhqd", w, vq.float())
        return out.transpose(1, 2).to(q.dtype)  # (B, 1, H, D)
    if cast != "bf16":
        raise ValueError(f"cast must be 'f32' or 'bf16', got {cast!r}")
    return _q8_bf16_plain(qh, kq, ks, vq, vs, valid, scale).transpose(1, 2).to(q.dtype)


def _q8_bf16_plain(qh, kq, ks, vq, vs, valid, scale: float, round_products: bool = True):
    """``cast="bf16"``'s formula on ``qh`` (B, H, 1, D) and the (B, 1, 1,
    Smax) ``valid`` mask, out (B, H, 1, D) fp32. ``round_products=False``
    keeps each product of two bf16 values in fp32, as XLA on the CPU does in
    the reference's interpret-mode kernel; every other rounding stays."""
    bf = lambda x: x.to(torch.bfloat16).float()
    prod = bf if round_products else (lambda x: x)
    logits = prod(bf(qh) * kq.float()).sum(-1)[:, :, None]  # (B, H, 1, Smax)
    logits = torch.where(valid, logits * ks.float().transpose(-1, -2) * scale, NEG_INF)
    p = torch.where(valid, torch.exp(logits - logits.amax(dim=-1, keepdim=True)), 0.0)
    w = bf(p * vs.float().transpose(-1, -2))  # (B, H, 1, Smax)
    acc = prod(w.transpose(-1, -2) * vq.float()).sum(-2)[:, :, None]  # (B, H, 1, D)
    return acc / p.sum(dim=-1, keepdim=True).clamp_min(1e-30)


def _round16(x: int) -> int:
    return -(-x // 16) * 16


def q8_stage_bytes(chunk: int, d: int) -> int:
    """Shared memory of one stage of the staged read: ``chunk`` int8 rows of
    ``d`` bytes and ``chunk`` bf16 scales, each region with 15 bytes of
    slack so that a slab keeps its address modulo 16."""
    return _round16(chunk * d + 15) + _round16(2 * chunk + 15)


def q8_math_smem(smax: int, chunk: int, mxu: bool) -> int:
    """The dynamic shared memory K9 (``mxu=False``: a chunk's fp32 logits and
    exps) or K10 (the logits and split weights of every slot, 6 bytes a
    slot, unless they go to its workspace) takes beside the stages."""
    if not mxu:
        return 8 * chunk
    return 6 * (-(-smax // 4) * 4) if q8_mxu_in_shared(smax) else 0


def q8_stage_plan(smax: int, d: int, mxu: bool = False) -> tuple[int, int]:
    """(slots a stage, stages) of K9's (or, ``mxu``, K10's) staged read of a
    head: the whole read, two stages of ``roundup(smax, 16)`` slots (the K
    rows and the V rows, both requested as the block starts), where they fit
    beside the kernel's own shared memory in ``Q8_DYNAMIC_SMEM``; else a ring
    of 4 stages of the most slots, a multiple of 16, that fit. Run
    (c)'s and (d)'s flagship cache (Smax 320, D = 128): (320, 2), 83 KiB."""
    whole = _round16(smax)
    if 2 * q8_stage_bytes(whole, d) + q8_math_smem(smax, whole, mxu) <= Q8_DYNAMIC_SMEM:
        return whole, 2
    chunk = _round16(Q8_DYNAMIC_SMEM // (Q8_RING_STAGES * (d + 2)))
    while (Q8_RING_STAGES * q8_stage_bytes(chunk, d)
           + q8_math_smem(smax, chunk, mxu) > Q8_DYNAMIC_SMEM):
        chunk -= 16
    if chunk < 16:
        raise ValueError(f"no staged read of Smax {smax}, D {d} fits in shared memory")
    return chunk, Q8_RING_STAGES


def q8_slab_copy(offset: int, nbytes: int) -> tuple[int, int, int]:
    """How the staged read copies a slab of ``nbytes`` bytes that starts
    ``offset`` bytes past a 16-byte-aligned address (a head's rows or
    scales, or a chunk of them): (head, body, tail). The body, whole 16-byte
    pieces from a 16-byte boundary, goes by one bulk copy; the head (up to
    that boundary) and the tail (after the body), at most 15 bytes each, by
    ordinary loads. Nothing past the slab is read."""
    head = min(-offset % 16, nbytes)
    body = (nbytes - head) // 16 * 16
    return head, body, nbytes - head - body


def _q8_mxu_eligible(h: int, smax: int, d: int) -> bool:
    """The reference's condition for the split-int8 read: a head chunk's
    fp32 image of the (Smax, D) int8 operands fits its VMEM budget
    (``8 * chunk * Smax * D <= 12 MiB``, Smax <= 1536 at H=32, D=128)."""
    chunk = 8 if h % 8 == 0 else (4 if h % 4 == 0 else 1)
    return 8 * chunk * smax * d <= FULL_READ_BUDGET


def q8_mxu_in_shared(smax: int) -> bool:
    """Whether K10 keeps a block's logits and split weights in shared memory
    (else in a workspace the wrapper allocates)."""
    return smax <= Q8_MXU_SHARED_SLOTS


def _q8_read(name, kernel, q, kq, ks, vq, vs, kv_len, scale, new=None, cast="f32"):
    """Checks K9's or K10's (``kernel``) operands and launches it: the read
    alone, or with ``new = (k_new, v_new, write_index)`` the fused form; K9
    with its products in ``cast``."""
    _cuda.check_cuda(name, q, dtypes=(torch.bfloat16, torch.float32))
    _cuda.check_cuda(name, kq, vq, dtypes=(torch.int8,))
    _cuda.check_cuda(name, ks, vs, dtypes=(torch.bfloat16,), align=2)
    _cuda.check_cuda(name, kv_len, dtypes=(torch.int32,), align=4)
    b, h, smax, d = kq.shape
    if (q.shape != (b, 1, h, d) or vq.shape != kq.shape or ks.shape != (b, h, smax, 1)
            or vs.shape != ks.shape):
        raise ValueError(f"{name}: q {q.shape} vs cache {kq.shape}")
    if kv_len.shape != (b,):
        raise ValueError(f"{name}: kv_len must be ({b},), got {tuple(kv_len.shape)}")
    if not 0 < d <= 128:
        raise ValueError(f"{name}: head dim {d} must be in 1..128")
    ptrs, strides = (None, None, None), (0,) * 4
    if new is not None:
        k_new, v_new, write_index = new
        # where D % 16 == 0 the kernel reads a row by 16-byte pieces and
        # requires the rows 16-byte aligned: rows in another layout are
        # copied once into an aligned one
        align = 16 if d % 16 == 0 else 1
        k_new, v_new = (_new_rows(name, t, q, (b, 1, h, d), align) for t in (k_new, v_new))
        _cuda.check_cuda(name, write_index, dtypes=(torch.int32,), align=4)
        if write_index.shape != (b,):
            raise ValueError(f"{name}: write_index must be ({b},), "
                             f"got {tuple(write_index.shape)}")
        ptrs = (k_new.data_ptr(), v_new.data_ptr(), write_index.data_ptr())
        strides = (k_new.stride(0), k_new.stride(2), v_new.stride(0), v_new.stride(2))
    mxu = kernel is K10
    forms = ("append",) * (new is not None) + (cast,) * (cast != "f32")
    out = torch.empty_like(q)
    chunk, stages = q8_stage_plan(smax, d, mxu=mxu)
    args = (q.data_ptr(), kq.data_ptr(), ks.data_ptr(), vq.data_ptr(), vs.data_ptr(),
            kv_len.data_ptr(), out.data_ptr())
    if mxu:
        ws = None if q8_mxu_in_shared(smax) else torch.empty(
            b * h * 6 * (-(-smax // 4) * 4), dtype=torch.uint8, device=q.device)
        args += (None if ws is None else ws.data_ptr(),)
    cast_arg = () if mxu else (int(cast == "bf16"),)
    kernel(*args, b, h, smax, d, float(scale), int(q.dtype == torch.bfloat16), chunk, stages,
           *ptrs, *strides, *cast_arg, _cuda.stream_of(q),
           form=forms[0] if len(forms) == 1 else forms or None)
    return out


def _check_cast(cast: str) -> None:
    if cast not in ("f32", "bf16"):
        raise ValueError(f"cast must be 'f32' or 'bf16', got {cast!r}")


def decode_attention_q8(q, kq, ks, vq, vs, kv_len, scale: float | None = None, *,
                        q8_mxu: bool = False, cast: str = "f32"):
    """One query token per sample against an int8 cache: q (B, 1, H, D) bf16
    or fp32, kq/vq (B, H, Smax, D) int8, ks/vs (B, H, Smax, 1) bf16, kv_len
    (B,) -> (B, 1, H, D) in q's dtype. ``q8_mxu=True`` asks for the
    split-int8 read (K10), taken where the reference takes it and ``cast``
    is ``"f32"``; otherwise K9, its products in ``cast`` (``"f32"`` or
    ``"bf16"``)."""
    _check_cast(cast)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _takes_mxu(q8_mxu, cast, kq.shape[1:]):
        return decode_attention_q8_mxu(q, kq, ks, vq, vs, kv_len, scale)
    if _cuda.on_cpu("decode_attention_q8", q):
        return decode_attention_q8_plain(q, kq, ks, vq, vs, kv_len, scale, cast=cast)
    return _q8_read("decode_attention_q8", K9, q, kq, ks, vq, vs, kv_len, scale, cast=cast)


def _takes_mxu(q8_mxu: bool, cast: str, hsd) -> bool:
    """Whether the int8 read is K10's: asked for, under the reference's
    condition, and not overruled by the bf16 cast (the reference's ragged
    route, which never takes the split-int8 read)."""
    return q8_mxu and cast == "f32" and _q8_mxu_eligible(*hsd)


def decode_attention_q8_append_plain(q, cache: dict, k_new, v_new, write_index, kv_len,
                                     scale: float | None = None, *, q8_mxu: bool = False,
                                     cast: str = "f32"):
    """Plain version of the fused int8 step: ``quantize_kv`` of the new rows
    (B, 1, H, D), ``kv_append_q8_plain``, then the read's plain version (K10's
    where ``decode_attention_q8`` takes it, else K9's in ``cast``)."""
    (kq, ks), (vq, vs) = quantize_kv(k_new.transpose(1, 2)), quantize_kv(v_new.transpose(1, 2))
    kv_append_q8_plain(cache, kq, ks, vq, vs, write_index)
    leaves = [cache[key] for key in Q8_LEAVES]
    if _takes_mxu(q8_mxu, cast, leaves[0].shape[1:]):
        return decode_attention_q8_mxu_plain(q, *leaves, kv_len, scale)
    return decode_attention_q8_plain(q, *leaves, kv_len, scale, cast=cast)


def decode_attention_q8_append(q, cache: dict, k_new, v_new, write_index, kv_len,
                               scale: float | None = None, *, q8_mxu: bool = False,
                               cast: str = "f32"):
    """The int8 decode step in one launch: the new K/V rows ``k_new``/``v_new``
    (B, 1, H, D) in q's dtype, as the projection gives them (read with their
    strides), are quantized as ``quantize_kv`` does and go IN PLACE into slot
    ``write_index[b]`` of the cache ``{"kq", "ks", "vq", "vs"}``
    (``dus_rows``' rule), then q (B, 1, H, D) attends to the slots
    ``< kv_len[b]`` -> (B, 1, H, D) in q's dtype: exactly what ``quantize_kv``
    twice, ``kv_append_q8`` and ``decode_attention_q8(q8_mxu=q8_mxu,
    cast=cast)`` give. One K9 launch, or K10 where ``decode_attention_q8``
    takes it, counted under its form ``"append"`` (and K9's ``"bf16"``)."""
    _check_cast(cast)
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _cuda.on_cpu("decode_attention_q8_append", q):
        return decode_attention_q8_append_plain(q, cache, k_new, v_new, write_index, kv_len,
                                                scale, q8_mxu=q8_mxu, cast=cast)
    leaves = [cache[key] for key in Q8_LEAVES]
    mxu = _takes_mxu(q8_mxu, cast, leaves[0].shape[1:])
    return _q8_read("decode_attention_q8_append", K10 if mxu else K9, q, *leaves, kv_len, scale,
                    (k_new, v_new, write_index), cast=cast)


def q14_split(x: torch.Tensor, amax_dims) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Exact 14-bit split-int8 encoding (``_q14_split``): ``x ~ (hi * 128 +
    lo) * s`` with ``s = amax / 16256`` over ``amax_dims``, ``hi`` in
    [-127, 127] and ``lo`` in [0, 127], both int8. Returns (hi, lo, s)."""
    xf = x.float()
    s = xf.abs().amax(dim=amax_dims, keepdim=True).clamp_min(1e-8) / 16256.0
    x14 = torch.round(xf / s).to(torch.int32)
    hi = x14 >> 7  # arithmetic shift = floor division by 128
    return hi.to(torch.int8), (x14 - hi * 128).to(torch.int8), s


def _wrap_int32(x: torch.Tensor) -> torch.Tensor:
    """int64 sums reduced modulo 2**32 into int32, as the reference's int32
    arithmetic wraps."""
    return ((x + 2 ** 31) % 2 ** 32 - 2 ** 31).to(torch.int32)


def _split_dot(a8: torch.Tensor, hi: torch.Tensor, lo: torch.Tensor, eq: str) -> torch.Tensor:
    """``128 * <a, hi> + <a, lo>`` of int8 operands in int32 arithmetic. The
    dots run in float64, exact for these integers (|sum| < 2**53), since
    CUDA has no integer batched matmul."""
    a = a8.double()
    dot = lambda b: torch.einsum(eq, a, b.double()).long()
    return _wrap_int32(128 * dot(hi) + dot(lo))


def decode_attention_q8_mxu_plain(q, kq, ks, vq, vs, kv_len, scale: float | None = None):
    """Plain version of K10 (``_decode_kernel_q8_mxu``): q split per (b, h)
    into int8 (hi, lo); logits ``s32 * k_s * (q_s * scale)`` from the exact
    int32 dot ``s32``; the masked fp32 softmax folded with ``v_s``, split
    again with ``w_s = max(w) / 16256``; output ``o32 * w_s`` from the int32
    dot of ``v_q`` and the weights. Integer sums wrap modulo 2**32 as the
    reference's int32 does (``|o32|`` passes 2**31 above kv_len ~1040 under
    near-uniform attention). A sample with no valid slot gets zeros."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    smax = kq.shape[2]
    qhi, qlo, qs = q14_split(q.transpose(1, 2), (-1, -2))  # (B, H, 1, D), s (B, H, 1, 1)
    s32 = _split_dot(kq, qhi, qlo, "bhkd,bhqd->bhqk")  # (B, H, 1, Smax)
    logits = s32.float() * ks.float().transpose(-1, -2) * (qs * scale)
    valid = (torch.arange(smax, device=q.device)[None, :] < kv_len[:, None].long())
    w = _masked_softmax(logits, valid[:, None, None, :]) * vs.float().transpose(-1, -2)
    ws = w.amax(dim=-1, keepdim=True).clamp_min(1e-30) / 16256.0  # (B, H, 1, 1)
    w14 = torch.round(w / ws).to(torch.int32)
    whi = w14 >> 7
    o32 = _split_dot(vq, whi, w14 - whi * 128, "bhkd,bhqk->bhqd")  # (B, H, 1, D)
    return (o32.float() * ws).transpose(1, 2).to(q.dtype)  # (B, 1, H, D)


def decode_attention_q8_mxu(q, kq, ks, vq, vs, kv_len, scale: float | None = None):
    """K10: the int8-cache read as exact split-int8 integer dots; the
    contract of ``decode_attention_q8``."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    if _cuda.on_cpu("decode_attention_q8_mxu", q):
        return decode_attention_q8_mxu_plain(q, kq, ks, vq, vs, kv_len, scale)
    return _q8_read("decode_attention_q8_mxu", K10, q, kq, ks, vq, vs, kv_len, scale)
