"""Host-side image/label transforms (numpy; the device-side tail is in-jit).

Ports the *algorithms* of ``mmmm/data/dataset/misc.py``:

  - ``get_patch_size_z``: log-normal sampling of the z patch size so one model
    trains across thin X-rays and thick CT volumes (the "resolution
    virtualization" trick) — outputs are snapped to powers of two, which is
    exactly what makes TPU bucketing finite;
  - ``get_max_resize``: integer optimization for the largest in-plane resize
    that fits the vision-token budget (t * ceil(a*t) <= M);
  - trilinear resize, symmetric divisible padding (MONAI convention), random
    flips / axial 90-degree rotations with consistent box updates;
  - CLIP intensity normalization (CogVLM stats);
  - box conversions: integer corner boxes (d0, h0, w0, d1, h1, w1) ->
    normalized CenterSize (cd, ch, cw, sd, sh, sw).

The port's own copy of ``mmmm_tpu/data/transforms.py``. ``resize_3d`` runs
the port's ``ops/resample.py resample_nd`` on CPU tensors, numpy in and numpy
out: the JAX package's dense interpolation matrices, so the images agree
with its to fp32 rounding.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ..ops.resample import resample_nd

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)


def intensity_norm(image: np.ndarray, mean=CLIP_MEAN, std=CLIP_STD) -> np.ndarray:
    """(C, D, H, W) in [0, 1] -> CLIP-normalized."""
    mean = np.asarray(mean, np.float32).reshape(-1, 1, 1, 1)
    std = np.asarray(std, np.float32).reshape(-1, 1, 1, 1)
    return (image - mean) / std


def get_patch_size_z(
    base_patch_size_z: int,
    base_pool_size_z: int,
    size_z: int,
    max_tokens_z: int,
    log2_patch_size_z_std: float | None = None,
    R: np.random.RandomState | None = None,
) -> tuple[int, int, int, int]:
    """Returns (patch_size_z, pool_size_z, stride_z, tokens_z).

    Thin volumes (size_z <= max_tokens_z) use patch 1; thicker ones sample
    log2(patch_z) around log2(size_z / (pool_z * max_tokens_z)), clipped to
    [0, log2(base_patch_z)] (``misc.py:93-119``).
    """
    if size_z <= max_tokens_z:
        return 1, 1, 1, size_z
    pool_size_z = base_pool_size_z
    center = np.log2(size_z / (pool_size_z * max_tokens_z))
    if log2_patch_size_z_std is None:
        log2_p = center
    else:
        log2_p = R.normal(center, log2_patch_size_z_std)
    log2_p = int(np.clip(np.rint(log2_p), 0, base_patch_size_z.bit_length() - 1))
    patch_size_z = 1 << log2_p
    stride_z = patch_size_z * pool_size_z
    tokens_z = min(math.ceil(size_z / stride_z), max_tokens_z)
    return patch_size_z, pool_size_z, stride_z, tokens_z


def _solve(a: float, m: int) -> int:
    """Max integer t such that t * ceil(a * t) <= m (``misc.py:52-60``)."""
    am = a * m
    n = math.ceil(am**0.5)
    if am > (n - 1) * n:
        return m // n
    return math.floor((n - 1) / a)


def get_max_resize(size, stride: int, max_tokens: int) -> tuple[int, int]:
    """Largest proportional (H, W) resize with at most ``max_tokens`` patches."""
    size = np.asarray(size)
    gcd = np.gcd(size, stride)
    size_p = size // gcd
    stride_p = stride // gcd
    ps = stride_p * np.flip(size_p)
    t = np.asarray([_solve(float(a), max_tokens) for a in ps / np.flip(ps)])
    scale = (t * stride_p / size_p).max()
    resize = np.round(size * scale).astype(np.int64)
    return int(resize[0]), int(resize[1])


def resize_3d(x: np.ndarray, shape: tuple[int, int, int]) -> np.ndarray:
    """Trilinear resize of (C, D, H, W) trailing dims (half-pixel centers)."""
    if x.shape[1:] == tuple(shape):
        return x
    t = torch.from_numpy(np.ascontiguousarray(x, np.float32))
    return resample_nd(t, tuple(shape)).numpy()


def divisible_pad_shape(spatial, stride) -> tuple[int, int, int]:
    """Spatial shape after ``divisible_pad`` (metadata-only planning)."""
    return tuple(int(-(-s // st) * st) for s, st in zip(spatial, stride))


def divisible_pad(x: np.ndarray, stride: tuple[int, int, int]):
    """Symmetric pad of (C, D, H, W) so spatial dims divide ``stride``.

    Returns (padded, pad_before (3,)) — MONAI SpatialPad 'symmetric' method.
    """
    spatial = np.asarray(x.shape[1:])
    target = -(-spatial // np.asarray(stride)) * np.asarray(stride)
    gap = target - spatial
    before = gap // 2
    pads = [(0, 0)] + [(int(b), int(g - b)) for b, g in zip(before, gap)]
    return np.pad(x, pads), before


def sample_flips_rot90(
    R: np.random.RandomState, flip_prob: float = 0.5, rot_prob: float = 0.75
) -> tuple[list[bool], int]:
    """Sample the flip/rot90 decisions WITHOUT touching pixels.

    Split from application so a metadata-only planning pass (multi-host
    host-invariant bucket scheduling) consumes the RNG identically to full
    materialization. Returns (flips per axis, k quarter-turns; k=0 = none)."""
    flips = [bool(R.uniform() < flip_prob) for _ in range(3)]
    k = int(R.randint(1, 4)) if R.uniform() < rot_prob else 0
    return flips, k


def apply_flips_rot90(
    image: np.ndarray,  # (C, D, H, W)
    masks: np.ndarray | None,  # (N, D, H, W)
    boxes: np.ndarray | None,  # (M, 6) int corners (d0,h0,w0,d1,h1,w1)
    flips: list[bool],
    k: int,
):
    boxes = None if boxes is None else np.asarray(boxes, np.int64).copy()
    for ax in range(3):
        if flips[ax]:
            image = np.flip(image, axis=1 + ax)
            if masks is not None:
                masks = np.flip(masks, axis=1 + ax)
            if boxes is not None:
                size = image.shape[1 + ax]
                lo, hi = boxes[:, ax].copy(), boxes[:, 3 + ax].copy()
                boxes[:, ax], boxes[:, 3 + ax] = size - hi, size - lo
    if k:
        image = np.rot90(image, k, axes=(2, 3))
        if masks is not None:
            masks = np.rot90(masks, k, axes=(2, 3))
        if boxes is not None:
            boxes = _rot90_boxes(boxes, k, (image.shape[2], image.shape[3]))
    return np.ascontiguousarray(image), (None if masks is None else np.ascontiguousarray(masks)), boxes


def rand_flips_rot90(
    image: np.ndarray,
    masks: np.ndarray | None,
    boxes: np.ndarray | None,
    R: np.random.RandomState,
    flip_prob: float = 0.5,
    rot_prob: float = 0.75,
):
    """Random per-axis flips + axial (H, W) 90-degree rotation with box updates."""
    flips, k = sample_flips_rot90(R, flip_prob, rot_prob)
    return apply_flips_rot90(image, masks, boxes, flips, k)


def _rot90_boxes(boxes: np.ndarray, k: int, final_hw: tuple[int, int]) -> np.ndarray:
    """Apply k CCW 90-degree rotations (numpy rot90 axes=(H, W)) to corner boxes."""
    # reconstruct initial (H, W): each rotation swaps them
    h, w = final_hw if k % 2 == 0 else (final_hw[1], final_hw[0])
    out = boxes.copy()
    for _ in range(k):
        # np.rot90(x, axes=(H, W)): a point (h, w) maps to (W-1-w, h), so a
        # half-open range [w0, w1) maps to new_h range [W-w1, W-w0) and the h
        # range carries over to new_w.
        new = out.copy()
        new[:, 1], new[:, 4] = w - out[:, 5], w - out[:, 2]
        new[:, 2], new[:, 5] = out[:, 1], out[:, 4]
        out = new
        h, w = w, h
    return out


def corners_to_center_size(boxes: np.ndarray, size) -> np.ndarray:
    """Integer corner boxes -> normalized CenterSize (``misc.py:171-177``)."""
    size = np.asarray(size, np.float64)
    b = boxes.astype(np.float64)
    lo, hi = b[:, :3] / size, b[:, 3:] / size
    return np.concatenate([(lo + hi) / 2, hi - lo], axis=1).astype(np.float32)


def scale_boxes(boxes: np.ndarray, src_size, dst_size) -> np.ndarray:
    """Rescale integer corner boxes between grids (rounded)."""
    scale = np.asarray(dst_size, np.float64) / np.asarray(src_size, np.float64)
    b = boxes.astype(np.float64)
    out = np.concatenate([b[:, :3] * scale, b[:, 3:] * scale], axis=1)
    return np.round(out).astype(np.int64)


def shift_boxes(boxes: np.ndarray, offset) -> np.ndarray:
    off = np.tile(np.asarray(offset, np.int64), 2)
    return boxes + off


def ensure_rgb(image: np.ndarray) -> np.ndarray:
    if image.shape[0] == 1:
        return np.repeat(image, 3, axis=0)
    return image
