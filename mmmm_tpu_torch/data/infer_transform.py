"""Inference-time single-image pipeline, the port's copy of
``mmmm_tpu/data/infer_transform.py`` (the reference's
``mmmm/misc.py:image_transform``).

The training transforms' geometry (deterministic z patch, token-budget
resize, symmetric divisible pad, CLIP normalization) for one image at a
time; the ``demo`` and ``predict`` commands call it. ``resize_3d`` is the
port's, over ``ops/resample.py resample_nd`` on CPU tensors. PNG and JPEG
files need ``PIL`` (``data/vl.py load_image_any``); ``.pt`` and ``.pt.zst``
volumes do not.
"""
from __future__ import annotations

import numpy as np

from .local import DatasetConf
from .transforms import (
    divisible_pad,
    ensure_rgb,
    get_max_resize,
    get_patch_size_z,
    intensity_norm,
    resize_3d,
)
from .vl import load_image_any


def image_transform(
    image_or_path,
    conf: DatasetConf,
    *,
    max_vision_tokens: int | None = None,
    max_tokens_z: int | None = None,
):
    """Returns (image, grounding_image, patch_size, pool_size, num_image_tokens).

    ``image_or_path``: a path (any supported format) or a (C, D, H, W) uint8
    array. Both images are fp32 numpy arrays (C, D, H, W): the CLIP-normalized
    one for the ViT, the [0, 1] one for SAM.
    """
    lt = conf.local_trans
    max_vision_tokens = max_vision_tokens or lt.max_vision_tokens
    max_tokens_z = max_tokens_z or lt.max_tokens_z
    if isinstance(image_or_path, np.ndarray):
        image = image_or_path.astype(np.float32) / 255.0
    else:
        image = load_image_any(image_or_path).astype(np.float32) / 255.0
    size_z = image.shape[1]
    patch_size_z, pool_size_z, stride_z, tokens_z = get_patch_size_z(
        conf.base_vit_patch_size_z, conf.base_pool_size_z, size_z, max_tokens_z
    )
    stride = (stride_z, conf.stride_xy, conf.stride_xy)
    resize = (
        min(size_z, tokens_z * stride_z),
        *get_max_resize(image.shape[2:], conf.stride_xy, max_vision_tokens // tokens_z),
    )
    image = resize_3d(image, resize)
    image, _ = divisible_pad(image, stride)
    image = ensure_rgb(image)
    grounding_image = image
    image = intensity_norm(image)
    patch = (patch_size_z, conf.vit_patch_size_xy, conf.vit_patch_size_xy)
    pool = (pool_size_z, conf.pool_size_xy, conf.pool_size_xy)
    n_tokens = int(np.prod([s // st for s, st in zip(image.shape[1:], stride)]))
    return image.astype(np.float32), grounding_image.astype(np.float32), patch, pool, n_tokens
