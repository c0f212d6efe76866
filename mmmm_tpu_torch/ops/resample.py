"""Spatial resampling and variable-depth patch ops, the port of
``mmmm_tpu/ops/resample.py``.

The resizes keep the JAX package's matrix form: a dense (new, old)
half-pixel linear-interpolation matrix per axis, which is exactly
``interpolate(align_corners=False)`` without anti-aliasing. The strided
patch conv and the stride-2 transposed conv stay reshape + one matmul;
``nearest_resize`` downsamples instance labels. All are differentiable
(SAM's patch embedding trains).
"""
from __future__ import annotations

import math

import numpy as np
import torch


def _linear_interp_matrix(old: int, new: int) -> np.ndarray:
    """(new, old) half-pixel linear interpolation matrix, no anti-aliasing."""
    centers = np.clip((np.arange(new) + 0.5) * (old / new) - 0.5, 0.0, old - 1.0)
    lo = np.floor(centers).astype(np.int64)
    hi = np.minimum(lo + 1, old - 1)
    frac = (centers - lo).astype(np.float32)
    w = np.zeros((new, old), np.float32)
    w[np.arange(new), lo] += 1.0 - frac
    w[np.arange(new), hi] += frac
    return w


def resample_nd(x: torch.Tensor, shape: tuple[int, ...], scale: bool = False) -> torch.Tensor:
    """Linearly resample the trailing ``len(shape)`` dims of ``x`` to ``shape``
    (fp32 math); ``scale=True`` preserves the summed response."""
    spatial = tuple(x.shape[x.dim() - len(shape):])
    if spatial == tuple(shape):
        return x
    out = x.float()
    lead = x.dim() - len(shape)
    for i, (old, new) in enumerate(zip(spatial, shape)):
        if old == new:
            continue
        w = torch.from_numpy(_linear_interp_matrix(old, new)).to(out.device)
        axis = lead + i
        out = torch.movedim(torch.tensordot(out, w, dims=([axis], [1])), -1, axis)
    if scale:
        out = out * (math.prod(spatial) / math.prod(shape))
    return out.to(x.dtype)


def collapse_patch_weight_z(weight: torch.Tensor, patch_size_z: int) -> torch.Tensor:
    """Sum-reduce a (Cout, Cin, Dmax, H, W) kernel to z extent ``patch_size_z``."""
    d_max = weight.shape[2]
    if d_max == patch_size_z:
        return weight
    if d_max % patch_size_z:
        raise ValueError(f"stored z kernel {d_max} not divisible by patch_size_z {patch_size_z}")
    co, ci, _, h, w = weight.shape
    return weight.reshape(co, ci, patch_size_z, d_max // patch_size_z, h, w).sum(dim=3)


def variable_patch_embed_3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                            patch_size: tuple[int, int, int]) -> torch.Tensor:
    """Non-overlapping patch embedding, (B, C, D, H, W) -> (B, Cout, D/pz,
    H/ph, W/pw), as patch extraction + one matmul."""
    pz, ph, pw = patch_size
    w = collapse_patch_weight_z(weight, pz)
    b, c, d, h, wd = x.shape
    if d % pz or h % ph or wd % pw:
        raise ValueError(f"image shape {(d, h, wd)} not divisible by patch {patch_size}")
    gd, gh, gw = d // pz, h // ph, wd // pw
    wmat = w.permute(2, 3, 1, 4, 0).reshape(pz * ph * c * pw, -1)
    patches = x.reshape(b, c, gd, pz, gh, ph, gw, pw).permute(0, 2, 4, 6, 3, 5, 1, 7)
    patches = patches.reshape(b, gd * gh * gw, pz * ph * c * pw)
    out = torch.matmul(patches, wmat.to(patches.dtype)).float()
    if bias is not None:
        out = out + bias.float()
    out = out.to(x.dtype)
    return out.reshape(b, gd, gh, gw, -1).permute(0, 4, 1, 2, 3)


def variable_upsample_3d(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor | None,
                         patch_size_z: int, cnt: int) -> torch.Tensor:
    """Stride-2 transposed conv (weight (Cin, Cout, 2, 2, 2)) whose z kernel
    is mean-collapsed to 1 when ``patch_size_z < 2 ** (cnt + 1)``; matmul +
    pixel shuffle."""
    collapse_z = patch_size_z < (1 << (cnt + 1))
    w = weight.mean(dim=2, keepdim=True) if collapse_z else weight
    kz = w.shape[2]
    cin, cout = w.shape[0], w.shape[1]
    b, _, d, h, wd = x.shape
    wmat = w.reshape(cin, cout * kz * 2 * 2)
    tokens = x.permute(0, 2, 3, 4, 1).reshape(b, d * h * wd, cin)
    o = torch.matmul(tokens, wmat.to(tokens.dtype)).to(x.dtype)
    o = o.reshape(b, d, h, wd, cout, kz, 2, 2).permute(0, 4, 1, 5, 2, 6, 3, 7)
    out = o.reshape(b, cout, d * kz, h * 2, wd * 2)
    if bias is not None:
        out = out + bias.to(out.dtype)[None, :, None, None, None]
    return out


def trilinear_resize(x: torch.Tensor, shape: tuple[int, int, int]) -> torch.Tensor:
    """Trilinear resize of (..., D, H, W) mask logits to the image grid."""
    return resample_nd(x, shape)


def nearest_resize(x: torch.Tensor, shape: tuple[int, ...]) -> torch.Tensor:
    """Nearest-neighbour resize of the trailing ``len(shape)`` dims (label
    downsampling), ``jax.image.resize(method="nearest")``: output index i
    reads ``floor((i + 0.5) * old / new)``, computed in fp32."""
    lead = x.dim() - len(shape)
    for i, new in enumerate(shape):
        old = x.shape[lead + i]
        if old == new:
            continue
        idx = torch.floor((torch.arange(new, dtype=torch.float32, device=x.device) + 0.5)
                          * old / new).long()
        x = x.index_select(lead + i, idx)
    return x
