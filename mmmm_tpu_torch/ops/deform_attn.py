"""Multi-scale deformable attention, the port of
``mmmm_tpu/ops/deform_attn.py`` (``bilinear_sample``, ``ms_deform_attn``).

The JAX package leaves this op to XLA (gathers and lerps, no Pallas
kernel), so the port is plain PyTorch, differentiable through autograd. It
keeps JAX's index arithmetic (``x = p W - 0.5``, ``floor``, clipped gather,
zero outside the map, ``align_corners=False``) but is batched: one level's
values are one (B heads, H W, head_dim) tensor and each of the four
bilinear taps is one gather over every (sample, head, query, point), where
the JAX code loops over (level, head). ``F.grid_sample`` computes the same
sampling; the port does not call it (``chip_smoke.py`` times it beside this
op as a yardstick).
"""
from __future__ import annotations

import torch


def _sample(value: torch.Tensor, h: int, w: int, points: torch.Tensor) -> torch.Tensor:
    """value (G, H W, C), points (G, N, 2) normalized (x, y) -> (G, N, C)."""
    c = value.shape[-1]
    x = points[..., 0] * w - 0.5
    y = points[..., 1] * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    x0, y0 = x0.long(), y0.long()

    def tap(yi, xi):
        inside = (yi >= 0) & (yi < h) & (xi >= 0) & (xi < w)
        idx = yi.clamp(0, h - 1) * w + xi.clamp(0, w - 1)
        v = value.gather(1, idx[..., None].expand(*idx.shape, c))
        return torch.where(inside[..., None], v, 0.0)

    v00 = tap(y0, x0)
    v01 = tap(y0, x0 + 1)
    v10 = tap(y0 + 1, x0)
    v11 = tap(y0 + 1, x0 + 1)
    top = v00 * (1 - fx) + v01 * fx
    bot = v10 * (1 - fx) + v11 * fx
    return top * (1 - fy) + bot * fy


def bilinear_sample(value: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
    """Bilinear interpolation of ``value`` (H, W, C) at ``points`` (N, 2),
    normalized (x, y), with zero padding outside (align_corners=False)."""
    h, w, c = value.shape
    return _sample(value.reshape(1, h * w, c), h, w, points[None])[0]


def ms_deform_attn(values: list[torch.Tensor], sampling_locations: torch.Tensor,
                   attention_weights: torch.Tensor) -> torch.Tensor:
    """``values`` per level (B, H_l, W_l, heads, head_dim);
    ``sampling_locations`` (B, Q, heads, L, P, 2) normalized (x, y);
    ``attention_weights`` (B, Q, heads, L, P). Returns (B, Q, heads
    head_dim) in fp32."""
    b, q, heads, num_levels, num_points, _ = sampling_locations.shape
    head_dim = values[0].shape[-1]
    locs = sampling_locations.float().permute(0, 2, 3, 1, 4, 5)  # (B, heads, L, Q, P, 2)
    weights = attention_weights.float().permute(0, 2, 3, 1, 4)  # (B, heads, L, Q, P)
    out = None
    for lvl in range(num_levels):
        _, h, w, _, _ = values[lvl].shape
        v = values[lvl].float().permute(0, 3, 1, 2, 4).reshape(b * heads, h * w, head_dim)
        pts = locs[:, :, lvl].reshape(b * heads, q * num_points, 2)
        sampled = _sample(v, h, w, pts).reshape(b * heads, q, num_points, head_dim)
        wl = weights[:, :, lvl].reshape(b * heads, q, num_points, 1)
        part = (sampled * wl).sum(2)  # (B heads, Q, head_dim)
        out = part if out is None else out + part
    return out.reshape(b, heads, q, head_dim).transpose(1, 2).reshape(b, q, heads * head_dim)
