"""Compact 3-D UNet for the segmentation ablation, the port of
``mmmm_tpu/models/unet.py``: strided-conv downsampling, instance-norm +
leaky-ReLU blocks, skip concatenations, a per-class logit head.

Parameters keep the JAX tree (``enc``, ``dec``, ``head``; conv weights
DHWIO, permuted to OIDHW at use). The public layout is JAX's, NCDHW, which
is also PyTorch's, so the convolutions run on it directly. ``"SAME"``
padding with a stride pads explicitly with XLA's (low, high) split
(``ops/resample.py pad_same``); the
upsampling is ``ops/resample.py resample_nd``, the half-pixel linear map
``jax.image.resize(..., "trilinear")`` computes when it enlarges; the
instance norm is ``F.instance_norm`` (biased variance, ``rsqrt(v + eps)``,
as ``_inorm``; it keeps no per-op intermediates for the backward, which
matters at the full patch); leaky ReLU is ``where(x >= 0, x, 0.01 x)``,
whose gradient at 0 is 1 as JAX's is (``F.leaky_relu``'s is the slope).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from ..ops.resample import pad_same, resample_nd
from ..params import Leaf, _init_tree


def _conv_spec(k, c_in, c_out):
    return {"w": Leaf((k, k, k, c_in, c_out), std=(2.0 / (k ** 3 * c_in)) ** 0.5, fp32=True),
            "b": Leaf((c_out,), "zeros", fp32=True)}


def _norm_spec(c):
    return {"scale": Leaf((c,), "ones", fp32=True), "bias": Leaf((c,), "zeros", fp32=True)}


def _block_spec(c_in, c_out):
    return {"conv1": _conv_spec(3, c_in, c_out), "n1": _norm_spec(c_out),
            "conv2": _conv_spec(3, c_out, c_out), "n2": _norm_spec(c_out)}


def unet_spec(in_channels: int, num_classes: int, channels=(16, 32, 64, 128)) -> dict:
    """The parameter tree of ``init_unet_params`` as ``params.Leaf``s (fp32)."""
    enc, dec = [], []
    c_prev = in_channels
    for c in channels:
        enc.append(_block_spec(c_prev, c))
        c_prev = c
    for i in range(len(channels) - 2, -1, -1):
        c_skip = channels[i]
        dec.append({"up": _conv_spec(1, c_prev, c_skip), "block": _block_spec(2 * c_skip, c_skip)})
        c_prev = c_skip
    return {"enc": enc, "dec": dec, "head": _conv_spec(1, c_prev, num_classes)}


def init_unet_params(in_channels: int, num_classes: int, channels=(16, 32, 64, 128),
                     seed: int = 0, device: str | torch.device = "cuda") -> dict:
    """Random parameters in the JAX tree's layout (the same initializers;
    another generator, so other values)."""
    return _init_tree(unet_spec(in_channels, num_classes, tuple(channels)), seed, torch.float32,
                      device)


def _conv(p, x, stride=1):
    x, pad = pad_same(x, p["w"].shape[:3], stride)
    return F.conv3d(x, p["w"].permute(4, 3, 0, 1, 2), p["b"], stride=stride, padding=pad)


def _leaky_relu(x):
    return torch.where(x >= 0, x, 0.01 * x)


def _block(p, x, stride=1):
    x = _conv(p["conv1"], x, stride)
    x = _leaky_relu(F.instance_norm(x, weight=p["n1"]["scale"], bias=p["n1"]["bias"], eps=1e-5))
    x = _conv(p["conv2"], x)
    return _leaky_relu(F.instance_norm(x, weight=p["n2"]["scale"], bias=p["n2"]["bias"],
                                       eps=1e-5))


def unet_forward(params, image: torch.Tensor) -> torch.Tensor:
    """image (B, C, D, H, W) -> logits (B, num_classes, D, H, W)."""
    x = image
    skips = []
    for i, p in enumerate(params["enc"]):
        x = _block(p, x, stride=1 if i == 0 else 2)
        skips.append(x)
    x = skips.pop()
    for p in params["dec"]:
        skip = skips.pop()
        x = resample_nd(_conv(p["up"], x), tuple(skip.shape[2:]))
        x = _block(p["block"], torch.cat([x, skip], dim=1))
    return _conv(params["head"], x)
