"""Exact GELU with the reference's dtype dispatch and its overrides, the port
of ``mmmm_tpu/ops/gelu.py``. The mode is ``ops/numerics.py``'s
``gelu_mode`` (the reference's ``MMMM_GELU``, ``MMMM_FAST_GELU=1`` being
its legacy alias of ``"tanh"``):

  - ``"auto"`` (the default): bf16 goes to the fitted tanh-form polynomial
    (fp32 internal math, one final rounding), every other dtype to erf GELU;
  - ``"fitted"``: the polynomial for every dtype;
  - ``"tanh"``: the tanh approximation (``jax.nn.gelu(approximate=True)``);
  - ``"erf"``: erf GELU for every dtype.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .numerics import current

# Degree-15 odd minimax fit of artanh(erf(x / sqrt(2))) on [0, 5]; the same
# float32 coefficients as mmmm_tpu/ops/gelu.py.
_C = (
    7.978606636e-01,
    3.637051076e-02,
    -4.755116162e-05,
    -5.336581080e-05,
    3.976416616e-06,
    -1.522087727e-07,
    3.107470242e-09,
    -2.664015293e-11,
)
_CLAMP = 5.0


def gelu_fitted(x: torch.Tensor) -> torch.Tensor:
    """x * sigmoid(2 u(x)) with u the fitted polynomial; 0 below -5."""
    xf = x.float()
    xc = xf.clamp(-_CLAMP, _CLAMP)
    x2 = xc * xc
    u = torch.full_like(x2, _C[-1])
    for c in _C[-2::-1]:
        u = c + x2 * u
    u = xc * u
    out = xf * torch.sigmoid(2.0 * u)
    out = torch.where(xf < -_CLAMP, 0.0, out)
    return out.to(x.dtype)


def gelu(x: torch.Tensor, mode: str | None = None) -> torch.Tensor:
    """GELU under ``mode`` (by default the running call's ``gelu_mode``)."""
    mode = current().gelu_mode if mode is None else mode
    if mode == "tanh":
        return F.gelu(x, approximate="tanh")
    if mode == "fitted" or (mode == "auto" and x.dtype == torch.bfloat16):
        return gelu_fitted(x)
    if mode not in ("auto", "erf"):
        raise ValueError(f"unknown gelu mode {mode!r}")
    return F.gelu(x, approximate="none")
