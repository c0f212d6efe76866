"""Exact GELU with the reference's dtype dispatch, the port of
``mmmm_tpu/ops/gelu.py``: bf16 goes to the fitted tanh-form polynomial
(fp32 internal math, one final rounding), every other dtype to erf GELU.
The ``MMMM_GELU`` overrides of the JAX package are not ported."""
from __future__ import annotations

import torch
import torch.nn.functional as F

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


def gelu(x: torch.Tensor) -> torch.Tensor:
    """bf16 -> :func:`gelu_fitted`; other dtypes -> exact erf GELU."""
    if x.dtype == torch.bfloat16:
        return gelu_fitted(x)
    return F.gelu(x, approximate="none")
