"""Exact linear-sum assignment for small square cost matrices, the port of
``mmmm_tpu/ops/hungarian.py hungarian``: every permutation of N <= 8 is
scored with one gather and one sum, and the first minimum is taken (as
``jnp.argmin``), batched over leading dims and with no host sync.
``lap_rectangular`` serves only the detector and is not ported yet."""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

_MAX_N = 8


@functools.lru_cache(maxsize=None)
def _permutation_table(n: int) -> np.ndarray:
    if n > _MAX_N:
        raise ValueError(f"hungarian: n={n} exceeds exact-enumeration limit {_MAX_N}")
    return np.array(list(itertools.permutations(range(n))), dtype=np.int64)


def hungarian(cost: torch.Tensor) -> torch.Tensor:
    """``col`` of shape (..., N) minimizing ``sum_i cost[..., i, col[i]]``
    for square (..., N, N) costs."""
    n = cost.shape[-1]
    if cost.shape[-2] != n:
        raise ValueError(f"hungarian expects square matrices, got {tuple(cost.shape)}")
    perms = torch.from_numpy(_permutation_table(n)).to(cost.device)  # (P, N)
    totals = cost[..., torch.arange(n, device=cost.device), perms].sum(-1)  # (..., P)
    return perms[totals.argmin(dim=-1)]
