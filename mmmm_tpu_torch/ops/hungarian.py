"""Exact linear-sum assignment, the port of ``mmmm_tpu/ops/hungarian.py``.

``hungarian`` (square N <= 8, the instance matcher): every permutation is
scored with one gather and one sum, and the first minimum is taken (as
``jnp.argmin``), batched over leading dims and with no host sync.

``lap_rectangular`` ((..., K, Q) with K <= Q, the detector's matcher): the
Jonker-Volgenant shortest augmenting path of ``lap_rectangular`` (:44), in
its order of arithmetic. CPU tensors take ``lap_rectangular_plain``, batched
over the leading dims as JAX's ``vmap`` is (finished problems are masked);
CUDA tensors launch the kernel LAP (``csrc/lap.cu``), one block a problem
and every problem in one launch, bit-equal to the plain version.
"""
from __future__ import annotations

import functools
import itertools

import numpy as np
import torch

from . import _cuda

_MAX_N = 8

LAP = _cuda.register(_cuda.Kernel(
    "LAP", "mmmm_lap", [_cuda.P, _cuda.P, _cuda.I, _cuda.I, _cuda.I, _cuda.P],
    source="mmmm_tpu_torch/csrc/lap.cu",
    replaces="mmmm_tpu/ops/hungarian.py:44 lap_rectangular (lax.while_loop under jit; "
             "no pallas_call)",
))


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


def lap_rectangular_plain(cost: torch.Tensor) -> torch.Tensor:
    """The plain version of :func:`lap_rectangular`: ``col4row`` (..., K)
    int64. fp32 throughout; the reduced cost is ``min_val + cost[i] - u[i]
    - v``, left to right; ``argmin`` takes the first minimum; the dual
    update of the scanned rows reads ``col4row`` before the augment."""
    *lead, k, q = cost.shape
    c = cost.detach().reshape(-1, k, q).float()
    n, dev = c.shape[0], c.device
    big = torch.finfo(torch.float32).max
    ar = torch.arange(n, device=dev)
    rows = torch.arange(k, device=dev)
    u = torch.zeros(n, k, device=dev)
    v = torch.zeros(n, q, device=dev)
    col4row = torch.full((n, k), -1, dtype=torch.long, device=dev)
    row4col = torch.full((n, q), -1, dtype=torch.long, device=dev)
    for cur in range(k):
        i = torch.full((n,), cur, dtype=torch.long, device=dev)
        min_val = torch.zeros(n, device=dev)
        shortest = torch.full((n, q), big, device=dev)
        path = torch.full((n, q), -1, dtype=torch.long, device=dev)
        sink = torch.full((n,), -1, dtype=torch.long, device=dev)
        sr = torch.zeros(n, k, dtype=torch.bool, device=dev)
        sc = torch.zeros(n, q, dtype=torch.bool, device=dev)
        while True:
            act = sink < 0
            if not bool(act.any()):
                break
            sr = sr | (act[:, None] & (rows[None] == i[:, None]))
            reduced = min_val[:, None] + c[ar, i] - u[ar, i][:, None] - v
            better = act[:, None] & ~sc & (reduced < shortest)
            shortest = torch.where(better, reduced, shortest)
            path = torch.where(better, i[:, None], path)
            masked = torch.where(sc, big, shortest)
            j = masked.argmin(-1)
            min_val = torch.where(act, masked[ar, j], min_val)
            sc = sc | (act[:, None] & (torch.arange(q, device=dev)[None] == j[:, None]))
            nxt = row4col[ar, j]
            sink = torch.where(act, torch.where(nxt < 0, j, -1), sink)
            i = torch.where(act, nxt.clamp(min=0), i)
        # dual updates (scipy _lsap semantics)
        u[:, cur] += min_val
        other = sr & (rows[None] != cur)
        u = u + torch.where(other, min_val[:, None] - shortest.gather(1, col4row.clamp(min=0)),
                            0.0)
        v = v + torch.where(sc, shortest - min_val[:, None], 0.0)
        # augment: walk predecessors back from the sink
        j, done = sink, torch.zeros(n, dtype=torch.bool, device=dev)
        while not bool(done.all()):
            live = ~done
            i = path[ar, j]
            row4col[ar[live], j[live]] = i[live]
            jnext = col4row[ar, i.clamp(min=0)]
            col4row[ar[live], i[live]] = j[live]
            done = done | (i == cur)
            j = torch.where(live, jnext, j)
    return col4row.reshape(*lead, k)


def lap_rectangular(cost: torch.Tensor) -> torch.Tensor:
    """Exact rectangular linear-sum assignment of (..., K, Q) costs, K <= Q:
    ``col4row`` (..., K) int64 minimizing each problem's summed cost (as
    ``scipy.optimize.linear_sum_assignment(cost)[1]``). No gradient flows.
    CPU tensors take the plain version; CUDA tensors launch LAP once."""
    *lead, k, q = cost.shape
    if k > q:
        raise ValueError(f"lap_rectangular expects K <= Q, got {tuple(cost.shape)}")
    if _cuda.on_cpu("lap_rectangular", cost):
        return lap_rectangular_plain(cost)
    c = cost.detach().reshape(-1, k, q).float().contiguous()
    out = torch.empty(c.shape[0], k, dtype=torch.int32, device=c.device)
    _cuda.check_cuda("lap_rectangular", c, out)
    LAP(c.data_ptr(), out.data_ptr(), c.shape[0], k, q, _cuda.stream_of(c))
    return out.long().reshape(*lead, k)
