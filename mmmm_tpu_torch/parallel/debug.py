"""Debug-mode consistency checks across the data-parallel processes, the
port of ``mmmm_tpu/parallel/debug.py`` (``check_batch_uniform``,
``assert_replicated_equal``).

Every process runs the same step on its own slice of the batch, so the
faults that remain sit at the host boundary: slices of other shapes,
samplers out of step, replicated state that drifts apart. The trainer runs
these under ``MMMM_DEBUG`` (``train/trainer.py``); each costs a collective a
leaf.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..params import _flatten
from .zero import ZeroLeaf, gather_dim


def check_batch_uniform(batch: dict, mesh, axis: str = "data", world_size: int = 1) -> None:
    """Raise if any array leaf's batch dimension does not split evenly over
    ``axis`` (``world_size`` scales a process-local leading dimension up to
    the global batch), or if the processes of ``axis`` hold slices of other
    leading dimensions (all-gathered)."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    dims = {}
    for name, leaf in _flatten(batch).items():
        if getattr(leaf, "ndim", 0) == 0:
            continue
        if (leaf.shape[0] * world_size) % n:
            raise ValueError(f"batch[{name}]: global leading dim {leaf.shape[0] * world_size} "
                             f"not divisible by {axis}={n}; ranks would receive unequal shards")
        dims[name] = int(leaf.shape[0])
    if n == 1:
        return
    seen = [None] * n
    dist.all_gather_object(seen, dims, group=mesh.get_group(axis))
    for r, other in enumerate(seen):
        if other != seen[0]:
            raise ValueError(f"batch leading dims differ between rank 0 {seen[0]} and rank {r} "
                             f"{other}; ranks would receive unequal shards")


def assert_replicated_equal(tree, mesh, axis: str = "data", atol: float = 0.0) -> None:
    """Raise if a replicated tensor of ``tree`` differs between the processes
    of ``axis`` by more than ``atol`` (a desync: optimizer state drifting
    apart, stray host randomness). Each leaf is all-gathered; ZeRO-sharded
    leaves are not replicated and are skipped."""
    n = mesh.size(mesh.mesh_dim_names.index(axis))
    group = mesh.get_group(axis)
    for name, x in _flatten(tree).items():
        if isinstance(x, ZeroLeaf) or not isinstance(x, torch.Tensor):
            continue
        g = gather_dim(x.detach().float()[None], 0, group, n)
        for r in range(1, n):
            if not torch.allclose(g[r], g[0], atol=atol, rtol=0):
                raise AssertionError(f"{name}: replicated value diverges between rank 0 and "
                                     f"rank {r}: max|d|={(g[r] - g[0]).abs().max().item()}")
