"""Tensor parallelism over the mesh's ``model`` axis: the collectives that
the model functions call (Megatron's ``f`` and ``g``) and the
vocabulary-parallel argmax.

The reference gets tensor parallelism from GSPMD: its parameters carry
their shardings and XLA inserts the collectives. Here every process runs
its own share of each layer, with whole heads (``sharding.py
local_params``), and calls these collectives where a share ends:

  - :func:`copy_to_model` at the entry of a column-parallel branch
    (the qkv and MLP-up products, the ``lm_head``): the identity forward,
    an all-reduce of the gradient backward;
  - :func:`reduce_from_model` after a row-parallel product (the
    attention dense and MLP-down products): an all-reduce forward, the
    identity backward;
  - :func:`vocab_argmax` over ``lm_head`` logits cut over the vocabulary.

The group is one process-wide value (:func:`model_parallel`, as
``ops/numerics.py``'s switches are: the backward of a rematerialized layer
recomputes it on the autograd engine's thread). With no group, or a group
of one process, every function here is the identity and
:func:`vocab_argmax` is ``torch.argmax``, bit for bit.
"""
from __future__ import annotations

import contextlib

import torch
import torch.distributed as dist

_STATE: dict = {"group": None}


def set_model_group(group) -> None:
    """Make ``group`` (a process group over the ``model`` axis, or None) the
    process's model group, for as long as its pieces serve
    (``sharding.tp_serving_params``)."""
    _STATE["group"] = group if group is not None and dist.get_world_size(group) > 1 else None


def model_group():
    """The model group, or None without tensor parallelism."""
    return _STATE["group"]


@contextlib.contextmanager
def model_parallel(group):
    """``group`` is the model group for the body (one training step)."""
    before = _STATE["group"]
    set_model_group(group)
    try:
        yield
    finally:
        _STATE["group"] = before


def model_world() -> int:
    group = _STATE["group"]
    return 1 if group is None else dist.get_world_size(group)


def model_rank() -> int:
    group = _STATE["group"]
    return 0 if group is None else dist.get_rank(group)


def local_count(total: int, what: str) -> int:
    """``total`` (heads, vocabulary) over the model group's processes; raises
    where they do not divide it."""
    n = model_world()
    if total % n:
        raise ValueError(f"tensor parallelism over {n} processes does not divide {total} {what}")
    return total // n


def check_local(local: int, total: int, where: str) -> None:
    """Raise unless ``local`` (heads or columns, read from a layer's weight)
    is this process's share of ``total``: the parameters must be the pieces
    of ``local_params`` for the current model group, or whole without one."""
    n = model_world()
    if local * n != total:
        raise ValueError(
            f"{where}: the weights hold {local} of {total} under a model group of {n} "
            "processes; tensor-parallel pieces (parallel/sharding.py local_params) need the "
            "model group that cut them (model_parallel / set_model_group), whole weights none")


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=group)
        return x

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor) -> torch.Tensor:
    """The identity; its gradient is summed over the model group (the input
    of a column-parallel branch, whose processes each add a share)."""
    group = _STATE["group"]
    return x if group is None else _CopyToModel.apply(x, group)


def reduce_from_model(x: torch.Tensor) -> torch.Tensor:
    """The sum over the model group of each process's partial ``x`` (the
    output of a row-parallel product); its gradient passes unchanged."""
    group = _STATE["group"]
    return x if group is None else _ReduceFromModel.apply(x, group)


def vocab_argmax(logits: torch.Tensor) -> torch.Tensor:
    """``torch.argmax(logits, dim=-1)`` of the whole vocabulary, given this
    process's contiguous piece of it (process ``r`` holds columns ``[r V/n,
    (r + 1) V/n)``). The winner is the largest value and, among equal
    values, the lowest global index, ``torch.argmax``'s and
    ``jnp.argmax``'s rule: two all-reduces (the maximum, then the least
    index that holds it). Returns int64 indices."""
    group = _STATE["group"]
    if group is None:
        return torch.argmax(logits, dim=-1)
    width = logits.shape[-1]
    idx = torch.argmax(logits, dim=-1)  # the first index of the local maximum
    best = logits.gather(-1, idx[..., None])[..., 0]
    top = best.clone()
    dist.all_reduce(top, op=dist.ReduceOp.MAX, group=group)
    idx = idx + dist.get_rank(group) * width
    cand = torch.where(best == top, idx, torch.full_like(idx, torch.iinfo(torch.int64).max))
    dist.all_reduce(cand, op=dist.ReduceOp.MIN, group=group)
    return cand
