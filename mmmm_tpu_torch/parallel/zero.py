"""ZeRO-3 over the ``data`` axis, the port's own form of what XLA does for
the reference's ``fsdp_shardings`` ("all-gathers just-in-time per use",
``mmmm_tpu/parallel/sharding.py``).

A :class:`ZeroLeaf` stands for one parameter (or optimizer moment) whose
spec puts ``data`` on one dimension: this process holds only its
contiguous chunk of that dimension (``local``, the tensor that trains and
that Adam updates). It plugs in where the model takes a layer:

  - ``leaf[i]`` is layer ``i`` of a stacked ``(L, ...)`` leaf, still
    sharded (a view of ``local``; the layer dimension is never the sharded
    one), so ``params.layer`` hands a rematerialized layer its shards;
  - ``leaf.full()`` all-gathers the whole tensor over the ``data`` group;
    its backward reduce-scatters the gradient with SUM, so ``local``'s
    gradient is the sum over the processes of the gradients of their
    shares of the loss;
  - ``peft/lora.py materialize`` and ``LoraLeaf.merge`` call ``full()``
    inside the layer, so one layer's weights are whole at a time (under
    remat the backward gathers them again).

``leaf.to(dtype)`` casts after the gather (the one-process route's cast of
the whole tensor, bit for bit), and the cast's backward hands the
reduce-scatter the gradient in the master's dtype.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import fsdp_shardings

# ZeRO-3 shards every leaf of at least this many elements over the data axis
# (fsdp_shardings' min_size); read when a tree is placed
FSDP_MIN_SIZE = 1 << 16

# all_gather_into_tensor / reduce_scatter_tensor under their newer names
# where this torch has them (the older names warn there)
_all_gather = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


def gather_dim(local: torch.Tensor, dim: int, group, world: int) -> torch.Tensor:
    """``local`` of every process of ``group``, concatenated along ``dim``."""
    x = local.movedim(dim, 0).contiguous()
    out = x.new_empty((world * x.shape[0], *x.shape[1:]))
    _all_gather(out, x, group=group)
    return out.movedim(0, dim).contiguous()


def reduce_scatter_dim(full: torch.Tensor, dim: int, group, world: int) -> torch.Tensor:
    """This process's chunk along ``dim`` of the sum of ``full`` over ``group``."""
    x = full.movedim(dim, 0).contiguous()
    out = x.new_empty((x.shape[0] // world, *x.shape[1:]))
    _reduce_scatter(out, x, group=group)
    return out.movedim(0, dim).contiguous()


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, local, dim, group, world):
        ctx.dim, ctx.group, ctx.world = dim, group, world
        return gather_dim(local, dim, group, world)

    @staticmethod
    def backward(ctx, g):
        return reduce_scatter_dim(g, ctx.dim, ctx.group, ctx.world), None, None, None


class ZeroLeaf:
    """This process's chunk ``local`` of a tensor of shape ``shape`` sharded
    along dimension ``sdim`` over ``group`` (``world`` processes, this one ``rank``);
    ``cast`` is the dtype :meth:`full` returns (None: ``local``'s)."""

    def __init__(self, local: torch.Tensor, dim: int, shape: tuple, group, world: int,
                 rank: int, cast: torch.dtype | None = None):
        self.local, self.sdim, self.shape = local, dim, torch.Size(shape)
        self.group, self.world, self.rank, self.cast = group, world, rank, cast

    @property
    def dtype(self) -> torch.dtype:
        return self.cast or self.local.dtype

    @property
    def device(self) -> torch.device:
        return self.local.device

    def to(self, dtype: torch.dtype) -> "ZeroLeaf":
        return ZeroLeaf(self.local, self.sdim, self.shape, self.group, self.world, self.rank,
                        dtype)

    def __getitem__(self, i: int) -> "ZeroLeaf":
        if self.sdim == 0:
            raise ValueError("ZeroLeaf: the layer dimension is sharded; fsdp_shardings never "
                             "shards a stacked leaf's layer dimension")
        return ZeroLeaf(self.local[i], self.sdim - 1, self.shape[1:], self.group, self.world,
                        self.rank, self.cast)

    def full(self) -> torch.Tensor:
        """The whole tensor, gathered over the group (differentiable)."""
        out = _Gather.apply(self.local, self.sdim, self.group, self.world)
        return out if self.cast is None else out.to(self.cast)


def whole(x):
    """``x.full()`` for a :class:`ZeroLeaf`, ``x`` otherwise."""
    return x.full() if isinstance(x, ZeroLeaf) else x


def shard(t: torch.Tensor, spec: tuple, axis: str, group, world: int, rank: int):
    """``t`` as a :class:`ZeroLeaf` where ``spec`` puts ``axis`` on a
    dimension (a copy of this process's chunk, so ``t`` may be freed;
    ``requires_grad`` kept), else ``t``; a :class:`ZeroLeaf` passes."""
    if isinstance(t, ZeroLeaf) or axis not in spec:
        return t
    dim = spec.index(axis)
    k = t.shape[dim] // world
    local = t.detach().narrow(dim, rank * k, k).clone().requires_grad_(t.requires_grad)
    return ZeroLeaf(local, dim, t.shape, group, world, rank)


def shard_tree(tree, specs, axis: str, group, world: int, rank: int):
    """:func:`shard` over a tree of dicts and its matching tree of specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], axis, group, world, rank) for k, v in tree.items()}
    return shard(tree, specs, axis, group, world, rank) \
        if isinstance(tree, (torch.Tensor, ZeroLeaf)) else tree


def place_tree(tree, mesh, axis: str = "data"):
    """``tree`` placed by ``fsdp_shardings(tree, mesh, min_size=FSDP_MIN_SIZE)``:
    each leaf that the specs shard over ``axis`` becomes this process's
    :class:`ZeroLeaf` chunk (a :class:`ZeroLeaf` passes); the rest stay as
    they are (replicated)."""
    specs = fsdp_shardings(tree, mesh, axis=axis, min_size=FSDP_MIN_SIZE)
    return shard_tree(tree, specs, axis, mesh.get_group(axis), mesh.size(
        mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis))


@torch.no_grad()
def gather_tree(tree):
    """The tree with every :class:`ZeroLeaf` gathered whole (outside
    autograd; every process of the group must call it)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return tree.full() if isinstance(tree, ZeroLeaf) else tree


def local_tensor(x):
    """The tensor this process holds of ``x``: a :class:`ZeroLeaf`'s chunk,
    or ``x``."""
    return x.local if isinstance(x, ZeroLeaf) else x


def gather_unstacked(tree):
    """Every :class:`ZeroLeaf` outside a stacked ``layers`` subtree gathered
    whole, for the model functions that use such leaves directly; the
    stacked ones stay sharded for ``params.layer``."""
    if isinstance(tree, dict):
        return {k: v if k == "layers" else gather_unstacked(v) for k, v in tree.items()}
    return whole(tree)
