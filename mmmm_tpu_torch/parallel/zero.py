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

Over a ``pipe`` axis above 1 (``fsdp_shardings``' pipe entries) a
:class:`PipeLeaf` holds this process's chunk of a leaf over the ``pipe``
group, itself a tensor or a :class:`ZeroLeaf` over ``data``:

  - a staged leaf (the LLM's stacked decoder layers, cut on their layer
    dimension) holds this stage's contiguous layers; ``leaf[i]`` is layer
    ``i`` of the whole stack, which must be one of them, and
    :meth:`PipeLeaf.gathered` (the route where the pipeline cannot run)
    gathers every stage's layers;
  - an unstaged leaf large enough for ZeRO is cut on another dimension;
    :meth:`PipeLeaf.full` gathers it.

Every ``pipe`` process computes the same gradient for what it gathers (the
activations are replicated over ``pipe`` outside the stages), so the
gather's backward takes this process's chunk and sums nothing: a
reduce-scatter would multiply the gradient by the stage count.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .sharding import axis_sizes, fsdp_shardings, local_params

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


class _PipeGather(torch.autograd.Function):
    """Gather over the ``pipe`` group; the backward takes this process's
    chunk of a gradient that every process of the group holds whole."""

    @staticmethod
    def forward(ctx, local, dim, group, world, rank):
        ctx.dim, ctx.rank, ctx.size = dim, rank, local.shape[dim]
        return gather_dim(local, dim, group, world)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(ctx.dim, ctx.rank * ctx.size, ctx.size), None, None, None, None


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


class PipeLeaf:
    """This process's chunk ``inner`` (a tensor, or a :class:`ZeroLeaf` of
    the chunk over ``data``) of a tensor of shape ``shape`` cut along
    dimension ``dim`` over the ``pipe`` ``group`` (``world`` stages, this
    one ``rank``); ``dim`` 0 of a stacked leaf is a stage's layers."""

    def __init__(self, inner, dim: int, shape: tuple, group, world: int, rank: int):
        self.inner, self.pdim, self.shape = inner, dim, torch.Size(shape)
        self.group, self.world, self.rank = group, world, rank

    @property
    def staged(self) -> bool:
        return self.pdim == 0

    @property
    def first(self) -> int:
        """The index along ``dim`` of this process's first row."""
        return self.rank * (self.shape[self.pdim] // self.world)

    @property
    def local(self) -> torch.Tensor:
        return local_tensor(self.inner)

    @property
    def dtype(self) -> torch.dtype:
        return self.inner.dtype

    @property
    def device(self) -> torch.device:
        return self.inner.device

    def _like(self, inner, dim: int, shape) -> "PipeLeaf":
        return PipeLeaf(inner, dim, shape, self.group, self.world, self.rank)

    def to(self, dtype: torch.dtype) -> "PipeLeaf":
        return self._like(self.inner.to(dtype), self.pdim, self.shape)

    def __getitem__(self, i: int):
        if self.staged:
            k = self.shape[0] // self.world
            if not self.first <= i < self.first + k:
                raise IndexError(f"PipeLeaf: layer {i} is not on stage {self.rank} (layers "
                                 f"{self.first}-{self.first + k - 1})")
            return self.inner[i - self.first]
        return self._like(self.inner[i], self.pdim - 1, self.shape[1:])

    def gathered(self):
        """The leaf gathered over ``pipe`` along its cut (differentiable),
        still a :class:`ZeroLeaf` over ``data`` where ``inner`` is one."""
        if isinstance(self.inner, ZeroLeaf):
            z = self.inner
            local = _PipeGather.apply(z.local, self.pdim, self.group, self.world, self.rank)
            return ZeroLeaf(local, z.sdim, self.shape, z.group, z.world, z.rank, z.cast)
        return _PipeGather.apply(self.inner, self.pdim, self.group, self.world, self.rank)

    def full(self) -> torch.Tensor:
        """The whole tensor, gathered over ``data`` and ``pipe``."""
        return whole(self.gathered())


def whole(x):
    """``x.full()`` for a :class:`ZeroLeaf` or :class:`PipeLeaf`, ``x``
    otherwise."""
    return x.full() if isinstance(x, (ZeroLeaf, PipeLeaf)) else x


def shard(t: torch.Tensor, spec: tuple, axis: str, group, world: int, rank: int):
    """``t`` as a :class:`ZeroLeaf` where ``spec`` puts ``axis`` on a
    dimension (a copy of this process's chunk, so ``t`` may be freed;
    ``requires_grad`` kept), else ``t``; a :class:`ZeroLeaf` passes."""
    if isinstance(t, (ZeroLeaf, PipeLeaf)) or axis not in spec:
        return t
    dim = spec.index(axis)
    k = t.shape[dim] // world
    local = t.detach().narrow(dim, rank * k, k).clone().requires_grad_(t.requires_grad)
    return ZeroLeaf(local, dim, t.shape, group, world, rank)


def shard_pipe(t: torch.Tensor, spec: tuple, axis: str, data: tuple, pipe: tuple | None):
    """``t`` placed by ``spec`` over ``pipe`` and ``axis``, each ``(group,
    world, rank)`` (``pipe`` None: no pipe axis): a :class:`PipeLeaf` of
    this stage's chunk where ``spec`` puts ``pipe`` on a dimension (the
    chunk then cut over ``axis`` by :func:`shard`), else :func:`shard`."""
    if isinstance(t, (ZeroLeaf, PipeLeaf)) or pipe is None or "pipe" not in spec:
        return shard(t, spec, axis, *data)
    dim = spec.index("pipe")
    group, world, rank = pipe
    k = t.shape[dim] // world
    chunk = t.detach().narrow(dim, rank * k, k).clone().requires_grad_(t.requires_grad)
    return PipeLeaf(shard(chunk, spec, axis, *data), dim, t.shape, group, world, rank)


def shard_tree(tree, specs, axis: str, data: tuple, pipe: tuple | None = None):
    """:func:`shard_pipe` over a tree of dicts and its matching tree of
    specs."""
    if isinstance(tree, dict):
        return {k: shard_tree(v, specs[k], axis, data, pipe) for k, v in tree.items()}
    return shard_pipe(tree, specs, axis, data, pipe) \
        if isinstance(tree, (torch.Tensor, ZeroLeaf, PipeLeaf)) else tree


def _axis(mesh, axis: str) -> tuple | None:
    """``(group, size, rank)`` of a mesh axis, None where the mesh lacks it."""
    if axis not in mesh.mesh_dim_names:
        return None
    return (mesh.get_group(axis), mesh.size(mesh.mesh_dim_names.index(axis)),
            mesh.get_local_rank(axis))


def place_tree(tree, mesh, axis: str = "data"):
    """``tree`` placed by ``fsdp_shardings(tree, mesh, min_size=FSDP_MIN_SIZE)``
    (the specs of the whole leaves): with a ``model`` axis above 1 each leaf
    is first cut to this process's tensor-parallel piece
    (``sharding.local_params``); with a ``pipe`` axis above 1 each leaf
    that the specs cut over ``pipe`` becomes a :class:`PipeLeaf` of this
    stage's chunk; then each leaf (or chunk) that the specs shard over
    ``axis`` becomes this process's :class:`ZeroLeaf` chunk of it (placed
    leaves pass); the rest stay as they are (replicated)."""
    specs = fsdp_shardings(tree, mesh, axis=axis, min_size=FSDP_MIN_SIZE)
    if axis_sizes(mesh).get("model", 1) > 1:
        tree = local_params(tree, mesh)
    pipe = _axis(mesh, "pipe")
    return shard_tree(tree, specs, axis, _axis(mesh, axis),
                      pipe if pipe and pipe[1] > 1 else None)


@torch.no_grad()
def gather_tree(tree):
    """The tree with every :class:`ZeroLeaf` gathered whole (outside
    autograd; every process of the group must call it)."""
    if isinstance(tree, dict):
        return {k: gather_tree(v) for k, v in tree.items()}
    return whole(tree)


def local_tensor(x):
    """The tensor this process holds of ``x``: a :class:`ZeroLeaf`'s or
    :class:`PipeLeaf`'s chunk, or ``x``."""
    return x.local if isinstance(x, (ZeroLeaf, PipeLeaf)) else x


def data_cut(x) -> bool:
    """Whether ``x`` is cut over ``data`` (its gradient is then this
    process's chunk of the sum over the group)."""
    return isinstance(x, ZeroLeaf) or (isinstance(x, PipeLeaf) and isinstance(x.inner, ZeroLeaf))


def gather_unstacked(tree):
    """Every :class:`ZeroLeaf` outside a stacked ``layers`` subtree gathered
    whole, for the model functions that use such leaves directly; the
    stacked ones stay sharded for ``params.layer``."""
    if isinstance(tree, dict):
        return {k: v if k == "layers" else gather_unstacked(v) for k, v in tree.items()}
    return whole(tree)
