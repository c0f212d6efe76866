"""Parameter and batch sharding rules, the port of
``mmmm_tpu/parallel/sharding.py`` (``DEFAULT_RULES``, ``PartitionRules``,
``param_shardings``, ``fsdp_shardings``, ``bytes_per_device``,
``batch_shardings``).

A spec is what the reference's ``PartitionSpec`` holds: a tuple with one
entry a dimension (or fewer, trailing dimensions unsharded), each entry a
mesh axis name or None. The rules are pure functions of a leaf's
``/``-joined path, its shape and the mesh's axis sizes, so ``mesh`` may be
a ``DeviceMesh`` (``parallel/mesh.py make_mesh``) or a mapping of axis name
to size: the specs of a mesh of 8 come out without 8 processes.

  - column-parallel: the qkv and MLP-up projections shard the output
    feature dimension over ``model``;
  - row-parallel: the attention dense and MLP-down projections shard the
    input feature dimension;
  - ``lm_head`` over the vocabulary; embeddings replicated;
  - SAM, iSAM and ``vg_proj`` replicated;
  - the batch dimension of every input array over ``data``.

``fsdp_shardings`` adds ZeRO-3 over ``data`` (and over ``pipe``) on top.
The port runs the ``data`` axis (``parallel/zero.py``, ``train/step.py``);
``model``, ``seq`` and ``pipe`` above 1 wait for ROADMAP Queue 1 items 8b
and 8c, and their rules are here so that they are held to the reference's.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping

import torch

from ..params import _flatten

Spec = tuple

# Stacked-layer weights carry a leading L axis, hence the leading None. LoRA
# factors ("<path>/a" and "<path>/b"): the "b" factor of a column-parallel
# weight shards its output dimension, the "a" factor of a row-parallel weight
# its input dimension.
DEFAULT_RULES: tuple[tuple[str, Spec], ...] = (
    # LLM dual-expert attention
    (r".*llm/layers/(vis|lang)_qkv$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_qkv/a$", (None, None, None)),
    (r".*llm/layers/(vis|lang)_qkv/b$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_dense$", (None, "model", None)),
    (r".*llm/layers/(vis|lang)_dense/a$", (None, "model", None)),
    (r".*llm/layers/(vis|lang)_dense/b$", (None, None, None)),
    # LLM dual-expert MLP
    (r".*llm/layers/(vis|lang)_mlp/(gate|up)$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_mlp/(gate|up)/a$", (None, None, None)),
    (r".*llm/layers/(vis|lang)_mlp/(gate|up)/b$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_mlp/down$", (None, "model", None)),
    (r".*llm/layers/(vis|lang)_mlp/down/a$", (None, "model", None)),
    (r".*llm/layers/(vis|lang)_mlp/down/b$", (None, None, None)),
    # W8A16 serving leaves ({"q", "s"} from quantize_llm_for_serving): the
    # int8 tensor shards as its bf16 original; the per-output-channel scales
    # (..., 1, out) follow column-parallel output dimensions and replicate for
    # row-parallel weights (_fit_spec drops the size-1 contraction entry)
    (r".*llm/layers/(vis|lang)_qkv/(q|s)$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_dense/q$", (None, "model", None)),
    (r".*llm/layers/(vis|lang)_mlp/(gate|up)/(q|s)$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_mlp/down/q$", (None, "model", None)),
    # LM head over the vocabulary
    (r".*llm/lm_head$", (None, "model")),
    (r".*llm/lm_head/b$", (None, "model")),
    (r".*llm/lm_head/(q|s)$", (None, "model")),
    # ViT
    (r".*vision/layers/(qkv_w|fc1_w)$", (None, None, "model")),
    (r".*vision/layers/(qkv_b|fc1_b)$", (None, "model")),
    (r".*vision/layers/(qkv_w|fc1_w)/b$", (None, None, "model")),
    (r".*vision/layers/(dense_w|fc2_w)$", (None, "model", None)),
    (r".*vision/layers/(dense_w|fc2_w)/a$", (None, "model", None)),
    (r".*vision/glu/(gate|h4h)$", (None, "model")),
    (r".*vision/glu/(gate|h4h)/b$", (None, "model")),
    (r".*vision/glu/4hh$", ("model", None)),
    (r".*vision/glu/4hh/a$", ("model", None)),
)


@dataclasses.dataclass(frozen=True)
class PartitionRules:
    rules: tuple[tuple[str, Spec], ...] = DEFAULT_RULES

    def spec_for(self, path: str, ndim: int) -> Spec:
        for pat, spec in self.rules:
            if re.match(pat, path) and len(spec) <= ndim:
                return spec
        return ()  # replicate


def axis_sizes(mesh) -> dict[str, int]:
    """``{axis name: size}`` of a ``DeviceMesh`` or of a mapping."""
    if isinstance(mesh, Mapping):
        return dict(mesh)
    return dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))


def _shape(leaf) -> tuple[int, ...]:
    return tuple(getattr(leaf, "shape", ()))


def _fit_spec(spec: Spec, shape, sizes: dict) -> Spec:
    """Replicate any entry whose dimension the mesh axis does not divide (an
    odd vocabulary over ``model``) and any entry on an axis of size 1 (it
    shards nothing, and would keep ZeRO from using the dimension); trailing
    Nones dropped."""
    out = list(spec) + [None] * (len(shape) - len(spec))
    for d, axis in enumerate(out):
        if axis is not None and (shape[d] % sizes[axis] or sizes[axis] == 1):
            out[d] = None
    while out and out[-1] is None:
        out.pop()
    return tuple(out)


def _is_stacked(path: str) -> bool:
    return re.search(r"/layers/", "/" + path + "/") is not None


def _pipe_spec(spec: Spec, path: str, shape, sizes: dict) -> Spec:
    """Stage the stacked LLM decoder layers over ``pipe``: their leading (L)
    dimension is the pipeline-stage dimension."""
    if sizes.get("pipe", 1) == 1:
        return spec
    if (re.search(r"llm/layers/", "/" + path + "/") and shape
            and shape[0] % sizes["pipe"] == 0):
        out = list(spec) + [None] * (len(shape) - len(spec))
        if out[0] is None:
            out[0] = "pipe"
        return tuple(out)
    return spec


def _base_spec(path: str, shape, sizes: dict, rules: PartitionRules) -> Spec:
    return _pipe_spec(_fit_spec(rules.spec_for(path, len(shape)), shape, sizes),
                      path, shape, sizes)


def _map_paths(fn, tree, prefix: str = ""):
    """``fn(path, leaf)`` over a tree of dicts and lists, structure kept."""
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, f"{prefix}{k}/") for k, v in tree.items()}
    if isinstance(tree, list):
        return [_map_paths(fn, v, f"{prefix}{i}/") for i, v in enumerate(tree)]
    return fn(prefix[:-1], tree)


def param_shardings(tree, mesh, rules: PartitionRules = PartitionRules()):
    """The spec of every leaf of ``tree`` (parameters, LoRA factors,
    optimizer moments), the tree's structure kept."""
    sizes = axis_sizes(mesh)
    return _map_paths(lambda path, leaf: _base_spec(path, _shape(leaf), sizes, rules), tree)


def _zero_dim(spec: list, path: str, shape, n: int) -> int | None:
    """The largest dimension that is unsharded, divisible by ``n`` and not a
    stacked leaf's layer dimension (a step slices that one every layer)."""
    stacked = _is_stacked(path)
    cand = [d for d in range(len(shape))
            if spec[d] is None and shape[d] % n == 0 and not (stacked and d == 0)]
    return max(cand, key=lambda d: shape[d]) if cand else None


def fsdp_shardings(tree, mesh, rules: PartitionRules = PartitionRules(), axis: str = "data",
                   min_size: int = 1 << 16):
    """The TP spec plus ZeRO-3 over ``axis``: every leaf of at least
    ``min_size`` elements shards its largest free dimension
    (:func:`_zero_dim`) over ``axis`` as well; with a ``pipe`` axis above 1,
    a leaf the pipeline does not stage also shards one over ``pipe``. The
    specs have one entry a dimension. Small leaves keep the TP spec."""
    sizes = axis_sizes(mesh)
    n = sizes[axis]

    def one(path, leaf):
        shape = _shape(leaf)
        base = _base_spec(path, shape, sizes, rules)
        spec = list(base) + [None] * (len(shape) - len(base))
        size = math.prod(shape) if shape else 0
        if n > 1 and size >= min_size and shape:
            d = _zero_dim(spec, path, shape, n)
            if d is not None:
                spec[d] = axis
        npipe = sizes.get("pipe", 1)
        if npipe > 1 and "pipe" not in spec and size >= min_size and shape:
            d = _zero_dim(spec, path, shape, npipe)
            if d is not None:
                spec[d] = "pipe"
        return tuple(spec)

    return _map_paths(one, tree)


def bytes_per_device(tree, shardings, mesh) -> int:
    """Bytes of ``tree`` (tensors, or anything with ``shape`` and a torch
    ``dtype``) a device holds under ``shardings``, the matching tree of
    specs: the memory-fit estimate for the flagship's configs."""
    sizes = axis_sizes(mesh)
    specs = _flatten(shardings)
    total = 0
    for path, leaf in _flatten(tree).items():
        shape = _shape(leaf)
        nbytes = math.prod(shape) * torch.empty((), dtype=leaf.dtype).element_size()
        total += nbytes // math.prod(sizes[a] for a in specs[path] if a is not None)
    return total


def batch_shardings(batch, mesh):
    """The leading (batch) dimension of every array leaf over ``data``."""
    def spec(path, leaf):
        ndim = len(_shape(leaf))
        return () if ndim == 0 else ("data", *([None] * (ndim - 1)))

    return _map_paths(spec, batch)
