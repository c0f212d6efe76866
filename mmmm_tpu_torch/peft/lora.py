"""LoRA as a parameter-tree transformation, the port of
``mmmm_tpu/peft/lora.py``.

``lora_init`` makes ``{"a": (.., in, r), "b": (.., r, out)}`` factors for
every targeted weight (``b`` zero, so step 0 is the base model);
``split_trainable`` / ``merge_trainable`` partition the tree into the
fully finetuned subset and the frozen rest. The scale is ``alpha / r``, or
``alpha / sqrt(r)`` with rsLoRA.

``lora_merge`` keeps the reference's arithmetic, ``w + ((a @ b) * scale)
cast to w's dtype`` with the product in the factors' fp32, but returns each
targeted weight as a :class:`LoraLeaf` that merges where it is used: the
model functions call :func:`materialize` on one layer's parameters inside
the rematerialized layer, so a layer's merged weights live only while that
layer runs (forward, then again in its backward). The reference merges the
whole tree before the forward; under autograd that keeps a second copy of
every targeted weight alive until the backward, ~35 GB at the flagship,
which does not fit one 80 GB card beside the frozen base. The numbers are
the same.

LoRA dropout zeroes fan-in rows of ``a`` with probability ``p`` and scales
by ``1/(1-p)``. Each leaf's mask comes from a generator seeded by
``(dropout_seed, step, index of the leaf in sorted path order)``, as the
reference folds the leaf index into the step's key; a seeded mask, not a
stateful draw, keeps a recomputed layer identical. The bits differ from
JAX's. Under tensor parallelism (``parallel/tensor.py``) a factor ``a``
cut over ``model`` takes its piece of the whole leaf's mask, so that every
number of processes draws the same masks.
"""
from __future__ import annotations

import dataclasses
import hashlib
import math
import re

import torch

from ..parallel.sharding import PartitionRules
from ..parallel.tensor import model_rank, model_world
from ..parallel.zero import whole
from ..params import _flatten as flatten
from ..params import _unflatten as unflatten

# modules fully finetuned rather than LoRA'd (SAM, iSAM, vg_proj, and the
# resized token embeddings)
FINETUNE_PATH_PREFIXES = ("sam", "isam", "vg_proj", "cogvlm/llm/embed_tokens")

_TARGETS = (  # a pattern string: re.match caches its compiled form
    r"cogvlm/(llm/layers/(vis|lang)_(qkv|dense)"
    r"|llm/layers/(vis|lang)_mlp/(gate|up|down)"
    r"|llm/lm_head"
    r"|vision/layers/(qkv_w|dense_w|fc1_w|fc2_w)"
    r"|vision/glu/(linear_proj|gate|h4h|4hh))$"
)


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    r: int = 64
    alpha: float = 8.0
    use_rslora: bool = True
    dropout: float = 0.05  # LoRA-branch input dropout

    @property
    def scale(self) -> float:
        return self.alpha / math.sqrt(self.r) if self.use_rslora else self.alpha / self.r


class LoraLeaf:
    """A targeted weight and its factors, merged on :meth:`merge`.

    ``keep`` is the dropout mask of ``a``'s fan-in rows (``(.., in, 1)``
    bool) or None, made over the whole leaf's shape where ``a`` is sharded.
    Indexing takes one layer of stacked leaves, as ``params.layer`` does
    for tensors; the parts may be ZeRO-sharded (``parallel/zero.py``) and
    are gathered on :meth:`merge`."""

    def __init__(self, base, a, b, scale: float, keep=None, p: float = 0.0):
        self.base, self.a, self.b, self.scale, self.keep, self.p = base, a, b, scale, keep, p

    def __getitem__(self, i):
        keep = None if self.keep is None else self.keep[i]
        return LoraLeaf(self.base[i], self.a[i], self.b[i], self.scale, keep, self.p)

    def map_parts(self, fn) -> "LoraLeaf":
        """The leaf with ``fn`` applied to its weight and factors."""
        return LoraLeaf(fn(self.base), fn(self.a), fn(self.b), self.scale, self.keep, self.p)

    def merge(self) -> torch.Tensor:
        base, a, b = whole(self.base), whole(self.a), whole(self.b)
        if self.keep is not None:
            a = a * self.keep.to(a.dtype) / (1.0 - self.p)
        delta = torch.matmul(a, b) * self.scale
        return base + delta.to(base.dtype)


def materialize(tree):
    """The tree with every :class:`LoraLeaf` merged and every ZeRO-sharded
    leaf (``parallel/zero.py``) gathered whole; tensors pass through."""
    if isinstance(tree, dict):
        return {k: materialize(v) for k, v in tree.items()}
    return tree.merge() if isinstance(tree, LoraLeaf) else whole(tree)


def default_lora_targets(params: dict) -> list[str]:
    """Paths of the CogVLM weight matrices to factorize: every linear weight
    of the LLM and ViT, the GLU and the ``lm_head``; no norms, biases or
    embeddings."""
    return sorted(path for path, leaf in flatten(params).items()
                  if re.match(_TARGETS, path) and leaf.dim() >= 2)


def lora_init(generator: torch.Generator, params: dict, cfg: LoraConfig,
              targets: list[str] | None = None, dtype=torch.float32) -> dict:
    """``a ~ normal / sqrt(fan_in)``, ``b = 0`` in ``dtype`` (the fp32
    masters) on ``generator``'s device, for each target in sorted order."""
    if targets is None:
        targets = default_lora_targets(params)
    flat = flatten(params)
    dev = generator.device
    lora = {}
    for path in targets:
        *batch, fan_in, fan_out = flat[path].shape
        a = torch.randn((*batch, fan_in, cfg.r), generator=generator, device=dev,
                        dtype=torch.float32) * (1.0 / math.sqrt(fan_in))
        lora[f"{path}/a"] = a.to(dtype)
        lora[f"{path}/b"] = torch.zeros((*batch, cfg.r, fan_out), dtype=dtype, device=dev)
    return unflatten(lora)


def dropout_keep(seed: int, step: int, index: int, shape, p: float,
                 device) -> torch.Tensor:
    """The keep mask (probability ``1 - p``) of leaf ``index`` at ``step``,
    drawn on the CPU from a generator seeded by ``(seed, step, index)``, so
    the card and the CPU draw the same mask."""
    digest = hashlib.sha256(f"{seed}/{step}/{index}".encode()).digest()
    gen = torch.Generator().manual_seed(int.from_bytes(digest[:8], "little") >> 1)
    return (torch.rand(shape, generator=gen) < 1.0 - p).to(device)


def _keep_piece(dropout: tuple[int, int], index: int, path: str, a, p: float):
    """The keep mask of factor ``a`` (at ``path``): the whole leaf's, cut to
    this process's piece where tensor parallelism cuts ``a``'s fan-in rows."""
    shape = [*a.shape[:-1], 1]
    n = model_world()
    spec = PartitionRules().spec_for(path, len(shape))
    if n == 1 or "model" not in spec:
        return dropout_keep(*dropout, index, tuple(shape), p, a.device)
    d = spec.index("model")
    k = shape[d]
    shape[d] *= n
    return dropout_keep(*dropout, index, tuple(shape), p, a.device).narrow(
        d, model_rank() * k, k)


def lora_merge(params: dict, lora: dict, cfg: LoraConfig, *,
               dropout: tuple[int, int] | None = None) -> dict:
    """``params`` with each factored weight replaced by a :class:`LoraLeaf`
    of ``W + scale * A @ B``. ``dropout=(seed, step)`` applies LoRA dropout
    when ``cfg.dropout > 0``; None merges deterministically."""
    flat_lora: dict = {}
    for path, leaf in flatten(lora).items():
        base_path, name = path.rsplit("/", 1)
        flat_lora.setdefault(base_path, {})[name] = leaf
    p = cfg.dropout if dropout is not None else 0.0
    merged = {}
    for i, (path, w) in enumerate(sorted(flatten(params).items())):
        if path in flat_lora:
            a, b = flat_lora[path]["a"], flat_lora[path]["b"]
            keep = _keep_piece(dropout, i, f"{path}/a", a, p) if p > 0.0 else None
            w = LoraLeaf(w, a, b, cfg.scale, keep, p)
        merged[path] = w
    return unflatten(merged)


def split_trainable(params: dict, prefixes=FINETUNE_PATH_PREFIXES) -> tuple[dict, dict]:
    """(finetune subtree, frozen subtree), partitioned by path prefix."""
    finetune, frozen = {}, {}
    for path, leaf in flatten(params).items():
        (finetune if path.startswith(prefixes) else frozen)[path] = leaf
    return unflatten(finetune), unflatten(frozen)


def merge_trainable(finetune: dict, frozen: dict) -> dict:
    return unflatten({**flatten(frozen), **flatten(finetune)})
