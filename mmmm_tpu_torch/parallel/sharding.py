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
The port runs the ``data`` axis (``parallel/zero.py``, ``train/step.py``)
and the ``model`` axis: :func:`local_params` gives this process its piece
of every leaf and :func:`join_pieces` / :func:`gather_pieces` put the pieces
back. The reference shards the fused ``(L, c, 3c)`` qkv weights
contiguously and lets XLA reshard; a process that runs its share of a layer
alone needs whole heads of q, k and v, so those leaves are cut
head-grouped: piece ``r`` of ``[q | k | v]`` is ``[q_r | k_r | v_r]``.
Stored trees (``params_from_jax``, checkpoints, adapters) keep the
reference's layout. A W4A16 row piece (``down``, ``dense``) holds every
scale group its rows touch, so ``k / n`` rows need not end on a group (the
reference replicates W4A16 leaves instead). The ``pipe`` entries
(the stacked LLM layers staged, large unstaged leaves cut) are placed by
``parallel/zero.py place_tree``; ``seq`` cuts no leaf.
"""
from __future__ import annotations

import dataclasses
import math
import re
from collections.abc import Mapping

import torch
import torch.distributed as dist

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
    # W4A16 leaves ({"q4", "s4"}, the port's own: the reference replicates
    # them): packed (K/2, N) int4 and (K/128, N) group scales, cut as their
    # bf16 original (local_params repacks a row piece)
    (r".*llm/layers/(vis|lang)_qkv/(q4|s4)$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_dense/(q4|s4)$", (None, "model", None)),
    (r".*llm/layers/(vis|lang)_mlp/(gate|up)/(q4|s4)$", (None, None, "model")),
    (r".*llm/layers/(vis|lang)_mlp/down/(q4|s4)$", (None, "model", None)),
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


# the fused q|k|v leaves, cut by whole heads: the weights, their LoRA "b"
# factors, W8A16 and W4A16 leaves and the ViT's bias
_HEAD_GROUPED = r".*(llm/layers/(vis|lang)_qkv|vision/layers/qkv_[wb])(/(b|q|s|q4|s4))?$"


def model_dim(path: str, shape, n: int, rules: PartitionRules = PartitionRules()):
    """The dimension of a leaf that tensor parallelism over ``n`` processes
    cuts (None: the leaf is replicated over ``model``). Raises where the
    rules shard the leaf over ``model`` but ``n`` does not divide that
    dimension (``_fit_spec`` would replicate it): that layer cannot run its
    share on each process."""
    if n == 1:
        return None
    spec = rules.spec_for(path, len(shape))
    if "model" not in spec:
        return None
    d = spec.index("model")
    if shape[d] % n or (re.match(_HEAD_GROUPED, path) and d == len(shape) - 1
                        and shape[d] % (3 * n)):
        raise ValueError(f"{path}: dimension {d} of {tuple(shape)} does not split over "
                         f"model={n}; tensor parallelism of this layer is impossible")
    return d


def model_paths(flat: dict, rules: PartitionRules = PartitionRules()) -> frozenset:
    """The paths of a flat tree whose leaves the rules shard over ``model``
    (under tensor parallelism each is a piece)."""
    return frozenset(p for p, t in flat.items()
                     if "model" in rules.spec_for(p, len(getattr(t, "shape", ()))))


def _unpack_rows(p: torch.Tensor) -> torch.Tensor:
    """``ops/w4_matmul.py unpack_int4`` over dim -2 of any rank."""
    p = p.to(torch.int32)
    return torch.cat([((p & 0xF) ^ 8) - 8, p >> 4], dim=-2).to(torch.int8)


def _pack_rows(q: torch.Tensor) -> torch.Tensor:
    k = q.shape[-2] // 2
    lo, hi = q[..., :k, :].to(torch.int32), q[..., k:, :].to(torch.int32)
    return ((lo & 0xF) | (hi << 4)).to(torch.int8)


def w4_window(k: int, group: int, n: int, r: int) -> tuple[int, int, int, int]:
    """Where piece ``r`` of ``n`` of a W4A16 weight of ``k`` input rows in
    scale groups of ``group`` lies: ``(front, rows, g0, g1)``, its own
    ``rows = k / n`` rows starting ``front`` rows into scale group ``g0``,
    the groups ``[g0, g1)`` touching them."""
    rows = k // n
    start = r * rows
    g0 = start // group
    return start - g0 * group, rows, g0, -(-(start + rows) // group)


def _w4_piece(path: str, w: dict, n: int, r: int) -> dict:
    """Piece ``r`` of ``n`` of a W4A16 leaf ``{"q4", "s4"}`` cut along its
    input rows: every scale group its rows touch (where ``k / n`` rows end
    inside a group, two neighbours share it), with zero weights outside its
    own rows, and zero groups at the end up to the even count every piece
    has (the most any piece touches, rounded up), so that each half of the
    packing (row i pairs with row K/2 + i) holds whole groups. ``rows4``, a
    tensor of no elements of shape ``(..., front, rows, 0)``, records the
    front offset and the row count, which ``ops/quant.py qdot`` pads x by:
    it travels with the tree wherever the tree is moved or indexed."""
    q4, s4 = w["q4"], w["s4"]
    k, groups = 2 * q4.shape[-2], s4.shape[-2]
    group = k // groups
    if k % n:
        raise ValueError(f"{path}: {k} input rows do not split over model={n}; tensor "
                         "parallelism of this layer is impossible")
    wins = [w4_window(k, group, n, i) for i in range(n)]
    width = max(g1 - g0 for _, _, g0, g1 in wins)
    width += width % 2
    front, rows, g0, g1 = wins[r]
    lead = q4.shape[:-2]
    q = _unpack_rows(q4).narrow(-2, g0 * group, (g1 - g0) * group)
    piece = torch.zeros((*lead, width * group, q4.shape[-1]), dtype=torch.int8,
                        device=q4.device)
    piece[..., front:front + rows, :] = q[..., front:front + rows, :]
    scales = s4.new_zeros((*lead, width, s4.shape[-1]))
    scales[..., :g1 - g0, :] = s4.narrow(-2, g0, g1 - g0)
    return {**{key: v for key, v in w.items() if key not in ("q4", "s4")},
            "q4": _pack_rows(piece), "s4": scales,
            "rows4": q4.new_empty((*lead, front, rows, 0))}


def join_w4(pieces: list) -> dict:
    """The whole ``{"q4", "s4"}`` leaf from the W4A16 row pieces of every
    process of the ``model`` axis, in rank order (:func:`_w4_piece`'s
    inverse): each piece's own rows, and each scale group once."""
    n, first = len(pieces), pieces[0]
    rows = first["rows4"].shape[-2]
    k = n * rows
    group = 2 * first["q4"].shape[-2] // first["s4"].shape[-2]
    lead, cols = first["q4"].shape[:-2], first["q4"].shape[-1]
    q = torch.empty((*lead, k, cols), dtype=torch.int8, device=first["q4"].device)
    s4 = first["s4"].new_empty((*lead, k // group, cols))
    for r, p in enumerate(pieces):
        front, _, g0, g1 = w4_window(k, group, n, r)
        q[..., r * rows:(r + 1) * rows, :] = _unpack_rows(p["q4"])[..., front:front + rows, :]
        s4[..., g0:g1, :] = p["s4"][..., :g1 - g0, :]
    return {"q4": _pack_rows(q), "s4": s4}


def _piece(path: str, t: torch.Tensor, d, n: int, r: int) -> torch.Tensor:
    if d is None:
        return t
    if re.match(_HEAD_GROUPED, path) and d == t.dim() - 1:
        x = t.reshape(*t.shape[:-1], 3, n, t.shape[-1] // (3 * n))
        return x.select(-2, r).reshape(*t.shape[:-1], -1).clone()
    k = t.shape[d] // n
    return t.narrow(d, r * k, k).clone()


def local_params(tree, mesh, *, cfg=None, rules: PartitionRules = PartitionRules()):
    """This process's piece of every leaf of ``tree`` (parameters, LoRA
    factors, optimizer moments; dicts and lists, paths as the reference's)
    for the mesh's ``model`` axis: the fused qkv leaves by whole heads of q,
    k and v, every other leaf that the rules shard over ``model``
    contiguously, the rest as they are. ``mesh`` is a ``DeviceMesh`` or
    ``(sizes, model rank)``. A leaf that the rules shard but the axis does
    not divide raises and names it; with ``cfg`` (a ``CogVLMConfig``) so do
    heads that the axis does not divide. Pieces are copies (the whole tree
    may be freed), and a piece passes unchanged, so cutting twice changes
    nothing."""
    if isinstance(mesh, tuple):
        sizes, r = mesh
    else:
        sizes, r = axis_sizes(mesh), mesh.get_local_rank("model")
    n = sizes.get("model", 1)
    if n == 1:
        return tree
    def one(path, leaf):
        if not isinstance(leaf, torch.Tensor) or getattr(leaf, "tp_piece", False):
            return leaf
        d = model_dim(path, leaf.shape, n, rules)
        if d is None:
            return leaf
        if cfg is not None and re.match(_HEAD_GROUPED, path):
            heads = cfg.vision.num_heads if "vision/" in path else cfg.num_attention_heads
            if heads % n:
                raise ValueError(f"{path}: {heads} heads do not split over model={n}")
        out = _piece(path, leaf, d, n, r)
        out.tp_piece = True  # cutting it again returns it
        return out

    def walk(node, prefix: str):
        if _is_w4_rows(node, prefix, n, rules):
            return node if "rows4" in node else _w4_piece(prefix[:-1], node, n, r)
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        return one(prefix[:-1], node)

    return walk(tree, "")


def _is_w4_rows(node, prefix: str, n: int, rules: PartitionRules) -> bool:
    """Whether ``node`` is a W4A16 leaf ``{"q4", "s4"}`` that the rules cut
    along its input rows (a row-parallel weight; its pieces carry ``rows4``)."""
    if not (isinstance(node, dict) and isinstance(node.get("q4"), torch.Tensor)):
        return False
    q4 = node["q4"]
    return model_dim(prefix + "q4", q4.shape, n, rules) == q4.dim() - 2


def join_pieces(path: str, pieces: list, rules: PartitionRules = PartitionRules()):
    """The whole leaf at ``path`` from the pieces of every process of the
    ``model`` axis, in rank order: the inverse of :func:`local_params` (a
    W4A16 row piece is joined with its ``rows4`` by :func:`join_w4`)."""
    n = len(pieces)
    t = pieces[0]
    spec = rules.spec_for(path, t.dim())
    if n == 1 or "model" not in spec:
        return t
    d = spec.index("model")
    if path.endswith(("/q4", "/s4")) and d == t.dim() - 2:
        raise ValueError(f"{path}: a W4A16 row piece is joined whole, by join_w4")
    if re.match(_HEAD_GROUPED, path) and d == t.dim() - 1:
        x = torch.stack([p.reshape(*p.shape[:-1], 3, -1) for p in pieces], dim=-2)
        return x.reshape(*t.shape[:-1], -1)
    return torch.cat(pieces, dim=d)


@torch.no_grad()
def gather_pieces(tree, group, rules: PartitionRules = PartitionRules()):
    """Every leaf that tensor parallelism cut, gathered whole over the
    ``model`` ``group`` (every process of it must call this; outside
    autograd); None or a group of one returns ``tree``."""
    if group is None or dist.get_world_size(group) == 1:
        return tree
    n = dist.get_world_size(group)

    def parts(leaf):
        out = [torch.empty_like(leaf) for _ in range(n)]
        dist.all_gather(out, leaf.contiguous(), group=group)
        return out

    def walk(node, prefix: str):
        if isinstance(node, dict) and "rows4" in node:
            return join_w4([{"q4": q, "s4": s, "rows4": node["rows4"]}
                            for q, s in zip(parts(node["q4"]), parts(node["s4"]))])
        if isinstance(node, dict):
            return {k: walk(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, f"{prefix}{i}/") for i, v in enumerate(node)]
        path = prefix[:-1]
        if not isinstance(node, torch.Tensor) or "model" not in rules.spec_for(path, node.dim()):
            return node
        return join_pieces(path, parts(node), rules)

    return walk(tree, "")


def tp_serving_params(params, tp: int):
    """Tensor-parallel serving over ``tp`` processes, the reference's
    ``tp_serving_params``: the processes form a ``(data = world / tp, model
    = tp)`` mesh (joined first by ``init_distributed`` from
    ``COORDINATOR_ADDRESS``, ``NUM_PROCESSES`` and ``PROCESS_ID``), the mesh's
    ``model`` group becomes the process's (``parallel/tensor.py
    set_model_group``), and this process keeps its piece of the weights
    (:func:`local_params`). Returns ``(pieces, attn_impl)``. ``attn_impl``
    is ``"auto"`` (the kernels run on each process's heads), where the
    reference returns ``"xla"``: its Pallas kernels have no GSPMD rule.
    ``tp <= 1`` returns ``params`` and leaves the process no model group:
    it serves whole weights."""
    from .distributed import init_distributed
    from .mesh import make_mesh
    from .tensor import set_model_group

    if tp <= 1:
        set_model_group(None)
        return params, "auto"

    dev = next(t.device for t in _flatten(params).values() if isinstance(t, torch.Tensor))
    init_distributed(device=dev)
    n = dist.get_world_size() if dist.is_initialized() else 1
    if n % tp:
        raise ValueError(f"tp={tp} does not divide {n} processes: tensor-parallel serving runs "
                         "one process a device, each started with COORDINATOR_ADDRESS, "
                         "NUM_PROCESSES and PROCESS_ID (parallel/distributed.py)")
    mesh = make_mesh(data=n // tp, model=tp, device=dev)
    set_model_group(mesh.get_group("model"))
    return local_params(params, mesh), "auto"
