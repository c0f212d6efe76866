"""Ring attention: sequence-parallel segment attention over the ``seq``
group, the port of ``mmmm_tpu/parallel/ring_attention.py``
(``ring_segment_attention``).

As the reference's outside its ``shard_map``, the activations are whole on
every process of the group: :func:`ring_segment_attention` takes the whole
q, k, v and segment ids, cuts this process's sequence shard (rank ``idx``
of ``n``: positions ``[idx S/n, (idx + 1) S/n)``), runs the ring and
all-gathers the output shards, so every process holds the whole output.
Its backward cuts the output gradient, runs the backward ring and
all-gathers dq, dk and dv: the gradients of the parameters are then the
same on every process, and nothing is reduced over ``seq``.

One step of the ring pairs this process's q shard with the K/V block of
source ``src = (idx + i) % n``. With ``causal`` the pair is fully live when
``src < idx`` (kernel K3 without the causal mask), causal on the diagonal
(``src == idx``: K3 with it, both blocks at one offset) and dead when
``src > idx``: no launch and no contribution (the reference computes it and
masks it out, with the same result). Without ``causal`` every pair is live.
The partial outputs merge in log-sum-exp space, in fp32: ``lse =
logsumexp(lse_i)``, ``out = sum exp(lse_i - lse) out_i``, cast to v's dtype
at the end. A row with no valid key in a block enters that block's merge
with weight 0 (K3 gives it ``lse = 0``, which is not a weight): a row's
validity in a block comes from the segment ids and the causal mask, and a
row valid in no block gives 0 (the reference's ``m = -1e30, l = 0``).

The backward is the reference's ring: at each live pair kernel K7 runs from
this shard of the whole output and the whole lse (so K7's own delta,
``rowsum(g out)``, is the ring's), dq accumulates at home in fp32, and the
dk/dv contributions travel with K and V and arrive home after ``n`` hops.

A hop sends to ``(idx - 1) % n`` and receives from ``(idx + 1) % n`` (the
reference's ``_ring_perm``) with ``batch_isend_irecv`` over the group, the
same operations in the same order on every process
(``distributed.exchange``). Under gloo, whose send and receive move host
memory, a CUDA tensor goes through a host copy each way; the choice is the
group's backend's, made before any hop. NCCL moves device tensors directly.

:func:`attention` is the models' attention sites' entry: under the context
that :func:`set_ring_context` sets (the trainer, under ``mesh_seq``), an
``impl="ring"`` self-attention whose sequence the ring's size divides rings
over the ``seq`` group; every other site, and every site without a context,
takes ``ops/attention.py segment_attention``'s ``"auto"``, as the
reference's.

The per-process step math (:func:`_fwd_steps`, :func:`_bwd_steps`,
generators that yield what they pass on and receive what comes in) is apart
from the transport: :func:`ring_attention_virtual` runs ``n`` virtual ranks
in lockstep in one process, through the same steps and the same autograd
function.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from ..ops.attention import build_mask, segment_attention
from ..ops.flash import flash_segment_attention, flash_segment_attention_bwd
from ..ops.remat import checkpoint_name
from .distributed import exchange
from .zero import gather_dim

# (mesh, seq axis) set by the trainer under mesh_seq; read by attention()
_RING_CONTEXT: tuple | None = None


def set_ring_context(mesh, axis: str = "seq") -> None:
    """Ring :func:`attention`'s ``impl="ring"`` self-attentions over
    ``mesh[axis]``; ``mesh=None`` clears."""
    global _RING_CONTEXT
    _RING_CONTEXT = None if mesh is None else (mesh, axis)


def get_ring_context():
    return _RING_CONTEXT


def _cut(t: torch.Tensor, idx: int, n: int) -> torch.Tensor:
    """Shard ``idx`` of ``n`` along the sequence dimension (1), contiguous."""
    k = t.shape[1] // n
    return t.narrow(1, idx * k, k).contiguous()


def _live(idx: int, src: int, causal: bool) -> bool | None:
    """The pair's causal flag (True on the diagonal, False where fully
    live), or None where it is dead."""
    if not causal:
        return False
    return None if src > idx else src == idx


def _fwd_steps(q, k, v, seg, idx: int, n: int, causal: bool, scale: float):
    """This rank's forward ring: yields the ``(k, v, segments)`` block it
    passes on and receives the next; returns ``(out, lse)`` of its shard."""
    parts, blk = [], (k, v, seg)
    for i in range(n):
        src = (idx + i) % n
        c = _live(idx, src, causal)
        if c is not None:
            kb, vb, sb = blk
            out, lse = flash_segment_attention(q, kb, vb, seg, sb, causal=c, scale=scale)
            parts.append((out, lse, build_mask(seg, sb, c).any(-1)))
        if i < n - 1:
            blk = yield blk
    return merge(parts, v.dtype)


def merge(parts, dtype):
    """``(out, lse)`` of partials ``(out_i (B, S, H, D), lse_i (B, H, S),
    valid_i (B, S))`` merged in log-sum-exp space: a row counts in block i
    only where ``valid_i``; a row valid nowhere gives 0 and lse 0. Both
    come out contiguous, as the kernels take them."""
    lses = torch.stack([torch.where(ok[:, None, :], lse, -torch.inf) for _, lse, ok in parts])
    lse = torch.logsumexp(lses, dim=0)
    valid = torch.isfinite(lse)
    w = torch.where(valid, torch.exp(lses - torch.where(valid, lse, 0.0)), 0.0)  # (P, B, H, S)
    out = sum(wi.transpose(1, 2)[..., None] * o.to(w.dtype) for wi, (o, _, _) in zip(w, parts))
    return out.to(dtype).contiguous(), torch.where(valid, lse, 0.0).contiguous()


def _bwd_steps(q, k, v, seg, out, lse, g, idx: int, n: int, causal: bool, scale: float):
    """This rank's backward ring: yields ``(k, v, segments, dk, dv)`` (the
    last hop only ``(dk, dv)``) and receives the next; returns ``(dq, dk,
    dv)`` of its shard, the last two arrived home."""
    dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    zeros = torch.zeros(k.shape, dtype=torch.float32, device=k.device)
    blk = (k, v, seg, zeros, zeros)
    for i in range(n):
        src = (idx + i) % n
        kb, vb, sb, dk, dv = blk
        c = _live(idx, src, causal)
        if c is not None:
            dq_i, dk_i, dv_i = flash_segment_attention_bwd(q, kb, vb, seg, sb, out, lse, g,
                                                           causal=c, scale=scale)
            dq += dq_i.float()
            dk, dv = dk + dk_i.float(), dv + dv_i.float()
        blk = yield (kb, vb, sb, dk, dv) if i < n - 1 else (dk, dv)
    dk, dv = blk
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


def _advance(gen, msg):
    try:
        return False, gen.send(msg)
    except StopIteration as stop:
        return True, stop.value


def _drive(gens, hop):
    """Run the ranks' steps in lockstep: every generator yields as often;
    ``hop(sent)`` maps what each sends to what each receives."""
    state = [_advance(g, None) for g in gens]
    while not all(done for done, _ in state):
        got = hop([msg for _, msg in state])
        state = [_advance(g, m) for g, m in zip(gens, got)]
    return [value for _, value in state]


class ProcessRing:
    """This process alone on the ring of ``group`` (the ``seq`` group)."""

    def __init__(self, group):
        self.group, self.n, self.idx = group, dist.get_world_size(group), dist.get_rank(group)
        self.ranks = (self.idx,)

    def hop(self, sent: list) -> list:
        return [ring_hop(sent[0], self.group, self.idx, self.n)]

    def gather(self, shards: list) -> torch.Tensor:
        return gather_dim(shards[0], 1, self.group, self.n)


class VirtualRing:
    """``n`` ranks in this process, hopping in lockstep."""

    def __init__(self, n: int):
        self.n, self.ranks = n, tuple(range(n))

    def hop(self, sent: list) -> list:
        return [sent[(i + 1) % self.n] for i in range(self.n)]

    def gather(self, shards: list) -> torch.Tensor:
        return torch.cat(shards, dim=1)


def ring_hop(tensors, group, idx: int, n: int) -> tuple:
    """``tensors`` sent to rank ``(idx - 1) % n`` of ``group``, the same
    count of tensors of the same shapes received from ``(idx + 1) % n``
    (``distributed.exchange``: one ``batch_isend_irecv``, through the host
    under gloo)."""
    return tuple(exchange(group, list(tensors), (idx - 1) % n, list(tensors), (idx + 1) % n))


class _Ring(torch.autograd.Function):
    @staticmethod
    def forward(ctx, q, k, v, segments, ring, causal, scale):
        n = ring.n
        seg = segments.to(torch.int32)
        cut = lambda t, i: _cut(t, i, n)
        shards = [(cut(q, i), cut(k, i), cut(v, i), cut(seg, i)) for i in ring.ranks]
        res = _drive([_fwd_steps(*s, i, n, causal, scale) for s, i in zip(shards, ring.ranks)],
                     ring.hop)
        ctx.ring, ctx.causal, ctx.scale = ring, causal, scale
        ctx.save_for_backward(*(t for s in shards for t in s), *(t for r in res for t in r))
        return ring.gather([out for out, _ in res])

    @staticmethod
    def backward(ctx, g):
        ring, n = ctx.ring, ctx.ring.n
        saved, m = ctx.saved_tensors, len(ring.ranks)
        shards = [saved[4 * j:4 * j + 4] for j in range(m)]
        res = [saved[4 * m + 2 * j:4 * m + 2 * j + 2] for j in range(m)]
        gens = [_bwd_steps(*s, out, lse, _cut(g, i, n), i, n, ctx.causal, ctx.scale)
                for s, (out, lse), i in zip(shards, res, ring.ranks)]
        grads = _drive(gens, ring.hop)
        dq, dk, dv = (ring.gather([gr[j] for gr in grads]) for j in range(3))
        return dq, dk, dv, None, None, None, None


def _check(q, n: int, scale):
    if q.shape[1] % n:
        raise ValueError(f"sequence {q.shape[1]} not divisible by ring size {n}")
    return q.shape[-1] ** -0.5 if scale is None else float(scale)


def ring_segment_attention(q, k, v, segments, group, *, causal: bool = False,
                           scale: float | None = None) -> torch.Tensor:
    """Sequence-parallel segment attention over the process ``group`` (the
    mesh's ``seq`` group): q, k, v (B, S, H, D) and ``segments`` (B, S) whole
    on every process, S divisible by the group's size. Semantics of
    ``ops/attention.py segment_attention`` (block-diagonal by nonzero
    segment id, optional causal, masked rows 0); returns the whole (B, S,
    H, D) output in v's dtype, differentiable in q, k and v."""
    ring = ProcessRing(group)
    return _Ring.apply(q, k, v, segments, ring, causal, _check(q, ring.n, scale))


def ring_attention_virtual(q, k, v, segments, n: int, *, causal: bool = False,
                           scale: float | None = None) -> torch.Tensor:
    """:func:`ring_segment_attention` with ``n`` virtual ranks in this
    process (the same steps, hops between them in lockstep)."""
    return _Ring.apply(q, k, v, segments, VirtualRing(n), causal, _check(q, n, scale))


def attention(q, k, v, q_segments, kv_segments=None, *, impl: str = "auto",
              causal: bool = False, scale: float | None = None, name: str = "", **kw):
    """``ops/attention.py segment_attention`` with the ring: under a ring
    context, ``impl="ring"`` on a self-attention (no ``kv_segments``) whose
    sequence the ring's size divides runs :func:`ring_segment_attention`
    over the context's group (its output tagged ``name``); every other call
    goes to ``segment_attention``, where ``"ring"`` is ``"auto"``."""
    if impl == "ring" and _RING_CONTEXT is not None and kv_segments is None:
        mesh, axis = _RING_CONTEXT
        n = mesh.size(mesh.mesh_dim_names.index(axis))
        if n > 1 and q.shape[1] % n == 0:
            out = ring_segment_attention(q, k, v, q_segments, mesh.get_group(axis),
                                         causal=causal, scale=scale)
            return checkpoint_name(out, name) if name else out
    return segment_attention(q, k, v, q_segments, kv_segments, impl=impl, causal=causal,
                             scale=scale, name=name, **kw)
