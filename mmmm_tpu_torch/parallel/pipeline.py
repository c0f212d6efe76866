"""Pipeline parallelism: a GPipe schedule over the ``pipe`` group, the port
of ``mmmm_tpu/parallel/pipeline.py`` (``set_pipe_context``,
``get_pipe_context``, ``pipe_ready``, ``pipeline_layers``).

Each process of the ``pipe`` group holds ``L / S`` contiguous layers of the
stacked LLM decoder (its stage; ``train/step.py place_state`` places them
as ``parallel/zero.py PipeLeaf`` chunks). The batch splits into ``M``
microbatches; at tick ``t`` stage ``s`` runs microbatch ``t - s``: stage 0
takes it from the input, a later stage receives it from stage ``s - 1``,
runs its layers and sends the result to ``s + 1``, and the last stage
collects it. After ``M + S - 1`` ticks the last stage broadcasts the
outputs to every process of the group (the reference's masked ``psum``),
so the final norm, the head and the losses run replicated over ``pipe``,
as over ``seq``. Bubble ticks, whose results the reference masks out, run
nothing.

Three autograd functions carry the schedule's communication, so that the
backward is the reverse pipeline:

  - :class:`_Hop`, a tick's exchange: forward sends this stage's output to
    ``s + 1`` and receives ``s - 1``'s; backward sends the received
    output's gradient back to ``s - 1`` and receives the gradient of what
    it sent from ``s + 1``;
  - :class:`_Broadcast`, the last stage's outputs to every process: its
    backward hands the last stage its own gradient and sums nothing (every
    process computed the same downstream gradient);
  - :class:`_Input`, the replicated input that only stage 0 consumes: its
    backward broadcasts stage 0's gradient to every process, so the ViT and
    the embeddings get the same gradients everywhere.

No factor of ``S`` enters anywhere. A scalar token threads every hop of a
process, from :class:`_Input` to :class:`_Broadcast`, so that each
process's backward runs the hops in exactly the reverse order of the
forward's ticks: every process issues the same exchanges in one order, each
with one ``batch_isend_irecv``, and none waits on a peer that is elsewhere.
Under gloo, whose send and receive move host memory, a CUDA tensor goes
through a host copy (``distributed.exchange``: the group's backend decides).

The tick loop (:func:`_schedule`) is apart from the transport: a
:class:`VirtualPipe` runs the ``S`` stages in one process, handing each
output on as a tensor.
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .distributed import exchange

# (mesh, axis, n_micro) set by the trainer; read by llm_forward, as the
# reference's
_PIPE_CONTEXT: tuple | None = None


def set_pipe_context(mesh, axis: str = "pipe", n_micro: int = 4) -> None:
    """Enable the pipelined ``llm_forward``: its stacked layers staged over
    ``mesh[axis]`` with ``n_micro`` microbatches; ``mesh=None`` clears.
    Raises with a ``model`` axis above 1, as the reference's."""
    global _PIPE_CONTEXT
    if mesh is not None and "model" in mesh.mesh_dim_names and \
            mesh.size(mesh.mesh_dim_names.index("model")) > 1:
        raise ValueError("pipeline parallelism does not compose with tensor parallelism in one "
                         "mesh; use model>1 XOR pipe>1")
    _PIPE_CONTEXT = None if mesh is None else (mesh, axis, n_micro)


def get_pipe_context():
    return _PIPE_CONTEXT


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    else:
        yield getattr(tree, "base", tree)  # a LoRA leaf's base weight


def staged(layers) -> bool:
    """Whether a stacked layer tree is staged over ``pipe`` (its leaves are
    this stage's chunks, ``PipeLeaf`` over the layer dimension)."""
    return any(getattr(leaf, "staged", False) for leaf in _leaves(layers))


def gather_stages(layers):
    """The stacked layer tree with every stage's layers gathered over
    ``pipe`` (differentiable; the route where the pipeline cannot run, as
    ZeRO gathers: every process then runs every layer)."""
    if isinstance(layers, dict):
        return {k: gather_stages(v) for k, v in layers.items()}
    if hasattr(layers, "map_parts"):  # a LoRA leaf
        return layers.map_parts(gather_stages)
    return layers.gathered() if getattr(layers, "staged", False) else layers


def stage_layers(layers, n_layers: int) -> range:
    """The indices of the layers this stage holds."""
    leaf = next(leaf for leaf in _leaves(layers) if getattr(leaf, "staged", False))
    return range(leaf.first, leaf.first + n_layers // leaf.world)


def pipe_ready(layers, batch: int) -> bool:
    """Whether the pipe context can take this call: a context with more than
    one stage, the layers staged over it (depth divisible by the stage
    count) and this process's ``batch`` divisible by the microbatches."""
    if _PIPE_CONTEXT is None:
        return False
    mesh, axis, n_micro = _PIPE_CONTEXT
    if mesh.size(mesh.mesh_dim_names.index(axis)) <= 1:
        return False
    return staged(layers) and batch % n_micro == 0


def _schedule(stages: tuple, n_stages: int, xm: list, sidem: list, stage_fn, hop) -> list:
    """GPipe over ``n_stages`` for the ``stages`` this process runs:
    ``stage_fn(s, h, side)`` runs stage ``s`` over one microbatch;
    ``hop(t, sent)`` takes ``{stage: output to pass on}`` of tick ``t`` and
    returns ``{stage: input of tick t + 1}``. Returns the last stage's
    outputs, one a microbatch (None where this process does not run it)."""
    n_micro = len(xm)
    inp, outs = {}, [None] * n_micro
    for t in range(n_micro + n_stages - 1):
        sent = {}
        for s in stages:
            m = t - s
            if not 0 <= m < n_micro:
                continue  # a bubble
            y = stage_fn(s, xm[m] if s == 0 else inp[s], sidem[m])
            if s == n_stages - 1:
                outs[m] = y
            else:
                sent[s] = y
        inp = hop(t, sent)
    return outs


def _micro(x, n_micro: int) -> list:
    return list(x.chunk(n_micro)) if isinstance(x, torch.Tensor) else [x] * n_micro


def _split_side(side: dict, n_micro: int) -> list:
    parts = {k: _micro(v, n_micro) for k, v in side.items()}
    return [{k: v[m] for k, v in parts.items()} for m in range(n_micro)]


class VirtualPipe:
    """All ``n`` stages in this process (the one-process tests)."""

    def __init__(self, n: int):
        self.n, self.stages = n, tuple(range(n))

    def run(self, stage_fn, x, side: dict, n_micro: int):
        outs = _schedule(self.stages, self.n, _micro(x, n_micro), _split_side(side, n_micro),
                         stage_fn, lambda t, sent: {s + 1: y for s, y in sent.items()})
        return torch.cat(outs)


class ProcessPipe:
    """This process as stage ``rank`` of the ``pipe`` ``group``."""

    def __init__(self, group):
        self.group, self.n, self.rank = group, dist.get_world_size(group), dist.get_rank(group)
        self.stages = (self.rank,)

    def peer(self, s: int) -> int:
        return dist.get_global_rank(self.group, s)

    def run(self, stage_fn, x, side: dict, n_micro: int):
        like = _micro(x, n_micro)[0].detach()
        token0 = torch.zeros((), device=x.device, requires_grad=True)
        x_in, token = _Input.apply(x, token0, self)
        xm = _micro(x_in, n_micro)
        s, n = self.rank, self.n
        state = {"token": token}

        def hop(t, sent):
            send = sent.get(s)
            recv = s > 0 and 0 <= t - (s - 1) < n_micro  # the previous stage ran at t
            token, got = _Hop.apply(state["token"], send if send is not None else state["token"],
                                    self, send is not None, recv, like)
            state["token"] = token
            return {s: got} if recv else {}

        outs = _schedule(self.stages, n, xm, _split_side(side, n_micro), stage_fn, hop)
        y = torch.cat(outs) if s == n - 1 else state["token"]
        return _Broadcast.apply(state["token"], y, self, x.shape, x.dtype)


class _Input(torch.autograd.Function):
    """``x`` (for stage 0) and the first token; the backward broadcasts
    stage 0's gradient of ``x`` to every stage."""

    @staticmethod
    def forward(ctx, x, token, pipe):
        ctx.pipe = pipe
        return x.clone(), token.clone()

    @staticmethod
    def backward(ctx, g, g_token):
        pipe = ctx.pipe
        g = g.contiguous() if pipe.rank == 0 else torch.zeros_like(g)
        dist.broadcast(g, pipe.peer(0), group=pipe.group)
        return g, g_token, None


class _Hop(torch.autograd.Function):
    """One tick's exchange between neighbouring stages: ``y`` to ``s + 1``
    where ``send``, a tensor like ``like`` from ``s - 1`` where ``recv``."""

    @staticmethod
    def forward(ctx, token, y, pipe, send, recv, like):
        ctx.pipe, ctx.send, ctx.recv, ctx.like = pipe, send, recv, like
        s = pipe.rank
        got = exchange(pipe.group, [y] if send else [], s + 1, [like] if recv else [], s - 1)
        return token.clone(), got[0] if recv else token.new_zeros(0)

    @staticmethod
    def backward(ctx, g_token, g_got):
        s = ctx.pipe.rank
        g_y = exchange(ctx.pipe.group, [g_got] if ctx.recv else [], s - 1,
                       [ctx.like] if ctx.send else [], s + 1)
        return g_token, g_y[0] if ctx.send else None, None, None, None, None


class _Broadcast(torch.autograd.Function):
    """The last stage's outputs ``y`` (B, ...) on every stage; the backward
    hands the last stage its own gradient."""

    @staticmethod
    def forward(ctx, token, y, pipe, shape, dtype):
        ctx.pipe = pipe
        last = pipe.n - 1
        out = y.detach().clone() if pipe.rank == last else \
            torch.empty(shape, dtype=dtype, device=token.device)
        dist.broadcast(out, pipe.peer(last), group=pipe.group)
        return out

    @staticmethod
    def backward(ctx, g):
        last = ctx.pipe.rank == ctx.pipe.n - 1
        # a zero gradient for the token, so that every process's hops run
        # their backward, in order
        return torch.zeros((), device=g.device), g if last else None, None, None, None


def pipeline_layers(stage_fn, x: torch.Tensor, side: dict, group, n_micro: int = 4):
    """Apply the stages of a pipeline over the ``pipe`` ``group`` to ``x``
    (B, S, C), replicated on every process of the group.
    ``stage_fn(stage, h, side_micro) -> h`` runs one stage's layers over one
    microbatch (this process's stage); ``side`` holds per-batch side inputs
    (B, ...) cut into microbatches with ``x``. This process's batch must
    divide into ``n_micro`` microbatches. Returns the activations after
    every stage, replicated over the group, differentiable in ``x`` and in
    whatever ``stage_fn`` uses."""
    return ProcessPipe(group).run(stage_fn, x, side, n_micro)
