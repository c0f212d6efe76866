"""The LoRA training step, the port of ``mmmm_tpu/train/step.py``
(``TrainState``, ``init_train_state``, ``effective_params``,
``make_step_fn``, ``make_train_step``): LoRA-merged forward, gradients by
autograd, global-norm clip and AdamW.

Precision policy (the reference's): trainable masters (LoRA factors, the
finetuned SAM, iSAM, ``vg_proj`` and ``embed_tokens``) are fp32; with
``bf16_vlm`` the whole CogVLM subtree is cast to bf16 before the merge,
``embed_tokens`` included, and the fp32 masters take fp32 gradients back
through the cast; ``frozen_vlm_bf16`` stores the frozen CogVLM base in
bf16. LoRA merges per layer inside the rematerialized layer
(``peft/lora.py``).

``remat`` is the reference's policy (``ops/remat.py``): True (recompute
each layer), False, ``"attn"`` (keep the LLM layers' attention context,
and on the flash route K3's output for K7) or ``"dots"`` (keep the
products with no batch dimension). ``gelu_mode`` is the reference's
``MMMM_GELU`` (``ops/gelu.py``), in force for the step's forward and
backward.

Profiler spans: ``vit``, ``llm_forward``, ``ce``, ``sam_loss`` (the
forward), ``backward`` (rematerialized layers recompute in it) and
``optimizer``.

The step updates the state in place (parameters, Adam moments, counts), as
PyTorch allows, instead of returning a new tree; it returns the same
``TrainState`` object and the logs (device tensors), with
``logs["grad_norm"]`` the global norm before clipping.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.distributed as dist
from torch.profiler import record_function

from ..models.mmmm import MMMMConfig, training_step
from ..ops._cuda import resolve_device
from ..ops.numerics import Numerics, numerics
from ..ops.remat import check_policy
from ..params import init_params
from ..peft.lora import (LoraConfig, flatten, lora_init, lora_merge, merge_trainable,
                         split_trainable, unflatten)
from ..parallel.distributed import batch_to, global_batch
from ..parallel.sharding import axis_sizes, model_paths
from ..parallel.tensor import model_parallel
from ..parallel.zero import PipeLeaf, data_cut, gather_unstacked, local_tensor, place_tree
from .optim import AdamW


@dataclasses.dataclass
class TrainState:
    step: int
    trainable: dict  # {"lora": ..., "ft": ...}, fp32 leaves that require grad
    opt_state: dict  # AdamW state over flatten(trainable): count, mu, nu


def _cast_vlm(tree: dict, dtype) -> dict:
    out = dict(tree)
    out["cogvlm"] = unflatten({p: t.to(dtype) if t.dtype == torch.float32 else t
                               for p, t in flatten(tree["cogvlm"]).items()})
    return out


def init_train_state(cfg: MMMMConfig, optimizer: AdamW, lora_cfg: LoraConfig, *,
                     seed: int = 0, frozen_vlm_bf16: bool = False,
                     device: str | torch.device = "cuda",
                     params: dict | None = None) -> tuple[TrainState, dict]:
    """Returns ``(state, frozen)``: the model from ``seed`` (or ``params``, a
    port tree in fp32, e.g. from ``params_from_jax``), LoRA factors from a
    generator seeded ``seed + 1``, the finetuned subset as fp32 masters and
    the frozen rest, its CogVLM in bf16 with ``frozen_vlm_bf16``.

    Made from the seed with ``frozen_vlm_bf16``, the CogVLM tower is drawn
    in bf16 directly (the flagship's 17 B fp32 parameters would not fit the
    card) and ``embed_tokens`` is then cast up to its fp32 master."""
    dev = resolve_device(device)
    if params is None:
        dtype = torch.bfloat16 if frozen_vlm_bf16 else torch.float32
        params = init_params(cfg, seed, dtype=dtype, device=dev)
    lora = lora_init(torch.Generator(device=dev).manual_seed(seed + 1), params, lora_cfg)
    ft, frozen = split_trainable(params)
    if frozen_vlm_bf16 and "cogvlm" in frozen:
        frozen = _cast_vlm(frozen, torch.bfloat16)
    trainable = {"lora": lora, "ft": unflatten({p: t.float() for p, t in flatten(ft).items()})}
    for t in flatten(trainable).values():
        t.requires_grad_(True)
    return TrainState(0, trainable, optimizer.init(flatten(trainable))), frozen


def effective_params(trainable: dict, frozen: dict, lora_cfg: LoraConfig, bf16_vlm: bool,
                     dropout: tuple[int, int] | None = None) -> dict:
    """The model's parameters: frozen + finetuned, the CogVLM cast to bf16
    with ``bf16_vlm``, LoRA leaves to merge where used (``dropout=(seed,
    step)`` for LoRA dropout). ZeRO-sharded leaves (``parallel/zero.py``)
    are gathered whole here, except the stacked layers', which each layer
    gathers when it runs."""
    base = merge_trainable(trainable["ft"], frozen)
    if bf16_vlm:
        base = _cast_vlm(base, torch.bfloat16)
    return lora_merge(gather_unstacked(base), trainable["lora"], lora_cfg, dropout=dropout)


def make_step_fn(cfg: MMMMConfig, optimizer: AdamW, lora_cfg: LoraConfig, *,
                 vg_mode: str = "none", bf16_vlm: bool = False, attn_impl: str = "auto",
                 remat: bool | str = True, dropout_seed: int | None = 0,
                 vis_span: tuple[int, int] | str | None = None, gelu_mode: str = "auto",
                 group=None, model_group=None, pipe_group=None):
    """The step_fn(state, frozen, batch) -> (state, logs) over a batch of
    tensors already on the state's device. A fresh LoRA-dropout mask each
    step, deterministic in ``(dropout_seed, step)`` (over each leaf's whole
    shape, so every process draws the same). With a data-parallel ``group``
    the batch is this process's slice, the state's and ``frozen``'s leaves
    may be ZeRO-sharded, and the logs are the global batch's. With a
    ``model_group`` the leaves are this process's tensor-parallel pieces
    (``place_state``), the forward and backward run under that group, and
    the gradients of the LoRA factors that the group's processes all use
    whole beside a cut partner (``a`` of a column-parallel weight, ``b``
    of a row-parallel one) are summed over it: each process holds its
    share. With a ``pipe_group`` the leaves placed over it are this stage's
    chunks (``parallel/zero.py PipeLeaf``), whose squares the global norm
    sums over the group."""
    use_dropout = dropout_seed is not None and lora_cfg.dropout > 0.0
    Numerics(gelu_mode=gelu_mode)  # a bad mode or policy raises here, not in a step
    check_policy(remat)

    def step_fn(state: TrainState, frozen: dict, batch: dict):
        leaves = flatten(state.trainable)
        flat = {p: local_tensor(v) for p, v in leaves.items()}
        with model_parallel(model_group), numerics(gelu_mode=gelu_mode):
            params = effective_params(state.trainable, frozen, lora_cfg, bf16_vlm,
                                      dropout=(dropout_seed, state.step) if use_dropout else None)
            loss, logs = training_step(params, cfg, batch, vg_mode=vg_mode,
                                       attn_impl=attn_impl, remat=remat, vis_span=vis_span,
                                       group=group, model_group=model_group)
            with record_function("backward"):
                grads = torch.autograd.grad(loss, list(flat.values()), allow_unused=True)
        grads = dict(zip(flat, grads))
        cut = frozenset()
        if model_group is not None:
            cut = model_paths(leaves)
            _sum_partials(grads, flat, cut, model_group)
        logs = {k: v.detach() for k, v in logs.items()}
        if group is not None:  # each process's logs are its share of the global batch's
            vals = torch.stack([logs[k].float() for k in sorted(logs)])
            dist.all_reduce(vals, group=group)
            logs = dict(zip(sorted(logs), vals.unbind()))
        opt_state = state.opt_state
        local_opt = {"count": opt_state["count"],
                     **{m: {p: local_tensor(t) for p, t in opt_state[m].items()}
                        for m in ("mu", "nu")}}
        with record_function("optimizer"):
            logs["grad_norm"] = optimizer.step(
                flat, grads, local_opt, group=group,
                sharded={p for p, v in leaves.items() if data_cut(v)},
                model_sharded=cut, model_group=model_group,
                pipe_sharded={p for p, v in leaves.items() if isinstance(v, PipeLeaf)},
                pipe_group=pipe_group)
        opt_state["count"] = local_opt["count"]
        state.step += 1
        return state, logs

    return step_fn


def _sum_partials(grads: dict, flat: dict, cut, group) -> None:
    """Sum over the model ``group``, in place and in one buffer, the
    gradients of the LoRA factors that are whole on each process while their
    partner factor is cut (each process's gradient is its pieces' share)."""
    partial = [p for p in flat if p.endswith(("/a", "/b")) and p not in cut
               and p[:-1] + ("b" if p.endswith("a") else "a") in cut]
    if not partial:
        return
    parts = [grads[p] if grads[p] is not None else torch.zeros_like(flat[p]) for p in partial]
    buf = torch.cat([g.reshape(-1) for g in parts])
    dist.all_reduce(buf, group=group)
    for p, g, like in zip(partial, buf.split([g.numel() for g in parts]), parts):
        grads[p] = g.view_as(like)


def place_state(state: TrainState, frozen: dict, mesh) -> tuple[TrainState, dict]:
    """``(state, frozen)`` placed for the mesh route by ``fsdp_shardings``
    (ZeRO-3, ``parallel/zero.py place_tree``): with a ``model`` axis above 1
    each leaf that the rules shard over it is first cut to this process's
    piece (``parallel/sharding.py local_params``); with a ``pipe`` axis
    above 1 the LLM's stacked layers become this stage's layers and the
    large unstaged leaves this process's chunk over ``pipe`` (a
    ``PipeLeaf``); then each leaf of the
    trainable tree, the Adam moments and the frozen base of at least
    ``FSDP_MIN_SIZE`` elements keeps this process's chunk (a
    :class:`ZeroLeaf`) of its piece over ``data``, so the whole leaf may be
    freed; the rest stay whole (replicated). ``state`` is
    placed in place and returned; placed leaves pass through, so placing
    twice changes nothing."""
    opt = state.opt_state
    state.trainable = place_tree(state.trainable, mesh)
    state.opt_state = {"count": opt["count"], "mu": place_tree(opt["mu"], mesh),
                       "nu": place_tree(opt["nu"], mesh)}
    return state, place_tree(frozen, mesh)


def make_train_step(cfg: MMMMConfig, optimizer: AdamW, lora_cfg: LoraConfig, *,
                    vg_mode: str = "none", bf16_vlm: bool = False, attn_impl: str = "auto",
                    remat: bool | str = True, mesh=None, dropout_seed: int | None = 0,
                    vis_span: tuple[int, int] | str | None = None, gelu_mode: str = "auto",
                    device: str | torch.device = "cuda"):
    """The step(state, frozen, batch) -> (state, logs) on ``device``; the
    batch's arrays are moved there.

    With ``mesh`` (``parallel/mesh.py make_mesh``, the reference's sharded
    step): data parallelism over the mesh's ``data`` axis, this process on
    its device (the mesh's; ``device`` must be of its type). The batch is
    this process's slice of the global batch (``scheduled_batches(rank=,
    world_size=)``); the step gives what one process gives on the global
    batch. The caller places the state and ``frozen`` once with
    :func:`place_state` (ZeRO-3); a leaf left whole trains as a replicated
    one. Tensor parallelism over the mesh's ``model`` axis: the processes
    of a ``model`` group hold the pieces of one replica (``place_state``)
    and feed the same slice of the batch; their logs are the same.
    Sequence parallelism over ``seq`` (``attn_impl="ring"`` under
    ``parallel/ring_attention.py set_ring_context``) and pipeline
    parallelism over ``pipe`` (``parallel/pipeline.py set_pipe_context``; the state placed
    by :func:`place_state`): the processes of a ``seq`` or ``pipe`` group
    feed the same slice of the batch and get the same logs; ``pipe`` with
    ``model`` raises, as the reference's pipeline does."""
    step_kw = dict(vg_mode=vg_mode, bf16_vlm=bf16_vlm, attn_impl=attn_impl, remat=remat,
                   dropout_seed=dropout_seed, vis_span=vis_span, gelu_mode=gelu_mode)
    if mesh is None:
        dev = resolve_device(device)
        step_fn = make_step_fn(cfg, optimizer, lora_cfg, **step_kw)

        def run(state: TrainState, frozen: dict, batch: dict):
            return step_fn(state, frozen, batch_to(batch, dev))

        return run

    sizes = axis_sizes(mesh)
    if sizes.get("pipe", 1) > 1 and sizes.get("model", 1) > 1:
        raise ValueError("pipeline parallelism does not compose with tensor parallelism in one "
                         "mesh; use model>1 XOR pipe>1")
    if resolve_device(device).type != mesh.device_type:
        raise ValueError(f"make_train_step: device {device} is not the mesh's "
                         f"{mesh.device_type}")
    model_group = mesh.get_group("model") if sizes["model"] > 1 else None
    pipe_group = mesh.get_group("pipe") if sizes.get("pipe", 1) > 1 else None
    step_fn = make_step_fn(cfg, optimizer, lora_cfg, group=mesh.get_group("data"),
                           model_group=model_group, pipe_group=pipe_group, **step_kw)

    def run_sharded(state: TrainState, frozen: dict, batch: dict):
        return step_fn(state, frozen, global_batch(batch, mesh))

    return run_sharded
