"""Rematerialization of one layer, the port of ``mmmm_tpu/ops/remat.py``
(``remat_policy``).

``remat=True`` recomputes the whole layer in the backward
(``torch.utils.checkpoint``, non-reentrant), the granularity of the
reference's ``jax.checkpoint`` around each scan body; ``remat=False`` (or
None) is a plain call. The selective policies run the same checkpoint with
a policy over the operators the dispatcher sees
(``create_selective_checkpoint_contexts``):

  - ``"dots"`` (``dots_with_no_batch_dims_saveable``) keeps the outputs of
    the matrix products with no batch dimension, ``aten.mm`` and
    ``aten.addmm`` (every projection ``x @ w``, and the per-layer LoRA
    merge's ``a @ b``), and recomputes the batched products (``bmm``, the
    plain attention's einsums) and everything else;
  - ``"attn"`` (``save_only_these_names("attn_out")``) keeps only what is
    tagged ``"attn_out"``: the LLM layer's attention context
    (:func:`checkpoint_name`, the counterpart of JAX's ``checkpoint_name``). On
    the flash route the tag rides on the flash operator itself
    (``ops/flash.py flash_attention(name=...)``), so its outputs, the
    context and its logsumexp, are kept and the backward runs K7 from them
    without launching K3 again.

A custom operator may not return an alias of its input, so a tag op
returns a copy: the flash route carries the name as an argument instead,
to keep one copy of the context.
"""
from __future__ import annotations

import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

ATTN_OUT = "attn_out"


@torch.library.custom_op("mmmm::checkpoint_name", mutates_args=())
def checkpoint_name(x: torch.Tensor, name: str) -> torch.Tensor:
    """``x``, tagged ``name`` for the ``"attn"`` policy (a copy)."""
    return x.clone()


torch.library.register_autograd(
    "mmmm::checkpoint_name", lambda ctx, g: (g, None),
    setup_context=lambda ctx, inputs, output: None)


def _saves(remat, op, args) -> bool:
    if remat == "dots":
        return op in (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)
    if op is torch.ops.mmmm.checkpoint_name.default:
        return args[1] == ATTN_OUT
    if op is torch.ops.mmmm.flash_attention.default:
        return args[-1] == ATTN_OUT
    return False


def _policy(remat, ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if _saves(remat, op, args)
            else CheckpointPolicy.PREFER_RECOMPUTE)


def check_policy(remat) -> None:
    """Raise unless ``remat`` is a policy :func:`remat_call` takes."""
    if not (remat is True or remat is False or remat is None or remat in ("attn", "dots")):
        raise ValueError(f"unknown remat policy {remat!r}")


def remat_call(fn, remat, *args):
    """``fn(*args)`` under the rematerialization policy ``remat``: True,
    False / None, ``"attn"`` or ``"dots"``."""
    if remat is True:
        return checkpoint(fn, *args, use_reentrant=False)
    if remat is False or remat is None:
        return fn(*args)
    check_policy(remat)
    from . import flash  # noqa: F401  (registers mmmm::flash_attention)

    context = functools.partial(create_selective_checkpoint_contexts,
                                functools.partial(_policy, remat))
    return checkpoint(fn, *args, use_reentrant=False, context_fn=context)
