"""The multi-process runtime, the port of ``mmmm_tpu/parallel/distributed.py``
(``init_distributed``, ``process_rank``, ``global_batch``).

The reference trains multi-node DDP through Lightning (its JAX port runs
multi-controller SPMD). Here every process owns one device and joins one
``torch.distributed`` process group:

  - every process calls :func:`init_distributed`, from its arguments or
    from ``COORDINATOR_ADDRESS`` (``host:port`` of rank 0's rendezvous),
    ``NUM_PROCESSES`` and ``PROCESS_ID``; NCCL on the card, gloo when the
    caller asks for the CPU;
  - the mesh (``parallel/mesh.py``) spans every process; each process
    feeds its contiguous slice of the global batch (:func:`global_batch`);
  - the sampler takes the process's rank (:func:`process_rank`), so the
    processes read disjoint slices of one schedule
    (``data/batching.py scheduled_batches``).

A single-process run skips all of this: with no coordinator anywhere,
:func:`init_distributed` makes no group and returns False.
"""
from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist

from ..ops._cuda import resolve_device


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     device: str | torch.device = "cuda") -> bool:
    """Join the process group; returns True when there is more than one
    process.

    Resolution order: explicit arguments, then the environment
    (``COORDINATOR_ADDRESS``, ``NUM_PROCESSES``, ``PROCESS_ID``). With no
    coordinator address and no process count anywhere this is a no-op that
    returns False; an initialized group returns ``world > 1``. On the card
    the process takes the card ``process_id % torch.cuda.device_count()``
    and NCCL; ``device="cpu"`` takes gloo."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    env = os.environ
    coordinator_address = coordinator_address or env.get("COORDINATOR_ADDRESS")
    if num_processes is None and env.get("NUM_PROCESSES"):
        num_processes = int(env["NUM_PROCESSES"])
    if process_id is None and env.get("PROCESS_ID"):
        process_id = int(env["PROCESS_ID"])
    if coordinator_address is None and num_processes is None:
        return False
    if coordinator_address is None or num_processes is None or process_id is None:
        raise ValueError("init_distributed needs the coordinator address, the number of "
                         "processes and this process's id (COORDINATOR_ADDRESS, "
                         "NUM_PROCESSES, PROCESS_ID); got "
                         f"{coordinator_address!r}, {num_processes!r}, {process_id!r}")
    dev = resolve_device(device)
    card = None
    if dev.type == "cuda":
        card = torch.device("cuda", process_id % torch.cuda.device_count())
        torch.cuda.set_device(card)
    address = coordinator_address if "://" in coordinator_address else \
        f"tcp://{coordinator_address}"
    dist.init_process_group("nccl" if card is not None else "gloo", init_method=address,
                            world_size=num_processes, rank=process_id, device_id=card)
    return dist.get_world_size() > 1


def process_rank() -> tuple[int, int]:
    """``(rank, world_size)``, ``(0, 1)`` without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def mesh_device(mesh) -> torch.device:
    """The device this process owns in ``mesh``: its current card, or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def batch_to(batch: dict, device: torch.device) -> dict:
    """Array leaves (numpy or tensors) on ``device``, dtypes kept;
    ``patch_size`` / ``pool_size`` and other non-arrays pass through."""
    out = {}
    for k, v in batch.items():
        if isinstance(v, np.ndarray):
            v = torch.from_numpy(np.ascontiguousarray(v))
        out[k] = v.to(device) if isinstance(v, torch.Tensor) else v
    return out


def global_batch(batch: dict, mesh) -> dict:
    """This process's slice of the global batch (leading dimension = global
    batch / ``data`` size, rows in rank order) on its device
    (:func:`batch_to`)."""
    return batch_to(batch, mesh_device(mesh))


def all_reduce_sum(t: torch.Tensor, group) -> torch.Tensor:
    """The sum of ``t`` over ``group``'s processes (``t`` itself when
    ``group`` is None), outside autograd: the global counts that divide each
    process's share of a loss."""
    if group is None:
        return t
    t = t.detach().clone()
    dist.all_reduce(t, group=group)
    return t
