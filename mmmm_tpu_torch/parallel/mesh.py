"""The device mesh, the port of ``mmmm_tpu/parallel/mesh.py make_mesh``: one
``torch.distributed`` ``DeviceMesh`` over every process, its axes named and
ordered as the reference's: ``pipe`` (outermost, only above 1), ``data``,
``model``, ``seq`` (innermost, only above 1).

A process owns one device: the card ``rank % torch.cuda.device_count()``,
or the CPU under gloo. The mesh must fill the world: where ``data x model x
seq x pipe`` is not the number of processes, :func:`make_mesh` raises (the
reference drops its spare devices; a spare process would have no role).
"""
from __future__ import annotations

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh

from ..ops._cuda import resolve_device


def make_mesh(data: int | None = None, model: int = 1, seq: int = 1, pipe: int = 1, *,
              device: str | torch.device = "cuda"):
    """A ``(pipe,) data, model (, seq)`` mesh over the process group;
    ``data=None`` takes every process that the other axes leave. Without a
    process group (one process, :func:`..distributed.init_distributed`
    returned False) a group of this process alone is made, in memory."""
    dev = resolve_device(device)
    world = dist.get_world_size() if dist.is_initialized() else 1
    rest = model * seq * pipe
    if data is None:
        if world % rest:
            raise ValueError(f"{world} processes not divisible by model={model} x seq={seq} "
                             f"x pipe={pipe}")
        data = world // rest
    if data * rest != world:
        raise ValueError(f"the mesh data={data} x model={model} x seq={seq} x pipe={pipe} "
                         f"must hold every one of the {world} processes (launch data x model "
                         "x seq x pipe processes, one a device)")
    card = None
    if dev.type == "cuda":
        card = torch.device("cuda", (dist.get_rank() if dist.is_initialized() else 0)
                            % torch.cuda.device_count())
        torch.cuda.set_device(card)
    if not dist.is_initialized():
        dist.init_process_group("nccl" if card is not None else "gloo",
                                store=dist.HashStore(), rank=0, world_size=1, device_id=card)
    shape, names = ([pipe], ["pipe"]) if pipe > 1 else ([], [])
    shape += [data, model]
    names += ["data", "model"]
    if seq > 1:
        shape.append(seq)
        names.append("seq")
    return init_device_mesh(dev.type, tuple(shape), mesh_dim_names=tuple(names))
