"""Data- and tensor-parallel training and tensor-parallel serving over
processes, the port of ``mmmm_tpu/parallel`` (the mesh, the sharding rules,
``tp_serving_params``, the multi-process runtime, the desync checks), with
ZeRO-3 over the ``data`` axis (``zero.py``) and Megatron's collectives over
the ``model`` axis (``tensor.py``). Sequence and pipeline parallelism (ring
attention, GPipe) wait for ROADMAP Queue 1 item 8c."""
from .debug import assert_replicated_equal, check_batch_uniform
from .distributed import global_batch, init_distributed, process_rank
from .mesh import make_mesh
from .sharding import (PartitionRules, batch_shardings, bytes_per_device, fsdp_shardings,
                       gather_pieces, join_pieces, local_params, param_shardings,
                       tp_serving_params)
from .zero import ZeroLeaf, gather_tree

__all__ = ["PartitionRules", "ZeroLeaf", "assert_replicated_equal", "batch_shardings",
           "bytes_per_device", "check_batch_uniform", "fsdp_shardings", "gather_pieces",
           "gather_tree", "global_batch", "init_distributed", "join_pieces", "local_params",
           "make_mesh", "param_shardings", "process_rank", "tp_serving_params"]
