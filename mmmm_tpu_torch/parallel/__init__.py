"""Data-parallel training over processes, the port of ``mmmm_tpu/parallel``
(the mesh, the sharding rules, the multi-process runtime, the desync
checks) with ZeRO-3 over the ``data`` axis (``zero.py``). Tensor, sequence
and pipeline parallelism (``tp_serving_params``, ring attention, GPipe) wait
for ROADMAP Queue 1 items 8b and 8c."""
from .debug import assert_replicated_equal, check_batch_uniform
from .distributed import global_batch, init_distributed, process_rank
from .mesh import make_mesh
from .sharding import (PartitionRules, batch_shardings, bytes_per_device, fsdp_shardings,
                       param_shardings)
from .zero import ZeroLeaf, gather_tree

__all__ = ["PartitionRules", "ZeroLeaf", "assert_replicated_equal", "batch_shardings",
           "bytes_per_device", "check_batch_uniform", "fsdp_shardings", "gather_tree",
           "global_batch", "init_distributed", "make_mesh", "param_shardings", "process_rank"]
