"""Data-, tensor-, sequence- and pipeline-parallel training and
tensor-parallel serving over processes, the port of ``mmmm_tpu/parallel``
(the mesh, the sharding rules, ``tp_serving_params``, the multi-process
runtime, the desync checks, ring attention, the GPipe pipeline), with ZeRO-3
over the ``data`` axis (``zero.py``), Megatron's collectives over the
``model`` axis (``tensor.py``), ring attention over ``seq``
(``ring_attention.py``) and the stages over ``pipe`` (``pipeline.py``)."""
from .debug import assert_replicated_equal, check_batch_uniform
from .distributed import global_batch, init_distributed, process_rank
from .mesh import make_mesh
from .pipeline import get_pipe_context, pipe_ready, pipeline_layers, set_pipe_context
from .ring_attention import get_ring_context, ring_segment_attention, set_ring_context
from .sharding import (PartitionRules, batch_shardings, bytes_per_device, fsdp_shardings,
                       gather_pieces, join_pieces, join_w4, local_params, param_shardings,
                       tp_serving_params)
from .zero import PipeLeaf, ZeroLeaf, gather_tree

__all__ = ["PartitionRules", "PipeLeaf", "ZeroLeaf", "assert_replicated_equal",
           "batch_shardings", "bytes_per_device", "check_batch_uniform", "fsdp_shardings",
           "gather_pieces", "gather_tree", "get_pipe_context", "get_ring_context", "global_batch",
           "init_distributed", "join_pieces", "join_w4", "local_params", "make_mesh",
           "param_shardings", "pipe_ready", "pipeline_layers", "process_rank",
           "ring_segment_attention", "set_pipe_context", "set_ring_context",
           "tp_serving_params"]
