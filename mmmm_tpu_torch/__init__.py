"""PyTorch + CUDA port of ``mmmm_tpu`` for one NVIDIA H100.

The port imports PyTorch only, never JAX and nothing of ``mmmm_tpu``. Its
layout mirrors the JAX package (``ops``, ``models/cogvlm``,
``models/segvol``, ``models/{generate,inference,mmmm}.py``,
``data/tokenizer.py``); parameters are nested dicts of tensors in the JAX
tree's layout (``params.py``; W8A16 and W4A16 serving weights from
``ops/quant.py quantize_llm_for_serving``). The TPU's Pallas kernels on the
grounded report path (greedy or n-gram speculative decode, bf16 or int8 KV
cache with the plain or split-int8 read, chunked prefill, semantic or
instance SAM) are CUDA C++ kernels in ``csrc/`` (K1-K6, K8-K11; K12 is
K4's kernel; probe P1 is a variant of it), built with ``nvcc`` at first
use; every kernel wrapper takes its plain PyTorch version for CPU tensors
and launches the kernel for CUDA tensors.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .models.inference import GroundedResult, generate_grounded
from .models.mmmm import MMMMConfig
from .ops.quant import quantize_llm_for_serving
from .params import init_params, params_from_jax

__all__ = ["GroundedResult", "MMMMConfig", "generate_grounded", "init_params",
           "params_from_jax", "quantize_llm_for_serving"]
