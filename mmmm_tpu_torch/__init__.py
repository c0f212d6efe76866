"""PyTorch + CUDA port of ``mmmm_tpu`` for one NVIDIA H100.

The port imports PyTorch only, never JAX and nothing of ``mmmm_tpu``. Its
layout mirrors the JAX package (``ops``, ``models/cogvlm``,
``models/segvol``, ``models/{generate,inference,mmmm}.py``,
``data/tokenizer.py``); parameters are nested dicts of tensors in the JAX
tree's layout (``params.py``; W8A16 and W4A16 serving weights from
``ops/quant.py quantize_llm_for_serving``). The TPU's Pallas kernels on the
grounded report path (greedy or n-gram speculative decode, bf16 or int8 KV
cache with the plain or split-int8 read, chunked prefill, semantic or
instance SAM) and on the LoRA training step (``train/``, ``peft/``; the
flash backward K7) are CUDA C++ kernels in ``csrc/`` (K1-K11; K12 is K4's
kernel; probe P1 is a variant of it), built with ``nvcc`` at first use;
every kernel wrapper takes its plain PyTorch version for CPU tensors and
launches the kernel for CUDA tensors. The continuous-batching servers
(``models/serving.py``), the text-generation harness
(``models/llm_batch.py``), the YAML configs (``config.py``), the ``.npz``
checkpoints (``train/checkpoint.py``) and the builders (``build.py``) run
on the same kernels. The training loop (``train/trainer.py Trainer``, its
step checkpoints ``CheckpointManager``) streams the data layer's batches
(``data/``: transforms, sampler, bucketing, ``MultiDataset``; ``utils/io.py``)
into the training step; ``models/align.py`` is stage-0 SAM alignment;
``cli.py`` has the ``fit`` and ``align-sam`` commands. The pseudo-box
detector (``models/detector.py``; its matcher ``ops/hungarian.py
lap_rectangular`` is the kernel LAP on the card), the 3-D UNet
(``models/unet.py``), the segmentation ablation (``train/seg_exp.py``) and
dataset processing (``preprocess/``, host only) are the ``detector-train``,
``detector-infer``, ``seg-exp`` and ``process`` commands.

Entry points run on the card unless the caller passes ``device="cpu"``.
"""
from .models.inference import GroundedResult, generate_grounded
from .models.llm_batch import make_text_generator
from .models.mmmm import MMMMConfig, MMMMModel
from .models.serving import GroundedServer, TextServer
from .ops.quant import quantize_llm_for_serving
from .params import init_params, params_from_jax, train_state_from_jax
from .peft.lora import LoraConfig
from .train import (OptimizerConfig, Trainer, TrainerConfig, init_train_state, make_optimizer,
                    make_train_step)

__all__ = ["GroundedResult", "GroundedServer", "LoraConfig", "MMMMConfig", "MMMMModel",
           "OptimizerConfig", "TextServer", "Trainer", "TrainerConfig", "generate_grounded",
           "init_params",
           "init_train_state", "make_optimizer", "make_text_generator", "make_train_step",
           "params_from_jax", "quantize_llm_for_serving", "train_state_from_jax"]
