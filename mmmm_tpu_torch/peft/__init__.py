"""Parameter-efficient finetuning of the port: LoRA as a tree transformation
(``lora.py``)."""
from .lora import (FINETUNE_PATH_PREFIXES, LoraConfig, LoraLeaf, default_lora_targets,
                   lora_init, lora_merge, materialize, merge_trainable, split_trainable)

__all__ = ["FINETUNE_PATH_PREFIXES", "LoraConfig", "LoraLeaf", "default_lora_targets",
           "lora_init", "lora_merge", "materialize", "merge_trainable", "split_trainable"]
