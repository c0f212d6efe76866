"""Top-level MMMM configuration and the grounding projection, the port of
``MMMMConfig`` and ``vg_project`` in ``mmmm_tpu/models/mmmm.py`` (the loss
fields of the config belong to training, a later slice).

Precision policy of the reference: the VLM runs in the parameter dtype
(bf16 when serving), SAM and ``vg_proj`` stay fp32.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from .cogvlm import CogVLMConfig
from .segvol import SamConfig


@dataclasses.dataclass(frozen=True)
class MMMMConfig:
    vlm: CogVLMConfig = dataclasses.field(default_factory=CogVLMConfig)
    sam: SamConfig = dataclasses.field(default_factory=SamConfig)

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "MMMMConfig":
        return cls(vlm=CogVLMConfig.tiny(vocab_size), sam=SamConfig.tiny())


def vg_project(params: dict, hidden: torch.Tensor) -> torch.Tensor:
    """Linear(C, C) -> ReLU -> Linear(C, prompt_dim) in fp32."""
    p = params["vg_proj"]
    x = F.relu(hidden.float() @ p["w1"] + p["b1"])
    return x @ p["w2"] + p["b2"]
