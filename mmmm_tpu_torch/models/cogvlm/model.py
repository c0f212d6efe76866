"""CogVLM vision splice, the port of ``splice_vision_embeds`` in
``mmmm_tpu/models/cogvlm/model.py``."""
from __future__ import annotations

import torch


def splice_vision_embeds(inputs_embeds: torch.Tensor, vision_embeds: torch.Tensor) -> torch.Tensor:
    """Overwrite embeddings [1, 1 + T') with the vision features."""
    n = vision_embeds.shape[1]
    return torch.cat([inputs_embeds[:, :1], vision_embeds.to(inputs_embeds.dtype),
                      inputs_embeds[:, 1 + n:]], dim=1)
