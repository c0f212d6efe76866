"""CogVLM model configuration (the port's own copy of
``mmmm_tpu/models/cogvlm/config.py``; the two must stay field-for-field equal).

Mirrors the reference's ``CogVLMConfig`` + vision dict
(``mmmm/models/cogvlm/configuration_cogvlm.py``; vision defaults from the
THUDM/cogvlm-chat-hf checkpoint, EVA2-CLIP-E) with the MMMM overrides from
``conf/model.yaml``: ViT patch 16, pos-embed grid (8, 32, 32) inflated from the
pretrained 2-D (35, 35).
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class VisionConfig:
    in_channels: int = 3
    hidden_size: int = 1792
    intermediate_size: int = 15360
    num_hidden_layers: int = 63
    num_heads: int = 16
    patch_size: Tuple[int, int, int] = (16, 16, 16)  # (z_max, h, w); z collapses at runtime
    pos_embed_shape: Tuple[int, int, int] = (8, 32, 32)
    pt_pos_embed_shape: Tuple[int, int] = (35, 35)
    layer_norm_eps: float = 1e-6
    dropout_prob: float = 0.0

    @classmethod
    def tiny(cls) -> "VisionConfig":
        return cls(
            hidden_size=32,
            intermediate_size=64,
            num_hidden_layers=2,
            num_heads=4,
            patch_size=(4, 4, 4),
            pos_embed_shape=(2, 4, 4),
            pt_pos_embed_shape=(5, 5),
        )


@dataclasses.dataclass(frozen=True)
class CogVLMConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_base: float = 10000.0
    vision: VisionConfig = dataclasses.field(default_factory=VisionConfig)

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_attention_heads

    @classmethod
    def tiny(cls, vocab_size: int = 128) -> "CogVLMConfig":
        return cls(
            vocab_size=vocab_size,
            hidden_size=64,
            intermediate_size=128,
            num_hidden_layers=2,
            num_attention_heads=4,
            max_position_embeddings=256,
            vision=VisionConfig.tiny(),
        )

    @classmethod
    def cogvlm17b(cls, vocab_size: int = 32008) -> "CogVLMConfig":
        """The flagship config: Vicuna-7B LLM + dual experts + EVA2-CLIP-E ViT
        with the 8 MMMM special tokens appended to the vocab."""
        return cls(vocab_size=vocab_size)
