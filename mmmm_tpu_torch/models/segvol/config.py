"""SegVol-derived SAM configuration (``mmmm/models/segvol/build_sam.py:12-57``).

The port's own copy of ``mmmm_tpu/models/segvol/config.py``; the two must
stay field-for-field equal."""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class SamConfig:
    in_channels: int = 3
    embed_dim: int = 768
    encoder_num_layers: int = 12
    encoder_num_heads: int = 12
    encoder_mlp_ratio: int = 4
    patch_size: Tuple[int, int, int] = (16, 16, 16)  # z collapses at runtime
    pos_embed_shape: Tuple[int, int, int] = (8, 32, 32)
    # mask decoder
    num_instances: int = 6  # instance queries (conf/phase-vg/model.yaml)
    decoder_depth: int = 2
    decoder_num_heads: int = 8
    decoder_mlp_dim: int = 2048
    attention_downsample_rate: int = 2

    @property
    def encoder_mlp_dim(self) -> int:
        return self.embed_dim * self.encoder_mlp_ratio

    @property
    def num_mask_tokens(self) -> int:
        return self.num_instances + 1  # 1 semantic + N instance

    @classmethod
    def tiny(cls) -> "SamConfig":
        return cls(
            embed_dim=32,
            encoder_num_layers=2,
            encoder_num_heads=4,
            patch_size=(4, 4, 4),
            pos_embed_shape=(2, 4, 4),
            num_instances=3,
            decoder_mlp_dim=64,
        )
