"""Shared data-layer definitions (``mmmm/data/defs.py`` equivalent).

The port's own copy of ``mmmm_tpu/data/defs.py``.
"""
from __future__ import annotations

import os
from enum import Enum
from pathlib import Path
from typing import NamedTuple

CE_IGNORE_INDEX = -100
LANGUAGE_TOKEN_TYPE = 0
VISION_TOKEN_TYPE = 1


class ConvTurn(NamedTuple):
    prompt: str
    response: str


class Split(str, Enum):
    TRAIN = "train"
    VAL = "validate"
    TEST = "test"


def mmmm_debug() -> bool:
    return os.environ.get("MMMM_DEBUG", "").lower() in ("1", "true", "yes")


DATA_ROOT = Path(os.environ.get("MMMM_DATA_ROOT", "data"))
PROCESSED_DATA_ROOT = DATA_ROOT / ("processed-debug" if mmmm_debug() else "processed")
PROCESSED_LOCAL_DATA_ROOT = PROCESSED_DATA_ROOT / "local"
PROCESSED_VL_DATA_ROOT = PROCESSED_DATA_ROOT / "vision-language"
PROCESSED_VG_DATA_ROOT = PROCESSED_DATA_ROOT / "visual-grounding"
