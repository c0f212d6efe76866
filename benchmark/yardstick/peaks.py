"""Data-sheet peaks of the NVIDIA H100 (dense rates, no sparsity) and the
least time of a piece of work.

Frozen from the port's smoke script so that the yardstick does not move
with it. The rates assume the card's full power limit; a run reports the
limit it found beside every share of a peak.
"""
from __future__ import annotations

# part -> (HBM bytes/s, bf16 tensor FLOP/s, fp32 CUDA-core FLOP/s, int8 tensor OP/s)
PEAKS = {
    "H100 SXM": (3.35e12, 989e12, 67e12, 1979e12),
    "H100 PCIe": (2.0e12, 756e12, 51e12, 1513e12),
    "H100 NVL": (3.9e12, 835e12, 60e12, 1671e12),
}
RATE = {"bf16": 1, "fp32": 2, "int8": 3}


def card_peaks(name: str) -> tuple[str, tuple]:
    key = "H100 PCIe" if "PCIe" in name else "H100 NVL" if "NVL" in name else "H100 SXM"
    return key, PEAKS[key]


def least_seconds(flops: float, bytes_moved: float, kind: str, peaks: tuple) -> float:
    """The larger of the operations over the peak rate of ``kind`` and the
    bytes over the memory bandwidth."""
    return max(flops / peaks[RATE[kind]], bytes_moved / peaks[0])
