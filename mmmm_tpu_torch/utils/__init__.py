"""Host utilities of the port: compressed array files (``io.py``) over the
native library (``native.py``: zstd, the trilinear uint8 resize, the
prefetcher), and the slice viewer (``viewer.py``, matplotlib)."""
from .io import load_array_zst, load_pt_zst, save_array_zst, save_pt_zst

__all__ = ["load_array_zst", "load_pt_zst", "save_array_zst", "save_pt_zst"]
