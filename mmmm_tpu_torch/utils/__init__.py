"""Host utilities of the port: compressed array files (``io.py``)."""
from .io import load_array_zst, load_pt_zst, save_array_zst, save_pt_zst

__all__ = ["load_array_zst", "load_pt_zst", "save_array_zst", "save_pt_zst"]
