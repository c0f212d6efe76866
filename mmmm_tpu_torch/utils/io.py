"""Compressed array container IO.

Two formats:

  - ``.pt.zst``: zstd-compressed torch serialization — byte-compatible with
    the reference's processed datasets (``luolib.utils.load_pt_zst``; files
    written by ``scripts/data/local/processors/_base.py:470-515``). torch (CPU)
    is used purely as a (de)serializer; arrays cross into numpy immediately.
  - ``.arr.zst``: the framework-native container — a tiny JSON header
    (dtype/shape/order) + zstd-compressed raw bytes. No pickle, seekable
    header, safe to mmap-decode, and trivially readable from C++ (the planned
    native loader reads this format).
"""
from __future__ import annotations

import io
import json
import struct
from pathlib import Path

import numpy as np
import torch

_MAGIC = b"MMMMARR1"


def load_pt_zst(path) -> np.ndarray | dict:
    """Load a zstd-compressed torch file; tensors become numpy arrays."""
    import zstandard

    with open(path, "rb") as f:
        data = zstandard.ZstdDecompressor().stream_reader(f).read()
    obj = torch.load(io.BytesIO(data), map_location="cpu", weights_only=False)

    def conv(x):
        if isinstance(x, torch.Tensor):
            return x.numpy()
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x

    return conv(obj)


def save_pt_zst(obj, path, level: int = 3) -> None:
    """Save (nested) numpy arrays as a zstd-compressed torch file."""
    import zstandard

    def conv(x):
        if isinstance(x, np.ndarray):
            return torch.from_numpy(np.ascontiguousarray(x))
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, (list, tuple)):
            return type(x)(conv(v) for v in x)
        return x

    buf = io.BytesIO()
    torch.save(conv(obj), buf)
    Path(path).write_bytes(zstandard.ZstdCompressor(level=level).compress(buf.getvalue()))


def save_array_zst(arr: np.ndarray, path, level: int = 3) -> None:
    import zstandard

    arr = np.ascontiguousarray(arr)
    header = json.dumps({"dtype": arr.dtype.str, "shape": list(arr.shape)}).encode()
    payload = zstandard.ZstdCompressor(level=level).compress(arr.tobytes())
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload)


def load_array_zst(path) -> np.ndarray:
    import zstandard

    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an .arr.zst file")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        raw = zstandard.ZstdDecompressor().stream_reader(f).read()
    return np.frombuffer(raw, dtype=np.dtype(header["dtype"])).reshape(header["shape"]).copy()
