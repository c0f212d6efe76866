"""Compressed array container IO, the port of ``mmmm_tpu/utils/io.py``.

Two formats:

  - ``.pt.zst``: zstd-compressed torch serialization — byte-compatible with
    the reference's processed datasets (``luolib.utils.load_pt_zst``; files
    written by ``scripts/data/local/processors/_base.py:470-515``). torch (CPU)
    is used purely as a (de)serializer; arrays cross into numpy immediately.
  - ``.arr.zst``: the framework-native container — a tiny JSON header
    (dtype/shape/order) + zstd-compressed raw bytes. No pickle, seekable
    header, safe to mmap-decode, and trivially readable from C++.

zstd goes through the port's native library (``utils/native.py``) on every
host, the card's machine included, which has no ``zstandard`` package. It
reads what the JAX package's ``zstandard`` stream reader reads (frames with
or without a recorded content size, concatenated frames), and each package
reads the other's files.
"""
from __future__ import annotations

import io
import json
import struct
from pathlib import Path

import numpy as np
import torch

from . import native

_MAGIC = b"MMMMARR1"


def load_pt_zst(path) -> np.ndarray | dict:
    """Load a zstd-compressed torch file; tensors become numpy arrays."""
    data = native.zstd_decompress(Path(path).read_bytes())
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
    Path(path).write_bytes(native.zstd_compress(buf.getvalue(), level))


def save_array_zst(arr: np.ndarray, path, level: int = 3) -> None:
    arr = np.ascontiguousarray(arr)
    header = json.dumps({"dtype": arr.dtype.str, "shape": list(arr.shape)}).encode()
    payload = native.zstd_compress(arr.tobytes(), level)
    with open(path, "wb") as f:
        f.write(_MAGIC)
        f.write(struct.pack("<I", len(header)))
        f.write(header)
        f.write(payload)


def load_array_zst(path) -> np.ndarray:
    with open(path, "rb") as f:
        magic = f.read(8)
        if magic != _MAGIC:
            raise ValueError(f"{path}: not an .arr.zst file")
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen))
        raw = native.zstd_decompress(f.read())
    return np.frombuffer(raw, dtype=np.dtype(header["dtype"])).reshape(header["shape"]).copy()
