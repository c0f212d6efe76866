"""ctypes bindings for the port's native host runtime
(``mmmm_tpu_torch/native/mmmm_native.cpp``), the port of
``mmmm_tpu/utils/native.py``: zstd encode and decode, the trilinear uint8
resize and the threaded file prefetcher.

The library is built with the host's C++ compiler (``$CXX`` or ``g++``) at
first use into ``mmmm_tpu_torch/_build/``, under a name hashed from the
source and the flags, so an edit rebuilds; it links the zstd runtime
library by its soname (``libzstd.so.1``), so no zstd headers are needed.
A missing compiler or library, or a failed build, raises with the
compiler's output: there is no pure-Python route.

The decoder reads what the ``zstandard`` package's stream reader reads:
frames that record their content size and frames that do not
(``stream_writer`` output), several frames one after another, and
skippable frames.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parent.parent
SOURCE = _PKG / "native" / "mmmm_native.cpp"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-Wall", "-shared", "-fPIC"]
LINK_FLAGS = ["-l:libzstd.so.1", "-lpthread"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def compiler() -> str:
    """The host C++ compiler: ``$CXX``, else ``g++`` on the path."""
    found = shutil.which(os.environ.get("CXX", "g++"))
    if found is None:
        raise RuntimeError("no C++ compiler for the native library: set CXX or install g++")
    return found


def library_path() -> Path:
    """Path of the shared library for the current source (built or not)."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(" ".join(CXX_FLAGS + LINK_FLAGS).encode())
    return BUILD_DIR / f"libmmmm_native_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the library unless one built from the same source exists;
    returns its path. Raises with the compiler's output on failure."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE), *LINK_FLAGS]
    r = subprocess.run(cmd, capture_output=True, text=True)
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"native library build failed ({' '.join(cmd)}):\n"
                           f"{r.stdout}{r.stderr}")
    os.replace(tmp, so)  # atomic: concurrent builders each land a whole file
    return so


def _load() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(str(build()))
        lib.mmmm_zstd_decompress.restype = ctypes.c_longlong
        lib.mmmm_zstd_decompress.argtypes = [ctypes.c_void_p, ctypes.c_size_t,
                                             ctypes.POINTER(ctypes.c_void_p)]
        lib.mmmm_free.restype = None
        lib.mmmm_free.argtypes = [ctypes.c_void_p]
        lib.mmmm_zstd_compress.restype = ctypes.c_longlong
        lib.mmmm_zstd_compress.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                                           ctypes.c_size_t, ctypes.c_int, ctypes.c_int]
        lib.mmmm_resize_trilinear_u8f32.restype = None
        lib.mmmm_resize_trilinear_u8f32.argtypes = (
            [ctypes.c_void_p] + [ctypes.c_int64] * 4 + [ctypes.c_void_p] + [ctypes.c_int64] * 3)
        lib.mmmm_prefetcher_create.restype = ctypes.c_void_p
        lib.mmmm_prefetcher_create.argtypes = [ctypes.c_int]
        lib.mmmm_prefetcher_submit.restype = ctypes.c_int64
        lib.mmmm_prefetcher_submit.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.mmmm_prefetcher_wait.restype = ctypes.c_longlong
        lib.mmmm_prefetcher_wait.argtypes = [ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
                                             ctypes.c_size_t]
        lib.mmmm_prefetcher_destroy.restype = None
        lib.mmmm_prefetcher_destroy.argtypes = [ctypes.c_void_p]
        _lib = lib
        return lib


def zstd_decompress(data: bytes) -> bytes:
    """Every frame of ``data`` decoded, one after another."""
    lib = _load()
    out = ctypes.c_void_p()
    n = lib.mmmm_zstd_decompress(data, len(data), ctypes.byref(out))
    if n < 0:
        raise ValueError("invalid or truncated zstd data")
    try:
        return ctypes.string_at(out, n)
    finally:
        lib.mmmm_free(out)


def zstd_compress(data: bytes, level: int = 3, content_size: bool = True) -> bytes:
    """One zstd frame of ``data``; ``content_size=False`` leaves the size out
    of the frame header, as ``zstandard``'s ``stream_writer`` does."""
    lib = _load()
    cap = lib.mmmm_zstd_compress(data, len(data), None, 0, level, 1)
    out = ctypes.create_string_buffer(cap)
    n = lib.mmmm_zstd_compress(data, len(data), out, cap, level, int(content_size))
    if n < 0:
        raise ValueError("zstd compression failed")
    return out.raw[:n]


def resize_trilinear_u8(volume: np.ndarray, shape: tuple[int, int, int]) -> np.ndarray:
    """(C, D, H, W) uint8 -> (C, d, h, w) float32 in [0, 1], half-pixel linear."""
    lib = _load()
    volume = np.ascontiguousarray(volume, np.uint8)
    if volume.ndim != 4 or len(shape) != 3 or min(shape) < 1 or min(volume.shape) < 1:
        raise ValueError(f"resize_trilinear_u8: (C, D, H, W) volume to 3 positive sizes, "
                         f"got {volume.shape} -> {tuple(shape)}")
    c, d0, h0, w0 = volume.shape
    d, h, w = shape
    out = np.empty((c, d, h, w), np.float32)
    lib.mmmm_resize_trilinear_u8f32(volume.ctypes.data, c, d0, h0, w0, out.ctypes.data, d, h, w)
    return out


class NativePrefetcher:
    """Background file reader and decompressor: ``submit(path)`` returns a
    job id, ``wait(id)`` the file's bytes (decoded when the file is zstd)."""

    def __init__(self, n_threads: int = 2):
        self.lib = _load()
        self.handle = self.lib.mmmm_prefetcher_create(n_threads)

    def submit(self, path: str | Path) -> int:
        return self.lib.mmmm_prefetcher_submit(self.handle, str(path).encode())

    def wait(self, job_id: int) -> bytes:
        n = self.lib.mmmm_prefetcher_wait(self.handle, job_id, None, 0)
        if n < 0:
            raise IOError(f"prefetch job {job_id} failed")
        out = ctypes.create_string_buffer(n)
        self.lib.mmmm_prefetcher_wait(self.handle, job_id, out, n)
        return out.raw

    def close(self) -> None:
        if getattr(self, "handle", None):
            self.lib.mmmm_prefetcher_destroy(self.handle)
            self.handle = None

    def __enter__(self):
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def __del__(self):
        self.close()
