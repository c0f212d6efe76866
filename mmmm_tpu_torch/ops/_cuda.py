"""Build, load and launch the port's hand-written CUDA kernels.

The sources in ``mmmm_tpu_torch/csrc`` have a plain C interface: each entry
point takes raw device pointers, ``int`` sizes and the stream, launches, and
returns ``cudaGetLastError()``. They are compiled for ``sm_90a`` with one
``nvcc`` per source, all started together, linked into one shared library
in ``mmmm_tpu_torch/_build/`` (named by a hash of the sources, so an edit
rebuilds) and loaded with ``ctypes`` at first use. Nothing here runs at
import time.

Every launch goes through :class:`Kernel`, which raises on a non-zero return
and counts the launches it made (all of them, and those of each named form
of an entry point, such as K1's fused append; a launch may be of several
forms, such as K9's fused append in bf16); ``KERNELS`` maps each kernel's ID
to it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
COMPILE_FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    candidate = Path(home) / "bin" / "nvcc"
    if candidate.exists():
        return str(candidate)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")
    return found


def library_path() -> Path:
    """Path of the shared library for the current sources (built or not)."""
    h = hashlib.sha256()
    for f in sorted(CSRC.glob("*.cu*")):
        h.update(f.name.encode())
        h.update(f.read_bytes())
    h.update(" ".join(ARCH_FLAGS + COMPILE_FLAGS).encode())
    return BUILD_DIR / f"libmmmm_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile every ``csrc/*.cu`` in parallel and link them into one library.

    Returns the library path; a library already built from the same sources
    is reused. ``nvcc``'s output (``-Xptxas -v``: registers, shared memory
    and spills per kernel) is kept in ``<library>.log``. Raises with the
    compiler's message if any source fails.
    """
    so = library_path()
    if so.exists():
        return so
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    sources = sorted(CSRC.glob("*.cu"))
    objs = [BUILD_DIR / f"{src.stem}.{so.stem}.{os.getpid()}.o" for src in sources]
    procs = [
        subprocess.Popen(
            [nvcc, *ARCH_FLAGS, *COMPILE_FLAGS, "-I", str(CSRC), "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(sources, objs)
    ]
    log, failed = [], []
    for src, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log.append(f"== {src.name}\n{out}")
        if proc.returncode:
            failed.append(src.name)
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    tmp = so.with_suffix(f".tmp{os.getpid()}")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    if link.returncode:
        raise RuntimeError(f"linking the kernels failed:\n{link.stdout}")
    os.replace(tmp, so)
    so.with_suffix(".log").write_text("\n".join(log))
    for obj in objs:
        obj.unlink()
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built first if needed."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            lib.mmmm_error_string.argtypes = [ctypes.c_int]
            lib.mmmm_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


P = ctypes.c_void_p
I = ctypes.c_int
F = ctypes.c_float


class Kernel:
    """One C entry point of the library and its launch count."""

    def __init__(self, name: str, symbol: str, argtypes: list, source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source
        self.replaces = replaces
        self.launches = 0
        self.forms: dict[str, int] = {}  # launches of each named form, within ``launches``
        self._fn = None

    def reset(self) -> None:
        self.launches = 0
        self.forms.clear()

    def __call__(self, *args, form: str | tuple[str, ...] | None = None) -> None:
        if self._fn is None:
            fn = getattr(library(), self.symbol)
            fn.argtypes = self.argtypes
            fn.restype = ctypes.c_int
            self._fn = fn
        err = self._fn(*args)
        if err:
            msg = library().mmmm_error_string(err).decode()
            raise RuntimeError(f"{self.name} ({self.symbol}) launch failed: {msg} ({err})")
        self.launches += 1
        for f in (form,) if isinstance(form, str) else form or ():
            self.forms[f] = self.forms.get(f, 0) + 1


KERNELS: dict[str, Kernel] = {}


def register(kernel: Kernel) -> Kernel:
    KERNELS[kernel.name] = kernel
    return kernel


def stream_of(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check_cuda(name: str, *tensors: torch.Tensor, dtypes=None, align: int = 16) -> None:
    """Raise unless every tensor is a contiguous, aligned CUDA tensor on one
    device (and, with ``dtypes``, of one of those dtypes)."""
    dev = tensors[0].device
    for t in tensors:
        if t.device.type != "cuda" or t.device != dev:
            raise ValueError(f"{name}: expected CUDA tensors on one device, got {t.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: expected contiguous tensors, got strides {t.stride()}")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: tensor data is not {align}-byte aligned")
        if dtypes is not None and t.dtype not in dtypes:
            raise ValueError(f"{name}: unsupported dtype {t.dtype}")


def resolve_device(device: str | torch.device) -> torch.device:
    """The run's device; raises when CUDA is asked for and absent."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("CUDA is not available: the port runs on the card; "
                           "pass device='cpu' to run the plain versions on the CPU")
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}")
    return dev


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True when ``t`` lies on the CPU, where the caller takes the plain
    version; False for a CUDA tensor, where it launches the kernel; raises
    for any other device."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: no kernel for device {t.device}")
