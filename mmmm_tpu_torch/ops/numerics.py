"""The reference's non-default numeric switches, as a setting that an entry
point enters for the length of a call.

The JAX package reads them from the environment wherever it computes:
``MMMM_GELU`` / ``MMMM_FAST_GELU`` (``mmmm_tpu/ops/gelu.py:87-92``),
``MMMM_DENSE_FAST_SOFTMAX`` (``mmmm_tpu/ops/dense_attn.py:38-41``) and
``MMMM_Q8_CAST`` (``mmmm_tpu/ops/decode_kernel.py:722``). The port reads
none of them: the entry points take them as keywords (``gelu_mode``,
``dense_fast_softmax``, ``q8_cast``) and run under :func:`numerics`, which
``ops/gelu.py gelu``, ``ops/attention.py segment_attention`` and the decode
step (``models/cogvlm/decoder.py``) read through :func:`current`.

The setting is one module-wide value, not a thread-local one: the backward
of CUDA tensors, where a rematerialized layer recomputes, runs on the
autograd engine's own thread while the entry point's call waits for it.
"""
from __future__ import annotations

import contextlib
import dataclasses

GELU_MODES = ("auto", "fitted", "tanh", "erf")
Q8_CASTS = ("f32", "bf16")


@dataclasses.dataclass(frozen=True)
class Numerics:
    gelu_mode: str = "auto"  # MMMM_GELU ("tanh" also MMMM_FAST_GELU=1)
    dense_fast_softmax: bool = False  # MMMM_DENSE_FAST_SOFTMAX=1: K4's fast softmax
    q8_cast: str = "f32"  # MMMM_Q8_CAST: K9's products in fp32 or bf16

    def __post_init__(self):
        if self.gelu_mode not in GELU_MODES:
            raise ValueError(f"gelu_mode must be one of {GELU_MODES}, got {self.gelu_mode!r}")
        if self.q8_cast not in Q8_CASTS:
            raise ValueError(f"q8_cast must be one of {Q8_CASTS}, got {self.q8_cast!r}")


_current = Numerics()


def current() -> Numerics:
    """The setting of the running call (the defaults outside any)."""
    return _current


@contextlib.contextmanager
def numerics(gelu_mode: str = "auto", dense_fast_softmax: bool = False, q8_cast: str = "f32"):
    """Run the body under these switches; the previous setting comes back
    after it."""
    global _current
    prev, _current = _current, Numerics(gelu_mode, bool(dense_fast_softmax), q8_cast)
    try:
        yield _current
    finally:
        _current = prev
