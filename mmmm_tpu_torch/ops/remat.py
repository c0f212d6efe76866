"""Rematerialization of one layer, the port of ``mmmm_tpu/ops/remat.py``.

``remat=True`` recomputes the whole layer in the backward
(``torch.utils.checkpoint``, non-reentrant), the granularity of the
reference's ``jax.checkpoint`` around each scan body; ``remat=False`` is a
plain call. The reference's selective policies ``"dots"`` and ``"attn"``
need checkpointing that sees the port's kernel calls and are not ported yet
(ROADMAP Queue 1).
"""
from __future__ import annotations

from torch.utils.checkpoint import checkpoint


def remat_call(fn, remat, *args):
    """``fn(*args)``, recomputed in the backward when ``remat`` is True."""
    if remat in ("dots", "attn"):
        raise NotImplementedError(f"remat={remat!r} (selective checkpointing) is not ported "
                                  "yet; see ROADMAP Queue 1")
    if remat is True:
        return checkpoint(fn, *args, use_reentrant=False)
    if remat is False or remat is None:
        return fn(*args)
    raise ValueError(f"unknown remat policy {remat!r}")
