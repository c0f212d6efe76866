"""MMMM tokenizer: a base LM tokenizer + the 8 grounding special tokens.

The port's own copy of ``mmmm_tpu/data/tokenizer.py``. The backend is
pluggable: ``MMMMTokenizer.from_pretrained(path)`` wraps a HuggingFace fast
tokenizer (``transformers`` is imported there only), and
``MMMMTokenizer.byte_fallback()`` is a self-contained byte-level tokenizer
(ids 0 pad, 1 bos, 2 eos, 3..258 bytes) for tests and random-weight runs.

``parse_targets`` extracts grounded phrase spans from generated ids using the
full span ``ids[bop+1 : i]``; ``compat_drop_last=True`` reproduces the
reference's ``ids[bop+1 : i-1]``.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

SPECIAL_TOKENS = ("<sys>", "<usr>", "<grd>", "<ngrd>", "<p>", "</p>", "<np>", "</np>")


class _ByteBackend:
    """Minimal self-contained byte-level tokenizer."""

    pad_token_id = 0
    bos_token_id = 1
    eos_token_id = 2

    def __init__(self):
        self.base_vocab_size = 259

    def encode(self, text: str) -> list[int]:
        return [3 + b for b in text.encode("utf-8")]

    def decode(self, ids: Sequence[int]) -> str:
        data = bytes(i - 3 for i in ids if 3 <= i < 259)
        return data.decode("utf-8", errors="replace")


class _HFBackend:
    """Wraps a HuggingFace fast tokenizer already holding the base vocab.

    ``handles_specials``: the 8 MMMM specials are AddedTokens inside the HF
    tokenizer, so one ``encode`` call splits on them natively; encoding the
    segments separately would give every post-special segment its own
    sentencepiece dummy-prefix space."""

    handles_specials = True

    def __init__(self, tok):
        self.tok = tok
        self.base_vocab_size = tok.vocab_size
        self.pad_token_id = tok.pad_token_id if tok.pad_token_id is not None else 0
        self.bos_token_id = tok.bos_token_id
        self.eos_token_id = tok.eos_token_id

    def encode(self, text: str) -> list[int]:
        return self.tok.encode(text, add_special_tokens=False)

    def decode(self, ids: Sequence[int]) -> str:
        return self.tok.decode(ids)


class MMMMTokenizer:
    def __init__(self, backend, special_to_id: dict[str, int] | None = None):
        self.backend = backend
        self.base_vocab_size = backend.base_vocab_size
        self.pad_token_id = backend.pad_token_id
        self.bos_token_id = backend.bos_token_id
        self.eos_token_id = backend.eos_token_id
        self._special_to_id = special_to_id or {
            tok: self.base_vocab_size + i for i, tok in enumerate(SPECIAL_TOKENS)
        }
        (
            self.sys_token_id,
            self.usr_token_id,
            self.grd_token_id,
            self.ngrd_token_id,
            self.bop_token_id,
            self.eop_token_id,
            self.bonp_token_id,
            self.eonp_token_id,
        ) = (self._special_to_id[t] for t in SPECIAL_TOKENS)

    @classmethod
    def from_pretrained(cls, path: str) -> "MMMMTokenizer":
        from transformers import AutoTokenizer

        tok = AutoTokenizer.from_pretrained(path, use_fast=True)
        tok.add_tokens(list(SPECIAL_TOKENS), special_tokens=True)
        return cls(_HFBackend(tok), {t: tok.convert_tokens_to_ids(t) for t in SPECIAL_TOKENS})

    @classmethod
    def byte_fallback(cls) -> "MMMMTokenizer":
        return cls(_ByteBackend())

    def __len__(self) -> int:
        return self.base_vocab_size + len(SPECIAL_TOKENS)

    @property
    def vocab_size(self) -> int:
        return len(self)

    def encode(self, text: str) -> list[int]:
        """Encode text, recognizing special tokens as atomic units."""
        if getattr(self.backend, "handles_specials", False):
            return self.backend.encode(text)
        ids: list[int] = []
        rest = text
        while rest:
            hits = [(rest.index(t), t) for t in SPECIAL_TOKENS if t in rest]
            if not hits:
                ids.extend(self.backend.encode(rest))
                break
            pos, tok = min(hits, key=lambda h: (h[0], -len(h[1])))
            if pos:
                ids.extend(self.backend.encode(rest[:pos]))
            ids.append(self._special_to_id[tok])
            rest = rest[pos + len(tok):]
        return ids

    def decode(self, ids: Sequence[int]) -> str:
        out: list[str] = []
        chunk: list[int] = []
        id_to_special = {v: k for k, v in self._special_to_id.items()}
        for i in ids:
            if i in id_to_special:
                if chunk:
                    out.append(self.backend.decode(chunk))
                    chunk = []
                out.append(id_to_special[i])
            elif i == self.eos_token_id or i == self.bos_token_id:
                continue
            else:
                chunk.append(i)
        if chunk:
            out.append(self.backend.decode(chunk))
        return "".join(out)

    def wrap_name(self, name: str, pos: bool) -> str:
        """A class name in ``<p> ...</p>`` (positive) or ``<np> ...</np>``."""
        bop, eop = ("<p>", "</p>") if pos else ("<np>", "</np>")
        return f"{bop} {name}{eop}"

    def _parse_targets(self, ids: Sequence[int], compat_drop_last: bool) -> list[str] | None:
        ret: list[str] = []
        last_bop: int | None = None
        for i, tid in enumerate(ids):
            if tid == self.bop_token_id:
                if last_bop is not None:
                    return None
                last_bop = i
            elif tid == self.eop_token_id:
                if last_bop is None:
                    return None
                end = i - 1 if compat_drop_last else i
                ret.append(self.decode(list(ids[last_bop + 1: end])).strip())
                last_bop = None
        return ret

    def parse_targets(self, batch_ids, compat_drop_last: bool = False):
        """(B, S) int array -> per-sample list of grounded phrases (None on
        malformed tag nesting)."""
        arr = np.asarray(batch_ids)
        return [self._parse_targets([int(t) for t in arr[i]], compat_drop_last)
                for i in range(arr.shape[0])]
