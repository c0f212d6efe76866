"""Conversation -> packed VLM input arrays.

Host-side (numpy) equivalent of ``prepare_vlm_inputs``
(``mmmm/data/utils.py:39-145``), reproducing the exact token layout:

  ``bos, boi, <image patches...>, eoi, <grd|ngrd>, text...``

with CogVLM's position-id scheme: positions [0, 1] for bos/boi, all image
patches share position 2, [3, 4] for eoi/grounding-flag, then text positions
starting at 5 where a token after ``<p>`` or a ``</p>`` token repeats the
previous position (``get_text_position_ids``, ``utils.py:20-29``).

Labels are pre-shifted (label[t] is the target for predicting input[t+1]);
negative-phrase tokens ``<np>/</np>`` are rewritten to ``<p>/</p>`` in the
inputs while labels are adjusted so the model never *predicts* a grounded
opening for negatives (``utils.py:87-101``).

TPU extras over the reference: ``pad_to`` pads everything to a static bucket
length, and ``vg_positions``/``vg_valid`` (fixed ``max_targets``) record the
hidden-state gather indices for ``</p>`` grounding, replacing runtime boolean
masking.

The port's own copy of ``mmmm_tpu/data/input_builder.py``, over the port's
``data/tokenizer.py``.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from .defs import CE_IGNORE_INDEX, ConvTurn, LANGUAGE_TOKEN_TYPE, VISION_TOKEN_TYPE
from .tokenizer import MMMMTokenizer


@dataclasses.dataclass
class VLMInputs:
    input_ids: np.ndarray
    token_type_ids: np.ndarray
    position_ids: np.ndarray
    attention_mask: np.ndarray  # 1/0 ints; doubles as the segment-id row
    labels: np.ndarray | None = None
    weight: np.ndarray | None = None

    def as_dict(self) -> dict:
        d = {
            "input_ids": self.input_ids,
            "token_type_ids": self.token_type_ids,
            "position_ids": self.position_ids,
            "attention_mask": self.attention_mask,
        }
        if self.labels is not None:
            d["labels"] = self.labels
            d["weight"] = self.weight
        return d


def get_text_position_ids(text_ids: np.ndarray, tokenizer: MMMMTokenizer, start: int) -> np.ndarray:
    ret = np.empty_like(text_ids)
    ret[0] = start
    for i in range(1, len(text_ids)):
        if text_ids[i - 1] == tokenizer.bop_token_id or text_ids[i] == tokenizer.eop_token_id:
            ret[i] = ret[i - 1]
        else:
            ret[i] = ret[i - 1] + 1
    return ret


def prepare_vlm_inputs(
    conversation: list[ConvTurn],
    tokenizer: MMMMTokenizer,
    num_image_tokens: int,
    *,
    inference: bool,
    grounding: bool,
    max_seq_len: int | None = None,
    bop_weight: float | None = None,
) -> tuple[VLMInputs, str]:
    """Build the packed input arrays for one conversation.

    ``num_image_tokens`` counts image-patch tokens only (boi/eoi are added
    here, as in ``utils.py:104``).
    """
    assert len(conversation) > 0
    if not inference and grounding:
        assert bop_weight is not None

    text_preview = "\n".join(f"<usr> {q}\n<sys> {a}" for q, a in conversation)

    text_chunks: list[np.ndarray] = []
    label_chunks: list[np.ndarray] = []
    for i, (query, answer) in enumerate(conversation):
        prompt_ids = np.asarray(tokenizer.encode(f"<usr> {query}<sys>"), np.int64)
        if inference and i + 1 == len(conversation):
            text_chunks.append(prompt_ids)
        else:
            answer_ids = np.asarray(tokenizer.encode(answer), np.int64)
            text_chunks.append(np.concatenate([prompt_ids, answer_ids]))
            if not inference:
                label_chunks.append(
                    np.concatenate([
                        np.full(len(prompt_ids) - 1, CE_IGNORE_INDEX, np.int64),
                        answer_ids,
                        np.asarray([tokenizer.eos_token_id], np.int64),
                    ])
                )

    text_ids = np.concatenate(text_chunks)
    # rewrite negative-phrase tags to positive in the *inputs*
    tail = text_ids[1:]
    bonp_mask = tail == tokenizer.bonp_token_id
    eonp_mask = tail == tokenizer.eonp_token_id
    tail[bonp_mask] = tokenizer.bop_token_id
    tail[eonp_mask] = tokenizer.eop_token_id

    labels = weight = None
    if not inference:
        labels = np.concatenate(label_chunks)
        head = labels[:-1]
        # negatives: predict the token after <np>, and close with </p> directly
        head[bonp_mask] = labels[1:][bonp_mask]
        head[eonp_mask] = tokenizer.eop_token_id
        weight = np.ones(len(labels), np.float32)
        if bop_weight is not None:
            weight[:-1][text_ids[1:] == tokenizer.bop_token_id] = bop_weight

    n_img = num_image_tokens + 2  # + boi/eoi
    input_ids = np.concatenate([
        np.asarray([tokenizer.bos_token_id], np.int64),
        np.zeros(n_img, np.int64),
        np.asarray([tokenizer.grd_token_id if grounding else tokenizer.ngrd_token_id], np.int64),
        text_ids,
    ])
    token_type_ids = np.concatenate([
        np.asarray([LANGUAGE_TOKEN_TYPE], np.int64),
        np.full(n_img, VISION_TOKEN_TYPE, np.int64),
        np.full(1 + len(text_ids), LANGUAGE_TOKEN_TYPE, np.int64),
    ])
    position_ids = np.concatenate([
        np.asarray([0, 1], np.int64),
        np.full(n_img - 2, 2, np.int64),
        np.asarray([3, 4], np.int64),
        get_text_position_ids(text_ids, tokenizer, start=5),
    ])
    attention_mask = np.ones(len(input_ids), np.int64)
    if not inference:
        prefix = 1 + n_img + 1
        labels = np.concatenate([np.full(prefix, CE_IGNORE_INDEX, np.int64), labels])
        weight = np.concatenate([np.zeros(prefix, np.float32), weight])

    inputs = VLMInputs(input_ids, token_type_ids, position_ids, attention_mask, labels, weight)
    if max_seq_len is not None:
        for f in dataclasses.fields(VLMInputs):
            v = getattr(inputs, f.name)
            if v is not None:
                setattr(inputs, f.name, v[:max_seq_len])
    return inputs, text_preview


def pad_to(inputs: VLMInputs, seq_len: int) -> VLMInputs:
    """Right-pad all arrays to a static bucket length (pad ids 0, labels
    IGNORE, mask/weight 0 — matching ``datamodule.py:20-39`` collate)."""

    def pad(v, value):
        if v is None:
            return None
        if len(v) > seq_len:
            raise ValueError(f"sequence {len(v)} exceeds bucket {seq_len}")
        return np.pad(v, (0, seq_len - len(v)), constant_values=value)

    return VLMInputs(
        pad(inputs.input_ids, 0),
        pad(inputs.token_type_ids, LANGUAGE_TOKEN_TYPE),
        pad(inputs.position_ids, 0),
        pad(inputs.attention_mask, 0),
        pad(inputs.labels, CE_IGNORE_INDEX),
        pad(inputs.weight, 0.0),
    )


def extract_vg_positions(
    input_ids: np.ndarray, eop_token_id: int, max_targets: int
) -> tuple[np.ndarray, np.ndarray]:
    """Indices t with input_ids[t+1] == </p> (the hidden state that generates
    each closing tag), padded to ``max_targets``.

    Returns (positions (max_targets,), valid (max_targets,)). Targets beyond
    ``max_targets`` are dropped, mirroring seq-len truncation handling
    (``grg.py:71-82``).
    """
    (pos,) = np.nonzero(input_ids[1:] == eop_token_id)
    pos = pos[:max_targets]
    out = np.zeros(max_targets, np.int64)
    valid = np.zeros(max_targets, bool)
    out[: len(pos)] = pos
    valid[: len(pos)] = True
    return out, valid
