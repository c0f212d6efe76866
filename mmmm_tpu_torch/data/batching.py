"""Bucketed static-shape batch assembly.

The reference collates ragged per-sample tensors into Python lists
(``datamodule.py:20-39``) — impossible under XLA. Here every data point maps
to a *bucket key* (image shape, patch/pool size, grounding mode, sequence
bucket); the ``BucketBatcher`` accumulates points per key and emits a batch
when one fills. ``collate`` pads everything to the bucket's static shapes:

  - vlm inputs -> (B, S_bucket) (labels pad -100, everything else 0);
  - grounded targets -> (B, max_targets) with ``vg_valid`` masks;
  - instance labels -> (B, max_instances, 6) + (B, max_targets, 2) offsets;
  - semantic masks -> (B, max_targets, D, H, W).

One compiled train step exists per bucket signature.

The port's own copy of ``mmmm_tpu/data/batching.py``. Batches stay numpy;
``train/step.py batch_to`` moves them to the device.
"""
from __future__ import annotations

from typing import Iterable, Iterator

import numpy as np

from .defs import CE_IGNORE_INDEX
from .input_builder import pad_to


def seq_bucket(length: int, quant: int = 128, max_len: int | None = None) -> int:
    b = -(-length // quant) * quant
    return min(b, max_len) if max_len else b


def bucket_key(dp: dict, seq_quant: int = 128, max_seq_len: int | None = None):
    if dp.get("plan"):
        # metadata-only plan (transform ``plan_only=True``): same key, no pixels
        mode = "none"
        if dp["grounding"] and dp["labels_present"]:
            mode = "instance" if dp["instance"] else "semantic"
        return (
            tuple(dp["image_shape"]),
            dp["patch_size"],
            dp["pool_size"],
            mode,
            seq_bucket(dp["seq_len"], seq_quant, max_seq_len),
        )
    mode = "none"
    if dp.get("grounding") and dp["vlm_inputs"].labels is not None:
        mode = "instance" if dp.get("instance") else "semantic"
    return (
        dp["image"].shape,
        dp["patch_size"],
        dp["pool_size"],
        mode,
        seq_bucket(len(dp["vlm_inputs"].input_ids), seq_quant, max_seq_len),
    )


def collate(
    points: list[dict],
    *,
    eop_token_id: int,
    max_targets: int,
    max_instances: int,
    seq_len: int,
    vg_mode: str,
) -> dict:
    b = len(points)
    vlm = [pad_to(p["vlm_inputs"], seq_len) for p in points]
    batch = {
        "input_ids": np.stack([v.input_ids for v in vlm]).astype(np.int32),
        "token_type_ids": np.stack([v.token_type_ids for v in vlm]).astype(np.int32),
        "position_ids": np.stack([v.position_ids for v in vlm]).astype(np.int32),
        "attention_mask": np.stack([v.attention_mask for v in vlm]).astype(np.int32),
        "image": np.stack([p["image"] for p in points]),
        "patch_size": points[0]["patch_size"],
        "pool_size": points[0]["pool_size"],
        "src": [p["src"] for p in points],
    }
    if vlm[0].labels is not None:
        batch["labels"] = np.stack([v.labels for v in vlm]).astype(np.int32)
        batch["weight"] = np.stack([v.weight for v in vlm]).astype(np.float32)
    if vg_mode == "none":
        return batch

    batch["grounding_image"] = np.stack([p["grounding_image"] for p in points])
    positions = np.zeros((b, max_targets), np.int64)
    valid = np.zeros((b, max_targets), bool)
    for i, (p, v) in enumerate(zip(points, vlm)):
        (all_pos,) = np.nonzero(v.input_ids[1:] == eop_token_id)
        lm = p.get("vg_label_mask")
        if lm is not None:
            # grg path: only label-backed prompts participate in grounding
            sel = all_pos[: len(lm)][lm]
        else:
            sel = all_pos
        sel = sel[:max_targets]
        positions[i, : len(sel)] = sel
        valid[i, : len(sel)] = True
    batch["vg_positions"] = positions.astype(np.int32)

    if vg_mode == "semantic":
        spatial = points[0]["image"].shape[1:]
        masks = np.zeros((b, max_targets, *spatial), bool)
        for i, p in enumerate(points):
            m = p["masks"]
            n = min(len(m), max_targets) if m is not None else 0
            if n:
                masks[i, :n] = m[:n]
            # targets beyond the available labels (or truncated eops) are invalid
            valid[i, n:] = False
        batch["masks"] = masks
    elif vg_mode == "instance":
        boxes = np.zeros((b, max_instances, 6), np.float32)
        offsets = np.zeros((b, max_targets, 2), np.int64)
        for i, p in enumerate(points):
            bx, off = p["boxes"], p["index_offsets"]
            if bx is not None and len(bx):
                k = min(len(bx), max_instances)
                boxes[i, :k] = bx[:k]
            if off is not None:
                n = min(len(off), max_targets)
                offsets[i, :n] = np.clip(off[:n], 0, max_instances)
                valid[i, n:] = False
        batch["boxes_label"] = boxes
        batch["index_offsets"] = offsets.astype(np.int32)
    else:
        raise ValueError(vg_mode)
    batch["vg_valid"] = valid
    return batch


class BucketBatcher:
    """Group a data-point stream into static-shape batches.

    Buckets flush when full; at most ``max_open`` buckets are held — overflow
    flushes the largest partial batch (padded by repeating its last sample so
    shapes stay static)."""

    def __init__(
        self,
        batch_size: int,
        *,
        eop_token_id: int,
        max_targets: int = 8,
        max_instances: int = 16,
        seq_quant: int = 128,
        max_seq_len: int | None = 1024,
        max_open: int = 8,
        drop_partial: bool = False,
    ):
        self.batch_size = batch_size
        self.eop_token_id = eop_token_id
        self.max_targets = max_targets
        self.max_instances = max_instances
        self.seq_quant = seq_quant
        self.max_seq_len = max_seq_len
        self.max_open = max_open
        self.drop_partial = drop_partial

    def collate_batch(self, key, points) -> dict:
        return collate(
            points,
            eop_token_id=self.eop_token_id,
            max_targets=self.max_targets,
            max_instances=self.max_instances,
            seq_len=key[4],
            vg_mode=key[3],
        ) | {"vg_mode": key[3]}

    def batches(self, stream: Iterable[dict]) -> Iterator[tuple[tuple, list]]:
        """Group the stream into (bucket key, points) batches (uncollated).

        Works over full data points OR metadata-only plans — both carry the
        same bucket key; partial flushes pad by repeating the last element so
        shapes stay static."""

        def pad(points):
            return points + [points[-1]] * (self.batch_size - len(points))

        open_buckets: dict = {}
        for dp in stream:
            key = bucket_key(dp, self.seq_quant, self.max_seq_len)
            open_buckets.setdefault(key, []).append(dp)
            if len(open_buckets[key]) == self.batch_size:
                yield key, open_buckets.pop(key)
            elif len(open_buckets) > self.max_open:
                flush_key = max(open_buckets, key=lambda k: len(open_buckets[k]))
                if not self.drop_partial:
                    yield flush_key, pad(open_buckets.pop(flush_key))
                else:
                    open_buckets.pop(flush_key)
        for key, points in open_buckets.items():
            if not self.drop_partial:
                yield key, pad(points)

    def __call__(self, stream: Iterable[dict]) -> Iterator[dict]:
        for key, points in self.batches(stream):
            yield self.collate_batch(key, points)


def scheduled_batches(
    dataset,
    batcher: BucketBatcher,
    num_samples: int,
    *,
    seed: int = 42,
    rank: int = 0,
    world_size: int = 1,
) -> Iterator[dict]:
    """Host-invariant batch schedule for multi-controller SPMD.

    Every process runs the SAME global sampler + batcher over metadata-only
    plans (``transform(plan_only=True)`` — no pixel IO), so all ranks agree on
    the exact (bucket shape, mode) sequence of jitted steps. Each rank then
    materializes only its contiguous ``1/world_size`` slice of every batch
    (matching ``make_array_from_process_local_data`` row ownership) and
    collates it locally with the bucket's static shapes.

    This removes the reference's DDP desync hazard class (dummy forwards,
    ``mmmm/models/mmmm.py:263-278``) by construction instead of by patching.
    """
    assert batcher.batch_size % world_size == 0, (batcher.batch_size, world_size)
    local = batcher.batch_size // world_size
    for key, plans in batcher.batches(dataset.plan_stream(num_samples, seed=seed)):
        sel = plans[rank * local : (rank + 1) * local]
        points = [dataset.materialize(p) for p in sel]
        yield batcher.collate_batch(key, points)
