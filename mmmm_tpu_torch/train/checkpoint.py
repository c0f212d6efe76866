"""Step checkpoints of the training state and the ``.npz`` export of
adapters and parameter trees, the port of ``mmmm_tpu/train/checkpoint.py``.

``CheckpointManager`` keeps a format of its own (the reference's is orbax,
which is JAX): one directory ``<directory>/<step>/`` a saved step, holding
one ``torch.save`` file per top-level key of the saved tree (the trainable
tree and the AdamW state: ``count``, ``mu``, ``nu``) as CPU tensors. A step
is written into a temporary directory that is then renamed into place, so a
killed run never leaves half a checkpoint. It saves at the steps orbax's
manager saves at: the steps that ``save_every`` divides, and the first step
it sees when the directory holds no checkpoint; never a step at or below
the latest on disk; ``keep`` retains the latest steps.

``save_adapter``, ``load_adapter``, ``save_params`` and ``load_params`` keep
the JAX package's file layout, so that each package reads the other's
files: one array a leaf under its ``/``-joined
path (list items as ``idx:N`` segments, non-array leaves JSON-encoded under
the path plus ``"\\x00json"``; a zip member's name ends at the NUL, so
both packages read such a leaf back as its uint8 JSON bytes).

Leaves are written from tensors or arrays and read back as CPU tensors.
NumPy has no bfloat16: the JAX package's bf16 leaves land in the file as
2-byte void arrays (``|V2``), which these functions write for bf16 tensors
and read back as bf16.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist


class CheckpointManager:
    """Step checkpoints in ``directory``. With a data-parallel ``group``
    every process calls each method at the same steps, and rank 0 of the
    group alone reads and writes ``directory``, which need not be shared:
    the others learn the steps on disk from it when the manager is made,
    every process then keeps the same list as it saves (so every process
    decides alike whether a step saves), a save's tree comes whole (its
    ZeRO shards gathered, ``state`` a callable that every process runs),
    and :meth:`restore` hands every process rank 0's checkpoint, so a
    checkpoint resumes at any number of processes."""

    def __init__(self, directory: str | Path, save_every: int, keep: int | None = None, *,
                 group=None):
        self.directory = Path(directory).absolute()
        self.save_every = save_every
        self.keep = keep
        self.group = group
        self.writer = group is None or dist.get_rank(group) == 0
        steps = [None]
        if self.writer:
            self.directory.mkdir(parents=True, exist_ok=True)
            steps = [sorted(int(p.name) for p in self.directory.iterdir()
                            if p.is_dir() and p.name.isdigit())]
        if group is not None:
            dist.broadcast_object_list(steps, src=dist.get_global_rank(group, 0), group=group)
        self._steps = steps[0]

    def all_steps(self) -> list[int]:
        return list(self._steps)

    def latest_step(self) -> int | None:
        return self._steps[-1] if self._steps else None

    def should_save(self, step: int) -> bool:
        steps = self._steps
        if steps and steps[-1] >= step:
            return False
        return step % self.save_every == 0 or not steps

    def maybe_save(self, step: int, state) -> bool:
        """Save ``state`` (a dict of trees of tensors and numbers, or a
        callable that returns one) when the interval policy says so; returns
        whether it saved."""
        if not self.should_save(step):
            return False
        self._save(step, state)
        return True

    def force_save(self, step: int, state) -> None:
        """Unconditional save (the preemption path), ignoring the interval;
        no-op when the step is already on disk."""
        if step not in self._steps:
            self._save(step, state)

    def _save(self, step: int, state) -> None:
        if callable(state):
            state = state()
        self._steps = sorted({*self._steps, step})
        old, self._steps = (self._steps[:-self.keep], self._steps[-self.keep:]) \
            if self.keep is not None else ([], self._steps)
        if self.writer:
            tmp = self.directory / f".tmp-{step}"
            shutil.rmtree(tmp, ignore_errors=True)
            tmp.mkdir()
            for key, tree in state.items():
                torch.save(_map_tensors(tree, lambda t: t.detach().cpu()), tmp / f"{key}.pt")
            os.replace(tmp, self.directory / str(step))
            for s in old:
                shutil.rmtree(self.directory / str(s))
        if self.group is not None:  # the step is on disk when any process goes on
            dist.barrier(group=self.group)

    def restore(self, state_like: dict):
        """``(step, state)`` of the latest checkpoint, each tensor on the
        device of its counterpart in ``state_like`` (same keys), or
        ``(None, None)`` when none is on disk."""
        step = self.latest_step()
        if step is None:
            return None, None
        out, error = None, None
        if self.writer:
            try:
                out = {key: _place_like(
                    torch.load(self.directory / str(step) / f"{key}.pt", weights_only=True),
                    like, key) for key, like in state_like.items()}
            except ValueError as e:
                if self.group is None:
                    raise
                error = str(e)
        if self.group is not None:
            out = self._from_writer(out, error, state_like)
        return step, out

    def _from_writer(self, tree, error, like):
        """Rank 0's restored ``tree`` (or its ``error``, raised) on every
        process of the group: the non-tensor leaves in one message, then
        each tensor broadcast into a buffer like its counterpart in ``like``."""
        src = dist.get_global_rank(self.group, 0)
        head = [error, None if tree is None else _map_tensors(tree, lambda t: None)]
        dist.broadcast_object_list(head, src=src, group=self.group)
        if head[0] is not None:
            raise ValueError(head[0])

        def fill(skeleton, node, like_node):
            if isinstance(like_node, dict):
                return {k: fill(skeleton[k], None if node is None else node[k], like_node[k])
                        for k in like_node}
            if isinstance(like_node, torch.Tensor):
                buf = torch.empty_like(like_node) if node is None else node
                dist.broadcast(buf, src=src, group=self.group)
                return buf
            return skeleton

        return fill(head[1], tree, like)

    def wait(self) -> None:
        """Saves are synchronous: nothing to wait for."""


def _map_tensors(tree, fn):
    if isinstance(tree, dict):
        return {k: _map_tensors(v, fn) for k, v in tree.items()}
    return fn(tree) if isinstance(tree, torch.Tensor) else tree


def _place_like(tree, like, path: str):
    if isinstance(like, dict):
        if not isinstance(tree, dict) or set(tree) != set(like):
            raise ValueError(f"checkpoint: {path} does not match the state's keys")
        return {k: _place_like(tree[k], like[k], f"{path}/{k}") for k in like}
    if isinstance(like, torch.Tensor):
        if not isinstance(tree, torch.Tensor) or tree.shape != like.shape or \
                tree.dtype != like.dtype:
            raise ValueError(f"checkpoint: {path} does not match the state's tensor")
        return tree.to(like.device)
    return tree


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach().cpu()
        if t.dtype == torch.bfloat16:
            return t.view(torch.int16).numpy().view("V2")
        return t.numpy()
    return np.asarray(leaf)


def _to_tensor(arr: np.ndarray) -> torch.Tensor:
    if arr.dtype == np.dtype("V2"):
        return torch.from_numpy(arr.view(np.int16).copy()).view(torch.bfloat16)
    return torch.from_numpy(np.array(arr, copy=True))


def save_adapter(path: str | Path, trainable: dict) -> None:
    """Flat-npz export of the trainable (LoRA and finetuned) tree. The
    members are stored, not deflated as the reference's
    ``np.savez_compressed`` does: its fp32 factors shrink by 14%, and one
    thread's zlib took 230-265 s for the flagship's 3.24 GiB (``PERF.md``);
    ``np.load`` (either package's ``load_adapter``) reads both."""
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}

    def walk(tree, prefix=""):
        for k, v in tree.items():
            p = f"{prefix}/{k}" if prefix else k
            if isinstance(v, dict):
                walk(v, p)
            else:
                flat[p] = _to_numpy(v)

    walk(trainable)
    np.savez(path, **flat)


def load_adapter(path: str | Path) -> dict:
    """The tree ``save_adapter`` wrote, as CPU tensors."""
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        cur = tree
        parts = key.split("/")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = _to_tensor(data[key])
    return tree


def save_params(path: str | Path, tree) -> None:
    """Flat-npz save of a dict/list tree of tensors or arrays to ``path``
    (``params.npz`` inside it where it is not an ``.npz`` path)."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path / "params.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    flat = {}

    def walk(node, prefix):
        if isinstance(node, dict):
            for k, v in node.items():
                walk(v, f"{prefix}/{k}" if prefix else str(k))
        elif isinstance(node, (list, tuple)):
            for i, v in enumerate(node):
                walk(v, f"{prefix}/idx:{i}" if prefix else f"idx:{i}")
        elif hasattr(node, "shape"):
            flat[prefix] = _to_numpy(node)
        else:
            flat[prefix + "\x00json"] = np.frombuffer(json.dumps(node).encode(), dtype=np.uint8)

    walk(tree, "")
    np.savez_compressed(path, **flat)


def load_params(path: str | Path):
    """Inverse of ``save_params``: arrays as CPU tensors, lists as lists."""
    path = Path(path)
    if path.suffix != ".npz":
        path = path / "params.npz"
    data = np.load(path)
    tree: dict = {}
    for key in data.files:
        is_json = key.endswith("\x00json")
        parts = (key[: -len("\x00json")] if is_json else key).split("/")
        cur = tree
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = (json.loads(bytes(data[key]).decode()) if is_json
                          else _to_tensor(data[key]))

    def listify(node):
        if not isinstance(node, dict):
            return node
        node = {k: listify(v) for k, v in node.items()}
        if node and all(k.startswith("idx:") for k in node):
            return [node[f"idx:{i}"] for i in range(len(node))]
        return node

    return listify(tree)
