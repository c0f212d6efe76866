""".npz export of adapters and parameter trees, the port of
``save_adapter``, ``load_adapter``, ``save_params`` and ``load_params`` in
``mmmm_tpu/train/checkpoint.py``, in the same file layout, so that each
package reads the other's files: one array a leaf under its ``/``-joined
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
from pathlib import Path

import numpy as np
import torch


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
    """Flat-npz export of the trainable (LoRA and finetuned) tree."""
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
    np.savez_compressed(path, **flat)


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
