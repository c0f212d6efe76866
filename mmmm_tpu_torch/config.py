"""YAML -> dataclass configuration, the port's own copy of
``mmmm_tpu/config.py``:

  - ``load_yaml(path)`` reads a YAML file; a string value ending in
    ``.yaml`` that names a file beside the including one is loaded and
    merged in its place (the reference's ``data: data.yaml`` pattern), and
    an ``_include:`` list merges base files first;
  - ``${a.b.c}`` strings interpolate values from the root document;
  - ``build(cls, cfg_dict)`` instantiates (frozen) dataclasses recursively,
    turning lists into tuples where the field is a tuple;
  - ``apply_overrides`` applies command-line ``a.b.c=value`` overrides.

PyYAML is imported where a YAML text is parsed, so that importing the port
does not need it.
"""
from __future__ import annotations

import dataclasses
import re
import types
import typing
from pathlib import Path

_INTERP = r"^\$\{([\w.]+)\}$"  # a pattern string: re.match caches its compiled form


def _merge(base: dict, override: dict) -> dict:
    out = dict(base)
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = _merge(out[k], v)
        else:
            out[k] = v
    return out


def load_yaml(path: str | Path, resolve: bool = True) -> dict:
    """Load and merge includes; ``resolve=False`` defers ``${...}``
    interpolation so that command-line overrides can land first."""
    import yaml

    path = Path(path)
    doc = yaml.safe_load(path.read_text()) or {}
    doc = _resolve_includes(doc, path.parent)
    if resolve:
        doc = _interpolate(doc, doc)
    return doc


def resolve_interpolations(doc: dict) -> dict:
    return _interpolate(doc, doc)


def _resolve_includes(node, base_dir: Path):
    if isinstance(node, dict):
        includes = node.pop("_include", [])
        if isinstance(includes, str):
            includes = [includes]
        merged: dict = {}
        for inc in includes:
            merged = _merge(merged, load_yaml(base_dir / inc, resolve=False))
        resolved = {}
        for k, v in node.items():
            if isinstance(v, str) and v.endswith(".yaml") and (base_dir / v).exists():
                resolved[k] = load_yaml(base_dir / v, resolve=False)
            else:
                resolved[k] = _resolve_includes(v, base_dir)
        return _merge(merged, resolved)
    if isinstance(node, list):
        return [_resolve_includes(v, base_dir) for v in node]
    return node


def _lookup(root: dict, dotted: str):
    cur = root
    for part in dotted.split("."):
        cur = cur[part]
    return cur


def _interpolate(node, root):
    if isinstance(node, dict):
        return {k: _interpolate(v, root) for k, v in node.items()}
    if isinstance(node, list):
        return [_interpolate(v, root) for v in node]
    if isinstance(node, str) and (m := re.match(_INTERP, node)):
        return _lookup(root, m.group(1))
    return node


def build(cls, cfg: dict | None):
    """Instantiate dataclass ``cls`` from a nested dict; an unknown key
    raises."""
    if cfg is None:
        return cls()
    if not dataclasses.is_dataclass(cls):
        return cfg
    hints = typing.get_type_hints(cls)
    fields = {f.name: f for f in dataclasses.fields(cls)}
    kwargs = {}
    for key, value in cfg.items():
        if key not in fields:
            raise KeyError(f"{cls.__name__}: unknown config key {key!r}")
        kwargs[key] = _coerce(hints.get(key, fields[key].type), value)
    return cls(**kwargs)


def _coerce(ann, value):
    origin = typing.get_origin(ann)
    if dataclasses.is_dataclass(ann) and isinstance(value, dict):
        return build(ann, value)
    if origin is tuple and isinstance(value, (list, tuple)):
        return tuple(value)
    if origin is list and isinstance(value, list):
        (item_t,) = typing.get_args(ann) or (None,)
        return [_coerce(item_t, v) if item_t else v for v in value]
    if origin in (typing.Union, types.UnionType):
        args = [a for a in typing.get_args(ann) if a is not type(None)]
        if value is None:
            return None
        if len(args) == 1:
            return _coerce(args[0], value)
    return value


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    """Command-line ``a.b.c=value`` overrides (values parsed as YAML)."""
    import yaml

    for ov in overrides:
        key, _, raw = ov.partition("=")
        value = yaml.safe_load(raw)
        cur = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            cur = cur.setdefault(p, {})
        cur[parts[-1]] = value
    return cfg
