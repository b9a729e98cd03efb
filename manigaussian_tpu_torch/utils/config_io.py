"""Dict/JSON ↔ config dataclasses with dotted overrides.

A copy of `manigaussian_tpu/utils/config_io.py`: `from_dict`,
`parse_overrides`, `load_config` (variant + optional YAML + dotted
overrides), `save_config` and `load_saved_config`. The saved `config.json`
has the same format in both packages.
"""

from __future__ import annotations

import dataclasses
import json
import os
import typing
from typing import Any, Dict, List, Optional, get_args, get_origin

from manigaussian_tpu_torch import config as C


def _coerce(value, target_type):
    origin = get_origin(target_type)
    if target_type is bool or (origin is None and target_type == Optional[bool]):
        if isinstance(value, bool):
            return value
        return str(value).lower() in ("1", "true", "yes", "on")
    if origin in (tuple, list):
        if isinstance(value, str):
            value = [v for v in value.strip("[]() ").split(",") if v != ""]
        inner = get_args(target_type)
        elt = inner[0] if inner else str
        return tuple(_coerce(v, elt) for v in value)
    if origin is not None and type(None) in get_args(target_type):
        if value in (None, "null", "None", "~"):
            return None
        non_none = [a for a in get_args(target_type) if a is not type(None)]
        return _coerce(value, non_none[0]) if non_none else value
    if target_type in (int, float, str):
        return target_type(value)
    return value


def _apply_to_dataclass(obj, updates: Dict[str, Any]):
    fields = {f.name for f in dataclasses.fields(obj)}
    hints = typing.get_type_hints(type(obj))
    kw = {}
    for key, val in updates.items():
        if key not in fields:
            raise KeyError(
                f"unknown config key '{key}' for {type(obj).__name__}")
        cur = getattr(obj, key)
        if dataclasses.is_dataclass(cur) and isinstance(val, dict):
            kw[key] = _apply_to_dataclass(cur, val)
        else:
            kw[key] = _coerce(val, hints[key])
    return dataclasses.replace(obj, **kw)


def from_dict(d: Dict[str, Any],
              base: Optional[C.ManiGaussianConfig] = None) -> C.ManiGaussianConfig:
    return _apply_to_dataclass(base or C.ManiGaussianConfig(), d)


def parse_overrides(overrides: List[str]) -> Dict[str, Any]:
    """['method.lr=0.001', 'rlbench.tasks=[a,b]'] → nested dict."""
    out: Dict[str, Any] = {}
    for ov in overrides:
        key, _, val = ov.partition("=")
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = val
    return out


def load_config(yaml_path: Optional[str] = None,
                overrides: Optional[List[str]] = None,
                variant: Optional[str] = None) -> C.ManiGaussianConfig:
    base = C.VARIANTS[variant]() if variant else C.ManiGaussianConfig()
    if yaml_path:
        import yaml  # only for a YAML config file
        with open(yaml_path) as f:
            base = from_dict(yaml.safe_load(f) or {}, base)
    if overrides:
        base = from_dict(parse_overrides(overrides), base)
    return base


def save_config(cfg: C.ManiGaussianConfig, logdir: str,
                name: str = "config.json") -> str:
    os.makedirs(logdir, exist_ok=True)
    path = os.path.join(logdir, name)
    with open(path, "w") as f:
        json.dump(dataclasses.asdict(cfg), f, indent=2)
    return path


def load_saved_config(logdir: str,
                      name: str = "config.json") -> C.ManiGaussianConfig:
    with open(os.path.join(logdir, name)) as f:
        return from_dict(json.load(f))
