"""Config system: YAML or JSON files, dotted-key overrides, attribute access
(the port's copy of x2vlm_tpu/core/config.py).

- ``load_config(path, overrides=...)`` reads YAML or JSON into a ``Config``.
- Overrides use the ``"key:value;a.b:value"`` syntax at any depth, the
  values parsed as YAML.
- ``Config`` is a dict with attribute access.

PyYAML is imported only where a ``.yaml`` file or an override needs it,
and its absence raises an error that names it.
"""

from __future__ import annotations

import json
import os
from typing import Any, Mapping

__all__ = ["Config", "load_config", "parse_overrides", "apply_overrides", "read_json"]


class Config(dict):
    """Dict with attribute access. Nested dicts are wrapped on access."""

    def __getattr__(self, name: str) -> Any:
        try:
            value = self[name]
        except KeyError as e:
            raise AttributeError(name) from e
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def get(self, key: str, default: Any = None) -> Any:
        value = super().get(key, default)
        if isinstance(value, dict) and not isinstance(value, Config):
            value = Config(value)
            super().__setitem__(key, value)
        return value

    def to_dict(self) -> dict:
        def unwrap(v):
            if isinstance(v, dict):
                return {k: unwrap(x) for k, x in v.items()}
            if isinstance(v, (list, tuple)):
                return [unwrap(x) for x in v]
            return v

        return unwrap(self)


def read_json(path: str) -> Config:
    with open(path, "r") as f:
        return Config(json.load(f))


def _yaml():
    """PyYAML, imported where a ``.yaml`` file or an override needs it."""
    try:
        import yaml
    except ImportError as e:
        raise ImportError("reading YAML configs and --override_cfg values needs PyYAML, "
                          "which is not installed") from e
    return yaml


def parse_overrides(override_cfg: str) -> dict:
    """Parse ``"k:v;nested.k:v2"`` into a flat {dotted_key: parsed_value}
    dict. Values are parsed as YAML (``lr:1e-4`` a float, ``flag:true`` a
    bool, ``xs:[1,2]`` a list)."""
    out: dict = {}
    if not override_cfg:
        return out
    yaml = _yaml()
    for item in override_cfg.split(";"):
        item = item.strip()
        if not item:
            continue
        key, sep, raw = item.partition(":")
        if not sep:
            raise ValueError(f"override item {item!r} must be 'key:value'")
        value = yaml.safe_load(raw.strip())
        if isinstance(value, str):
            # YAML 1.1 misses bare scientific notation like "1e-4"
            try:
                value = int(value)
            except ValueError:
                try:
                    value = float(value)
                except ValueError:
                    pass
        out[key.strip()] = value
    return out


def apply_overrides(config: Mapping, overrides: Mapping[str, Any]) -> Config:
    cfg = Config(_deepcopy(config))
    for dotted, value in overrides.items():
        node = cfg
        parts = dotted.split(".")
        for p in parts[:-1]:
            child = node.setdefault(p, {})
            if not isinstance(child, dict):
                raise TypeError(f"cannot override through non-dict key {p!r} in {dotted!r}")
            if not isinstance(child, Config):
                child = Config(child)
                node[p] = child
            node = child
        node[parts[-1]] = value
    return cfg


def _deepcopy(obj):
    if isinstance(obj, Mapping):
        return {k: _deepcopy(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return [_deepcopy(v) for v in obj]
    return obj


def load_config(path: str, overrides: str | Mapping[str, Any] | None = None) -> Config:
    """Load a YAML or JSON config file and apply optional overrides."""
    with open(path, "r") as f:
        if os.path.splitext(path)[1] == ".json":
            raw = json.load(f)
        else:
            raw = _yaml().safe_load(f)
    if raw is None:
        raw = {}
    if overrides is None:
        return Config(raw)
    if isinstance(overrides, str):
        overrides = parse_overrides(overrides)
    return apply_overrides(raw, overrides)
