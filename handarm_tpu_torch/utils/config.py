"""Layered yaml configs with `key=value` overrides (a copy of
handarm_tpu/utils/config.py, which the port may not import).

A yaml may name parents under `inherits:` (paths relative to the file);
they merge first, the file over them, then the overrides. Dotted keys
index nested dicts; values parse as yaml scalars, lists or dicts:

    cfg = load_config("configs/task/Ur5SihMultiObjectManipulation.yaml",
                      overrides=["env.num_envs=4096", "rl.goal=throw"])
"""

from __future__ import annotations

import copy
import os
from typing import Any

import yaml


def deep_merge(base: dict, over: dict) -> dict:
    out = copy.deepcopy(base)
    for k, v in over.items():
        if isinstance(v, dict) and isinstance(out.get(k), dict):
            out[k] = deep_merge(out[k], v)
        else:
            out[k] = copy.deepcopy(v)
    return out


def _parse_value(s: str) -> Any:
    try:
        return yaml.safe_load(s)
    except Exception:
        return s


def apply_overrides(cfg: dict, overrides: list[str]) -> dict:
    cfg = copy.deepcopy(cfg)
    for ov in overrides:
        if "=" not in ov:
            raise ValueError(f"override must be key=value, got {ov!r}")
        key, val = ov.split("=", 1)
        node = cfg
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = _parse_value(val)
    return cfg


def load_config(path: str, overrides: list[str] | None = None) -> dict:
    """The yaml at `path` over its `inherits:` parents, then the overrides."""
    with open(path) as f:
        cfg = yaml.safe_load(f) or {}
    parents = cfg.pop("inherits", [])
    if isinstance(parents, str):
        parents = [parents]
    merged: dict = {}
    for parent in parents:
        ppath = parent if os.path.isabs(parent) else os.path.join(os.path.dirname(path), parent)
        merged = deep_merge(merged, load_config(ppath))
    merged = deep_merge(merged, cfg)
    if overrides:
        merged = apply_overrides(merged, overrides)
    return merged


def get(cfg: dict, dotted: str, default=None):
    node = cfg
    for p in dotted.split("."):
        if not isinstance(node, dict) or p not in node:
            return default
        node = node[p]
    return node
