"""Config frontends: reference-style .txt files, yaml, and CLI overrides
(a copy of tensorf_tpu/config/frontends.py).

Parses the ``key = value`` txt format (inline ``#`` comments, bracketed
lists, python-style bools) and hydra-style yaml with ``${key}``
interpolation.  CLI flags override file values, which override defaults.
"""

from __future__ import annotations

import argparse
import dataclasses
import re
from typing import Any, Dict, Optional

from .schema import TrainConfig


def _coerce_scalar(text: str) -> Any:
    t = text.strip()
    if t.lower() in ("true", "false"):
        return t.lower() == "true"
    if t.lower() in ("none", "null", ""):
        return None
    try:
        return int(t)
    except ValueError:
        pass
    try:
        return float(t)
    except ValueError:
        pass
    return t.strip("'\"")


def _coerce(text: str) -> Any:
    t = text.strip()
    if t.startswith("[") and t.endswith("]"):
        inner = t[1:-1].strip()
        if not inner:
            return []
        return [_coerce_scalar(p) for p in inner.split(",")]
    return _coerce_scalar(t)


def parse_txt_config(path: str) -> Dict[str, Any]:
    """Parse a reference-style ``key = value`` config txt file."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line or "=" not in line:
                continue
            key, value = line.split("=", 1)
            out[key.strip()] = _coerce(value)
    return out


def parse_yaml_config(path: str) -> Dict[str, Any]:
    """Parse a hydra-style yaml config with ${key} interpolation."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    def interp(v):
        if isinstance(v, str):
            return re.sub(r"\$\{(\w+)\}", lambda m: str(raw.get(m.group(1), m.group(0))), v)
        return v

    return {k: interp(v) for k, v in (raw or {}).items()}


def apply_overrides(cfg: TrainConfig, values: Dict[str, Any]) -> TrainConfig:
    fields = {f.name for f in dataclasses.fields(TrainConfig)}
    unknown = []
    for k, v in values.items():
        if k in fields:
            if v is not None or k in ("ckpt", "ckpt_path"):
                setattr(cfg, k, v)
        else:
            unknown.append(k)
    if unknown:
        print(f"[config] ignoring unknown keys: {unknown}")
    return cfg


def load_config(
    path: Optional[str] = None, overrides: Optional[Dict[str, Any]] = None
) -> TrainConfig:
    cfg = TrainConfig()
    if path:
        if path.endswith((".yaml", ".yml")):
            apply_overrides(cfg, parse_yaml_config(path))
        else:
            apply_overrides(cfg, parse_txt_config(path))
    if overrides:
        apply_overrides(cfg, overrides)
    return cfg


def add_config_args(parser: argparse.ArgumentParser) -> None:
    """--config plus one flag per schema field."""
    parser.add_argument("--config", type=str, default=None,
                        help="config file path (.txt or .yaml)")
    for f in dataclasses.fields(TrainConfig):
        flag = f"--{f.name}"
        if f.type in ("bool", bool) or isinstance(f.default, bool):
            parser.add_argument(flag, type=_coerce_scalar, default=None)
        elif "List" in str(f.type):
            parser.add_argument(flag, type=str, default=None,
                                help="bracketed list, e.g. [1,2,3]")
        else:
            parser.add_argument(flag, type=str, default=None)


def config_from_args(args: argparse.Namespace) -> TrainConfig:
    overrides = {}
    for f in dataclasses.fields(TrainConfig):
        v = getattr(args, f.name, None)
        if v is not None:
            overrides[f.name] = _coerce(v) if isinstance(v, str) else v
    return load_config(args.config, overrides)

