"""Minimal layered config: YAML + ``${key}`` interpolation.

The port's own copy of the JAX package's loader, so the same
``configs/*.yaml`` files drive both packages.
"""

from __future__ import annotations

import re
from typing import Any, Dict, Mapping

__all__ = ["load_config", "interpolate", "merge_args"]

_VAR = re.compile(r"\$\{([^}]+)\}")


def interpolate(obj: Any, root: Mapping[str, Any]) -> Any:
    if isinstance(obj, str):
        def sub(m):
            val = root
            for part in m.group(1).split("."):
                val = val[part]
            return str(val)

        return _VAR.sub(sub, obj)
    if isinstance(obj, dict):
        return {k: interpolate(v, root) for k, v in obj.items()}
    if isinstance(obj, list):
        return [interpolate(v, root) for v in obj]
    return obj


def load_config(path: str) -> Dict[str, Any]:
    import yaml

    with open(path) as f:
        cfg = yaml.safe_load(f)
    # iterate to a fixpoint so chained references (${b} -> ${a}) resolve
    for _ in range(10):
        new = interpolate(cfg, cfg)
        if new == cfg:
            break
        cfg = new
    return cfg


def merge_args(cfg: Dict[str, Any], args) -> Dict[str, Any]:
    """A new config whose top-level keys are overridden by the argparse
    Namespace's values that are not None (the reference's ``main.py``)."""
    out = dict(cfg)
    for k, v in vars(args).items():
        if v is not None:
            out[k] = v
    return out
