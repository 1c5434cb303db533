"""Heuristic-constant override registry (the reference's config tier 3).

The port's own copy of supernova_tpu/core/config.py, kept equal to it by
tests/test_torch_hostcopies.py apart from _PKG, so that an addin path names
the port's constant: the port imports nothing of the JAX package.

The reference has three config tiers (SURVEY §5.6): MRO pipeline params
(-> Pipeline/CLI arguments here), per-binary CommandArgument CLI flags with
a CS build freezing PD-only flags (system/ParsedArgs.h, DF.cc:93,156-189),
and an `addin` map letting the pipeline inject extra key=value args into
any binary (mro/stages/denovo/df/__init__.py:138-139).  Heuristic constants
live in 10X/Heuristics.h and inline per function.

Here every heuristic is a module-level constant (same layout as the
reference); this module is the addin analogue: dotted-path overrides
applied by setattr, validated against the existing constant's type.

    apply_addins({"asm.star.MIN_ADVANTAGE": 40,
                  "asm.nucleate.MIN_OVER_BASES": 150})

CLI: `supernova_tpu run --addin asm.star.MIN_ADVANTAGE=40 ...`.
"""
from __future__ import annotations

import importlib
from typing import Dict, Tuple

_PKG = "supernova_tpu_torch"


def _resolve(path: str):
    """'asm.star.MIN_ADVANTAGE' -> (module, attr).  Accepts a leading
    'supernova_tpu.' too."""
    parts = path.split(".")
    if parts[0] == _PKG:
        parts = parts[1:]
    if len(parts) < 2:
        raise ValueError(f"addin path too short: {path!r}")
    modpath, attr = ".".join(parts[:-1]), parts[-1]
    mod = importlib.import_module(f"{_PKG}.{modpath}")
    if not hasattr(mod, attr):
        raise AttributeError(f"no heuristic {attr!r} in {_PKG}.{modpath}")
    if not attr.isupper():
        raise ValueError(
            f"{path!r}: only UPPER_CASE heuristic constants are overridable"
        )
    return mod, attr


def _coerce(old, new_str: str):
    if isinstance(old, bool):
        if new_str.lower() in ("1", "true", "yes"):
            return True
        if new_str.lower() in ("0", "false", "no"):
            return False
        raise ValueError(f"bad bool {new_str!r}")
    if isinstance(old, int):
        return int(new_str)
    if isinstance(old, float):
        return float(new_str)
    if isinstance(old, str):
        return new_str
    raise TypeError(f"cannot override constant of type {type(old).__name__}")


def apply_addins(addins: Dict[str, object]) -> Dict[str, object]:
    """Apply overrides; values may be strings (coerced to the constant's
    type) or already-typed.  Returns {path: previous value} for restore."""
    prev: Dict[str, object] = {}
    for path, val in addins.items():
        mod, attr = _resolve(path)
        old = getattr(mod, attr)
        if isinstance(val, str):
            val = _coerce(old, val)
        elif not isinstance(val, type(old)) and not (
            isinstance(old, float) and isinstance(val, int)
        ):
            raise TypeError(
                f"{path}: expected {type(old).__name__}, got {type(val).__name__}"
            )
        prev[path] = old
        setattr(mod, attr, val)
    return prev


def restore_addins(prev: Dict[str, object]) -> None:
    for path, val in prev.items():
        mod, attr = _resolve(path)
        setattr(mod, attr, val)


def parse_addin_args(pairs) -> Dict[str, str]:
    """['a.b.C=3', ...] -> {'a.b.C': '3'} with validation."""
    out: Dict[str, str] = {}
    for p in pairs or ():
        if "=" not in p:
            raise ValueError(f"addin must be key=value: {p!r}")
        k, v = p.split("=", 1)
        out[k.strip()] = v.strip()
    return out
