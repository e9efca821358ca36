"""Config parsing: YAML file + dotted CLI overrides -> dataclass tree.

Reference: ``veomni/arguments/parser.py:161-198`` (``parse_args``): first CLI
token may be a YAML path; remaining ``--a.b.c=value`` (or ``--a.b.c value``)
tokens override nested fields with type coercion.
"""

from __future__ import annotations

import dataclasses
import json
import os
import sys
from typing import Any, Dict, List, Optional, Type, TypeVar, get_args, get_origin

T = TypeVar("T")


def _coerce(value: str, target_type) -> Any:
    origin = get_origin(target_type)
    if target_type is bool or (origin is None and isinstance(target_type, type) and issubclass(target_type, bool)):
        return value.lower() in ("1", "true", "yes", "on")
    if target_type in (int, float, str):
        return target_type(value)
    if origin in (list, dict) or target_type in (list, dict):
        return json.loads(value)
    if target_type is Any or target_type is None:
        return value
    try:
        return json.loads(value)
    except (json.JSONDecodeError, ValueError):
        return value


def _set_dotted(obj: Any, dotted: str, value: str) -> None:
    parts = dotted.split(".")
    for p in parts[:-1]:
        if not hasattr(obj, p):
            raise AttributeError(f"unknown config section {p!r} in {dotted!r}")
        obj = getattr(obj, p)
    name = parts[-1]
    if dataclasses.is_dataclass(obj):
        fields = {f.name: f for f in dataclasses.fields(obj)}
        if name not in fields:
            raise AttributeError(f"unknown config field {dotted!r}")
        setattr(obj, name, _coerce(value, _resolve_type(type(obj), name)))
    elif isinstance(obj, dict):
        obj[name] = value
    else:
        raise AttributeError(f"cannot set {dotted!r} on {type(obj)}")


def _resolve_type(cls, field_name):
    import typing

    hints = typing.get_type_hints(cls)
    return hints.get(field_name, str)


def _apply_dict(obj: Any, data: Dict[str, Any], lenient: bool = False) -> None:
    for k, v in data.items():
        if not hasattr(obj, k):
            if lenient:
                # reference-schema file: its surface is larger than the TPU
                # mapping; the translator already warned about known drops
                from veomni_tpu_torch.utils.logging import get_logger

                get_logger(__name__).warning_rank0(
                    "reference-config: unknown key %r for %s, ignored",
                    k, type(obj).__name__,
                )
                continue
            raise AttributeError(f"unknown config key {k!r} for {type(obj).__name__}")
        cur = getattr(obj, k)
        if dataclasses.is_dataclass(cur) and isinstance(v, dict):
            _apply_dict(cur, v, lenient=lenient)
        else:
            # YAML 1.1 parses bare "1e-3" as a string — coerce scalars to the
            # declared field type so yaml and CLI values behave identically.
            if isinstance(v, str):
                v = _coerce(v, _resolve_type(type(obj), k))
            setattr(obj, k, v)


def parse_args(cls: Type[T], argv: Optional[List[str]] = None) -> T:
    argv = list(sys.argv[1:] if argv is None else argv)
    obj = cls()
    # optional leading YAML/JSON config file
    if argv and not argv[0].startswith("-"):
        path = argv.pop(0)
        with open(path) as f:
            if path.endswith((".yaml", ".yml")):
                import yaml

                data = yaml.safe_load(f)
            else:
                data = json.load(f)
        lenient = False
        if data:
            from veomni_tpu_torch.arguments.compat import translate_reference_schema

            data, _, lenient = translate_reference_schema(data)
        _apply_dict(obj, data or {}, lenient=lenient)
    i = 0
    while i < len(argv):
        tok = argv[i]
        if not tok.startswith("--"):
            raise ValueError(f"unexpected argument {tok!r}")
        key = tok[2:]
        if "=" in key:
            key, value = key.split("=", 1)
            i += 1
        else:
            if i + 1 >= len(argv):
                raise ValueError(f"missing value for {tok!r}")
            value = argv[i + 1]
            i += 2
        _set_dotted(obj, key, value)
    # re-run __post_init__ hooks after overrides
    for f in dataclasses.fields(obj):
        sub = getattr(obj, f.name)
        if dataclasses.is_dataclass(sub) and hasattr(sub, "__post_init__"):
            sub.__post_init__()
    return obj


def save_args(args: Any, output_dir: str) -> None:
    """Persist the resolved config (reference save_args)."""
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "train_config.json"), "w") as f:
        json.dump(dataclasses.asdict(args), f, indent=2, default=str)
