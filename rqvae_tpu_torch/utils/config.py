"""Config system: gin-style config files without the gin dependency (the
port's own copy of rqvae_tpu/utils/config.py). The shipped configs/*.gin bind
every experiment knob in this format:

    import data.processed                  # ignored (module scoping no-op)
    train.iterations=400000                # Python literal values
    train.vae_hidden_dims=[512, 256, 128]
    train.dataset=%data.processed.RecDataset.AMAZON   # enum reference
    train.vae_codebook_mode=%modules.quantize.QuantizeForwardMode.STE

Enum references resolve by their trailing `EnumName.MEMBER` against a
registry, so the shipped config files work verbatim.
"""

from __future__ import annotations

import ast
import enum
from typing import Any, Dict, Type

_ENUM_REGISTRY: Dict[str, Type[enum.Enum]] = {}


def register_enum(e: Type[enum.Enum]) -> Type[enum.Enum]:
    _ENUM_REGISTRY[e.__name__] = e
    return e


def _register_builtin_enums() -> None:
    from rqvae_tpu_torch.data.registry import RecDataset
    from rqvae_tpu_torch.models.quantize import QuantizeDistance, QuantizeForwardMode

    for e in (QuantizeForwardMode, QuantizeDistance, RecDataset):
        register_enum(e)


def _resolve_enum(ref: str) -> enum.Enum:
    """'%a.b.EnumName.MEMBER' -> registry['EnumName'].MEMBER."""
    parts = ref.lstrip("%").split(".")
    if len(parts) < 2:
        raise ValueError(f"Bad enum reference: {ref}")
    enum_name, member = parts[-2], parts[-1]
    if not _ENUM_REGISTRY:
        _register_builtin_enums()
    if enum_name not in _ENUM_REGISTRY:
        _register_builtin_enums()
    if enum_name not in _ENUM_REGISTRY:
        raise ValueError(f"Unknown enum {enum_name!r} in reference {ref!r}")
    return _ENUM_REGISTRY[enum_name][member]


def _parse_value(raw: str) -> Any:
    raw = raw.strip()
    if raw.startswith("%"):
        return _resolve_enum(raw)
    try:
        return ast.literal_eval(raw)
    except (ValueError, SyntaxError):
        # bare identifiers like True/False/None are literal_eval-able;
        # anything else is kept as a string (gin treats quoted strings only,
        # but being lenient here costs nothing)
        return raw


def parse_config_file(path: str, scope: str = "train") -> Dict[str, Any]:
    """Parse a .gin-style file, returning {param: value} for `scope.param`
    bindings. Other scopes raise (to surface typos), imports are ignored."""
    out: Dict[str, Any] = {}
    with open(path) as f:
        for lineno, line in enumerate(f, 1):
            line = line.split("#", 1)[0].strip()
            if not line or line.startswith("import "):
                continue
            if "=" not in line:
                raise ValueError(f"{path}:{lineno}: cannot parse {line!r}")
            key, raw = line.split("=", 1)
            key = key.strip()
            if "." not in key:
                raise ValueError(f"{path}:{lineno}: expected 'scope.param=value'")
            key_scope, param = key.split(".", 1)
            if key_scope != scope:
                raise ValueError(
                    f"{path}:{lineno}: unknown scope {key_scope!r} (expected {scope!r})"
                )
            out[param] = _parse_value(raw)
    return out


def apply_config(fn, config_path: str, scope: str = "train", **overrides):
    """Call fn(**file_bindings, **overrides), erroring on unknown params."""
    import inspect

    bindings = parse_config_file(config_path, scope)
    bindings.update(overrides)
    sig = inspect.signature(fn)
    unknown = set(bindings) - set(sig.parameters)
    if unknown:
        raise ValueError(f"Unknown config parameters for {fn.__name__}: {sorted(unknown)}")
    return fn(**bindings)
