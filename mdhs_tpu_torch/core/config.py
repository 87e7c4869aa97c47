"""Nested-dict configs with dotted access, ``_base_`` chains and overrides.

Counterpart of ``mdhs_tpu/core/config.py``: ``Config`` (dotted get/set,
deep merge, ``key=value`` overrides) and ``load_config`` with the in-file
``_base_: path`` chain (the JAX one's separate base-file argument, which no
caller uses, is left out). A machine may have no yaml reader, so a
file that parses as JSON is read with ``json`` and any other file with
``yaml.safe_load``, imported only then; ``yaml.safe_load`` reads a JSON file
to the same dict, so both packages load the same config from it. Override
values are coerced as YAML reads a scalar: with ``yaml.safe_load`` where yaml
imports, else with ``parse_scalar``, this module's reading of the YAML 1.1
scalars a command line gives (int, float, bool, null, a flow list, a quoted
or plain string).
"""

from __future__ import annotations

import copy
import json
import os
import re
from typing import Any, Mapping


def _deep_merge(base: dict, override: Mapping) -> dict:
    out = copy.deepcopy(base)
    for key, val in override.items():
        if key in out and isinstance(out[key], dict) and isinstance(val, Mapping):
            out[key] = _deep_merge(out[key], val)
        else:
            out[key] = copy.deepcopy(val)
    return out


# YAML 1.1's implicit scalar types, as PyYAML's SafeLoader resolves them
_BOOL = {**dict.fromkeys(("yes", "Yes", "YES", "true", "True", "TRUE", "on", "On", "ON"), True),
         **dict.fromkeys(("no", "No", "NO", "false", "False", "FALSE", "off", "Off", "OFF"), False)}
_NULL = ("", "~", "null", "Null", "NULL")
_INT = re.compile(r"[-+]?(?:0b[01_]+|0[0-7_]+|(?:0|[1-9][0-9_]*)|0x[0-9a-fA-F_]+)")
_FLOAT = re.compile(r"[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?")
_INF = re.compile(r"([-+]?)\.(?:inf|Inf|INF)")
_NAN = re.compile(r"\.(?:nan|NaN|NAN)")


def _yaml_int(text: str) -> int:
    sign = -1 if text[0] == "-" else 1
    digits = text.lstrip("+-").replace("_", "")
    if digits.startswith("0b"):
        return sign * int(digits[2:], 2)
    if digits.startswith("0x"):
        return sign * int(digits[2:], 16)
    if len(digits) > 1 and digits.startswith("0"):
        return sign * int(digits, 8)
    return sign * int(digits)


def _split_flow(body: str) -> list[str]:
    """The items of a flow sequence's body, split at top-level commas."""
    items, depth, quote, cur = [], 0, None, []
    for ch in body:
        if quote:
            quote = None if ch == quote else quote
        elif ch in "'\"":
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == "," and depth == 0:
            items.append("".join(cur))
            cur = []
            continue
        cur.append(ch)
    items.append("".join(cur))
    if items and not items[-1].strip():
        items.pop()  # a trailing comma
    return items


def parse_scalar(text: str) -> Any:
    """A command-line value as ``yaml.safe_load`` reads it: null, bool, int,
    float, a flow list of such values, a quoted string, or the plain string.
    What it does not read (a flow mapping, a block, an anchor) stays the
    string it was, as ``_coerce`` leaves a value yaml refuses."""
    s = text.strip()
    if s in _NULL:
        return None
    if s in _BOOL:
        return _BOOL[s]
    if _INT.fullmatch(s):
        return _yaml_int(s)
    if _FLOAT.fullmatch(s):
        return float(s.replace("_", ""))
    if m := _INF.fullmatch(s):
        return float(f"{m.group(1)}inf")
    if _NAN.fullmatch(s):
        return float("nan")
    if len(s) >= 2 and s[0] == s[-1] == "'":
        return s[1:-1].replace("''", "'")
    if len(s) >= 2 and s[0] == s[-1] == '"':
        return json.loads(s)
    if s.startswith("[") and s.endswith("]"):
        return [parse_scalar(item) for item in _split_flow(s[1:-1])]
    return text.strip()


def _coerce(value: str) -> Any:
    """Parse a CLI override value with YAML semantics ("7"->int, "true"->bool)."""
    try:
        import yaml
    except ImportError:
        return parse_scalar(value)
    try:
        return yaml.safe_load(value)
    except yaml.YAMLError:
        return value


def read_file(path: str | os.PathLike) -> dict:
    """A config file's mapping: JSON where the file parses as JSON, else YAML."""
    with open(path, "r", encoding="utf-8") as f:
        text = f.read()
    try:
        data = json.loads(text)
    except json.JSONDecodeError:
        import yaml  # only for a file that is not JSON: a machine may have no yaml

        data = yaml.safe_load(text)
    return data or {}


class Config:
    """A nested mapping with dotted-path get/set."""

    def __init__(self, data: Mapping | None = None):
        self._data: dict = copy.deepcopy(dict(data or {}))

    def __getitem__(self, key: str):
        val = self._data[key]
        return Config(val) if isinstance(val, dict) else val

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def get(self, path: str, default: Any = None):
        """`cfg.get("a.b.c", default)`; plain keys work too."""
        node: Any = self._data
        for part in path.split("."):
            if isinstance(node, Mapping) and part in node:
                node = node[part]
            else:
                return default
        return Config(node) if isinstance(node, dict) else node

    def set(self, path: str, value: Any) -> None:
        parts = path.split(".")
        node = self._data
        for part in parts[:-1]:
            node = node.setdefault(part, {})
            if not isinstance(node, dict):
                raise TypeError(f"Cannot set {path}: {part} is not a mapping")
        node[parts[-1]] = value.to_dict() if isinstance(value, Config) else value

    def merged(self, other: "Config | Mapping") -> "Config":
        data = other.to_dict() if isinstance(other, Config) else dict(other)
        return Config(_deep_merge(self._data, data))

    def with_overrides(self, overrides: list[str] | None) -> "Config":
        cfg = Config(self._data)
        for item in overrides or []:
            if "=" not in item:
                raise ValueError(f"Override must be key=value, got: {item}")
            key, _, val = item.partition("=")
            cfg.set(key.strip(), _coerce(val.strip()))
        return cfg

    def save_json(self, path: str | os.PathLike) -> None:
        """Write the mapping as JSON that ``load_config`` of either package reads
        to the same dict (``to_json``)."""
        os.makedirs(os.path.dirname(os.fspath(path)) or ".", exist_ok=True)
        with open(path, "w", encoding="utf-8") as f:
            f.write(to_json(self._data) + "\n")


def _json_float(v: float) -> str:
    """A float as JSON that YAML 1.1 also reads as a float: PyYAML takes "2e-05" for a
    string (its float pattern needs a dot), so the mantissa gets one, "2.0e-05"."""
    if v != v or v in (float("inf"), float("-inf")):
        raise ValueError(f"{v} has no JSON form")
    text = repr(v)
    if "e" in text and "." not in text:
        mantissa, _, exponent = text.partition("e")
        text = f"{mantissa}.0e{exponent}"
    return text


def to_json(value: Any, indent: str = "") -> str:
    """``value`` (dicts, lists, str, int, float, bool, None) as indented JSON, each
    float in ``_json_float``'s form."""
    inner = indent + " "
    if isinstance(value, dict):
        if not value:
            return "{}"
        items = [f"{inner}{json.dumps(str(k), ensure_ascii=False)}: {to_json(v, inner)}" for k, v in value.items()]
        return "{\n" + ",\n".join(items) + "\n" + indent + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(to_json(v, inner) for v in value) + "]"
    if isinstance(value, float):
        return _json_float(value)
    return json.dumps(value, ensure_ascii=False)


def load_config(path: str | os.PathLike, overrides: list[str] | None = None) -> Config:
    """Load a config; an in-file ``_base_: path`` (relative to the file) is
    deep-merged under it, recursively; then the ``key=value`` overrides."""
    cfg = Config(read_file(path))
    base_ref = cfg.get("_base_")
    if base_ref is not None:
        base = load_config(os.path.join(os.path.dirname(os.fspath(path)), base_ref))
        data = cfg.to_dict()
        data.pop("_base_", None)
        cfg = base.merged(data)
    return cfg.with_overrides(overrides)
