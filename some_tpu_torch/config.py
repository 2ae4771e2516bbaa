"""YAML config reader and writer for the subset SOME configs use, and the
``base_config`` cascade.

The machine the port serves on has no PyYAML, so the port reads its configs
itself: ``configs/*.yaml`` and the ``config.yaml`` that the JAX and the
reference trainers write beside a checkpoint (PyYAML's ``safe_dump`` of the
composed config). The subset: ``#`` comments, block mappings with plain
keys, block sequences of scalars (``- item``, indented or at the parent
key's indent), flow sequences of scalars (``[a, b]``), the empty mapping
``{}``, single-quoted strings, and plain scalars: ``null``, ``~``, ``true``,
``false``, decimal integers, decimals with a dot (``0.5``, ``1.0e-05``),
``.inf``, ``-.inf``, ``.nan``, and any other plain text that PyYAML's
``safe_load`` reads as a string (``32-true``, ``/data/some ds/binary``).
Each reads as ``safe_load`` reads it; a plain scalar that YAML 1.1 would
read as another type the subset lacks (``yes``, ``0x1F``, ``1_000``,
``1e-5`` without a dot, a date, ...), double quotes, and nested or mapping
sequence items raise ``ValueError``.

The cascade mirrors ``some_tpu/config.py``: parents in ``base_config`` are
squashed depth-first and the child overrides leaf keys, nested dicts merging.
"""
from __future__ import annotations

import pathlib
import re
from typing import Any, List, Tuple

_INT = re.compile(r"^-?(0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^-?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")
_WORD = re.compile(r"^(?=[^A-Za-z]*[A-Za-z])[A-Za-z0-9_][A-Za-z0-9_./-]*$")
# words with a letter that YAML 1.1 reads as a number, or PyYAML as a string
# only by a narrow rule (``1e-5``, ``0x1F``, ``0b101``): outside the subset
_NUMBERISH = re.compile(r"^[0-9][0-9_.]*(?:[eE][-+]?[0-9]+|[xXbBoO].*)$")
_KEY = re.compile(r"^([A-Za-z_][A-Za-z0-9_.-]*)\s*:(?:\s+(.*)|)$")
_CONSTANTS = {"": None, "null": None, "~": None, "true": True, "false": False,
              ".inf": float("inf"), "-.inf": float("-inf"), ".nan": float("nan")}
# words that YAML 1.1 reads as a boolean or null in some spelling
_RESERVED = {"yes", "no", "on", "off", "true", "false", "null"}
# plain scalars that PyYAML's implicit resolvers read as something other than
# a string (bool, int, float, null, timestamp, merge, value), in their forms
# outside the subset
_OTHER_TYPE = re.compile(
    r"^(?:yes|Yes|YES|no|No|NO|True|TRUE|False|FALSE|on|On|ON|off|Off|OFF|Null|NULL"
    r"|[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN)"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]"
    r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)?|<<|=)$")
# a plain scalar may not start with an indicator, nor hold ": " or " #"
_PLAIN_STR = re.compile(r"^(?![-?:,\[\]{}#&*!|>'\"%@`])(?!.*(?::\s| #))[^\t]*(?<![\s:])$")


def _is_word(text: str) -> bool:
    return (bool(_WORD.match(text)) and not _NUMBERISH.match(text)
            and text.lower() not in _RESERVED)


def _is_plain_string(text: str) -> bool:
    """A plain scalar that ``safe_load`` reads as a string, or a leading
    ``-`` that no space follows (``-x``), as ``safe_dump`` writes it."""
    body = text[1:] if text.startswith("-") and len(text) > 1 and text[1] != " " else text
    return bool(_PLAIN_STR.match(body)) and not _OTHER_TYPE.match(text)


def _scalar(text: str) -> Any:
    if text.startswith("'"):
        inner = text[1:-1]
        if len(text) < 2 or not text.endswith("'") or "'" in inner.replace("''", ""):
            raise ValueError(f"bad single-quoted YAML string {text!r}")
        return inner.replace("''", "'")
    if text in _CONSTANTS:
        return _CONSTANTS[text]
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    if _is_word(text) or _is_plain_string(text):
        return text
    raise ValueError(f"YAML scalar {text!r} is outside the subset configs/*.yaml use")


def _value(text: str) -> Any:
    """An inline value: a scalar, a flow sequence of scalars, or ``{}``."""
    if text == "{}":
        return {}
    if text.startswith("["):
        if not text.endswith("]"):
            raise ValueError(f"bad flow sequence {text!r}")
        inner = text[1:-1].strip()
        return [_scalar(item.strip()) for item in inner.split(",")] if inner else []
    return _scalar(text)


def _strip_comment(line: str) -> str:
    """Drop a ``#`` comment that starts the line or follows whitespace,
    outside single quotes."""
    quoted = False
    for i, ch in enumerate(line):
        if ch == "'" and (quoted or i == 0 or line[i - 1] in " \t[,:-"):
            quoted = not quoted
        elif ch == "#" and not quoted and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


def _is_seq_item(content: str) -> bool:
    return content == "-" or content.startswith("- ")


def _parse_block(lines: List[Tuple[int, str]], i: int, indent: int) -> Tuple[Any, int]:
    if _is_seq_item(lines[i][1]):
        out: list = []
        while i < len(lines) and lines[i][0] == indent and _is_seq_item(lines[i][1]):
            rest = lines[i][1][1:].strip()
            if not rest or _KEY.match(rest):
                raise ValueError(f"only scalar sequence items are supported: {lines[i][1]!r}")
            out.append(_value(rest))
            i += 1
        return out, i
    out_map: dict = {}
    while i < len(lines) and lines[i][0] == indent and not _is_seq_item(lines[i][1]):
        m = _KEY.match(lines[i][1])
        if m is None:
            raise ValueError(f"cannot parse YAML line {lines[i][1]!r}")
        key, rest = m.group(1), (m.group(2) or "").strip()
        i += 1
        if rest:
            out_map[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent or (
                lines[i][0] == indent and _is_seq_item(lines[i][1]))):
            out_map[key], i = _parse_block(lines, i, lines[i][0])
        else:
            out_map[key] = None
    return out_map, i


def parse_yaml(text: str) -> Any:
    """Parse the YAML subset described in the module docstring."""
    lines = []
    for raw in text.splitlines():
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise ValueError("tabs in YAML indentation")
        content = _strip_comment(raw).rstrip()
        if content.strip():
            lines.append((len(content) - len(content.lstrip()), content.strip()))
    if not lines:
        return None
    value, i = _parse_block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"cannot parse YAML line {lines[i][1]!r} (bad indentation)")
    return value


def load_yaml(path: pathlib.Path | str) -> Any:
    with open(path, "r", encoding="utf8") as f:
        return parse_yaml(f.read())


def _format_scalar(value: Any) -> str:
    if value is None:
        return "null"
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float):
        text = repr(value)
        mantissa, _, exponent = text.partition("e")
        if "." not in mantissa:
            mantissa += ".0"
        if not _FLOAT.match(mantissa):
            raise ValueError(f"cannot write float {value!r} in the YAML subset")
        if exponent and exponent[0] not in "+-":
            exponent = "+" + exponent
        return mantissa + ("e" + exponent if exponent else "")
    if isinstance(value, str):
        if "\n" in value:
            raise ValueError(f"cannot write a multi-line string: {value!r}")
        return value if _is_word(value) else "'" + value.replace("'", "''") + "'"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_format_scalar(v) for v in value) + "]"
    if isinstance(value, dict) and not value:
        return "{}"
    raise TypeError(f"cannot write {type(value).__name__} as a YAML scalar")


def dump_yaml(config: dict, indent: int = 0) -> str:
    """Write a config dict in the subset :func:`parse_yaml` reads (and that
    PyYAML reads the same way)."""
    out = []
    for key, value in config.items():
        if not isinstance(key, str) or not _KEY.match(key + ":"):
            raise ValueError(f"cannot write key {key!r} in the YAML subset")
        head = " " * indent + key + ":"
        if isinstance(value, dict) and value:
            out.append(head + "\n" + dump_yaml(value, indent + 2))
        else:
            out.append(head + " " + _format_scalar(value) + "\n")
    return "".join(out)


def save_yaml(config: dict, path: pathlib.Path | str) -> None:
    pathlib.Path(path).write_text(dump_yaml(config), encoding="utf8")


def deep_update(base: dict, overrides: dict) -> dict:
    """Recursively merge ``overrides`` into ``base`` (in place, returns base)."""
    for key, value in overrides.items():
        if isinstance(value, dict) and isinstance(base.get(key), dict):
            deep_update(base[key], value)
        else:
            base[key] = value
    return base


def read_full_config(config_path: pathlib.Path | str) -> dict:
    """Load a config, resolving its ``base_config`` chain. Relative parent
    paths resolve against the working directory first, then against the
    config file's own directory."""
    config_path = pathlib.Path(config_path).resolve()
    config = load_yaml(config_path) or {}
    if "base_config" not in config:
        return config
    bases = config["base_config"]
    if not isinstance(bases, list):
        bases = [bases]
    squashed: dict = {}
    for base in bases:
        base_path = pathlib.Path(base)
        if not base_path.exists():
            for candidate in (config_path.parent / base_path.name,
                              config_path.parent / base_path):
                if candidate.exists():
                    base_path = candidate
                    break
        deep_update(squashed, read_full_config(base_path))
    deep_update(squashed, config)
    squashed.pop("base_config")
    return squashed


def print_config(config: dict) -> None:
    """Colorized k: v dump, five entries per line."""
    items = sorted(config.items())
    for i, (k, v) in enumerate(items):
        print(f"\033[0;33m{k}\033[0m: {v}", end="")
        if i < len(items) - 1:
            print(", ", end="")
        if i % 5 == 4:
            print()
    print()
