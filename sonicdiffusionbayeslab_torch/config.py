"""YAML experiment-config loader of the port.

Counterpart of ``sonicdiffusionbayeslab_tpu/config.py``: the same sections
(``experiment / model / scheduler / dataset / quality_metrics / logger /
inference / experiment_params``), :class:`ConfigNode` with dotted attribute
access, :func:`validate_config`, dotted ``--set`` overrides and
:func:`load_config`.

The YAML is read by this module's own reader, on every machine: PyYAML is
not a dependency of the port.  It reads the subset that ``configs/*.yaml``
use, with PyYAML's ``safe_load`` meaning:

* block mappings (string keys, nested by indentation) and ``#`` comments;
* quoted scalars (``"..."`` with backslash escapes, ``'...'`` with ``''``)
  and plain scalars, resolved as YAML 1.1 does: null (``~``, ``null``),
  bool (``true``/``false``/``yes``/``no``/``on``/``off`` in three cases),
  decimal int, float (``1.5``, ``1.0e-4``, ``.inf``, ``.nan``; a float
  needs its dot, so ``1e-4`` stays a string, as in PyYAML), else string;
* flow sequences on one line, nested too (``[[2, 3], [5, 6, 7]]``).

Anything else (block sequences, flow mappings, anchors, tags, multi-line
scalars, octal/hex/sexagesimal numbers, timestamps, duplicate keys, tabs)
raises :class:`ConfigError` naming the line.
"""

from __future__ import annotations

import copy
import re
from pathlib import Path
from typing import Any, Iterator, Mapping


class ConfigError(ValueError):
    pass


class ConfigNode(Mapping[str, Any]):
    """Read-only dict wrapper with attribute access, nesting-aware."""

    __slots__ = ("_data",)

    def __init__(self, data: Mapping[str, Any]):
        object.__setattr__(self, "_data", dict(data))

    def __getitem__(self, key: str) -> Any:
        return _wrap(self._data[key])

    def __iter__(self) -> Iterator[str]:
        return iter(self._data)

    def __len__(self) -> int:
        return len(self._data)

    def __contains__(self, key: object) -> bool:
        return key in self._data

    def __getattr__(self, key: str) -> Any:
        try:
            return _wrap(self._data[key])
        except KeyError:
            raise AttributeError(
                f"config has no key {key!r}; available: {sorted(self._data)}"
            ) from None

    def __setattr__(self, key: str, value: Any) -> None:
        raise TypeError("ConfigNode is read-only; use .replace(**updates)")

    def get(self, key: str, default: Any = None) -> Any:
        return _wrap(self._data.get(key, default))

    def to_dict(self) -> dict:
        return copy.deepcopy(self._data)

    def replace(self, **updates: Any) -> "ConfigNode":
        d = self.to_dict()
        d.update(updates)
        return ConfigNode(d)

    def __repr__(self) -> str:
        return f"ConfigNode({self._data!r})"


def _wrap(value: Any) -> Any:
    if isinstance(value, ConfigNode):
        return value
    if isinstance(value, Mapping):
        return ConfigNode(value)
    return value


REQUIRED_SECTIONS = ("experiment", "model", "dataset", "inference")
KNOWN_SECTIONS = REQUIRED_SECTIONS + (
    "experiment_name",
    "scheduler",
    "quality_metrics",
    "logger",
    "experiment_params",
    "training",
)
REQUIRED_TRAINING_SECTIONS = ("model", "dataset", "training")


def validate_config(cfg: ConfigNode) -> ConfigNode:
    required = REQUIRED_TRAINING_SECTIONS if "training" in cfg else REQUIRED_SECTIONS
    missing = [s for s in required if s not in cfg]
    if missing:
        raise ConfigError(f"config missing required sections {missing}")
    unknown = [s for s in cfg if s not in KNOWN_SECTIONS]
    if unknown:
        raise ConfigError(
            f"config has unknown sections {unknown}; known: {sorted(KNOWN_SECTIONS)}"
        )
    if "training" not in cfg and "method" not in cfg.experiment:
        raise ConfigError("config experiment section must set 'method'")
    if "model_name" not in cfg.model:
        raise ConfigError("config model section must set 'model_name'")
    return cfg


def apply_overrides(raw: dict, overrides: Mapping[str, Any]) -> dict:
    """Apply dotted-key overrides (``{"dataset.max_count": 32}``) in place.
    Intermediate mappings are created as needed; a non-mapping in the middle
    of a path is a :class:`ConfigError`."""
    for dotted, value in overrides.items():
        parts = dotted.split(".")
        node = raw
        for p in parts[:-1]:
            nxt = node.setdefault(p, {})
            if not isinstance(nxt, dict):
                raise ConfigError(
                    f"override {dotted!r}: {p!r} is {type(nxt).__name__}, not a section")
            node = nxt
        node[parts[-1]] = value
    return raw


def load_config(path: str | Path, overrides: Mapping[str, Any] | None = None) -> ConfigNode:
    """Load and validate a YAML experiment config; ``overrides`` maps dotted
    keys to values and is applied before validation.  A bare name that does
    not exist resolves under ``./configs``."""
    path = Path(path)
    if not path.exists():
        alt = Path("configs") / path.name
        if alt.exists():
            path = alt
        else:
            raise FileNotFoundError(f"config not found: {path}")
    raw = parse_yaml(path.read_text(), str(path))
    if not isinstance(raw, Mapping):
        raise ConfigError(f"config root must be a mapping, got {type(raw).__name__}")
    raw = dict(raw)
    if overrides:
        apply_overrides(raw, overrides)
    return validate_config(ConfigNode(raw))


# ------------------------------------------------------------ YAML subset
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
_NULL = re.compile(r"^(?:~|null|Null|NULL)$")
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_INF_NAN = re.compile(r"^(?:[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# What YAML 1.1 also reads as a number, a timestamp or a merge key; none of
# it is in the subset (PyYAML's resolver patterns).
_OTHER = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?0x[0-9a-fA-F_]+"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}(?:(?:[Tt]|[ \t]+)[0-9].*)?|<<|=)$")
_INDICATORS = "-?:,[]{}#&*!|>%@`"
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n", "v": "\v",
            "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"', "/": "/", "\\": "\\",
            "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


class _Line:
    """One line of YAML text being scanned: ``text`` without its newline,
    ``pos`` the scan position, ``no`` the line number for errors."""

    def __init__(self, text: str, no: int, source: str):
        self.text, self.no, self.source, self.pos = text, no, source, 0

    def error(self, why: str) -> ConfigError:
        return ConfigError(f"{self.source}:{self.no}: {why} (outside the YAML subset the "
                           f"port reads): {self.text.strip()!r}")

    def peek(self) -> str:
        return self.text[self.pos] if self.pos < len(self.text) else ""

    def skip_spaces(self) -> None:
        while self.peek() == " ":
            self.pos += 1

    def at_end(self) -> bool:
        """True when only spaces and a comment are left."""
        self.skip_spaces()
        return self.pos >= len(self.text) or self.peek() == "#"


def _resolve_plain(s: str, line: _Line) -> Any:
    if _NULL.match(s):
        return None
    if _BOOL.match(s):
        return s.lower() in ("yes", "true", "on")
    if _INT.match(s):
        return int(s)
    if _FLOAT.match(s):
        return float(s)
    if _INF_NAN.match(s):
        low = s.lower()
        return float("nan") if low.endswith("nan") else float(low.replace(".", ""))
    if _OTHER.match(s):
        raise line.error(f"plain scalar {s!r} is a YAML 1.1 number, timestamp or merge key")
    return s


def _scan_quoted(line: _Line) -> str:
    quote = line.peek()
    line.pos += 1
    out = []
    while True:
        c = line.peek()
        if not c:
            raise line.error("unterminated or multi-line quoted scalar")
        line.pos += 1
        if c == quote:
            if quote == "'" and line.peek() == "'":
                out.append("'")
                line.pos += 1
                continue
            return "".join(out)
        if c == "\\" and quote == '"':
            e = line.peek()
            line.pos += 1
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
            elif e in _HEX_ESCAPES:
                digits = line.text[line.pos:line.pos + _HEX_ESCAPES[e]]
                if len(digits) != _HEX_ESCAPES[e] or not all(
                        d in "0123456789abcdefABCDEF" for d in digits):
                    raise line.error(f"bad \\{e} escape")
                out.append(chr(int(digits, 16)))
                line.pos += len(digits)
            else:
                raise line.error(f"unknown escape \\{e}")
            continue
        out.append(c)


def _scan_plain(line: _Line, flow: bool) -> Any:
    """A plain scalar from ``line.pos``: in a flow sequence up to ``,`` or
    ``]``, else up to a comment or the line's end."""
    c = line.peek()
    nxt = line.text[line.pos + 1:line.pos + 2]
    if c in _INDICATORS and not (c in "-?:" and nxt not in ("", " ")):
        raise line.error(f"a node starting with {c!r}")
    start = line.pos
    stops = ",[]{}" if flow else ""
    while line.pos < len(line.text):
        c = line.text[line.pos]
        if c in stops or (c == "#" and line.text[line.pos - 1] == " "):
            break
        if c == ":" and line.text[line.pos + 1:line.pos + 2] in ("", " "):
            raise line.error("a mapping inside a value")
        line.pos += 1
    s = line.text[start:line.pos].rstrip(" ")
    if not s:
        raise line.error("an empty flow sequence entry")
    return _resolve_plain(s, line)


def _scan_flow_sequence(line: _Line) -> list:
    line.pos += 1  # "["
    items = []
    while True:
        line.skip_spaces()
        c = line.peek()
        if c == "]":
            line.pos += 1
            return items
        if not c or c == "#":
            raise line.error("a flow sequence that does not close on its line")
        items.append(_scan_node(line, flow=True))
        line.skip_spaces()
        c = line.peek()
        if c == ",":
            line.pos += 1
        elif c != "]":
            raise line.error("a flow sequence entry not followed by ',' or ']'")


def _scan_node(line: _Line, flow: bool) -> Any:
    c = line.peek()
    if c in "\"'":
        return _scan_quoted(line)
    if c == "[":
        return _scan_flow_sequence(line)
    return _scan_plain(line, flow)


def _scan_key(line: _Line) -> str:
    if line.peek() in "\"'":
        key = _scan_quoted(line)
        line.skip_spaces()
        if line.peek() != ":":
            raise line.error("a quoted key without ':'")
    else:
        c = line.peek()
        if c in _INDICATORS:
            raise line.error(f"a line starting with {c!r}")
        end = line.text.find(":", line.pos)
        while end >= 0 and line.text[end + 1:end + 2] not in ("", " "):
            end = line.text.find(":", end + 1)
        if end < 0:
            raise line.error("a line that is not 'key: value'")
        raw = line.text[line.pos:end].rstrip(" ")
        if " #" in raw:
            raise line.error("a line that is not 'key: value'")
        key = _resolve_plain(raw, line)
        if not isinstance(key, str):
            raise line.error(f"a key that is not a string ({raw!r})")
        line.pos = end
    line.pos += 1  # ":"
    return key


_NO_VALUE = object()


def _parse_mapping(lines, i: int, indent: int):
    out = {}
    while i < len(lines):
        ind, line = lines[i]
        if ind < indent:
            break
        if ind > indent:
            raise line.error("unexpected indentation")
        key = _scan_key(line)
        if key in out:
            raise line.error(f"duplicate key {key!r}")
        value = _NO_VALUE
        if not line.at_end():
            value = _scan_node(line, flow=False)
            if not line.at_end():
                raise line.error("text after a value")
        i += 1
        deeper = i < len(lines) and lines[i][0] > indent
        if value is _NO_VALUE:
            if deeper:
                value, i = _parse_mapping(lines, i, lines[i][0])
            else:
                value = None
        elif deeper:
            raise lines[i][1].error("a multi-line value")
        out[key] = value
    return out, i


def parse_yaml(text: str, source: str = "<yaml>") -> Any:
    """A document of the subset above -> dict (None when it is empty)."""
    lines = []
    for no, raw in enumerate(text.splitlines(), 1):
        line = _Line(raw.rstrip(" \t\r"), no, source)
        body = line.text.lstrip(" ")
        if not body or body.startswith("#"):
            continue
        if body.startswith("\t"):
            raise line.error("a tab in the indentation")
        if body.startswith(("---", "...", "%")):
            raise line.error("a document marker or directive")
        line.pos = len(line.text) - len(body)
        lines.append((line.pos, line))
    if not lines:
        return None
    tree, i = _parse_mapping(lines, 0, lines[0][0])
    if i < len(lines):
        raise lines[i][1].error("indentation that closes the top-level mapping")
    return tree


def parse_value(text: str, source: str = "<value>") -> Any:
    """One scalar or flow sequence (a ``--set`` value), as YAML reads it."""
    line = _Line(text.strip(" "), 1, source)
    if not line.text:
        return None
    value = _scan_node(line, flow=False)
    if not line.at_end():
        raise line.error("text after a value")
    return value
