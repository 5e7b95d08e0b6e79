"""Config system with class-path instantiation and CLI overrides, and
its own reader for the YAML the configs use (no PyYAML).

The port's counterpart of ``snn_for_object_detection_tpu/utils/config.py``:
YAML files with ``class_path`` / ``init_args`` nodes, merged left to
right, dotted-key CLI overrides beating them, and a resolved-config
snapshot beside the run's outputs.

The reader (:func:`loads`) takes the subset of YAML that ``config/*.yaml``
and the overrides use, and gives PyYAML's ``safe_load`` value (YAML 1.1
scalars) or raises ``ConfigSyntaxError``:

- block mappings by indentation, block sequences of scalars, mappings or
  sequences (``- key: value`` items included);
- flow sequences and flow mappings on one line (``[240, 304]``,
  ``{hflip: 0.5}``), nested;
- comments, single- and double-quoted scalars on one line without
  escapes, and plain scalars resolved by YAML 1.1's rules: ``1e-3`` is
  a string and ``1.0e-3`` a float; ``yes``/``no``/``on``/``off`` are
  booleans; ``~`` is null; decimal ints and ``0x10`` are ints.

Anything else (escapes, the other YAML 1.1 number forms such as ``010``,
``1_000``, ``1:30``, ``.5`` or ``.inf``, anchors, aliases, tags, block
scalars, multi-line scalars or flow collections, documents markers,
tabs, timestamps, merge keys, complex keys) raises rather than risk
another value.
"""

from __future__ import annotations

import copy
import importlib
import math
import os
import re
from typing import Any, Dict, List, Sequence, Tuple

JAX_PACKAGE = "snn_for_object_detection_tpu."
PORT_PACKAGE = "snn_for_object_detection_tpu_torch."


class ConfigSyntaxError(ValueError):
    """YAML outside the subset this reader takes."""


# ---- scalars ----

# PyYAML's YAML 1.1 implicit resolvers: what it reads as a boolean, a
# float, an int, null or a timestamp
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                    |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                    |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                    |[-+]?\.(?:inf|Inf|INF)
                    |\.(?:nan|NaN|NAN))$""", re.X)
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                    |[-+]?0[0-7_]+
                    |[-+]?(?:0|[1-9][0-9_]*)
                    |[-+]?0x[0-9a-fA-F_]+
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
# the number forms this reader takes: decimal and hex ints, dotted floats
_INT_TAKEN = re.compile(r"^[-+]?(?:0|[1-9][0-9]*|0x[0-9a-fA-F]+)$")
_FLOAT_TAKEN = re.compile(r"^[-+]?[0-9]+\.[0-9]*(?:[eE][-+][0-9]+)?$")


def resolve_plain(text: str) -> Any:
    """A plain scalar's value under YAML 1.1 (PyYAML's implicit tags);
    raises on the number forms not taken (octal, binary, ``_``,
    sexagesimal, ``.5``, ``.inf``, ``.nan``) and on timestamps."""
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _NULL.match(text):
        return None
    if _FLOAT.match(text) or _INT.match(text) or _TIMESTAMP.match(text):
        if _INT_TAKEN.match(text):
            return int(text, 0)
        if _FLOAT_TAKEN.match(text):
            return float(text)
        raise ConfigSyntaxError(f"this number or timestamp form is not "
                                f"supported: {text!r}")
    if text in ("<<", "="):
        raise ConfigSyntaxError(f"merge and value keys are not supported: "
                                f"{text!r}")
    return text


def _quoted(text: str, pos: int) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[pos]``, without escapes
    (``\\`` in double quotes, ``''`` in single quotes raise); returns
    (value, the position after the closing quote)."""
    quote = text[pos]
    end = text.find(quote, pos + 1)
    if end < 0:
        raise ConfigSyntaxError(f"unterminated quoted scalar (multi-line "
                                f"scalars are not supported): {text!r}")
    value = text[pos + 1:end]
    if (quote == '"' and "\\" in value) or text[end + 1:end + 2] == quote:
        raise ConfigSyntaxError(f"escapes in quoted scalars are not "
                                f"supported: {text!r}")
    return value, end + 1


# ---- one line: comments, flow collections, scalars ----

def _check_plain_start(text: str, pos: int, flow: bool) -> None:
    """Raise unless a plain scalar may start at ``text[pos]`` (PyYAML's
    ``check_plain``; ``?`` is refused in both contexts)."""
    ch, nxt = text[pos:pos + 1], text[pos + 1:pos + 2]
    if (not ch or ch in ",[]{}#&*!|>'\"%@`?"
            or (ch in "-:" and (nxt in ("", " ") or (flow and ch == ":")))):
        raise ConfigSyntaxError(f"unsupported YAML at column {pos} of "
                                f"{text!r}")


def _strip_comment(line: str) -> str:
    """``line`` without its comment: a ``#`` at the start or after a
    space, outside quoted scalars. A quote opens a quoted scalar only
    where a token starts (inside a plain scalar it is a character)."""
    i, depth, at_start = 0, 0, True
    while i < len(line):
        ch, nxt = line[i], line[i + 1:i + 2]
        if ch == " ":
            i += 1
            continue
        if ch == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip()
        if at_start and ch in "'\"":
            _, i = _quoted(line, i)
            at_start = False
            continue
        if at_start and ch in "[{":
            depth += 1
        elif depth and ch in "]}":
            depth -= 1
            at_start = False
        elif depth and ch == ",":
            at_start = True
        elif ch == ":" and (nxt in ("", " ") or (depth and nxt in ",[]{}")):
            at_start = True
        elif at_start and ch in "-?" and nxt in ("", " "):
            pass  # a block entry or key indicator: a token starts after it
        else:
            at_start = False
        i += 1
    return line.rstrip()


def _plain_end(text: str, pos: int, flow: bool) -> int:
    """End of the plain scalar starting at ``pos``."""
    i = pos
    while i < len(text):
        ch = text[i]
        nxt = text[i + 1:i + 2]
        if ch == ":" and (nxt in ("", " ") or (flow and nxt in ",[]{}")):
            break
        if flow and ch in ",[]{}":
            break
        i += 1
    return i


class _Flow:
    """Recursive descent over one line of flow YAML."""

    def __init__(self, text: str):
        self.text, self.pos = text, 0

    def skip(self) -> None:
        while self.pos < len(self.text) and self.text[self.pos] == " ":
            self.pos += 1

    def peek(self) -> str:
        self.skip()
        return self.text[self.pos:self.pos + 1]

    def expect(self, ch: str) -> None:
        if self.peek() != ch:
            raise ConfigSyntaxError(f"expected {ch!r} at column {self.pos} "
                                    f"of {self.text!r}")
        self.pos += 1

    def node(self, flow: bool) -> Any:
        ch = self.peek()
        if ch == "[":
            return self.sequence()
        if ch == "{":
            return self.mapping()
        if ch in ("'", '"'):
            value, self.pos = _quoted(self.text, self.pos)
            return value
        return self.plain(flow)

    def plain(self, flow: bool) -> Any:
        text, pos = self.text, self.pos
        _check_plain_start(text, pos, flow)
        end = _plain_end(text, pos, flow)
        value = text[pos:end].strip()
        if flow and "?" in value:
            raise ConfigSyntaxError(f"'?' in a flow scalar: {text!r}")
        self.pos = end
        return resolve_plain(value)

    def sequence(self) -> List[Any]:
        self.expect("[")
        out = []
        if self.peek() == "]":
            self.pos += 1
            return out
        while True:
            out.append(self.node(flow=True))
            if self.peek() == ":":
                raise ConfigSyntaxError(f"single-pair mappings in a flow "
                                        f"sequence are not supported: "
                                        f"{self.text!r}")
            if self.peek() == "]":
                self.pos += 1
                return out
            self.expect(",")
            if self.peek() == "]":
                raise ConfigSyntaxError(f"trailing comma in {self.text!r}")

    def mapping(self) -> Dict[Any, Any]:
        self.expect("{")
        out: Dict[Any, Any] = {}
        if self.peek() == "}":
            self.pos += 1
            return out
        while True:
            if self.peek() in ("[", "{"):
                raise ConfigSyntaxError(f"flow keys are not supported: "
                                        f"{self.text!r}")
            key = self.node(flow=True)
            self.expect(":")
            value = None if self.peek() in (",", "}") else \
                self.node(flow=True)
            out[key] = value
            if self.peek() == "}":
                self.pos += 1
                return out
            self.expect(",")
            if self.peek() == "}":
                raise ConfigSyntaxError(f"trailing comma in {self.text!r}")


def _inline(text: str) -> Any:
    """A whole node written on one line: a scalar or a flow collection."""
    if text.startswith(("- ", "? ")) or text in ("-", "?"):
        raise ConfigSyntaxError(f"a block entry where a value is expected: "
                                f"{text!r}")
    parser = _Flow(text)
    value = parser.node(flow=False)
    if parser.peek():
        raise ConfigSyntaxError(f"unexpected {text[parser.pos:]!r} in "
                                f"{text!r}")
    return value


def _split_entry(text: str):
    """``(key, rest)`` if ``text`` is a block mapping entry ``key:`` or
    ``key: value``, else None."""
    if text.startswith(("[", "{")):
        return None
    if text.startswith(("'", '"')):
        key, end = _quoted(text, 0)
        rest = text[end:].lstrip(" ")
        if not rest.startswith(":"):
            return None
    else:
        end = _plain_end(text, 0, flow=False)
        if end == len(text):
            return None
        _check_plain_start(text, 0, flow=False)
        key = resolve_plain(text[:end].strip())
        rest = text[end:]
    if rest[1:2] not in ("", " "):
        return None
    return key, rest[1:].strip()


# ---- block structure ----

class _Line:
    __slots__ = ("indent", "text")

    def __init__(self, indent: int, text: str):
        self.indent, self.text = indent, text


_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF"
                            "\uE000-\uFFFD\U00010000-\U0010FFFF]")


def _lines(source: str) -> List[_Line]:
    source = source[1:] if source.startswith("\ufeff") else source
    bad = _NON_PRINTABLE.search(source)
    if bad:
        raise ConfigSyntaxError(f"unacceptable character {bad.group()!r}")
    if re.search("[\x85\u2028\u2029\t]", source):
        raise ConfigSyntaxError("tabs and Unicode line breaks are not "
                                "supported")
    out = []
    for raw in source.replace("\r\n", "\n").replace("\r", "\n").split("\n"):
        text = _strip_comment(raw)
        if not text.strip():
            continue
        if raw.startswith(("---", "...", "%")):
            raise ConfigSyntaxError(f"document markers and directives are "
                                    f"not supported: {raw!r}")
        stripped = text.lstrip(" ")
        out.append(_Line(len(text) - len(stripped), stripped))
    return out


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


class _Block:
    def __init__(self, lines: List[_Line]):
        self.lines, self.i = lines, 0

    def at(self, indent: int) -> bool:
        return self.i < len(self.lines) and \
            self.lines[self.i].indent == indent

    def node(self, indent: int) -> Any:
        line = self.lines[self.i]
        if _is_item(line.text):
            return self.sequence(indent)
        if _split_entry(line.text) is not None:
            return self.mapping(indent)
        self.i += 1
        value = _inline(line.text)
        self.no_deeper(indent)
        return value

    def no_deeper(self, indent: int) -> None:
        if self.i < len(self.lines) and self.lines[self.i].indent > indent:
            raise ConfigSyntaxError(
                f"unexpected indentation (multi-line scalars are not "
                f"supported): {self.lines[self.i].text!r}")

    def value_after(self, indent: int, rest: str, in_mapping: bool) -> Any:
        """The value of an entry whose text after the indicator is
        ``rest``, the entry's own lines at ``indent``."""
        if rest:
            value = _inline(rest)
            self.no_deeper(indent)
            return value
        if self.i < len(self.lines):
            nxt = self.lines[self.i]
            if nxt.indent > indent:
                return self.node(nxt.indent)
            if in_mapping and nxt.indent == indent and _is_item(nxt.text):
                return self.sequence(indent)
        return None

    def mapping(self, indent: int) -> Dict[Any, Any]:
        out: Dict[Any, Any] = {}
        while self.at(indent) and not _is_item(self.lines[self.i].text):
            line = self.lines[self.i]
            entry = _split_entry(line.text)
            if entry is None:
                raise ConfigSyntaxError(f"expected 'key: value', got "
                                        f"{line.text!r}")
            key, rest = entry
            self.i += 1
            out[key] = self.value_after(
                indent, rest, in_mapping=True)
        self.no_deeper(indent)
        return out

    def sequence(self, indent: int) -> List[Any]:
        out = []
        while self.at(indent) and _is_item(self.lines[self.i].text):
            line = self.lines[self.i]
            rest = line.text[1:].lstrip(" ")
            if rest and (_is_item(rest) or _split_entry(rest) is not None):
                # "- key: value" / "- - x": the item's first line, at the
                # column its text starts in
                self.lines[self.i] = _Line(
                    indent + len(line.text) - len(rest), rest)
                out.append(self.node(self.lines[self.i].indent))
                continue
            self.i += 1
            out.append(self.value_after(indent, rest, in_mapping=False))
        self.no_deeper(indent)
        return out


def loads(source: str) -> Any:
    """Parse one YAML document of the supported subset; ``None`` when it
    is empty, as PyYAML."""
    lines = _lines(source)
    if not lines:
        return None
    block = _Block(lines)
    value = block.node(lines[0].indent)
    if block.i != len(lines):
        raise ConfigSyntaxError(f"unexpected line "
                                f"{lines[block.i].text!r}")
    return value


# ---- writer: block mappings, flow sequences, quoted strings ----

_SAFE_PLAIN = re.compile(r"^(?:[A-Za-z_]|\.?\.?/)[A-Za-z0-9_./-]*$")


def _scalar(value: Any) -> str:
    if value is None:
        return "null"
    if value is True or value is False:
        return "true" if value else "false"
    if isinstance(value, int):
        return str(value)
    if isinstance(value, float) and math.isfinite(value):
        mantissa, e, exponent = repr(value).partition("e")
        if "." not in mantissa:  # YAML 1.1 floats need the dot
            mantissa += ".0"
        return mantissa + e + exponent
    if isinstance(value, str):
        if _SAFE_PLAIN.fullmatch(value) and resolve_plain(value) == value:
            return value
        if all(ch.isprintable() for ch in value):
            if '"' not in value and "\\" not in value:
                return f'"{value}"'
            if "'" not in value:
                return f"'{value}'"
    raise ValueError(f"cannot write {type(value).__name__} {value!r} to a "
                     "config file without escapes")


def _flow(value: Any) -> str:
    if isinstance(value, dict):
        return "{" + ", ".join(f"{_scalar(k)}: {_flow(v)}"
                               for k, v in value.items()) + "}"
    if isinstance(value, (list, tuple)):
        return "[" + ", ".join(_flow(v) for v in value) + "]"
    return _scalar(value)


def dumps(value: Any, indent: int = 0) -> str:
    """YAML for a config: nested dicts as block mappings, everything
    else on one line (sequences in flow form, strings quoted where a
    plain scalar would read back as another value). PyYAML's
    ``safe_load`` and :func:`loads` both read it back to ``value``.
    Raises ``ValueError`` on what needs an escape (a control character,
    a string with both kinds of quote or a backslash and ``'``), an
    infinite or NaN float, or a type other than the configs'."""
    if not isinstance(value, dict) or (not value and not indent):
        return _flow(value) + "\n"
    lines = []
    for k, v in value.items():
        key = " " * indent + _scalar(k) + ":"
        if isinstance(v, dict) and v:
            lines.append(key + "\n" + dumps(v, indent + 2))
        else:
            lines.append(f"{key} {_flow(v)}\n")
    return "".join(lines)


# ---- the config system ----

def load_yaml(path: str) -> Dict[str, Any]:
    with open(path) as f:
        return loads(f.read()) or {}


def deep_update(base: Dict, override: Dict) -> Dict:
    """Recursively merge ``override`` into ``base`` (override wins)."""
    for k, v in override.items():
        if isinstance(v, dict) and isinstance(base.get(k), dict):
            deep_update(base[k], v)
        else:
            base[k] = v
    return base


def parse_overrides(args: Sequence[str]) -> Dict[str, Any]:
    """Parse ``--a.b.c=value`` CLI args into a nested dict; values are
    read as YAML documents (so ``true``, ``3``, ``[1,2]`` work)."""
    out: Dict[str, Any] = {}
    for arg in args:
        if not arg.startswith("--") or "=" not in arg:
            raise ValueError(f"Expected --dotted.key=value, got {arg!r}")
        key, _, raw = arg[2:].partition("=")
        value = loads(raw)
        node = out
        parts = key.split(".")
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = value
    return out


def load_config(
    config_paths: Sequence[str], overrides: Sequence[str] = ()
) -> Dict[str, Any]:
    """Merge config files left-to-right, then CLI overrides on top."""
    cfg: Dict[str, Any] = {}
    for path in config_paths:
        deep_update(cfg, load_yaml(path))
    deep_update(cfg, parse_overrides(overrides))
    return cfg


def port_class_path(path: str) -> str:
    """A class path of the JAX package rewritten to the port's module of
    the same name (as a string: the JAX package is never imported). Any
    other path is returned as written."""
    if not path.startswith(JAX_PACKAGE):
        return path
    return PORT_PACKAGE + path[len(JAX_PACKAGE):]


def _import_class(path: str):
    module, _, name = port_class_path(path).rpartition(".")
    return getattr(importlib.import_module(module), name)


def instantiate(node: Any, **extra: Any) -> Any:
    """Recursively build objects from ``class_path``/``init_args`` nodes
    (jsonargparse semantics, config/config.yaml:4-20); ``extra`` adds
    keyword arguments to the top node's class."""
    if isinstance(node, dict):
        if "class_path" in node:
            cls = _import_class(node["class_path"])
            kwargs = {
                k: instantiate(v)
                for k, v in (node.get("init_args") or {}).items()
            }
            return cls(**kwargs, **extra)
        return {k: instantiate(v) for k, v in node.items()}
    if isinstance(node, list):
        return [instantiate(v) for v in node]
    return node


def save_config_snapshot(cfg: Dict[str, Any], out_dir: str) -> str:
    os.makedirs(out_dir, exist_ok=True)
    path = os.path.join(out_dir, "config.yaml")
    with open(path, "w") as f:
        f.write(dumps(copy.deepcopy(cfg)))
    return path
