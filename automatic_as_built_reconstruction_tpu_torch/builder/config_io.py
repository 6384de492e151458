"""Config file IO: a reader for the protobuf *text* format -> nested dicts.

The port runs where protobuf is not installed, so it cannot parse configs
through the JAX package's ``*_pb2.py`` modules.  This reader takes the
subset of the text format the repo's ``.config`` files use:

- ``name { ... }`` and ``name: { ... }`` (also ``< ... >``) nested messages;
- ``name: value`` scalars: integers, floats (``1e-3``, ``inf``, ``nan``),
  quoted strings with backslash escapes, ``true``/``false`` and bare
  enum identifiers (returned as ``str``);
- ``name: [v1, v2, ...]`` lists, and repeated keys;
- ``#`` comments, and ``,`` / ``;`` field separators.

A key seen once maps to its value; a repeated key or a ``[..]`` list maps
to a ``list``.  Use :func:`as_list` where a field is ``repeated`` in the
schema.  Floats come back as Python floats of the literal; proto ``float``
fields hold them in single precision, which :func:`f32` reproduces.
:func:`to_text` writes such a dict back as text that this reader (and
protobuf's) reads to the same values.
"""
from __future__ import annotations

import re
from pathlib import Path
from typing import Any, Dict, List

import numpy as np

_TOKEN = re.compile(r"""
    (?P<ws>\s+|\#[^\n]*)
  | (?P<str>"(?:[^"\\\n]|\\.)*"|'(?:[^'\\\n]|\\.)*')
  | (?P<num>[-+]?(?:\d+\.\d*|\.\d+|\d+)(?:[eE][-+]?\d+)?[fF]?
            |[-+]?(?:inf|infinity|nan)\b)
  | (?P<ident>[A-Za-z_][A-Za-z0-9_.]*)
  | (?P<punct>[{}<>\[\]:,;])
""", re.VERBOSE | re.IGNORECASE)

_ESCAPES = {"n": "\n", "t": "\t", "r": "\r", "\\": "\\", "'": "'",
            '"': '"', "0": "\0"}


class ConfigSyntaxError(ValueError):
    pass


def _tokenize(text: str) -> List[tuple]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if m is None:
            line = text.count("\n", 0, pos) + 1
            raise ConfigSyntaxError(
                f"line {line}: unexpected character {text[pos]!r}")
        kind = m.lastgroup
        if kind != "ws":
            toks.append((kind, m.group(kind), text.count("\n", 0, pos) + 1))
        pos = m.end()
    return toks


def _unquote(s: str) -> str:
    body, out, i = s[1:-1], [], 0
    while i < len(body):
        ch = body[i]
        if ch == "\\" and i + 1 < len(body):
            out.append(_ESCAPES.get(body[i + 1], body[i + 1]))
            i += 2
        else:
            out.append(ch)
            i += 1
    return "".join(out)


def _number(s: str):
    t = s.rstrip("fF") if not s.lower().endswith(("inf", "infinity")) else s
    if re.fullmatch(r"[-+]?\d+", t):
        return int(t)
    return float(t)


class _Parser:
    def __init__(self, toks):
        self.toks = toks
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else None

    def take(self, value=None):
        tok = self.peek()
        if tok is None:
            raise ConfigSyntaxError("unexpected end of input")
        if value is not None and tok[1] != value:
            raise ConfigSyntaxError(
                f"line {tok[2]}: expected {value!r}, got {tok[1]!r}")
        self.i += 1
        return tok

    def message(self, close=None) -> Dict[str, Any]:
        out: Dict[str, Any] = {}
        while True:
            tok = self.peek()
            if tok is None:
                if close is not None:
                    raise ConfigSyntaxError(f"missing {close!r}")
                return out
            if close is not None and tok[1] == close:
                self.take()
                return out
            kind, name, line = self.take()
            if kind != "ident":
                raise ConfigSyntaxError(
                    f"line {line}: expected a field name, got {name!r}")
            colon = self.peek() is not None and self.peek()[1] == ":"
            if colon:
                self.take(":")
            nxt = self.peek()
            if nxt is None:
                raise ConfigSyntaxError(f"line {line}: {name} has no value")
            if nxt[1] in ("{", "<"):
                self.take()
                value = self.message("}" if nxt[1] == "{" else ">")
                _add(out, name, value)
            elif nxt[1] == "[":
                if not colon:
                    raise ConfigSyntaxError(
                        f"line {line}: {name} needs ':' before a list")
                self.take("[")
                values = []
                while self.peek() is not None and self.peek()[1] != "]":
                    if self.peek()[1] in ("{", "<"):
                        b = self.take()[1]
                        values.append(self.message("}" if b == "{" else ">"))
                    else:
                        values.append(self.scalar())
                    if self.peek() is not None and self.peek()[1] == ",":
                        self.take(",")
                self.take("]")
                _extend(out, name, values)
            else:
                if not colon:
                    raise ConfigSyntaxError(
                        f"line {line}: {name} needs ':' before a scalar")
                _add(out, name, self.scalar())
            if self.peek() is not None and self.peek()[1] in (",", ";"):
                self.take()

    def scalar(self):
        kind, text, line = self.take()
        if kind == "num":
            return _number(text)
        if kind == "str":
            # adjacent string literals concatenate, as in protobuf
            s = _unquote(text)
            while self.peek() is not None and self.peek()[0] == "str":
                s += _unquote(self.take()[1])
            return s
        if kind == "ident":
            low = text.lower()
            if low in ("true", "t"):
                return True
            if low in ("false", "f"):
                return False
            return text
        raise ConfigSyntaxError(f"line {line}: unexpected {text!r}")


def _add(out: Dict[str, Any], name: str, value) -> None:
    if name not in out:
        out[name] = value
    elif isinstance(out[name], list):
        out[name].append(value)
    else:
        out[name] = [out[name], value]


def _extend(out: Dict[str, Any], name: str, values: list) -> None:
    if name not in out:
        out[name] = list(values)
    else:
        out[name] = as_list(out[name]) + list(values)


def parse_text(text: str) -> Dict[str, Any]:
    """Protobuf text format -> nested dicts (see module docstring)."""
    return _Parser(_tokenize(text)).message()


def load_config(path) -> Dict[str, Any]:
    """Read a ``.config`` file (TrainEvalPipelineConfig text format)."""
    return parse_text(Path(path).read_text())


def as_list(value) -> list:
    """A repeated field's value as a list (absent -> ``[]``)."""
    if value is None:
        return []
    return list(value) if isinstance(value, list) else [value]


def f32(value) -> float:
    """A proto ``float`` field's value: the literal rounded to fp32."""
    return float(np.float32(value))


# the schema's one enum (second.proto LossNormType): its values are
# written bare, every other string quoted
ENUM_VALUES = frozenset(("NormByNumPositives", "NormByNumExamples",
                         "NormByNumPosNeg", "DontNorm"))


def _scalar_text(value) -> str:
    if isinstance(value, bool):
        return "true" if value else "false"
    if isinstance(value, (int, float)):
        return repr(value)
    if isinstance(value, str):
        if value in ENUM_VALUES:
            return value
        return '"' + (value.replace("\\", "\\\\").replace('"', '\\"')
                      .replace("\n", "\\n")) + '"'
    raise TypeError(f"no text form for {type(value).__name__}")


def to_text(config: Dict[str, Any], indent: int = 0) -> str:
    """Nested dicts -> protobuf text format: ``parse_text(to_text(d)) ==
    d`` for every dict :func:`parse_text` gives."""
    pad = "  " * indent
    lines = []
    for name, value in config.items():
        if isinstance(value, dict):
            lines.append(f"{pad}{name} {{")
            lines.append(to_text(value, indent + 1))
            lines.append(f"{pad}}}")
        elif isinstance(value, list) and any(isinstance(v, dict)
                                             for v in value):
            lines.append(f"{pad}{name}: [")
            for i, v in enumerate(value):
                lines.append(f"{pad}  {{")
                lines.append(to_text(v, indent + 2))
                lines.append(f"{pad}  }}" + ("," if i + 1 < len(value)
                                             else ""))
            lines.append(f"{pad}]")
        elif isinstance(value, list):
            lines.append(f"{pad}{name}: ["
                         + ", ".join(map(_scalar_text, value)) + "]")
        else:
            lines.append(f"{pad}{name}: {_scalar_text(value)}")
    return "\n".join(line for line in lines if line)
