"""The part of YAML that the repo's config files and ``--opts`` use, read
and written without ``yaml``.

:func:`loads` reads:

  - block maps by indentation (``KEY: value``, or ``KEY:`` with an
    indented block below);
  - flow lists and maps (``[2, 2, 6, 2]``, ``['_base.yaml']``,
    ``{semseg: [2.0]}``), nested;
  - scalars, plain or quoted, resolved as ``yaml.safe_load`` resolves them
    (YAML 1.1): ``yes``/``no``/``on``/``off``/``true``/``false`` in their
    three spellings are booleans; ``~``, ``null`` and nothing are None;
    an int is decimal or ``0x``; a float needs a dot, and an exponent
    needs its sign (``1e-4`` and ``1.0e4`` stay strings, ``1.0e-4`` and
    ``.5`` are floats);
  - ``#`` comments, and empty documents (None).

Everything else is refused with a ``ValueError`` naming the line: block
lists, anchors, tags, multi-line scalars, several documents, the
double-quote escapes that JSON lacks, and YAML 1.1's other numbers
(octal, binary, sexagesimal, ``_`` separators, ``.inf``, ``.nan``).

:func:`dumps` writes nested dicts, lists, tuples (read back as lists) and
scalars as block maps with flow lists, in a form that :func:`loads` reads
back equal: strings plain where they read back as themselves and
double-quoted otherwise, floats always with a dot.
"""

from __future__ import annotations

import json
import math
import re
from typing import Any, List, Tuple

# yaml.resolver.Resolver's implicit resolvers of YAML 1.1 (PyYAML 6)
_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                   r"|FALSE|on|On|ON|off|Off|OFF)$")
_TRUE = {"yes", "true", "on"}
_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
# the numbers read; _YAML11_NUMBER is every int and float of PyYAML's
# resolvers, so that the forms not read are refused, not taken as strings
_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9]*|0x[0-9a-fA-F]+)$")
_FLOAT = re.compile(r"^(?:[-+]?[0-9]+\.[0-9]*|\.[0-9]+)(?:[eE][-+][0-9]+)?$")
_YAML11_NUMBER = re.compile(
    r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
    r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+"
    r"|[-+]?[0-9][0-9_]*\.[0-9_]*(?:[eE][-+][0-9]+)?"
    r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
    r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
    r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$")
# strings written without quotes: these read back as themselves where
# ``resolve`` leaves them strings
_PLAIN = re.compile(r"^[A-Za-z_][A-Za-z0-9_.\-/]*$")


class _Error(ValueError):
    pass


def resolve(text: str) -> Any:
    """A plain (unquoted) scalar as ``yaml.safe_load`` gives it."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in _TRUE
    if _INT.match(text):
        return int(text, 0)
    if _FLOAT.match(text):
        return float(text)
    if _YAML11_NUMBER.match(text):
        raise _Error(f"the number {text!r} is in a form not read here")
    return text


def _strip_comment(line: str) -> str:
    """The line without its ``#`` comment (a ``#`` at the start or after
    a space, outside quotes)."""
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i]
    return line


class _Flow:
    """A recursive-descent reader of one flow value or scalar."""

    def __init__(self, text: str, where: str):
        self.s = text
        self.i = 0
        self.where = where

    def fail(self, what: str):
        raise _Error(f"{self.where}: {what} in {self.s!r}")

    def ws(self):
        while self.i < len(self.s) and self.s[self.i] in " \t":
            self.i += 1

    def value(self, stops: str) -> Any:
        self.ws()
        if self.i >= len(self.s):
            return None
        ch = self.s[self.i]
        if ch == "[":
            return self.seq()
        if ch == "{":
            return self.mapping()
        if ch in "'\"":
            return self.quoted()
        if ch in "&*!|>%@`" or self.s[self.i:self.i + 2] in ("-", "- "):
            self.fail(f"unsupported YAML construct {ch!r}")
        start = self.i
        while self.i < len(self.s) and self.s[self.i] not in stops:
            if self.s[self.i] == ":" and stops != "" and (
                    self.i + 1 == len(self.s) or self.s[self.i + 1] == " "):
                break
            self.i += 1
        try:
            return resolve(self.s[start:self.i].strip())
        except _Error as e:
            self.fail(str(e))

    def quoted(self) -> str:
        """A single-quoted scalar (``''`` is a quote), or a double-quoted
        one with JSON's escapes, which mean the same in YAML."""
        q = self.s[self.i]
        start = self.i
        self.i += 1
        out = []
        while self.i < len(self.s):
            ch = self.s[self.i]
            if q == "'" and ch == "'":
                if self.s[self.i + 1:self.i + 2] != "'":
                    self.i += 1
                    return "".join(out)
                self.i += 1
            elif q == '"' and ch == "\\":
                self.i += 2
                continue
            elif q == '"' and ch == '"':
                self.i += 1
                try:
                    return json.loads(self.s[start:self.i], strict=False)
                except ValueError:
                    self.fail("an escape JSON lacks")
            out.append(ch)
            self.i += 1
        self.fail("unterminated quoted scalar")

    def seq(self) -> list:
        self.i += 1
        out = []
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "]":
                self.i += 1
                return out
            out.append(self.value(",]"))
            self.ws()
            ch = self.s[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "]":
                self.fail("expected ',' or ']'")

    def mapping(self) -> dict:
        self.i += 1
        out = {}
        while True:
            self.ws()
            if self.s[self.i:self.i + 1] == "}":
                self.i += 1
                return out
            key = self.value(",}:")
            self.ws()
            if self.s[self.i:self.i + 1] == ":":
                self.i += 1
                val = self.value(",}")
            else:
                val = None
            out[key] = val
            self.ws()
            ch = self.s[self.i:self.i + 1]
            if ch == ",":
                self.i += 1
            elif ch != "}":
                self.fail("expected ',' or '}'")

    def whole(self) -> Any:
        v = self.value("")
        self.ws()
        if self.i != len(self.s):
            self.fail("trailing text")
        return v


def _scalar_or_flow(text: str, where: str) -> Any:
    return _Flow(text, where).whole()


def _split_key(text: str, where: str):
    """``KEY: rest`` -> (key, rest), or None when the line holds no map
    key (a ``:`` followed by a space or the end, outside quotes and
    brackets)."""
    quote, depth = None, 0
    for i, ch in enumerate(text):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "'\"" and (i == 0 or depth):
            quote = ch
        elif ch in "[{":
            depth += 1
        elif ch in "]}":
            depth -= 1
        elif ch == ":" and not depth and (i + 1 == len(text)
                                          or text[i + 1] == " "):
            key = _scalar_or_flow(text[:i].strip(), where)
            return key, text[i + 1:].strip()
    return None


def _lines(text: str) -> List[Tuple[int, int, str]]:
    out = []
    for n, raw in enumerate(text.splitlines(), 1):
        if "\t" in raw[:len(raw) - len(raw.lstrip())]:
            raise _Error(f"line {n}: tab in indentation")
        body = _strip_comment(raw).rstrip()
        if not body.strip():
            continue
        if body.strip() in ("---", "...") and not body.startswith(" "):
            if out:
                raise _Error(f"line {n}: more than one document")
            continue
        out.append((n, len(body) - len(body.lstrip()), body.strip()))
    return out


def _block(lines, pos: int, indent: int):
    """The block node starting at ``lines[pos]`` (indented ``indent``);
    returns (value, next position)."""
    n, ind, text = lines[pos]
    if _split_key(text, f"line {n}") is None:
        return _scalar_or_flow(text, f"line {n}"), pos + 1
    out = {}
    while pos < len(lines) and lines[pos][1] == indent:
        n, ind, text = lines[pos]
        kv = _split_key(text, f"line {n}")
        if kv is None:
            raise _Error(f"line {n}: expected 'KEY: value', got {text!r}")
        key, rest = kv
        if key in out:
            raise _Error(f"line {n}: duplicate key {key!r}")
        if rest:
            out[key], pos = _scalar_or_flow(rest, f"line {n}"), pos + 1
        elif pos + 1 < len(lines) and lines[pos + 1][1] > indent:
            out[key], pos = _block(lines, pos + 1, lines[pos + 1][1])
        else:
            out[key], pos = None, pos + 1
    if pos < len(lines) and lines[pos][1] > indent:
        n = lines[pos][0]
        raise _Error(f"line {n}: unexpected indentation")
    return out, pos


def loads(text: str) -> Any:
    """The value of a YAML document of the subset above (None for an
    empty one)."""
    lines = _lines(text)
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][1])
    if pos != len(lines):
        raise _Error(f"line {lines[pos][0]}: unexpected indentation")
    return value


def load(path: str) -> Any:
    with open(path, "r") as f:
        return loads(f.read())


def _scalar_text(v: Any) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if not math.isfinite(v):
            raise ValueError(f"cannot write {v!r}: the reader refuses it")
        text = repr(v)
        mant, e, exp = text.partition("e")
        if "." not in mant:
            mant += ".0"
        if e and exp[0] not in "+-":
            exp = "+" + exp
        return mant + (e + exp if e else "")
    if isinstance(v, str):
        return v if _PLAIN.match(v) and resolve(v) == v else json.dumps(v)
    raise TypeError(f"cannot write a {type(v).__name__} as YAML: {v!r}")


def _flow_text(v: Any) -> str:
    if isinstance(v, dict):
        return "{" + ", ".join(f"{_scalar_text(k)}: {_flow_text(x)}"
                               for k, x in v.items()) + "}"
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_flow_text(x) for x in v) + "]"
    return _scalar_text(v)


def dumps(value: Any, sort_keys: bool = True) -> str:
    """``value`` as YAML text that :func:`loads` reads back equal (tuples
    come back as lists): dicts as block maps, lists as flow lists."""
    if not isinstance(value, dict) or not value:
        return _flow_text(value) + "\n"
    out: List[str] = []

    def emit(d: dict, indent: int):
        items = sorted(d.items(), key=lambda kv: str(kv[0])) \
            if sort_keys else d.items()
        for k, v in items:
            key = _scalar_text(k)
            if isinstance(v, dict) and v:
                out.append(f"{' ' * indent}{key}:")
                emit(v, indent + 2)
            else:
                out.append(f"{' ' * indent}{key}: {_flow_text(v)}")

    emit(value, 0)
    return "\n".join(out) + "\n"
