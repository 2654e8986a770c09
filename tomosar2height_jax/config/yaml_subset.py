"""Loader and dumper for the YAML subset the repo's own files use.

Covers ``conf/**/*.yaml``, CLI override values and ``chunk_info.yaml``:
block mappings and sequences (``- item``, ``- key: value``), flow lists and
mappings (``[a, 'b', [1, 2]]``, ``{a: 1}``), plain / single- / double-quoted
scalars, and comments. Plain scalars resolve as PyYAML's ``safe_load`` does
(YAML 1.1: ``yes``/``on`` are booleans, ``1e-4`` without a dot is a string),
except that dates stay strings.
``${...}`` is left as text for :func:`config.compose.compose`. Anchors,
aliases, tags, block scalars (``|``, ``>``) and multi-document streams raise
ValueError.
"""

from __future__ import annotations

import math
import re
from typing import Any, List, Tuple

_BOOL = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                   r"|on|On|ON|off|Off|OFF)$")
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
_ESCAPES = {"0": "\0", "a": "\a", "b": "\b", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\v", "f": "\f", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "/": "/", "\\": "\\", "N": "\x85", "_": "\xa0"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}


def _sexagesimal(text: str, cast):
    value = 0
    for part in text.split(":"):
        value = value * 60 + cast(part)
    return value


def resolve_plain(text: str) -> Any:
    """A plain (unquoted) scalar's value under YAML 1.1 implicit typing."""
    if _NULL.match(text):
        return None
    if _BOOL.match(text):
        return text.lower() in ("yes", "true", "on")
    if _FLOAT.match(text):
        v = text.replace("_", "").lower()
        sign = -1.0 if v[0] == "-" else 1.0
        v = v.lstrip("+-")
        if v == ".inf":
            return sign * math.inf
        if v == ".nan":
            return math.nan
        return sign * (_sexagesimal(v, float) if ":" in v else float(v))
    if _INT.match(text):
        v = text.replace("_", "")
        sign = -1 if v[0] == "-" else 1
        v = v.lstrip("+-")
        if v == "0":
            return 0
        if v.startswith("0b"):
            return sign * int(v[2:], 2)
        if v.startswith("0x"):
            return sign * int(v[2:], 16)
        if v[0] == "0":
            return sign * int(v, 8)
        return sign * (_sexagesimal(v, int) if ":" in v else int(v))
    return text


def _quoted(s: str, pos: int) -> Tuple[str, int]:
    """Parse the quoted scalar starting at s[pos]; return (value, end)."""
    quote = s[pos]
    out = []
    i = pos + 1
    while i < len(s):
        c = s[i]
        if quote == "'" and c == "'":
            if s[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), i + 1
        if quote == '"' and c == '"':
            return "".join(out), i + 1
        if quote == '"' and c == "\\":
            e = s[i + 1:i + 2]
            if e in _ESCAPES:
                out.append(_ESCAPES[e])
                i += 2
            elif e in _HEX_ESCAPES:
                n = _HEX_ESCAPES[e]
                out.append(chr(int(s[i + 2:i + 2 + n], 16)))
                i += 2 + n
            else:
                raise ValueError(f"unknown escape \\{e} in {s!r}")
            continue
        out.append(c)
        i += 1
    raise ValueError(f"unterminated quoted scalar in {s!r}")


def _skip_ws(s: str, pos: int) -> int:
    while pos < len(s) and s[pos] == " ":
        pos += 1
    return pos


def _flow(s: str, pos: int, stops: str) -> Tuple[Any, int]:
    """Parse one flow node at s[pos]; a plain scalar ends before ``stops``."""
    pos = _skip_ws(s, pos)
    if pos >= len(s):
        return None, pos
    c = s[pos]
    if c in "'\"":
        return _quoted(s, pos)
    if c in "[{":
        close = "]" if c == "[" else "}"
        out: Any = [] if c == "[" else {}
        pos = _skip_ws(s, pos + 1)
        while True:
            if pos >= len(s):
                raise ValueError(f"unterminated flow collection in {s!r}")
            if s[pos] == close:
                return out, pos + 1
            if c == "[":
                item, pos = _flow(s, pos, ",]")
                out.append(item)
            else:
                key, pos = _flow(s, pos, ":,}")
                pos = _skip_ws(s, pos)
                value = None
                if pos < len(s) and s[pos] == ":":
                    value, pos = _flow(s, pos + 1, ",}")
                out[key] = value
            pos = _skip_ws(s, pos)
            if pos < len(s) and s[pos] == ",":
                pos = _skip_ws(s, pos + 1)
            elif pos < len(s) and s[pos] != close:
                raise ValueError(f"expected ',' or {close!r} at {s[pos:]!r}")
    if c in "&*!|>%@`":
        raise ValueError(f"unsupported YAML syntax {c!r} in {s!r}")
    end = pos
    while end < len(s) and s[end] not in stops:
        end += 1
    return resolve_plain(s[pos:end].rstrip()), end


def _value(text: str) -> Any:
    """A whole-line value: flow collection, quoted or plain scalar."""
    if text[0] in "[{'\"":
        value, end = _flow(text, 0, "")
        if text[end:].strip():
            raise ValueError(f"trailing text after value: {text!r}")
        return value
    if text[0] in "&*!|>%@`":
        raise ValueError(f"unsupported YAML syntax {text[0]!r} in {text!r}")
    return resolve_plain(text)


def _strip_comment(line: str) -> str:
    quote = None
    for i, c in enumerate(line):
        if quote:
            if c == quote:
                quote = None
        elif c in "'\"" and (i == 0 or line[i - 1] in " [{,:-"):
            quote = c
        elif c == "#" and (i == 0 or line[i - 1] == " "):
            return line[:i].rstrip()
    return line.rstrip()


def _lines(text: str) -> List[List]:
    out = []
    for raw in text.splitlines():
        if raw.strip() in ("---", "...") and not raw.startswith(" "):
            raise ValueError("multi-document YAML is not supported")
        line = _strip_comment(raw)
        if not line.strip():
            continue
        body = line.lstrip(" ")
        if body.startswith("\t"):
            raise ValueError(f"tab indentation in {raw!r}")
        out.append([len(line) - len(body), body])
    return out


def _split_key(text: str):
    """('key', 'rest') for a ``key: rest`` line, else None."""
    if text[0] in "[{":
        return None
    if text[0] in "'\"":
        key, end = _quoted(text, 0)
        rest = text[end:]
        if rest.startswith(":") and (len(rest) == 1 or rest[1] == " "):
            return key, rest[1:].strip()
        return None
    for m in re.finditer(":", text):
        i = m.start()
        if i + 1 == len(text) or text[i + 1] == " ":
            return resolve_plain(text[:i].rstrip()), text[i + 1:].strip()
    return None


def _is_item(text: str) -> bool:
    return text == "-" or text.startswith("- ")


def _block(lines, i: int, indent: int) -> Tuple[Any, int]:
    text = lines[i][1]
    if _is_item(text):
        return _sequence(lines, i, indent)
    if _split_key(text) is not None:
        return _mapping(lines, i, indent)
    if i + 1 < len(lines) and lines[i + 1][0] > indent:
        raise ValueError(f"multi-line plain scalars are not supported: {text!r}")
    return _value(text), i + 1


def _mapping(lines, i: int, indent: int) -> Tuple[dict, int]:
    out: dict = {}
    while i < len(lines) and lines[i][0] == indent:
        kv = _split_key(lines[i][1])
        if kv is None:
            raise ValueError(f"expected 'key: value', got {lines[i][1]!r}")
        key, rest = kv
        i += 1
        if rest:
            out[key] = _value(rest)
        elif i < len(lines) and (lines[i][0] > indent
                                 or (lines[i][0] == indent and _is_item(lines[i][1]))):
            out[key], i = _block(lines, i, lines[i][0])
        else:
            out[key] = None
    if i < len(lines) and lines[i][0] > indent:
        raise ValueError(f"bad indentation at {lines[i][1]!r}")
    return out, i


def _sequence(lines, i: int, indent: int) -> Tuple[list, int]:
    out = []
    while i < len(lines) and lines[i][0] == indent and _is_item(lines[i][1]):
        content = lines[i][1][1:].lstrip(" ")
        if content:
            # re-read the item's content as a block starting at its column
            lines[i] = [indent + len(lines[i][1]) - len(content), content]
            item, i = _block(lines, i, lines[i][0])
        elif i + 1 < len(lines) and lines[i + 1][0] > indent:
            item, i = _block(lines, i + 1, lines[i + 1][0])
        else:
            item, i = None, i + 1
        out.append(item)
    return out, i


def load(text: str) -> Any:
    """Parse a YAML document of the supported subset (None when empty)."""
    lines = _lines(text)
    if not lines:
        return None
    value, i = _block(lines, 0, lines[0][0])
    if i != len(lines):
        raise ValueError(f"unexpected line {lines[i][1]!r}")
    return value


def load_file(path: str) -> Any:
    with open(path) as f:
        return load(f.read())


def _dump_scalar(v) -> str:
    if v is None:
        return "null"
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, int):
        return str(v)
    if isinstance(v, float):
        if math.isnan(v):
            return ".nan"
        if math.isinf(v):
            return ".inf" if v > 0 else "-.inf"
        s = repr(v).lower()
        if "." not in s and "e" in s:
            s = s.replace("e", ".0e", 1)
        return s
    if isinstance(v, str):
        if (re.fullmatch(r"[A-Za-z0-9_./][A-Za-z0-9_./-]*", v)
                and resolve_plain(v) == v):
            return v
        return "'" + v.replace("'", "''") + "'"
    raise TypeError(f"cannot dump {type(v).__name__}")


def _is_scalar(v) -> bool:
    return not isinstance(v, (dict, list, tuple))


def _dump(node, indent: int, out: List[str]) -> None:
    pad = " " * indent
    for key in sorted(node):
        v = node[key]
        head = f"{pad}{_dump_scalar(key)}:"
        if isinstance(v, dict) and v:
            out.append(head)
            _dump(v, indent + 2, out)
        elif isinstance(v, (list, tuple)) and not all(_is_scalar(x) for x in v):
            raise TypeError("only lists of scalars can be dumped")
        elif isinstance(v, (list, tuple)):
            out.append(f"{head} [{', '.join(_dump_scalar(x) for x in v)}]")
        elif isinstance(v, dict):
            out.append(f"{head} {{}}")
        else:
            out.append(f"{head} {_dump_scalar(v)}")


def dump(data: dict) -> str:
    """Block-style text for a mapping of mappings / scalar lists / scalars,
    keys sorted (what ``chunk_info.yaml`` holds); :func:`load` reads it back
    to an equal value, and so does PyYAML."""
    out: List[str] = []
    _dump(data, 0, out)
    return "\n".join(out) + "\n"
