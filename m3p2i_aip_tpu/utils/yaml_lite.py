"""Reader for the YAML subset the shipped configs use.

Supported: ``key: value`` mappings (top level, or nested under a key by
indentation), block lists of scalars or one-key mappings (the hydra
``defaults:`` list), flow lists ``[...]`` that may span lines and nest,
plain/quoted scalars (ints, floats, ``True``/``False``/``null``, strings)
and ``#`` comments.  Anything outside that subset raises ``ValueError``.
"""
from __future__ import annotations

import re

_INT = re.compile(r"^[-+]?[0-9]+$")
_FLOAT = re.compile(r"^[-+]?(\.[0-9]+|[0-9]+\.[0-9]*|[0-9]+)([eE][-+]?[0-9]+)?$")
_BOOLS = {"true": True, "false": False}
_NULLS = {"null", "~", ""}


def _strip_comment(line: str) -> str:
    quote = None
    for i, ch in enumerate(line):
        if quote:
            if ch == quote:
                quote = None
        elif ch in "\"'":
            quote = ch
        elif ch == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
    return line.rstrip()


def scalar(text: str):
    """One plain or quoted scalar, resolved like YAML's core schema."""
    text = text.strip()
    if len(text) >= 2 and text[0] == text[-1] and text[0] in "\"'":
        return text[1:-1]
    low = text.lower()
    if low in _BOOLS:
        return _BOOLS[low]
    if low in _NULLS:
        return None
    if _INT.match(text):
        return int(text)
    if _FLOAT.match(text):
        return float(text)
    return text


def _flow(text: str, i: int):
    """Parse a flow list starting at ``text[i] == '['``; returns (list, end)."""
    out, i = [], i + 1
    while True:
        while i < len(text) and text[i] in " \t\n,":
            i += 1
        if i >= len(text):
            raise ValueError("unterminated flow list")
        if text[i] == "]":
            return out, i + 1
        if text[i] == "[":
            item, i = _flow(text, i)
            out.append(item)
            continue
        j = i
        if text[i] in "\"'":
            j = text.index(text[i], i + 1) + 1
        while j < len(text) and text[j] not in ",]":
            j += 1
        out.append(scalar(text[i:j]))
        i = j


def _value(text: str):
    if text.startswith("["):
        value, end = _flow(text, 0)
        if text[end:].strip():
            raise ValueError(f"trailing text after flow list: {text!r}")
        return value
    if text.startswith("{"):
        raise ValueError("flow mappings are outside the supported subset")
    return scalar(text)


def _logical_lines(src: str):
    """(indent, text) per logical line; a flow list is joined until its
    brackets balance."""
    pending, indent = None, 0
    for raw in src.splitlines():
        line = _strip_comment(raw)
        if pending is not None:
            pending += "\n" + line
        elif not line.strip():
            continue
        else:
            indent = len(line) - len(line.lstrip(" "))
            pending = line.strip()
        if pending.count("[") == pending.count("]"):
            yield indent, pending
            pending = None
    if pending is not None:
        raise ValueError("unterminated flow list at end of document")


def _block(lines, pos: int, indent: int):
    """Parse the block (mapping or list) whose lines sit at ``indent``."""
    if lines[pos][1].startswith("- ") or lines[pos][1] == "-":
        out = []
        while pos < len(lines) and lines[pos][0] == indent:
            text = lines[pos][1]
            if not (text.startswith("- ") or text == "-"):
                raise ValueError(f"mixed block list: {text!r}")
            item = text[1:].strip()
            key, sep, rest = item.partition(":")
            if sep and not item.startswith(("[", '"', "'")):
                out.append({scalar(key): _value(rest.strip())})
            else:
                out.append(_value(item))
            pos += 1
        return out, pos
    out = {}
    while pos < len(lines) and lines[pos][0] == indent:
        key, sep, rest = lines[pos][1].partition(":")
        if not sep:
            raise ValueError(f"expected 'key: value', got {lines[pos][1]!r}")
        key, rest = scalar(key), rest.strip()
        pos += 1
        if rest:
            out[key] = _value(rest)
        elif pos < len(lines) and lines[pos][0] > indent:
            out[key], pos = _block(lines, pos, lines[pos][0])
        elif pos < len(lines) and lines[pos][0] == indent and lines[pos][1].startswith("-"):
            out[key], pos = _block(lines, pos, indent)
        else:
            out[key] = None
    return out, pos


def loads(src: str):
    """Parse a document; an empty document gives ``None`` like PyYAML."""
    lines = list(_logical_lines(src))
    if not lines:
        return None
    value, pos = _block(lines, 0, lines[0][0])
    if pos != len(lines):
        raise ValueError(f"unexpected indentation at {lines[pos][1]!r}")
    return value


def load(path):
    with open(path) as f:
        return loads(f.read())
