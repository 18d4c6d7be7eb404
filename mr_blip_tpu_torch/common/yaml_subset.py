"""A reader for the YAML subset of the repo's ``configs/``, without pyyaml.

The machines the port runs on need not have pyyaml, so ``load_yaml`` reads
the files itself. The subset is what every file under ``configs/`` uses:

* block mappings, nested by indentation (spaces only), one ``key: value``
  or ``key:`` a line, plain keys;
* flow lists ``[a, "b", 3]`` (nestable) on one line;
* ``#`` comments (at a line's start or after whitespace, outside quotes);
* single- and double-quoted scalars on one line, and plain scalars.

Plain scalars resolve as pyyaml's ``SafeLoader`` with the JAX package's
extra float resolver (``mr_blip_tpu/common/config.py::_Yaml12Loader``)
resolves them: ``null``/``Null``/``NULL``/``~``/nothing -> None,
``true``/``True``/``TRUE`` and the false forms -> bool, decimal integers
-> int, decimal floats with or without a dot or exponent (``3e-4``),
``.inf`` and ``.nan`` -> float, anything else -> str.

Everything else raises ``YamlSubsetError`` with the file and line: block
sequences, flow mappings, anchors, aliases, tags, multi-line and block
scalars, documents and directives, duplicate keys, and the scalar forms
YAML 1.1 reads otherwise than a reader of this subset would guess (yes/no/
on/off, octal, hex, binary, sexagesimal, dates, ``=``, ``<<``).
"""

from __future__ import annotations

import re
from typing import Any, List, Tuple


class YamlSubsetError(ValueError):
    pass


_INT = re.compile(r"^[-+]?(?:0|[1-9][0-9_]*)$")
# pyyaml's YAML 1.1 float resolver, then the JAX package's full-exponent one.
_FLOAT = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_FLOAT12 = re.compile(
    r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+]?[0-9]+)?
    |[-+]?(?:[0-9][0-9_]*)(?:[eE][-+]?[0-9]+)
    |\.[0-9_]+(?:[eE][-+][0-9]+)?
    |[-+]?\.(?:inf|Inf|INF)
    |\.(?:nan|NaN|NAN))$""", re.X)
_NULLS = {"", "~", "null", "Null", "NULL"}
_TRUE = {"true", "True", "TRUE"}
_FALSE = {"false", "False", "FALSE"}
# Resolved otherwise by YAML 1.1 than by 1.2: refused rather than guessed.
_AMBIGUOUS_WORDS = {"yes", "Yes", "YES", "no", "No", "NO", "on", "On", "ON",
                    "off", "Off", "OFF", "y", "Y", "n", "N", "=", "<<"}
_AMBIGUOUS = re.compile(
    r"^(?:[-+]?0[0-9_]+|[-+]?0[bBxXoO].*|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+(?:\.[0-9_]*)?"
    r"|[0-9]{4}-[0-9]{1,2}-[0-9]{1,2}.*)$")
_FLOW_FORBIDDEN_START = set("&*!|>%@`{}'\"")


def _construct_float(text: str) -> float:
    value = text.replace("_", "").lower()
    sign = -1.0 if value.startswith("-") else 1.0
    if value[:1] in "+-":
        value = value[1:]
    if value == ".inf":
        return sign * float("inf")
    if value == ".nan":
        return float("nan")
    return sign * float(value)


def resolve_plain(text: str, where: str) -> Any:
    """The value of a plain (unquoted) scalar."""
    if text in _NULLS:
        return None
    if text in _TRUE:
        return True
    if text in _FALSE:
        return False
    if text in _AMBIGUOUS_WORDS or _AMBIGUOUS.match(text):
        raise YamlSubsetError(f"{where}: scalar {text!r} reads differently in "
                              "YAML 1.1 and 1.2; quote it")
    if _INT.match(text):
        return int(text.replace("_", ""))
    if _FLOAT.match(text) or _FLOAT12.match(text):
        return _construct_float(text)
    if text[0] in _FLOW_FORBIDDEN_START or text[0] in "[]," or text.startswith(
            ("- ", "? ", ": ")) or text in ("-", "?", ":"):
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML subset")
    if ": " in text or text.endswith(":") or " #" in text:
        raise YamlSubsetError(f"{where}: {text!r} is outside the YAML subset")
    return text


def _quoted(text: str, start: int, where: str) -> Tuple[str, int]:
    """The quoted scalar starting at ``text[start]`` and the index past it."""
    quote = text[start]
    out: List[str] = []
    i = start + 1
    while i < len(text):
        c = text[i]
        if quote == "'":
            if c == "'":
                if text[i + 1:i + 2] == "'":
                    out.append("'")
                    i += 2
                    continue
                return "".join(out), i + 1
            out.append(c)
        else:
            if c == '"':
                return "".join(out), i + 1
            if c == "\\":
                esc = text[i + 1:i + 2]
                table = {'"': '"', "\\": "\\", "/": "/", "n": "\n", "t": "\t",
                         "0": "\0", " ": " "}
                if esc not in table:
                    raise YamlSubsetError(f"{where}: escape \\{esc} is outside "
                                          "the YAML subset")
                out.append(table[esc])
                i += 2
                continue
            out.append(c)
        i += 1
    raise YamlSubsetError(f"{where}: quoted scalar does not end on its line")


def _strip_comment(line: str, where: str) -> str:
    """The line without its comment (a ``#`` at the start or after
    whitespace, outside quotes)."""
    i = 0
    while i < len(line):
        c = line[i]
        if c in "'\"" and (i == 0 or line[i - 1] in " \t[,:"):
            _, i = _quoted(line, i, where)
            continue
        if c == "#" and (i == 0 or line[i - 1] in " \t"):
            return line[:i].rstrip()
        i += 1
    return line.rstrip()


def _flow_list(text: str, start: int, where: str) -> Tuple[list, int]:
    """The flow list opening at ``text[start]`` and the index past it."""
    items: list = []
    i = start + 1
    expect_item = True
    while True:
        while i < len(text) and text[i] == " ":
            i += 1
        if i >= len(text):
            raise YamlSubsetError(f"{where}: flow list does not end on its line")
        c = text[i]
        if c == "]":
            if expect_item and items:
                raise YamlSubsetError(f"{where}: trailing comma in a flow list")
            return items, i + 1
        if not expect_item:
            if c != ",":
                raise YamlSubsetError(f"{where}: expected ',' or ']' in a flow list")
            i += 1
            expect_item = True
            continue
        if c == "[":
            item, i = _flow_list(text, i, where)
        elif c in "'\"":
            item, i = _quoted(text, i, where)
        elif c in "{,":
            raise YamlSubsetError(f"{where}: {c!r} in a flow list is outside the "
                                  "YAML subset")
        else:
            j = i
            while j < len(text) and text[j] not in ",[]{}":
                j += 1
            item = resolve_plain(text[i:j].strip(), where)
            i = j
        items.append(item)
        expect_item = False


def _value(text: str, where: str) -> Any:
    """The value after ``key:`` (not empty)."""
    if text[0] == "[":
        value, end = _flow_list(text, 0, where)
    elif text[0] in "'\"":
        value, end = _quoted(text, 0, where)
    else:
        return resolve_plain(text, where)
    if text[end:].strip():
        raise YamlSubsetError(f"{where}: {text[end:].strip()!r} after a value")
    return value


def loads(text: str, name: str = "<string>") -> Any:
    """The mapping of a document in the subset (None for an empty one)."""
    lines = []
    for number, raw in enumerate(text.splitlines(), 1):
        where = f"{name}:{number}"
        if "\t" in raw[:len(raw) - len(raw.lstrip(" \t"))]:
            raise YamlSubsetError(f"{where}: tab in the indentation")
        line = _strip_comment(raw, where)
        if not line.strip():
            continue
        indent = len(line) - len(line.lstrip(" "))
        body = line.strip()
        if body in ("---", "...") or body.startswith(("%", "--- ")):
            raise YamlSubsetError(f"{where}: documents and directives are outside "
                                  "the YAML subset")
        if body == "-" or body.startswith("- "):
            raise YamlSubsetError(f"{where}: block sequences are outside the YAML "
                                  "subset")
        lines.append((indent, body, where))
    if not lines:
        return None
    root: dict = {}
    # Open mappings: (indent of their keys, mapping); None = not yet known.
    stack: List[list] = [[lines[0][0], root]]
    if lines[0][0] != 0:
        raise YamlSubsetError(f"{lines[0][2]}: the document does not start at "
                              "column 0")
    pending = None  # (mapping, key) of a "key:" that may open a mapping
    for indent, body, where in lines:
        if pending is not None:
            parent, key = pending
            pending = None
            if indent > stack[-1][0]:
                child: dict = {}
                parent[key] = child
                stack.append([indent, child])
        while indent < stack[-1][0]:
            stack.pop()
        if indent != stack[-1][0]:
            raise YamlSubsetError(f"{where}: indentation matches no open mapping "
                                  "(a multi-line scalar?)")
        mapping = stack[-1][1]
        m = re.match(r"^([^'\"\[\]{},#&*!|>%@`][^:]*?)\s*:(?:\s+(.*))?$", body)
        if m is None:
            raise YamlSubsetError(f"{where}: {body!r} is not a 'key: value' line "
                                  "of the YAML subset")
        key = resolve_plain(m.group(1), where)
        if not isinstance(key, str):
            raise YamlSubsetError(f"{where}: key {m.group(1)!r} is not a string")
        if key in mapping:
            raise YamlSubsetError(f"{where}: duplicate key {key!r}")
        rest = m.group(2)
        if rest is None:
            mapping[key] = None
            pending = (mapping, key)
        else:
            mapping[key] = _value(rest, where)
    return root


def load(path: str) -> Any:
    with open(path, "r") as f:
        return loads(f.read(), name=str(path))
