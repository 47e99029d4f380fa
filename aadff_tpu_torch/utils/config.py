"""A reader for the YAML subset of the run configs (`configs/*.yml`), with
nothing but the stdlib: the port of `aadff_tpu/utils/config.py`, which needs
PyYAML.

The subset:
  * block maps nested by indentation (spaces only), `key: value` or `key:`
    opening a nested map (with nothing nested, the value is None);
  * comments, on their own line or after a value (`#` after a space);
  * plain, 'single-quoted' and "double-quoted" scalars;
  * flow sequences `[a, b]` of scalars, as lists, and with the tag
    `!!python/tuple` as tuples (`configs/aber_aware_dff_synth.yml:21`).
Plain scalars resolve as PyYAML's SafeLoader resolves them (YAML 1.1):
null, bool (yes/no/true/false/on/off), int (decimal, 0x, 0b, 0-octal,
sexagesimal), float (which needs a dot: `1e-4` stays the string "1e-4") and
otherwise str.  Anything else (block sequences, flow maps, anchors, other
tags, timestamps, multi-line scalars, documents) raises ValueError with the
line number.
"""
from __future__ import annotations

import re

_NULL = re.compile(r"^(?:~|null|Null|NULL|)$")
_BOOL = {"yes": True, "true": True, "on": True,
         "no": False, "false": False, "off": False}
_BOOL_FORMS = re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False"
                         r"|FALSE|on|On|ON|off|Off|OFF)$")
_INT = re.compile(r"""^(?:[-+]?0b[0-1_]+
                      |[-+]?0[0-7_]+
                      |[-+]?(?:0|[1-9][0-9_]*)
                      |[-+]?0x[0-9a-fA-F_]+
                      |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X)
_FLOAT = re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                        |\.[0-9_]+(?:[eE][-+][0-9]+)?
                        |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                        |[-+]?\.(?:inf|Inf|INF)
                        |\.(?:nan|NaN|NAN))$""", re.X)
_TIMESTAMP = re.compile(r"^[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?")
_TUPLE_TAG = "!!python/tuple"
_DQ_ESCAPES = {"\\": "\\", '"': '"', "/": "/", "n": "\n", "t": "\t", "r": "\r",
               "0": "\0", " ": " "}


class _Error(ValueError):
    def __init__(self, lineno: int, message: str):
        super().__init__(f"line {lineno}: {message}")


def _sexagesimal(value: str, conv):
    sign = -1 if value[0] == "-" else 1
    if value[0] in "+-":
        value = value[1:]
    total = 0
    for part in value.split(":"):
        total = total * 60 + conv(part)
    return sign * total


def _int(value: str) -> int:
    value = value.replace("_", "")
    sign = -1 if value[0] == "-" else 1
    body = value[1:] if value[0] in "+-" else value
    if ":" in body:
        return _sexagesimal(value, int)
    if body == "0":
        return 0
    if body.startswith("0b"):
        return sign * int(body[2:], 2)
    if body.startswith("0x"):
        return sign * int(body[2:], 16)
    if body.startswith("0"):
        return sign * int(body, 8)
    return sign * int(body)


def _float(value: str) -> float:
    value = value.replace("_", "").lower()
    sign = -1.0 if value[0] == "-" else 1.0
    body = value[1:] if value[0] in "+-" else value
    if body == ".inf":
        return sign * float("inf")
    if body == ".nan":
        return float("nan")
    if ":" in body:
        return _sexagesimal(value, float)
    return sign * float(body)


def _plain(value: str, lineno: int):
    """A plain scalar, resolved as SafeLoader resolves it."""
    if _NULL.match(value):
        return None
    if _BOOL_FORMS.match(value):
        return _BOOL[value.lower()]
    if _INT.match(value):
        return _int(value)
    if _FLOAT.match(value):
        return _float(value)
    if _TIMESTAMP.match(value):
        raise _Error(lineno, f"timestamps are outside the subset: {value!r}")
    if (value[0] in "&*!|>%@`{}[],#'\""
            or (value[0] in "-?:" and (len(value) == 1 or value[1] == " "))):
        raise _Error(lineno, f"unsupported YAML syntax: {value!r}")
    if ": " in value or value.endswith(":"):
        raise _Error(lineno, f"a mapping in a plain scalar: {value!r}")
    return value


def _quoted(text: str, lineno: int) -> tuple[str, str]:
    """(the string of the quoted scalar that starts `text`, the rest)."""
    quote, out, i = text[0], [], 1
    while i < len(text):
        ch = text[i]
        if quote == "'" and ch == "'":
            if text[i + 1:i + 2] == "'":
                out.append("'")
                i += 2
                continue
            return "".join(out), text[i + 1:]
        if quote == '"' and ch == "\\":
            esc = text[i + 1:i + 2]
            if esc not in _DQ_ESCAPES:
                raise _Error(lineno, f"unsupported escape \\{esc}")
            out.append(_DQ_ESCAPES[esc])
            i += 2
            continue
        if quote == '"' and ch == '"':
            return "".join(out), text[i + 1:]
        out.append(ch)
        i += 1
    raise _Error(lineno, "unterminated quoted scalar")


def _no_trailer(rest: str, lineno: int, what: str):
    """Only spaces and a comment may follow `what`."""
    rest = rest.strip()
    if rest and not rest.startswith("#"):
        raise _Error(lineno, f"text after {what}: {rest!r}")


def _flow_sequence(text: str, lineno: int) -> list:
    """The scalar items of the flow sequence `[a, b, ...]` that is `text`."""
    body, items = text[1:].lstrip(), []
    if body.startswith("]"):
        _no_trailer(body[1:], lineno, "a flow sequence")
        return items
    while True:
        if body[:1] in ("'", '"'):
            value, body = _quoted(body, lineno)
            items.append(value)
        else:
            m = re.match(r"[^,\[\]{}]*", body)
            token = m.group(0).strip()
            if not token:
                raise _Error(lineno, f"empty or nested item in {text!r}")
            items.append(_plain(token, lineno))
            body = body[m.end():]
        body = body.lstrip()
        if body.startswith(","):
            body = body[1:].lstrip()
        elif body.startswith("]"):
            _no_trailer(body[1:], lineno, "a flow sequence")
            return items
        else:
            raise _Error(lineno, f"malformed flow sequence {text!r}")


def _value(text: str, lineno: int):
    """The value that follows `key:` on its line."""
    if text.startswith(_TUPLE_TAG + " "):
        rest = text[len(_TUPLE_TAG):].strip()
        if not rest.startswith("["):
            raise _Error(lineno, f"{_TUPLE_TAG} needs a flow sequence")
        return tuple(_flow_sequence(rest, lineno))
    if text.startswith("["):
        return _flow_sequence(text, lineno)
    if text[0] in ("'", '"'):
        value, rest = _quoted(text, lineno)
        _no_trailer(rest, lineno, "a quoted scalar")
        return value
    m = re.search(r"\s#", text)
    return _plain(text[:m.start()].rstrip() if m else text, lineno)


def _key(text: str, lineno: int):
    """(key, what follows `key:`) of a map line."""
    if text[0] in ("'", '"'):
        key, rest = _quoted(text, lineno)
        if not re.match(r":(\s|$)", rest):
            raise _Error(lineno, "expected ':' after a quoted key")
        return key, rest[1:].strip()
    m = re.match(r"(.*?):(?:\s|$)", text)
    if not m or not m.group(1).strip():
        raise _Error(lineno, f"expected 'key: value', got {text!r}")
    return _plain(m.group(1).strip(), lineno), text[m.end():].strip()


def loads(text: str) -> dict | None:
    """Parse a document of the subset (see the module docstring); None for
    a document with no content, as PyYAML returns."""
    root: dict = {}
    stack: list[tuple[int, dict]] = []   # (indent, map) of the open maps
    pending = None                        # (indent, map, key) of a `key:`
    for lineno, raw in enumerate(text.splitlines(), 1):
        body = raw.strip()
        if not body or body.startswith("#"):
            continue
        lead = raw[:len(raw) - len(raw.lstrip())]
        if "\t" in lead:
            raise _Error(lineno, "tabs in indentation")
        if body in ("---", "...") or body[0] == "%" or body == "-" \
                or body.startswith("- "):
            raise _Error(lineno, f"unsupported YAML syntax: {body!r}")
        indent = len(lead)
        if not stack:
            stack.append((indent, root))
        if pending is not None:
            p_indent, parent, p_key = pending
            pending = None
            if indent > p_indent:
                parent[p_key] = {}
                stack.append((indent, parent[p_key]))
        while stack and stack[-1][0] > indent:
            stack.pop()
        if not stack or stack[-1][0] != indent:
            raise _Error(lineno, "indentation does not match any open map")
        current = stack[-1][1]
        key, rest = _key(body, lineno)
        if not rest or rest.startswith("#"):
            current[key] = None
            pending = (indent, current, key)
        else:
            current[key] = _value(rest, lineno)
    return root if stack else None


def load_config(path: str) -> dict:
    """Read a run config (`configs/*.yml`) into a dict, as the JAX package's
    `load_config` does."""
    with open(path) as f:
        return loads(f.read())
