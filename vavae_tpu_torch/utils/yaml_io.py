"""The port's YAML reader and writer, in the standard library alone.

``safe_load`` reads the part of YAML that the configs, the ``key=value``
overrides and ImageNet's ``index_synset.yaml`` use: block mappings and
block sequences (compact ``- key: value`` items and sequences at their
key's indent included), single-line flow sequences and flow mappings,
full-line and trailing comments, single- and double-quoted scalars with
their escapes, plain scalars, scalar keys and an empty document (``None``).
Plain scalars resolve as PyYAML 6's ``SafeLoader`` resolves them (YAML
1.1: ``1e-4`` is a string, ``1.0e-04`` a float, ``010`` is 8, ``0x1F``
31, ``1:30`` 90, ``yes``/``On`` True, ``~`` and the empty value None,
``2001-12-14`` a ``datetime.date``). Everything else raises ``ValueError``
naming the line and the construct: anchors and aliases, tags, ``|``/``>``
block scalars, several documents and document markers, ``<<`` merges,
``?`` keys, scalars or flow collections that span lines, timestamps with a
time, tabs outside quoted scalars, line breaks other than ``\\n``. So the
reader either gives PyYAML's value or raises.

``safe_dump`` writes what ``yaml.safe_dump(obj, sort_keys=False)`` writes
(block style, indent 2, width 80, ASCII with escapes) for trees of dicts,
lists, str, int, float, bool and None. It raises ``ValueError`` where
PyYAML would write something this reader refuses: a scalar folded over
lines, a multi-line quoted string, a key of 128 characters or more, an
empty or non-scalar key, a dict or list reached twice (PyYAML's anchors),
a scalar at the top, or any other type.
"""
from __future__ import annotations

import datetime
import re
from typing import Any, NamedTuple

# -- scalar resolution: PyYAML 6's implicit resolvers, in its order --------

_RESOLVERS = (
    ("bool", re.compile(r"""^(?:yes|Yes|YES|no|No|NO
                        |true|True|TRUE|false|False|FALSE
                        |on|On|ON|off|Off|OFF)$""", re.X), "yYnNtTfFoO"),
    ("float", re.compile(r"""^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?
                         |\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?
                         |[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*
                         |[-+]?\.(?:inf|Inf|INF)
                         |\.(?:nan|NaN|NAN))$""", re.X), "-+0123456789."),
    ("int", re.compile(r"""^(?:[-+]?0b[0-1_]+
                       |[-+]?0[0-7_]+
                       |[-+]?(?:0|[1-9][0-9_]*)
                       |[-+]?0x[0-9a-fA-F_]+
                       |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X), "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"^(?:~|null|Null|NULL|)$"), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                             |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                              (?:[Tt]|[ \t]+)[0-9][0-9]?
                              :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                              (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""", re.X),
     "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
)
_DATE = re.compile(r"([0-9]{4})-([0-9]{2})-([0-9]{2})\Z")
_BOOL = {"yes": True, "no": False, "true": True, "false": False, "on": True, "off": False}


def resolve(text: str) -> str:
    """The tag PyYAML gives ``text`` as a plain scalar: bool, float, int,
    merge, null, timestamp, value or str."""
    if not text:
        return "null"
    for tag, regexp, first in _RESOLVERS:
        if text[0] in first and regexp.match(text):
            return tag
    return "str"


def _sexagesimal(text: str, cast):
    value, base = cast(0), 1
    for digit in reversed(text.split(":")):
        value += cast(digit) * base
        base *= 60
    return value


def _int(text: str) -> int:
    text = text.replace("_", "")
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == "0":
        return 0
    if text.startswith("0b"):
        return sign * int(text[2:], 2)
    if text.startswith("0x"):
        return sign * int(text[2:], 16)
    if text[0] == "0":
        return sign * int(text, 8)
    if ":" in text:
        return sign * _sexagesimal(text, int)
    return sign * int(text)


def _float(text: str) -> float:
    text = text.replace("_", "").lower()
    sign = -1 if text[0] == "-" else 1
    if text[0] in "+-":
        text = text[1:]
    if text == ".inf":
        return sign * float("inf")
    if text == ".nan":
        return float("nan")
    if ":" in text:
        return sign * _sexagesimal(text, float)
    return sign * float(text)


# -- the reader --------------------------------------------------------------

_NON_PRINTABLE = re.compile(
    "[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\uD7FF\uE000-\uFFFD\U00010000-\U0010FFFF]")
_REFUSED_CHARS = {"\r": "a carriage return", "\x85": "a NEL line break",
                  "\u2028": "a line separator", "\u2029": "a paragraph separator",
                  "\uFEFF": "a byte order mark"}
_REFUSED = re.compile("[" + "".join(_REFUSED_CHARS) + "]")
_ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\t", "\t": "\t", "n": "\n",
            "v": "\x0b", "f": "\x0c", "r": "\r", "e": "\x1b", " ": " ", '"': '"',
            "\\": "\\", "/": "/", "N": "\x85", "_": "\xa0", "L": "\u2028", "P": "\u2029"}
_HEX_ESCAPES = {"x": 2, "u": 4, "U": 8}
_HEX = set("0123456789ABCDEFabcdef")
_CONSTRUCTS = {"&": "an anchor", "*": "an alias", "!": "a tag", "|": "a block scalar",
               ">": "a block scalar", "%": "a directive", "@": "a reserved indicator",
               "`": "a reserved indicator", "?": "a complex key", ":": "an empty key",
               "-": "a block sequence entry", ",": "a stray flow indicator",
               "]": "a stray flow indicator", "}": "a stray flow indicator"}
_KEY_LIMIT = 1000  # PyYAML refuses simple keys of more than 1,024 characters


class _Line(NamedTuple):
    number: int   # 1-based
    indent: int
    text: str     # from the first non-space character


def _error(number: int, what: str) -> ValueError:
    return ValueError(f"YAML line {number}: {what}")


def _skip_spaces(s: str, i: int, number: int) -> int:
    while i < len(s) and s[i] == " ":
        i += 1
    if i < len(s) and s[i] == "\t":
        raise _error(number, "a tab outside a quoted scalar")
    return i


def _at_end(s: str, i: int, number: int) -> None:
    """Only spaces and a comment may follow a complete node."""
    j = _skip_spaces(s, i, number)
    if j < len(s) and not (s[j] == "#" and j > i):
        what = ("a mapping value where none is allowed" if s[j] == ":"
                else f"text after the node ({s[j:j + 20]!r})")
        raise _error(number, what)


def _rest_empty(s: str, i: int, number: int) -> bool:
    j = _skip_spaces(s, i, number)
    return j == len(s) or (s[j] == "#" and j > i)


def _is_entry(text: str) -> bool:
    return text == "-" or text[:2] in ("- ", "-\t")


def _can_start_plain(s: str, i: int, flow: bool) -> bool:
    ch = s[i]
    if ch not in " \t-?:,[]{}#&*!|>'\"%@`":
        return True
    nxt = s[i + 1] if i + 1 < len(s) else ""
    return nxt not in ("", " ", "\t") and (ch == "-" or (not flow and ch in "?:"))


def _plain_end(s: str, i: int, flow: bool, number: int) -> int:
    """End of the plain scalar starting at ``i``: before ``: ``, `` #``, the
    line's end and, in a flow collection, ``,?[]{}`` and ``:`` before one."""
    stops = " \t,[]{}" if flow else " \t"
    j = i
    while j < len(s):
        ch = s[j]
        if ch == "\t":
            raise _error(number, "a tab outside a quoted scalar")
        if ch == " ":
            k = _skip_spaces(s, j, number)
            if k == len(s) or s[k] == "#":
                break
            j = k
            continue
        if ch == ":" and (j + 1 == len(s) or s[j + 1] in stops):
            break
        if flow and ch in ",?[]{}":
            break
        j += 1
    return j


def _plain(text: str, number: int) -> Any:
    tag = resolve(text)
    if tag == "str":
        return text
    if tag == "null":
        return None
    if tag == "bool":
        return _BOOL[text.lower()]
    if tag in ("int", "float", "timestamp"):
        try:
            if tag == "int":
                return _int(text)
            if tag == "float":
                return _float(text)
            m = _DATE.match(text)
            if m is None:
                raise _error(number, f"a timestamp with a time ({text!r})")
            return datetime.date(*map(int, m.groups()))
        except ValueError as e:  # as PyYAML: an int, float or date its constructor refuses
            raise _error(number, f"{tag} {text!r}: {e}") from None
    raise _error(number, f"a {'<< merge key' if tag == 'merge' else '= value key'}")


def _quoted(s: str, i: int, number: int) -> tuple[str, int]:
    quote, out = s[i], []
    i += 1
    while True:
        if i >= len(s):
            raise _error(number, "a quoted scalar that spans lines")
        ch = s[i]
        if quote == "'":
            if ch == "'":
                if s[i + 1:i + 2] != "'":
                    return "".join(out), i + 1
                i += 1
            out.append(ch)
            i += 1
        elif ch == '"':
            return "".join(out), i + 1
        elif ch == "\\":
            esc = s[i + 1:i + 2]
            if not esc:
                raise _error(number, "a double-quoted scalar continued on the next line")
            if esc in _ESCAPES:
                out.append(_ESCAPES[esc])
                i += 2
            elif esc in _HEX_ESCAPES:
                n = _HEX_ESCAPES[esc]
                digits = s[i + 2:i + 2 + n]
                if len(digits) < n or not set(digits) <= _HEX:
                    raise _error(number, f"a \\{esc} escape without {n} hex digits")
                try:
                    out.append(chr(int(digits, 16)))
                except ValueError as e:
                    raise _error(number, f"escape \\{esc}{digits}: {e}") from None
                i += 2 + n
            else:
                raise _error(number, f"an unknown escape \\{esc}")
        else:
            out.append(ch)
            i += 1


class _Reader:
    def __init__(self, text: str):
        bad = _NON_PRINTABLE.search(text) or _REFUSED.search(text)
        if bad is not None:
            ch = bad.group()
            what = _REFUSED_CHARS.get(ch, f"the non-printable character {ch!r}")
            raise _error(text.count("\n", 0, bad.start()) + 1, what)
        self.lines: list[_Line] = []
        for number, raw in enumerate(text.split("\n"), 1):
            body = raw.lstrip(" ")
            if not body or body[0] == "#":
                continue
            if body[0] == "\t":
                raise _error(number, "a tab in the indentation")
            indent = len(raw) - len(body)
            if indent == 0 and body[:3] in ("---", "...") and body[3:4] in ("", " ", "\t"):
                raise _error(number, "a document marker (one document, no markers, is read)")
            self.lines.append(_Line(number, indent, body))
        self.pos = 0

    def document(self) -> Any:
        if not self.lines:
            return None
        value = self.node()
        if self.pos < len(self.lines):
            raise _error(self.lines[self.pos].number, "content after the document's top node")
        return value

    def _deeper(self, indent: int) -> bool:
        return self.pos < len(self.lines) and self.lines[self.pos].indent > indent

    def _no_deeper(self, indent: int) -> None:
        if self._deeper(indent):
            raise _error(self.lines[self.pos].number,
                         "a line indented deeper than its block allows (a continued "
                         "scalar or a misaligned entry)")

    def node(self) -> Any:
        line = self.lines[self.pos]
        if _is_entry(line.text):
            return self.sequence(line.indent)
        if self.key(line) is not None:
            return self.mapping(line.indent)
        value = self.inline(line, 0)
        self.pos += 1
        return value

    def mapping(self, indent: int) -> dict:
        out: dict = {}
        while self.pos < len(self.lines) and self.lines[self.pos].indent == indent:
            line = self.lines[self.pos]
            found = None if _is_entry(line.text) else self.key(line)
            if found is None:
                raise _error(line.number, "a line that is not a 'key: value' entry of its mapping")
            key, i = found
            self.pos += 1
            if not _rest_empty(line.text, i, line.number):
                out[key] = self.inline(line, i)
            elif self._deeper(indent):
                out[key] = self.node()
            elif (self.pos < len(self.lines) and self.lines[self.pos].indent == indent
                  and _is_entry(self.lines[self.pos].text)):
                out[key] = self.sequence(indent)  # a sequence at its key's indent
            else:
                out[key] = None
        self._no_deeper(indent)
        return out

    def sequence(self, indent: int) -> list:
        out: list = []
        while (self.pos < len(self.lines) and self.lines[self.pos].indent == indent
               and _is_entry(self.lines[self.pos].text)):
            line = self.lines[self.pos]
            if _rest_empty(line.text, 1, line.number):
                self.pos += 1
                out.append(self.node() if self._deeper(indent) else None)
            else:  # a compact item: its content read as a line of its own
                j = _skip_spaces(line.text, 1, line.number)
                self.lines[self.pos] = _Line(line.number, indent + j, line.text[j:])
                out.append(self.node())
        self._no_deeper(indent)
        return out

    def key(self, line: _Line):
        """``(key, index after its ':')`` when the line is a mapping entry."""
        s, number = line.text, line.number
        if s[0] in "'\"":
            key, j = _quoted(s, 0, number)
        elif s[0] == "?" and (len(s) == 1 or s[1] in " \t"):
            raise _error(number, "a complex key ('? ')")
        elif s[0] not in "[{" and _can_start_plain(s, 0, False):
            j = _plain_end(s, 0, False, number)
            key = None
        else:
            return None
        k = _skip_spaces(s, j, number)
        if not (k < len(s) and s[k] == ":" and (k + 1 == len(s) or s[k + 1] in " \t")):
            return None
        if k > _KEY_LIMIT:
            raise _error(number, "a key longer than a simple key may be")
        if key is None:
            key = _plain(s[:j].rstrip(" "), number)
        return key, k + 1

    def inline(self, line: _Line, i: int) -> Any:
        s, number = line.text, line.number
        i = _skip_spaces(s, i, number)
        value, i = self.value(s, i, number, flow=False)
        _at_end(s, i, number)
        return value

    def value(self, s: str, i: int, number: int, flow: bool) -> tuple[Any, int]:
        ch = s[i]
        if ch in "[{":
            return self.flow(s, i, number)
        if ch in "'\"":
            return _quoted(s, i, number)
        if _can_start_plain(s, i, flow):
            j = _plain_end(s, i, flow, number)
            return _plain(s[i:j].rstrip(" "), number), j
        raise _error(number, _CONSTRUCTS.get(ch, f"the character {ch!r}"))

    def flow(self, s: str, i: int, number: int) -> tuple[Any, int]:
        close = "]" if s[i] == "[" else "}"
        out: Any = [] if close == "]" else {}
        i += 1
        first = True
        while True:
            i = _skip_spaces(s, i, number)
            if i < len(s) and s[i] == close:
                return out, i + 1
            if not first:
                if i >= len(s) or s[i] != ",":
                    break
                i = _skip_spaces(s, i + 1, number)
                if i < len(s) and s[i] == close:
                    return out, i + 1
            if i >= len(s) or s[i] == "#":
                break
            first = False
            if close == "}":
                if s[i] in "[{" or (s[i] == "?" and s[i + 1:i + 2] in ("", " ", "\t")):
                    raise _error(number, "a flow mapping key that is not a scalar")
                key, i = self.value(s, i, number, flow=True)
                i = _skip_spaces(s, i, number)
                if i >= len(s) or s[i] != ":":
                    raise _error(number, "a flow mapping key without ':'")
                i = _skip_spaces(s, i + 1, number)
                if i < len(s) and s[i] in ",}":
                    out[key] = None
                else:
                    if i >= len(s) or s[i] == "#":
                        break
                    out[key], i = self.value(s, i, number, flow=True)
            else:
                item, i = self.value(s, i, number, flow=True)
                j = _skip_spaces(s, i, number)
                if j < len(s) and s[j] == ":":
                    raise _error(number, "a 'key: value' pair inside a flow sequence")
                out.append(item)
        if i >= len(s) or s[i] == "#":
            raise _error(number, "a flow collection that spans lines")
        raise _error(number, f"{s[i]!r} where ',' or {close!r} was expected in a flow collection")


def safe_load(stream) -> Any:
    """The document in ``stream`` (str, UTF-8 bytes, or a file object), as
    PyYAML's ``yaml.safe_load`` gives it, or ``ValueError``."""
    text = stream.read() if hasattr(stream, "read") else stream
    if isinstance(text, bytes):
        text = text.decode("utf-8")
    try:
        return _Reader(text).document()
    except RecursionError:
        raise ValueError("YAML: collections nested too deep to read") from None


# -- the writer: PyYAML's emitter, for block-style trees of plain types ------

_WIDTH = 80  # PyYAML's best_width
_DUMP_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\t": "t", "\n": "n", "\x0b": "v",
                 "\x0c": "f", "\r": "r", "\x1b": "e", '"': '"', "\\": "\\", "\x85": "N",
                 "\xa0": "_", "\u2028": "L", "\u2029": "P"}
_BREAKS = "\n\x85\u2028\u2029"
_WHITESPACE = "\0 \t\r\n\x85\u2028\u2029"


def _represent(value) -> tuple[str, str]:
    """(tag, text) of a scalar, as PyYAML's ``SafeRepresenter`` writes it."""
    kind = type(value)
    if value is None:
        return "null", "null"
    if kind is bool:
        return "bool", "true" if value else "false"
    if kind is int:
        return "int", str(value)
    if kind is float:
        if value != value:
            return "float", ".nan"
        if value in (float("inf"), float("-inf")):
            return "float", ".inf" if value > 0 else "-.inf"
        text = repr(value).lower()
        if "." not in text and "e" in text:  # 1e-06 is no YAML 1.1 float: 1.0e-06
            text = text.replace("e", ".0e", 1)
        return "float", text
    if kind is str:
        return "str", value
    raise ValueError("safe_dump writes dict, list, str, int, float, bool and None, "
                     f"not {kind.__name__}")


class _Analysis(NamedTuple):
    empty: bool
    multiline: bool
    block_plain: bool
    single_quoted: bool


def _analyze(scalar: str) -> _Analysis:
    """PyYAML's ``Emitter.analyze_scalar`` in block context with
    ``allow_unicode`` off (its default): the styles ``scalar`` allows."""
    if not scalar:
        return _Analysis(True, False, True, True)
    block_indicators = scalar.startswith(("---", "..."))
    line_breaks = special = False
    leading = trailing = break_space = space_break = False
    previous_space = previous_break = False
    preceded_by_ws = True
    followed_by_ws = len(scalar) == 1 or scalar[1] in _WHITESPACE
    last = len(scalar) - 1
    for index, ch in enumerate(scalar):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`" or (ch in "?:-" and followed_by_ws):
                block_indicators = True
        elif (ch == ":" and followed_by_ws) or (ch == "#" and preceded_by_ws):
            block_indicators = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7e"):
            special = True
        if ch == " ":
            leading |= index == 0
            trailing |= index == last
            break_space |= previous_break
            previous_space, previous_break = True, False
        elif ch in _BREAKS:
            leading |= index == 0
            trailing |= index == last
            space_break |= previous_space
            previous_space, previous_break = False, True
        else:
            previous_space = previous_break = False
        preceded_by_ws = ch in _WHITESPACE
        followed_by_ws = index + 2 > last or scalar[index + 2] in _WHITESPACE
    plain = not (leading or trailing or break_space or space_break or special
                 or line_breaks or block_indicators)
    return _Analysis(False, line_breaks, plain, not (break_space or space_break or special))


class _Emitter:
    """The states of PyYAML's ``Emitter`` that a block-style dump visits,
    with its column bookkeeping, raising where it would fold a line."""

    def __init__(self, sort_keys: bool):
        self.sort_keys = sort_keys
        self.out: list[str] = []
        self.column = 0
        self.whitespace = self.indention = True
        self.indent: int | None = None
        self.seen: set[int] = set()

    def write(self, data: str) -> None:
        self.out.append(data)
        self.column += len(data)

    def write_indent(self) -> None:
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self.out.append("\n")
            self.column, self.whitespace, self.indention = 0, True, True
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def indicator(self, text: str, need_space: bool, whitespace: bool = False,
                  indention: bool = False) -> None:
        self.write(text if self.whitespace or not need_space else " " + text)
        self.whitespace = whitespace
        self.indention = self.indention and indention

    def node(self, value, *, mapping: bool = False, key: bool = False) -> None:
        kind = type(value)
        if kind not in (dict, list):
            if self.indent is None:
                raise ValueError("safe_dump writes a dict or a list at the top")
            self.scalar(value, key)
            return
        if key:
            raise ValueError("safe_dump writes scalar keys only")
        if id(value) in self.seen:
            raise ValueError("safe_dump: a dict or list reached twice (PyYAML writes an anchor)")
        self.seen.add(id(value))
        if not value:  # PyYAML writes an empty collection in flow style
            self.indicator("{" if kind is dict else "[", True, whitespace=True)
            self.indicator("}" if kind is dict else "]", False)
        elif kind is dict:
            self.block_mapping(value)
        else:
            self.block_sequence(value, mapping)

    def block_sequence(self, items: list, mapping: bool) -> None:
        saved = self.indent
        indentless = mapping and not self.indention  # a mapping's value: at its key's indent
        self.indent = 0 if saved is None else saved + (0 if indentless else 2)
        for item in items:
            self.write_indent()
            self.indicator("-", True, indention=True)
            self.node(item)
        self.indent = saved

    def block_mapping(self, mapping: dict) -> None:
        saved = self.indent
        self.indent = 0 if saved is None else saved + 2
        items = list(mapping.items())
        if self.sort_keys:
            try:
                items = sorted(items)
            except TypeError:  # as PyYAML: keys that do not compare keep their order
                pass
        for k, v in items:
            self.write_indent()
            self.node(k, key=True)
            self.indicator(":", False)
            self.node(v, mapping=True)
        self.indent = saved

    def scalar(self, value, key: bool) -> None:
        tag, text = _represent(value)
        analysis = _analyze(text)
        if key and (analysis.empty or analysis.multiline or len(text) >= 128):
            raise ValueError(f"safe_dump: the key {text!r} is not a simple key (empty, "
                             "multi-line, or 128 characters or more)")
        if resolve(text) == tag and analysis.block_plain:
            self.plain(text, split=not key)
        elif analysis.single_quoted and not analysis.multiline:
            self.single_quoted(text, split=not key)
        elif analysis.single_quoted:
            raise ValueError("safe_dump: a multi-line string (PyYAML writes it over lines)")
        else:
            self.double_quoted(text, split=not key)

    @staticmethod
    def _folded() -> ValueError:
        return ValueError("safe_dump: PyYAML folds this scalar over lines at width 80, "
                          "which the reader refuses")

    def plain(self, text: str, split: bool) -> None:
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces, start = False, 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > _WIDTH and split:
                        raise self._folded()
                    self.write(text[start:end])
                    start = end
            elif ch is None or ch == " ":
                self.write(text[start:end])
                start = end
            spaces = ch == " "

    def single_quoted(self, text: str, split: bool) -> None:
        self.indicator("'", True)
        spaces, start = False, 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > _WIDTH and split
                            and start != 0 and end != len(text)):
                        raise self._folded()
                    self.write(text[start:end])
                    start = end
            elif (ch is None or ch in " '") and start < end:
                self.write(text[start:end])
                start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            spaces = ch == " "
        self.indicator("'", False)

    def double_quoted(self, text: str, split: bool) -> None:
        self.indicator('"', True)
        start = 0
        for end in range(len(text) + 1):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\uFEFF' or not "\x20" <= ch <= "\x7e":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _DUMP_ESCAPES:
                        self.write("\\" + _DUMP_ESCAPES[ch])
                    elif ch <= "\xff":
                        self.write("\\x%02X" % ord(ch))
                    elif ch <= "\uFFFF":
                        self.write("\\u%04X" % ord(ch))
                    else:
                        self.write("\\U%08X" % ord(ch))
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > _WIDTH and split):
                raise self._folded()
        self.indicator('"', False)


def safe_dump(obj, stream=None, sort_keys: bool = False):
    """``yaml.safe_dump(obj, stream, sort_keys=sort_keys)`` for a dict or a
    list of dicts, lists, str, int, float, bool and None: the text, or None
    once it is written to ``stream``. Raises ``ValueError`` where the two
    would differ or where ``safe_load`` could not read the text back."""
    emitter = _Emitter(sort_keys)
    emitter.node(obj)
    emitter.write_indent()  # the document's end: PyYAML's final line break
    text = "".join(emitter.out)
    if stream is None:
        return text
    stream.write(text)
    return None
