"""YAML 1.1 as PyYAML reads and writes it, with no dependency.

:func:`parse_yaml` returns what ``yaml.safe_load`` returns, in value and
in Python type: one document (``---``, ``...`` and ``%YAML``/``%TAG``
directives), block and flow collections, anchors, aliases and ``<<``
merge keys, literal and folded block scalars with their chomping and
indentation indicators, multi-line plain and quoted scalars, every
double-quoted escape, ``? key`` complex keys, the standard ``!!`` tags and
YAML 1.1's implicit resolvers (bools such as ``yes``/``off``, octal, hex,
binary and sexagesimal ints, floats that need a dot, so ``1e3`` is a
string, and timestamps as ``datetime.date``/``datetime.datetime``).
Duplicate keys keep the last value.  What the safe loader rejects raises a
:class:`YAMLError` (a ``ValueError``) that names the construct and its
line and column.

:func:`dump_yaml` returns ``yaml.dump(obj, default_flow_style=False)``
byte for byte: sorted keys, PyYAML's choice of plain, single-quoted,
double-quoted or literal style, folding at 80 columns, non-ASCII escaped,
``&id001``/``*id001`` for an object that appears twice.

The reader is a scanner (tokens, with PyYAML's simple-key and indentation
rules) and a recursive parser that composes nodes; the constructor turns
nodes into Python objects.  The writer builds the same event stream as
PyYAML's representer and serializer and runs it through a port of its
emitter's state machine.
"""

from __future__ import annotations

import base64
import binascii
import datetime
import re
from typing import Any, Dict, List, Optional

__all__ = ["YAMLError", "parse_yaml", "dump_yaml"]


class YAMLError(ValueError):
    pass


_BREAKS = "\r\n\x85\u2028\u2029"
_BLANK_END = "\0 \t" + _BREAKS          # whitespace, a break or the end
_WORD = re.compile(r"[0-9A-Za-z_-]*")
_URI_CHARS = "-;/?:@&=+$,_.!~*'()[]%"
_NON_PRINTABLE = re.compile("[^\x09\x0A\x0D\x20-\x7E\x85\xA0-\ud7ff"
                            "\ue000-\ufffd\U00010000-\U0010ffff]")
_TAG = "tag:yaml.org,2002:"

# ----------------------------------------------------------------------
# implicit resolvers (YAML 1.1, in PyYAML's order per first character)
# ----------------------------------------------------------------------
_RESOLVERS = [
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
                    |[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$""", re.X),
     "-+0123456789"),
    ("merge", re.compile(r"^(?:<<)$"), "<"),
    ("null", re.compile(r"""^(?: ~
                    |null|Null|NULL
                    | )$""", re.X), "~nN"),
    ("timestamp", re.compile(r"""^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]
                    |[0-9][0-9][0-9][0-9] -[0-9][0-9]? -[0-9][0-9]?
                     (?:[Tt]|[ \t]+)[0-9][0-9]?
                     :[0-9][0-9] :[0-9][0-9] (?:\.[0-9]*)?
                     (?:[ \t]*(?:Z|[-+][0-9][0-9]?(?::[0-9][0-9])?))?)$""",
                          re.X), "0123456789"),
    ("value", re.compile(r"^(?:=)$"), "="),
]


def _resolve_scalar(value: str) -> str:
    """The tag PyYAML's resolver gives a plain scalar."""
    if value == "":
        return _TAG + "null"
    for name, pattern, first in _RESOLVERS:
        if value[0] in first and pattern.match(value):
            return _TAG + name
    return _TAG + "str"


# ----------------------------------------------------------------------
# scanner
# ----------------------------------------------------------------------
class _Token:
    __slots__ = ("kind", "value", "line", "col", "plain", "style")

    def __init__(self, kind, line, col, value=None, plain=False, style=None):
        self.kind, self.value, self.line, self.col = kind, value, line, col
        self.plain, self.style = plain, style


class _SimpleKey:
    __slots__ = ("number", "required", "index", "line", "col")

    def __init__(self, number, required, index, line, col):
        self.number, self.required = number, required
        self.index, self.line, self.col = index, line, col


class _Scanner:
    """PyYAML's scanner: the whole stream to a token list."""

    def __init__(self, text: str):
        bad = _NON_PRINTABLE.search(text)
        if bad:
            raise YAMLError(f"YAML: the unacceptable character "
                            f"#x{ord(bad.group()):04x} at offset "
                            f"{bad.start()}: special characters are not "
                            "allowed")
        self.buf = text + "\0\0\0\0"
        self.index = self.line = self.col = 0
        self.tokens: List[_Token] = [_Token("stream-start", 0, 0)]
        self.flow_level = 0
        self.indent = -1
        self.indents: List[int] = []
        self.allow_simple_key = True
        self.keys: Dict[int, _SimpleKey] = {}
        self.done = False
        while not self.done:
            self.fetch()

    # -- reading --------------------------------------------------------
    def peek(self, i: int = 0) -> str:
        return self.buf[self.index + i]

    def prefix(self, n: int) -> str:
        return self.buf[self.index:self.index + n]

    def forward(self, n: int = 1) -> None:
        for _ in range(n):
            ch = self.buf[self.index]
            self.index += 1
            if ch in "\n\x85\u2028\u2029" or (
                    ch == "\r" and self.buf[self.index] != "\n"):
                self.line += 1
                self.col = 0
            elif ch != "\ufeff":
                self.col += 1

    def error(self, what: str, detail: str = "", line=None, col=None):
        line = self.line if line is None else line
        col = self.col if col is None else col
        return YAMLError(f"YAML line {line + 1} column {col + 1}: {what}"
                         + (f" ({detail})" if detail else ""))

    def add(self, kind, value=None, line=None, col=None, **kw) -> None:
        self.tokens.append(_Token(kind, self.line if line is None else line,
                                  self.col if col is None else col, value,
                                  **kw))

    # -- the token dispatcher -------------------------------------------
    def fetch(self) -> None:
        self.scan_to_next_token()
        self.stale_keys()
        self.unwind_indent(self.col)
        ch = self.peek()
        if ch == "\0":
            self.unwind_indent(-1)
            self.remove_key()
            self.allow_simple_key = False
            self.keys = {}
            self.add("stream-end")
            self.done = True
        elif ch == "%" and self.col == 0:
            self.unwind_indent(-1)
            self.remove_key()
            self.allow_simple_key = False
            self.scan_directive()
        elif ch in "-." and self.col == 0 and self.prefix(3) in ("---", "...") \
                and self.peek(3) in _BLANK_END:
            self.unwind_indent(-1)
            self.remove_key()
            self.allow_simple_key = False
            kind = "document-start" if ch == "-" else "document-end"
            self.add(kind)
            self.forward(3)
        elif ch in "[{":
            self.save_key()
            self.flow_level += 1
            self.allow_simple_key = True
            self.add("flow-seq-start" if ch == "[" else "flow-map-start")
            self.forward()
        elif ch in "]}":
            self.remove_key()
            self.flow_level -= 1
            self.allow_simple_key = False
            self.add("flow-seq-end" if ch == "]" else "flow-map-end")
            self.forward()
        elif ch == ",":
            self.allow_simple_key = True
            self.remove_key()
            self.add("flow-entry")
            self.forward()
        elif ch == "-" and self.peek(1) in _BLANK_END:
            self.fetch_block_entry()
        elif ch == "?" and (self.flow_level or self.peek(1) in _BLANK_END):
            self.fetch_key()
        elif ch == ":" and (self.flow_level or self.peek(1) in _BLANK_END):
            self.fetch_value()
        elif ch in "*&":
            self.save_key()
            self.allow_simple_key = False
            self.scan_anchor()
        elif ch == "!":
            self.save_key()
            self.allow_simple_key = False
            self.scan_tag()
        elif ch in "|>" and not self.flow_level:
            self.allow_simple_key = True
            self.remove_key()
            self.scan_block_scalar(ch)
        elif ch in "'\"":
            self.save_key()
            self.allow_simple_key = False
            self.scan_flow_scalar(ch)
        elif self.check_plain():
            self.save_key()
            self.allow_simple_key = False
            self.scan_plain()
        elif ch == "\t":
            raise self.error("a tab in the indentation or between tokens",
                             "found character '\\t' that cannot start any "
                             "token")
        elif ch in "@`":
            raise self.error(f"the reserved indicator {ch!r}",
                             "it cannot start any token")
        else:
            raise self.error(f"the character {ch!r}",
                             "it cannot start any token")

    def check_plain(self) -> bool:
        ch = self.peek()
        return ch not in "\0 \t\r\n\x85\u2028\u2029-?:,[]{}#&*!|>'\"%@`" or (
            self.peek(1) not in _BLANK_END
            and (ch == "-" or (not self.flow_level and ch in "?:")))

    # -- simple keys and indentation --------------------------------------
    def stale_keys(self) -> None:
        for level in list(self.keys):
            key = self.keys[level]
            if key.line != self.line or self.index - key.index > 1024:
                if key.required:
                    raise self.error("a simple key without ':'",
                                     "could not find expected ':'",
                                     key.line, key.col)
                del self.keys[level]

    def save_key(self) -> None:
        required = not self.flow_level and self.indent == self.col
        if self.allow_simple_key:
            self.remove_key()
            self.keys[self.flow_level] = _SimpleKey(
                len(self.tokens), required, self.index, self.line, self.col)

    def remove_key(self) -> None:
        key = self.keys.pop(self.flow_level, None)
        if key is not None and key.required:
            raise self.error("a simple key without ':'",
                             "could not find expected ':'", key.line, key.col)

    def unwind_indent(self, col: int) -> None:
        if self.flow_level:
            return
        while self.indent > col:
            self.indent = self.indents.pop()
            self.add("block-end")

    def add_indent(self, col: int) -> bool:
        if self.indent < col:
            self.indents.append(self.indent)
            self.indent = col
            return True
        return False

    def fetch_block_entry(self) -> None:
        if not self.flow_level:
            if not self.allow_simple_key:
                raise self.error("a sequence entry where none is allowed",
                                 "sequence entries are not allowed here")
            if self.add_indent(self.col):
                self.add("block-seq-start")
        self.allow_simple_key = True
        self.remove_key()
        self.add("block-entry")
        self.forward()

    def fetch_key(self) -> None:
        if not self.flow_level:
            if not self.allow_simple_key:
                raise self.error("a complex key where none is allowed",
                                 "mapping keys are not allowed here")
            if self.add_indent(self.col):
                self.add("block-map-start")
        self.allow_simple_key = not self.flow_level
        self.remove_key()
        self.add("key")
        self.forward()

    def fetch_value(self) -> None:
        key = self.keys.pop(self.flow_level, None)
        if key is not None:
            self.tokens.insert(key.number, _Token("key", key.line, key.col))
            if not self.flow_level and self.add_indent(key.col):
                self.tokens.insert(key.number,
                                   _Token("block-map-start", key.line,
                                          key.col))
            self.allow_simple_key = False
        else:
            if not self.flow_level:
                if not self.allow_simple_key:
                    what = "a nested mapping on one line (as in 'a: b: c')"
                    kinds = [t.kind for t in self.tokens]
                    if "directive" in kinds and "document-start" not in kinds:
                        what = "a directive without '---' after it"
                    raise self.error(what,
                                     "mapping values are not allowed here")
                if self.add_indent(self.col):
                    self.add("block-map-start")
            self.allow_simple_key = not self.flow_level
            self.remove_key()
        self.add("value")
        self.forward()

    # -- whitespace, comments, breaks ------------------------------------
    def scan_to_next_token(self) -> None:
        if self.index == 0 and self.peek() == "\ufeff":
            self.forward()
        while True:
            while self.peek() == " ":
                self.forward()
            if self.peek() == "#":
                while self.peek() not in "\0" + _BREAKS:
                    self.forward()
            if self.scan_line_break():
                if not self.flow_level:
                    self.allow_simple_key = True
            else:
                return

    def scan_line_break(self) -> str:
        ch = self.peek()
        if ch in "\r\n\x85":
            self.forward(2 if self.prefix(2) == "\r\n" else 1)
            return "\n"
        if ch in "\u2028\u2029":
            self.forward()
            return ch
        return ""

    def skip_comment_to_break(self, what: str) -> None:
        while self.peek() == " ":
            self.forward()
        if self.peek() == "#":
            while self.peek() not in "\0" + _BREAKS:
                self.forward()
        if self.peek() not in "\0" + _BREAKS:
            raise self.error(what, "expected a comment or a line break, "
                             f"but found {self.peek()!r}")
        self.scan_line_break()

    # -- directives, anchors, tags ----------------------------------------
    def scan_directive(self) -> None:
        line, col = self.line, self.col
        self.forward()
        name = _WORD.match(self.buf, self.index).group()
        if not name or self.peek(len(name)) not in "\0 " + _BREAKS:
            raise self.error("a directive", "expected an alphanumeric name")
        self.forward(len(name))
        value = None
        if name == "YAML":
            while self.peek() == " ":
                self.forward()
            m = re.compile(r"([0-9]+)\.([0-9]+)").match(self.buf, self.index)
            if not m or self.peek(len(m.group())) not in "\0 " + _BREAKS:
                raise self.error("the %YAML directive",
                                 "expected a version such as 1.1")
            self.forward(len(m.group()))
            value = (int(m.group(1)), int(m.group(2)))
        elif name == "TAG":
            while self.peek() == " ":
                self.forward()
            handle = self.scan_tag_handle("the %TAG directive")
            if self.peek() != " ":
                raise self.error("the %TAG directive", "expected ' '")
            while self.peek() == " ":
                self.forward()
            prefix = self.scan_tag_uri("the %TAG directive")
            if self.peek() not in "\0 " + _BREAKS:
                raise self.error("the %TAG directive", "expected ' '")
            value = (handle, prefix)
        else:
            while self.peek() not in "\0" + _BREAKS:
                self.forward()
        self.skip_comment_to_break("a directive")
        self.add("directive", (name, value), line, col)

    def scan_anchor(self) -> None:
        line, col = self.line, self.col
        kind = "alias" if self.peek() == "*" else "anchor"
        self.forward()
        name = _WORD.match(self.buf, self.index).group()
        if not name or self.peek(len(name)) not in _BLANK_END + "?:,]}%@`":
            raise self.error(f"an {kind}",
                             "expected an alphanumeric name")
        self.forward(len(name))
        self.add(kind, name, line, col)

    def scan_tag(self) -> None:
        line, col = self.line, self.col
        ch = self.peek(1)
        if ch == "<":
            self.forward(2)
            handle, suffix = None, self.scan_tag_uri("a tag")
            if self.peek() != ">":
                raise self.error("a tag", f"expected '>', found "
                                 f"{self.peek()!r}")
            self.forward()
        elif ch in _BLANK_END:
            handle, suffix = None, "!"
            self.forward()
        else:
            n, use_handle = 1, False
            while ch not in "\0 " + _BREAKS:
                if ch == "!":
                    use_handle = True
                    break
                n += 1
                ch = self.peek(n)
            if use_handle:
                handle = self.scan_tag_handle("a tag")
            else:
                handle = "!"
                self.forward()
            suffix = self.scan_tag_uri("a tag")
        if self.peek() not in "\0 " + _BREAKS:
            raise self.error("a tag", f"expected ' ', found {self.peek()!r}")
        self.add("tag", (handle, suffix), line, col)

    def scan_tag_handle(self, what: str) -> str:
        if self.peek() != "!":
            raise self.error(what, f"expected '!', found {self.peek()!r}")
        n = 1
        if self.peek(1) != " ":
            n += len(_WORD.match(self.buf, self.index + 1).group())
            if self.peek(n) != "!":
                self.forward(n)
                raise self.error(what, f"expected '!', found "
                                 f"{self.peek()!r}")
            n += 1
        value = self.prefix(n)
        self.forward(n)
        return value

    def scan_tag_uri(self, what: str) -> str:
        chunks, n = [], 0
        ch = self.peek()
        while ch.isascii() and (ch.isalnum() or ch in _URI_CHARS):
            if ch == "%":
                chunks.append(self.prefix(n))
                self.forward(n)
                n = 0
                codes = []
                while self.peek() == "%":
                    self.forward()
                    hexd = self.prefix(2)
                    if not re.fullmatch(r"[0-9A-Fa-f]{2}", hexd):
                        raise self.error(what, "expected a URI escape of "
                                         "2 hexadecimal digits")
                    codes.append(int(hexd, 16))
                    self.forward(2)
                try:
                    chunks.append(bytes(codes).decode("utf-8"))
                except UnicodeDecodeError as e:
                    raise self.error(what, str(e))
            else:
                n += 1
            ch = self.peek(n)
        if n:
            chunks.append(self.prefix(n))
            self.forward(n)
        if not chunks:
            raise self.error(what, f"expected a URI, found {ch!r}")
        return "".join(chunks)

    # -- block scalars ----------------------------------------------------
    def scan_block_scalar(self, style: str) -> None:
        line, col = self.line, self.col
        folded = style == ">"
        chunks: List[str] = []
        self.forward()
        chomping = increment = None
        for _ in range(2):
            ch = self.peek()
            if ch in "+-" and chomping is None:
                chomping = ch == "+"
                self.forward()
            elif ch in "0123456789" and increment is None:
                if ch == "0":
                    raise self.error("a block scalar", "the indentation "
                                     "indicator must be 1-9, found 0")
                increment = int(ch)
                self.forward()
        if self.peek() not in "\0 " + _BREAKS:
            raise self.error("a block scalar", "expected chomping or "
                             f"indentation indicators, found {self.peek()!r}")
        self.skip_comment_to_break("a block scalar")
        min_indent = max(self.indent + 1, 1)
        if increment is None:
            breaks, max_indent = [], 0
            while self.peek() in " " + _BREAKS:
                if self.peek() != " ":
                    breaks.append(self.scan_line_break())
                else:
                    self.forward()
                    max_indent = max(max_indent, self.col)
            indent = max(min_indent, max_indent)
        else:
            indent = min_indent + increment - 1
            breaks = self.block_breaks(indent)
        line_break = ""
        while self.col == indent and self.peek() != "\0":
            chunks.extend(breaks)
            leading_non_space = self.peek() not in " \t"
            n = 0
            while self.peek(n) not in "\0" + _BREAKS:
                n += 1
            chunks.append(self.prefix(n))
            self.forward(n)
            line_break = self.scan_line_break()
            breaks = self.block_breaks(indent)
            if self.col == indent and self.peek() != "\0":
                if (folded and line_break == "\n" and leading_non_space
                        and self.peek() not in " \t"):
                    if not breaks:
                        chunks.append(" ")
                else:
                    chunks.append(line_break)
            else:
                break
        if chomping is not False:
            chunks.append(line_break)
        if chomping is True:
            chunks.extend(breaks)
        self.add("scalar", "".join(chunks), line, col, style=style)

    def block_breaks(self, indent: int) -> List[str]:
        chunks = []
        while self.col < indent and self.peek() == " ":
            self.forward()
        while self.peek() in _BREAKS:
            chunks.append(self.scan_line_break())
            while self.col < indent and self.peek() == " ":
                self.forward()
        return chunks

    # -- quoted scalars ---------------------------------------------------
    _ESCAPES = {"0": "\0", "a": "\x07", "b": "\x08", "t": "\x09",
                "\t": "\x09", "n": "\x0A", "v": "\x0B", "f": "\x0C",
                "r": "\x0D", "e": "\x1B", " ": "\x20", '"': '"',
                "\\": "\\", "/": "/", "N": "\x85", "_": "\xA0",
                "L": "\u2028", "P": "\u2029"}

    def scan_flow_scalar(self, quote: str) -> None:
        line, col = self.line, self.col
        double = quote == '"'
        chunks: List[str] = []
        self.forward()
        self.quoted_non_spaces(double, chunks, line, col)
        while self.peek() != quote:
            self.quoted_spaces(double, chunks, line, col)
            self.quoted_non_spaces(double, chunks, line, col)
        self.forward()
        self.add("scalar", "".join(chunks), line, col, style=quote)

    def quoted_non_spaces(self, double, chunks, line, col) -> None:
        while True:
            n = 0
            while self.peek(n) not in "'\"\\\0 \t" + _BREAKS:
                n += 1
            if n:
                chunks.append(self.prefix(n))
                self.forward(n)
            ch = self.peek()
            if not double and ch == "'" and self.peek(1) == "'":
                chunks.append("'")
                self.forward(2)
            elif (double and ch == "'") or (not double and ch in '"\\'):
                chunks.append(ch)
                self.forward()
            elif double and ch == "\\":
                self.forward()
                ch = self.peek()
                if ch in self._ESCAPES:
                    chunks.append(self._ESCAPES[ch])
                    self.forward()
                elif ch in "xuU":
                    width = {"x": 2, "u": 4, "U": 8}[ch]
                    self.forward()
                    digits = self.prefix(width)
                    if not re.fullmatch(r"[0-9A-Fa-f]{%d}" % width, digits):
                        raise self.error(
                            "a double-quoted scalar", f"expected an escape "
                            f"of {width} hexadecimal digits", line, col)
                    chunks.append(chr(int(digits, 16)))
                    self.forward(width)
                elif ch in _BREAKS:
                    self.scan_line_break()
                    chunks.extend(self.quoted_breaks(line, col))
                else:
                    raise self.error(f"the unknown escape \\{ch} in a "
                                     "double-quoted scalar", "", line, col)
            else:
                return

    def quoted_spaces(self, double, chunks, line, col) -> None:
        n = 0
        while self.peek(n) in " \t":
            n += 1
        whitespace = self.prefix(n)
        self.forward(n)
        ch = self.peek()
        if ch == "\0":
            raise self.error("an unterminated quoted scalar",
                             "found the end of the stream", line, col)
        if ch in _BREAKS:
            line_break = self.scan_line_break()
            breaks = self.quoted_breaks(line, col)
            if line_break != "\n":
                chunks.append(line_break)
            elif not breaks:
                chunks.append(" ")
            chunks.extend(breaks)
        else:
            chunks.append(whitespace)

    def quoted_breaks(self, line, col) -> List[str]:
        chunks = []
        while True:
            if self.prefix(3) in ("---", "...") and \
                    self.peek(3) in _BLANK_END:
                raise self.error("an unterminated quoted scalar",
                                 "found a document separator", line, col)
            while self.peek() in " \t":
                self.forward()
            if self.peek() in _BREAKS:
                chunks.append(self.scan_line_break())
            else:
                return chunks

    # -- plain scalars ----------------------------------------------------
    def scan_plain(self) -> None:
        line, col = self.line, self.col
        chunks: List[str] = []
        indent = self.indent + 1
        spaces: Optional[List[str]] = []
        stop = ",[]{}" if self.flow_level else ""
        while True:
            if self.peek() == "#":
                break
            n = 0
            while True:
                ch = self.peek(n)
                if ch in _BLANK_END or (
                        ch == ":" and self.peek(n + 1) in _BLANK_END + stop) \
                        or (self.flow_level and ch in ",?[]{}"):
                    break
                n += 1
            if n == 0:
                break
            self.allow_simple_key = False
            chunks.extend(spaces)
            chunks.append(self.prefix(n))
            self.forward(n)
            spaces = self.plain_spaces()
            if not spaces or self.peek() == "#" or (
                    not self.flow_level and self.col < indent):
                break
        self.add("scalar", "".join(chunks), line, col, plain=True)

    def plain_spaces(self) -> Optional[List[str]]:
        chunks = []
        n = 0
        while self.peek(n) == " ":
            n += 1
        whitespace = self.prefix(n)
        self.forward(n)
        if self.peek() in _BREAKS:
            line_break = self.scan_line_break()
            self.allow_simple_key = True
            if self.prefix(3) in ("---", "...") and \
                    self.peek(3) in _BLANK_END:
                return None
            breaks = []
            while self.peek() in " " + _BREAKS:
                if self.peek() == " ":
                    self.forward()
                else:
                    breaks.append(self.scan_line_break())
                    if self.prefix(3) in ("---", "...") and \
                            self.peek(3) in _BLANK_END:
                        return None
            if line_break != "\n":
                chunks.append(line_break)
            elif not breaks:
                chunks.append(" ")
            chunks.extend(breaks)
        elif whitespace:
            chunks.append(whitespace)
        return chunks


# ----------------------------------------------------------------------
# parser and composer: tokens -> nodes
# ----------------------------------------------------------------------
class _Node:
    __slots__ = ("kind", "tag", "value", "line", "col", "style")

    def __init__(self, kind, tag, value, line, col, style=None):
        self.kind, self.tag, self.value = kind, tag, value  # scalar/seq/map
        self.line, self.col, self.style = line, col, style


_TOKEN_NAMES = {"block-end": "<block end>", "stream-end": "<stream end>",
                "document-start": "<document start>"}


class _Parser:
    def __init__(self, tokens: List[_Token]):
        self.tokens = tokens
        self.pos = 0
        self.anchors: Dict[str, _Node] = {}
        self.handles: Dict[str, str] = {}

    def peek(self) -> _Token:
        return self.tokens[self.pos]

    def check(self, *kinds) -> bool:
        return self.tokens[self.pos].kind in kinds

    def take(self) -> _Token:
        tok = self.tokens[self.pos]
        self.pos += 1
        return tok

    def error(self, what: str, tok: _Token, detail: str = ""):
        return YAMLError(f"YAML line {tok.line + 1} column {tok.col + 1}: "
                         f"{what}" + (f" ({detail})" if detail else ""))

    def unexpected(self, context: str) -> YAMLError:
        tok = self.peek()
        name = _TOKEN_NAMES.get(tok.kind, repr(tok.kind))
        return self.error(f"{context}: found {name}", tok)

    # -- documents --------------------------------------------------------
    def single_document(self) -> Optional[_Node]:
        self.take()  # stream-start
        root = None
        if not self.check("stream-end"):
            root = self.document()
        if not self.check("stream-end"):
            while self.check("document-end"):
                self.take()
        if not self.check("stream-end"):
            raise self.error("a second document in the stream", self.peek(),
                             "the port reads one document per file, as "
                             "yaml.safe_load does")
        return root

    def document(self) -> _Node:
        self.handles = {"!": "!", "!!": _TAG}
        if not self.check("directive", "document-start", "stream-end"):
            node = self.block_node()
        else:
            while self.check("document-end"):
                self.take()
            if self.check("stream-end"):
                return None
            self.directives()
            if not self.check("document-start"):
                raise self.unexpected(
                    "a directive or document end must be followed by '---'"
                    " (expected <document start>)")
            self.take()
            if self.check("directive", "document-start", "document-end",
                          "stream-end"):
                tok = self.peek()
                node = _Node("scalar", _TAG + "null", "", tok.line, tok.col)
            else:
                node = self.block_node()
        if self.check("document-end"):
            self.take()
        self.anchors = {}
        return node

    def directives(self) -> None:
        version = None
        handles: Dict[str, str] = {}
        while self.check("directive"):
            tok = self.take()
            name, value = tok.value
            if name == "YAML":
                if version is not None:
                    raise self.error("a duplicate %YAML directive", tok)
                if value[0] != 1:
                    raise self.error(f"the %YAML {value[0]}.{value[1]} "
                                     "directive (version 1.* is required)",
                                     tok)
                version = value
            elif name == "TAG":
                handle, prefix = value
                if handle in handles:
                    raise self.error(f"the duplicate tag handle {handle!r}",
                                     tok)
                handles[handle] = prefix
        self.handles = {"!": "!", "!!": _TAG, **handles}

    # -- nodes ------------------------------------------------------------
    def block_node(self, indentless: bool = False) -> _Node:
        return self.node(block=True, indentless=indentless)

    def node(self, block: bool = False, indentless: bool = False) -> _Node:
        if self.check("alias"):
            tok = self.take()
            if tok.value not in self.anchors:
                raise self.error(f"the undefined alias {tok.value!r}", tok)
            return self.anchors[tok.value]
        start = self.peek()
        anchor = tag = None
        tag_tok = None
        for _ in range(2):
            if self.check("anchor") and anchor is None:
                anchor = self.take().value
            elif self.check("tag") and tag is None:
                tag_tok = self.take()
                tag = tag_tok.value
        if anchor is not None and anchor in self.anchors:
            raise self.error(f"the duplicate anchor {anchor!r}", start)
        if tag is not None:
            handle, suffix = tag
            if handle is not None:
                if handle not in self.handles:
                    raise self.error(f"the undefined tag handle {handle!r}",
                                     tag_tok)
                tag = self.handles[handle] + suffix
            else:
                tag = suffix
        tok = self.peek()
        if indentless and self.check("block-entry"):
            node = _Node("seq", self.collection_tag("seq", tag), [],
                         tok.line, tok.col)
            self.register(anchor, node)
            while self.check("block-entry"):
                entry = self.take()
                if self.check("block-entry", "key", "value", "block-end"):
                    node.value.append(self.empty(entry))
                else:
                    node.value.append(self.block_node())
            return node
        if self.check("scalar"):
            self.take()
            if (tok.plain and tag is None) or tag == "!":
                tag = _resolve_scalar(tok.value)
            elif tag is None:
                tag = _TAG + "str"
            node = _Node("scalar", tag, tok.value, start.line, start.col,
                         tok.style)
            self.register(anchor, node)
            return node
        if self.check("flow-seq-start", "flow-map-start"):
            return self.flow_collection(anchor, tag)
        if block and self.check("block-seq-start"):
            node = _Node("seq", self.collection_tag("seq", tag), [],
                         tok.line, tok.col)
            self.register(anchor, node)
            self.take()
            while self.check("block-entry"):
                entry = self.take()
                if self.check("block-entry", "block-end"):
                    node.value.append(self.empty(entry))
                else:
                    node.value.append(self.block_node())
            if not self.check("block-end"):
                raise self.unexpected("a block sequence entry at the wrong "
                                      "indentation (expected <block end>)")
            self.take()
            return node
        if block and self.check("block-map-start"):
            node = _Node("map", self.collection_tag("map", tag), [],
                         tok.line, tok.col)
            self.register(anchor, node)
            self.take()
            while self.check("key"):
                ktok = self.take()
                if self.check("key", "value", "block-end"):
                    key = self.empty(ktok)
                else:
                    key = self.block_node(indentless=True)
                if self.check("value"):
                    vtok = self.take()
                    if self.check("key", "value", "block-end"):
                        value = self.empty(vtok)
                    else:
                        value = self.block_node(indentless=True)
                else:
                    value = self.empty(self.peek())
                node.value.append((key, value))
            if not self.check("block-end"):
                raise self.unexpected("a block mapping entry at the wrong "
                                      "indentation (expected <block end>)")
            self.take()
            return node
        if anchor is not None or tag is not None:
            node = _Node("scalar", _resolve_scalar("") if tag in (None, "!")
                         else tag, "", start.line, start.col)
            self.register(anchor, node)
            return node
        raise self.unexpected(f"a {'block' if block else 'flow'} node "
                              "without content")

    def collection_tag(self, kind: str, tag: Optional[str]) -> str:
        if tag is None or tag == "!":
            return _TAG + kind
        return tag

    def register(self, anchor: Optional[str], node: _Node) -> None:
        if anchor is not None:
            self.anchors[anchor] = node

    def empty(self, tok: _Token) -> _Node:
        return _Node("scalar", _TAG + "null", "", tok.line, tok.col)

    def flow_collection(self, anchor, tag) -> _Node:
        start = self.take()
        is_seq = start.kind == "flow-seq-start"
        end = "flow-seq-end" if is_seq else "flow-map-end"
        node = _Node("seq" if is_seq else "map",
                     self.collection_tag("seq" if is_seq else "map", tag),
                     [], start.line, start.col)
        self.register(anchor, node)
        first = True
        while not self.check(end):
            if not first:
                if not self.check("flow-entry"):
                    raise self.unexpected(
                        "a flow collection (expected ',' or "
                        f"'{']' if is_seq else '}'}')")
                self.take()
                if self.check(end):
                    break
            first = False
            if is_seq and not self.check("key"):
                node.value.append(self.node())
                continue
            if self.check("key"):  # "? key" or an implicit key
                ktok = self.take()
                if self.check("value", "flow-entry", end):
                    key = self.empty(ktok)
                else:
                    key = self.node()
                if self.check("value"):
                    vtok = self.take()
                    if self.check("flow-entry", end):
                        value = self.empty(vtok)
                    else:
                        value = self.node()
                else:
                    value = self.empty(self.peek())
            else:  # a flow mapping entry with no ':'
                key = self.node()
                value = self.empty(self.peek())
            if is_seq:  # a single-pair mapping inside a flow sequence
                node.value.append(_Node("map", _TAG + "map", [(key, value)],
                                        key.line, key.col))
            else:
                node.value.append((key, value))
        self.take()
        return node


# ----------------------------------------------------------------------
# constructor: nodes -> Python objects (PyYAML's SafeConstructor)
# ----------------------------------------------------------------------
_TIMESTAMP = re.compile(
    r"""^(?P<year>[0-9][0-9][0-9][0-9])
        -(?P<month>[0-9][0-9]?)
        -(?P<day>[0-9][0-9]?)
        (?:(?:[Tt]|[ \t]+)
        (?P<hour>[0-9][0-9]?)
        :(?P<minute>[0-9][0-9])
        :(?P<second>[0-9][0-9])
        (?:\.(?P<fraction>[0-9]*))?
        (?:[ \t]*(?P<tz>Z|(?P<tz_sign>[-+])(?P<tz_hour>[0-9][0-9]?)
        (?::(?P<tz_minute>[0-9][0-9]))?))?)?$""", re.X)
_BOOLS = {"yes": True, "no": False, "true": True, "false": False,
          "on": True, "off": False}


def _int(text: str) -> int:
    v = text.replace("_", "")
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == "0":
        return 0
    if v.startswith("0b"):
        return sign * int(v[2:], 2)
    if v.startswith("0x"):
        return sign * int(v[2:], 16)
    if v[0] == "0":
        return sign * int(v, 8)
    if ":" in v:
        out = 0
        for part in v.split(":"):
            out = out * 60 + int(part)
        return sign * out
    return sign * int(v)


def _float(text: str) -> float:
    v = text.replace("_", "").lower()
    sign = -1 if v[0] == "-" else 1
    if v[0] in "+-":
        v = v[1:]
    if v == ".inf":
        return sign * float("inf")
    if v == ".nan":
        return float("nan")
    if ":" in v:
        digits = [float(part) for part in v.split(":")]
        out, base = 0.0, 1
        for digit in reversed(digits):
            out += digit * base
            base *= 60
        return sign * out
    return sign * float(v)


def _timestamp(text: str):
    m = _TIMESTAMP.match(text)
    g = m.groupdict()
    year, month, day = int(g["year"]), int(g["month"]), int(g["day"])
    if not g["hour"]:
        return datetime.date(year, month, day)
    fraction = 0
    if g["fraction"]:
        fraction = int(g["fraction"][:6].ljust(6, "0"))
    tzinfo = None
    if g["tz_sign"]:
        delta = datetime.timedelta(hours=int(g["tz_hour"]),
                                   minutes=int(g["tz_minute"] or 0))
        tzinfo = datetime.timezone(-delta if g["tz_sign"] == "-" else delta)
    elif g["tz"]:
        tzinfo = datetime.timezone.utc
    return datetime.datetime(year, month, day, int(g["hour"]),
                             int(g["minute"]), int(g["second"]), fraction,
                             tzinfo=tzinfo)


_SCALARS = {"null": lambda v: None, "bool": lambda v: _BOOLS[v.lower()],
            "int": _int, "float": _float, "str": lambda v: v,
            "timestamp": _timestamp}


class _Constructor:
    def __init__(self):
        self.done: Dict[int, Any] = {}

    def error(self, what: str, node: _Node):
        return YAMLError(f"YAML line {node.line + 1} column {node.col + 1}: "
                         f"{what}")

    def build(self, node: _Node):
        if id(node) in self.done:
            return self.done[id(node)]
        short = node.tag[len(_TAG):] if node.tag.startswith(_TAG) else None
        if short in _SCALARS or short == "binary":
            if node.kind != "scalar" and short == "timestamp":
                raise self.error(f"the tag !!timestamp on a {node.kind} "
                                 "node", node)
            text = self.scalar_text(node, short)
            try:
                if short == "binary":
                    data = base64.decodebytes(text.encode("ascii"))
                else:
                    data = _SCALARS[short](text)
            except (KeyError, ValueError, AttributeError, TypeError,
                    binascii.Error) as e:
                raise self.error(f"the scalar {text!r} is no valid "
                                 f"!!{short} ({e!r})", node)
        elif node.kind == "seq" and short == "seq":
            data = []
            self.done[id(node)] = data
            data.extend(self.build(item) for item in node.value)
        elif node.kind == "seq" and short in ("omap", "pairs"):
            data = []
            self.done[id(node)] = data
            for sub in node.value:
                if sub.kind != "map" or len(sub.value) != 1:
                    raise self.error(f"a !!{short} entry that is no "
                                     "single-pair mapping", sub)
                data.append((self.build(sub.value[0][0]),
                             self.build(sub.value[0][1])))
        elif node.kind == "map" and short in ("map", "set"):
            data = {} if short == "map" else set()
            self.done[id(node)] = data
            self.flatten(node)
            for key_node, value_node in node.value:
                key = self.build(key_node)
                try:
                    hash(key)
                except TypeError:
                    raise self.error("an unhashable (collection) mapping "
                                     "key", key_node)
                if short == "map":
                    data[key] = self.build(value_node)
                else:
                    data.add(key)
        elif short in _SCALARS or short in ("seq", "map", "binary", "omap",
                                            "pairs", "set"):
            raise self.error(f"the tag !!{short} on a {node.kind} node",
                             node)
        elif short in ("merge", "value"):
            raise self.error(f"the {'merge key <<' if short == 'merge' else '= key'}"
                             " used as a value (PyYAML has no constructor "
                             f"for the tag {node.tag!r})", node)
        else:
            raise self.error(f"the unknown tag {node.tag!r} (the safe "
                             "loader's standard tags only)", node)
        self.done[id(node)] = data
        return data

    def scalar_text(self, node: _Node, short: str) -> str:
        """PyYAML's SafeConstructor.construct_scalar: a mapping stands for
        the value of its ``=`` key."""
        if node.kind == "map":
            for key, value in node.value:
                if key.tag == _TAG + "value":
                    return self.scalar_text(value, short)
        if node.kind != "scalar":
            raise self.error(f"the tag !!{short} on a {node.kind} node",
                             node)
        return node.value

    def flatten(self, node: _Node) -> None:
        """PyYAML's flatten_mapping: ``<<`` pairs come first, so that the
        mapping's own keys win, and of a list of merges the first wins."""
        merge = []
        index = 0
        while index < len(node.value):
            key, value = node.value[index]
            if key.tag == _TAG + "merge":
                del node.value[index]
                if value.kind == "map":
                    self.flatten(value)
                    merge.extend(value.value)
                elif value.kind == "seq":
                    subs = []
                    for sub in value.value:
                        if sub.kind != "map":
                            raise self.error("a merge key << whose list "
                                             "holds a non-mapping", sub)
                        self.flatten(sub)
                        subs.append(sub.value)
                    for sub in reversed(subs):
                        merge.extend(sub)
                else:
                    raise self.error("a merge key << whose value is no "
                                     "mapping or list of mappings", value)
            elif key.tag == _TAG + "value":
                key.tag = _TAG + "str"
                index += 1
            else:
                index += 1
        if merge:
            node.value = merge + node.value


def parse_yaml(text: str) -> Any:
    """One YAML document -> Python objects, as ``yaml.safe_load(text)``."""
    root = _Parser(_Scanner(text).tokens).single_document()
    return None if root is None else _Constructor().build(root)


# ----------------------------------------------------------------------
# writer: PyYAML's representer, serializer and emitter
# ----------------------------------------------------------------------
class _Event:
    __slots__ = ("kind", "anchor", "tag", "implicit", "value", "style")

    def __init__(self, kind, anchor=None, tag=None, implicit=None,
                 value=None, style=None):
        self.kind, self.anchor, self.tag = kind, anchor, tag
        self.implicit, self.value, self.style = implicit, value, style


def _represent(data, seen: Dict[int, _Node]) -> _Node:
    """PyYAML's Representer (``yaml.dump``'s) for the types the reader
    returns, plus tuples."""
    kind = type(data)
    shared = kind not in (type(None), str, bytes, bool, int, float) and \
        not (kind is tuple and data == ())
    if shared and id(data) in seen:  # the tree keeps ``data`` alive
        return seen[id(data)]

    def scalar(tag, value, style=None):
        node = _Node("scalar", _TAG + tag, value, 0, 0, style)
        if shared:
            seen[id(data)] = node
        return node

    if data is None:
        return scalar("null", "null")
    if kind is bool:
        return scalar("bool", "true" if data else "false")
    if kind is int:
        return scalar("int", str(data))
    if kind is float:
        if data != data:
            value = ".nan"
        elif data == float("inf"):
            value = ".inf"
        elif data == float("-inf"):
            value = "-.inf"
        else:
            value = repr(data).lower()
            if "." not in value and "e" in value:
                value = value.replace("e", ".0e", 1)
        return scalar("float", value)
    if kind is str:
        return scalar("str", data)
    if kind is bytes:
        return scalar("binary", base64.encodebytes(data).decode("ascii"),
                      "|")
    if kind is datetime.date:
        return scalar("timestamp", data.isoformat())
    if kind is datetime.datetime:
        return scalar("timestamp", data.isoformat(" "))
    if kind in (list, tuple):
        node = _Node("seq", _TAG + ("seq" if kind is list
                                    else "python/tuple"), [], 0, 0)
        seen[id(data)] = node
        node.value.extend(_represent(item, seen) for item in data)
        return node
    if kind in (dict, set):
        node = _Node("map", _TAG + ("map" if kind is dict else "set"), [],
                     0, 0)
        seen[id(data)] = node
        items = list(data.items() if kind is dict
                     else dict.fromkeys(data).items())
        try:
            items = sorted(items)
        except TypeError:
            pass
        for key, value in items:
            node.value.append((_represent(key, seen),
                               _represent(value, seen)))
        return node
    raise YAMLError(f"YAML: the port's writer cannot represent a "
                    f"{kind.__name__} value: {data!r}")


def _serialize(root: _Node) -> List[_Event]:
    anchors: Dict[int, Optional[str]] = {}
    count = [0]

    def anchor(node):
        if id(node) in anchors:
            if anchors[id(node)] is None:
                count[0] += 1
                anchors[id(node)] = "id%03d" % count[0]
            return
        anchors[id(node)] = None
        if node.kind == "seq":
            for item in node.value:
                anchor(item)
        elif node.kind == "map":
            for key, value in node.value:
                anchor(key)
                anchor(value)

    anchor(root)
    events = [_Event("document-start")]
    done = set()

    def walk(node):
        name = anchors[id(node)]
        if id(node) in done:
            events.append(_Event("alias", anchor=name))
            return
        done.add(id(node))
        if node.kind == "scalar":
            implicit = (node.tag == _resolve_scalar(node.value),
                        node.tag == _TAG + "str")
            events.append(_Event("scalar", name, node.tag, implicit,
                                 node.value, node.style))
        else:
            events.append(_Event(node.kind + "-start", name, node.tag,
                                 node.tag == _TAG + node.kind))
            for item in node.value:
                if node.kind == "map":
                    walk(item[0])
                    walk(item[1])
                else:
                    walk(item)
            events.append(_Event(node.kind + "-end"))

    walk(root)
    events.append(_Event("document-end"))
    return events


class _Analysis:
    __slots__ = ("scalar", "empty", "multiline", "allow_block_plain",
                 "allow_single_quoted", "allow_block")


def _analyze(scalar: str) -> _Analysis:
    """PyYAML's analyze_scalar with ``allow_unicode`` off."""
    a = _Analysis()
    a.scalar = scalar
    a.empty = not scalar
    if not scalar:
        a.multiline = False
        a.allow_block_plain = a.allow_single_quoted = True
        a.allow_block = False
        return a
    block_indicators = line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    if scalar.startswith(("---", "...")):
        block_indicators = True
    preceded_by_ws = True
    followed_by_ws = len(scalar) == 1 or scalar[1] in _BLANK_END
    prev_space = prev_break = False
    n = len(scalar)
    for index, ch in enumerate(scalar):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                block_indicators = True
            if ch in "?:-" and followed_by_ws:
                block_indicators = True
        elif (ch == ":" and followed_by_ws) or (ch == "#" and
                                                 preceded_by_ws):
            block_indicators = True
        if ch in "\n\x85\u2028\u2029":
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True  # non-ASCII is escaped: allow_unicode is off
        if ch == " ":
            leading_space |= index == 0
            trailing_space |= index == n - 1
            break_space |= prev_break
            prev_space, prev_break = True, False
        elif ch in "\n\x85\u2028\u2029":
            leading_break |= index == 0
            trailing_break |= index == n - 1
            space_break |= prev_space
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_by_ws = ch in _BLANK_END
        followed_by_ws = index + 2 >= n or scalar[index + 2] in _BLANK_END
    plain = single = block = True
    if leading_space or leading_break or trailing_space or trailing_break:
        plain = False
    if trailing_space:
        block = False
    if break_space:
        plain = single = False
    if space_break or special:
        plain = single = block = False
    if line_breaks or block_indicators:
        plain = False
    a.multiline = line_breaks
    a.allow_block_plain, a.allow_single_quoted = plain, single
    a.allow_block = block
    return a


_DQ_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n",
               "\x0B": "v", "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"',
               "\\": "\\", "\x85": "N", "\xA0": "_", "\u2028": "L",
               "\u2029": "P"}


class _Emitter:
    """PyYAML's emitter for block-style output (``default_flow_style=False``:
    only empty collections are written in flow style), width 80, indent 2,
    ``allow_unicode`` off."""

    WIDTH = 80

    def __init__(self, events: List[_Event]):
        self.events = events
        self.pos = 0
        self.out: List[str] = []
        self.indents: List[Optional[int]] = []
        self.indent: Optional[int] = None
        self.column = 0
        self.whitespace = self.indention = True
        self.open_ended = False
        self.root = self.mapping = self.simple_key = False
        self.analysis: Optional[_Analysis] = None
        self.style: Optional[str] = None

    def next_event(self) -> _Event:
        event = self.events[self.pos]
        self.pos += 1
        return event

    def following(self) -> Optional[_Event]:
        return self.events[self.pos] if self.pos < len(self.events) else None

    def run(self) -> str:
        self.next_event()  # document-start: implicit, no '---' needed
        self.node(self.next_event(), root=True)
        self.next_event()  # document-end
        self.write_indent()
        if self.open_ended:
            self.write_indicator("...", True)
            self.write_indent()
        return "".join(self.out)

    # -- structure --------------------------------------------------------
    def increase_indent(self, flow: bool = False,
                        indentless: bool = False) -> None:
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = 2 if flow else 0
        elif not indentless:
            self.indent += 2

    def is_empty(self, event: _Event) -> bool:
        nxt = self.following()
        return nxt is not None and nxt.kind == event.kind.replace(
            "-start", "-end")

    def node(self, event: _Event, root=False, mapping=False,
             simple_key=False) -> None:
        self.root, self.mapping, self.simple_key = root, mapping, simple_key
        if event.kind == "alias":
            self.write_indicator("*" + event.anchor, True)
            return
        if event.anchor is not None:
            self.write_indicator("&" + event.anchor, True)
        self.process_tag(event)
        if event.kind == "scalar":
            self.increase_indent(flow=True)
            self.process_scalar(event)
            self.indent = self.indents.pop()
        elif self.is_empty(event):  # [] or {}
            self.write_indicator("[" if event.kind == "seq-start" else "{",
                                 True, whitespace=True)
            self.next_event()
            self.write_indicator("]" if event.kind == "seq-start" else "}",
                                 False)
        elif event.kind == "seq-start":
            self.block_sequence()
        else:
            self.block_mapping()

    def block_sequence(self) -> None:
        self.increase_indent(indentless=self.mapping and not self.indention)
        while True:
            event = self.next_event()
            if event.kind == "seq-end":
                break
            self.write_indent()
            self.write_indicator("-", True, indention=True)
            self.node(event)
        self.indent = self.indents.pop()

    def block_mapping(self) -> None:
        self.increase_indent()
        while True:
            event = self.next_event()
            if event.kind == "map-end":
                break
            self.write_indent()
            if self.check_simple_key(event):
                self.node(event, mapping=True, simple_key=True)
                self.write_indicator(":", False)
            else:
                self.write_indicator("?", True, indention=True)
                self.node(event, mapping=True)
                self.write_indent()
                self.write_indicator(":", True, indention=True)
            self.node(self.next_event(), mapping=True)
        self.indent = self.indents.pop()

    def check_simple_key(self, event: _Event) -> bool:
        length = len(event.anchor) if event.anchor is not None else 0
        if event.kind in ("scalar", "seq-start", "map-start") and \
                event.tag is not None:
            length += len(self.tag_text(event.tag))
        if event.kind == "scalar":
            if self.analysis is None:
                self.analysis = _analyze(event.value)
            length += len(self.analysis.scalar)
        return length < 128 and (
            event.kind == "alias"
            or (event.kind == "scalar" and not self.analysis.empty
                and not self.analysis.multiline)
            or (event.kind in ("seq-start", "map-start")
                and self.is_empty(event)))

    # -- tags and scalar styles ----------------------------------------------
    @staticmethod
    def tag_text(tag: str) -> str:
        if tag.startswith(_TAG) and len(tag) > len(_TAG):
            return "!!" + tag[len(_TAG):]
        return "!<%s>" % tag

    def process_tag(self, event: _Event) -> None:
        if event.kind == "scalar":
            if self.style is None:
                self.style = self.choose_style(event)
            if (self.style == "" and event.implicit[0]) or (
                    self.style != "" and event.implicit[1]):
                return
        elif event.kind in ("seq-start", "map-start"):
            if event.implicit:
                return
        else:
            return
        self.write_indicator(self.tag_text(event.tag), True)

    def choose_style(self, event: _Event) -> str:
        if self.analysis is None:
            self.analysis = _analyze(event.value)
        a = self.analysis
        if event.style == "|":  # only !!binary asks for it
            if not self.simple_key and a.allow_block:
                return "|"
            return '"'
        if event.implicit[0] and not (
                self.simple_key and (a.empty or a.multiline)) \
                and a.allow_block_plain:
            return ""
        if a.allow_single_quoted and not (self.simple_key and a.multiline):
            return "'"
        return '"'

    def process_scalar(self, event: _Event) -> None:
        if self.analysis is None:
            self.analysis = _analyze(event.value)
        if self.style is None:
            self.style = self.choose_style(event)
        split = not self.simple_key
        text = self.analysis.scalar
        if self.style == "|":
            self.write_literal(text)
        elif self.style == '"':
            self.write_double_quoted(text, split)
        elif self.style == "'":
            self.write_single_quoted(text, split)
        else:
            self.write_plain(text, split)
        self.analysis = None
        self.style = None

    # -- writing ----------------------------------------------------------------
    def write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def write_indicator(self, indicator: str, need_whitespace: bool,
                        whitespace: bool = False,
                        indention: bool = False) -> None:
        data = indicator if self.whitespace or not need_whitespace \
            else " " + indicator
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self.open_ended = False
        self.write(data)

    def write_indent(self) -> None:
        indent = self.indent or 0
        if not self.indention or self.column > indent or (
                self.column == indent and not self.whitespace):
            self.write_line_break()
        if self.column < indent:
            self.whitespace = True
            self.write(" " * (indent - self.column))

    def write_line_break(self, data: str = "\n") -> None:
        self.whitespace = self.indention = True
        self.column = 0
        self.out.append(data)

    def write_breaks(self, text: str) -> None:
        for br in text:
            self.write_line_break("\n" if br == "\n" else br)

    def write_plain(self, text: str, split: bool) -> None:
        if self.root:
            self.open_ended = True
        if not text:
            return
        if not self.whitespace:
            self.write(" ")
        self.whitespace = self.indention = False
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if start + 1 == end and self.column > self.WIDTH and split:
                        self.write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch not in "\n\x85\u2028\u2029":
                    if text[start] == "\n":
                        self.write_line_break()
                    self.write_breaks(text[start:end])
                    self.write_indent()
                    self.whitespace = self.indention = False
                    start = end
            elif ch is None or ch in " \n\x85\u2028\u2029":
                self.write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
                breaks = ch in "\n\x85\u2028\u2029"
            end += 1

    def write_literal(self, text: str) -> None:
        hints = ""
        if text:
            if text[0] in " \n\x85\u2028\u2029":
                hints += "2"
            if text[-1] not in "\n\x85\u2028\u2029":
                hints += "-"
            elif len(text) == 1 or text[-2] in "\n\x85\u2028\u2029":
                hints += "+"
        self.write_indicator("|" + hints, True)
        if hints[-1:] == "+":
            self.open_ended = True
        self.write_line_break()
        breaks = True
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if breaks:
                if ch is None or ch not in "\n\x85\u2028\u2029":
                    self.write_breaks(text[start:end])
                    if ch is not None:
                        self.write_indent()
                    start = end
            elif ch is None or ch in "\n\x85\u2028\u2029":
                self.out.append(text[start:end])
                if ch is None:
                    self.write_line_break()
                start = end
            if ch is not None:
                breaks = ch in "\n\x85\u2028\u2029"
            end += 1

    def write_single_quoted(self, text: str, split: bool) -> None:
        self.write_indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if start + 1 == end and self.column > self.WIDTH and \
                            split and start != 0 and end != len(text):
                        self.write_indent()
                    else:
                        self.write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in "\n\x85\u2028\u2029":
                    if text[start] == "\n":
                        self.write_line_break()
                    self.write_breaks(text[start:end])
                    self.write_indent()
                    start = end
            elif ch is None or ch in " \n\x85\u2028\u2029" or ch == "'":
                if start < end:
                    self.write(text[start:end])
                    start = end
            if ch == "'":
                self.write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in "\n\x85\u2028\u2029"
            end += 1
        self.write_indicator("'", False)

    def write_double_quoted(self, text: str, split: bool) -> None:
        self.write_indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if ch is None or ch in '"\\\x85\u2028\u2029\ufeff' or \
                    not "\x20" <= ch <= "\x7E":
                if start < end:
                    self.write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _DQ_ESCAPES:
                        data = "\\" + _DQ_ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uffff":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self.write(data)
                    start = end + 1
            if 0 < end < len(text) - 1 and (ch == " " or start >= end) and \
                    self.column + (end - start) > self.WIDTH and split:
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self.write(data)
                self.write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self.write("\\")
            end += 1
        self.write_indicator('"', False)


def dump_yaml(obj: Any) -> str:
    """``yaml.dump(obj, default_flow_style=False)``, byte for byte."""
    events = _serialize(_represent(obj, {}))
    return _Emitter(events).run()
