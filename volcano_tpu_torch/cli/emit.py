"""A YAML emitter for the JSON values the service's API returns.

``safe_dump(data)`` gives what ``yaml.safe_dump(data, sort_keys=False)``
gives for a mapping or a sequence whose leaves are ``str``, ``int``,
``float``, ``bool`` and ``None``: block collections (a sequence inside a
mapping not indented), ``{}`` / ``[]`` for empty ones, scalars plain where
YAML 1.1 would read them back as the same value, else single-quoted, else
double-quoted with escapes, folded at 80 columns the way PyYAML folds them.
The port carries no YAML library; ``vtpuctl job view`` prints through this.
Any other value raises ``TypeError``.
"""

from __future__ import annotations

import re
from typing import List, Optional

BEST_WIDTH = 80
BEST_INDENT = 2
_SPACE = "\0 \t\r\n\x85\u2028\u2029"
_BREAKS = "\n\x85\u2028\u2029"

# YAML 1.1's implicit types, by first character, as the safe loader
# resolves plain scalars: a string matching one of them must be quoted.
_IMPLICIT = [
    (re.compile(r"^(?:yes|Yes|YES|no|No|NO|true|True|TRUE|false|False|FALSE"
                r"|on|On|ON|off|Off|OFF)$"), "yYnNtTfFoO"),
    (re.compile(r"^(?:[-+]?(?:[0-9][0-9_]*)\.[0-9_]*(?:[eE][-+][0-9]+)?"
                r"|\.[0-9][0-9_]*(?:[eE][-+][0-9]+)?"
                r"|[-+]?[0-9][0-9_]*(?::[0-5]?[0-9])+\.[0-9_]*"
                r"|[-+]?\.(?:inf|Inf|INF)|\.(?:nan|NaN|NAN))$"),
     "-+0123456789."),
    (re.compile(r"^(?:[-+]?0b[0-1_]+|[-+]?0[0-7_]+|[-+]?(?:0|[1-9][0-9_]*)"
                r"|[-+]?0x[0-9a-fA-F_]+|[-+]?[1-9][0-9_]*(?::[0-5]?[0-9])+)$"),
     "-+0123456789"),
    (re.compile(r"^(?:<<)$"), "<"),
    (re.compile(r"^(?:~|null|Null|NULL)$"), "~nN"),
    (re.compile(r"^(?:[0-9][0-9][0-9][0-9]-[0-9][0-9]-[0-9][0-9]"
                r"|[0-9][0-9][0-9][0-9]-[0-9][0-9]?-[0-9][0-9]?"
                r"(?:[Tt]|[ \t]+)[0-9][0-9]?:[0-9][0-9]:[0-9][0-9]"
                r"(?:\.[0-9]*)?(?:[ \t]*(?:Z|[-+][0-9][0-9]?"
                r"(?::[0-9][0-9])?))?)$"), "0123456789"),
    (re.compile(r"^(?:=)$"), "="),
]

_ESCAPES = {"\0": "0", "\x07": "a", "\x08": "b", "\x09": "t", "\x0A": "n",
            "\x0B": "v", "\x0C": "f", "\x0D": "r", "\x1B": "e", '"': '"',
            "\\": "\\", "\x85": "N", "\xA0": "_", "\u2028": "L",
            "\u2029": "P"}


def _text(value):
    """(text, plain-implicit) of a scalar, as PyYAML's safe representer
    writes it."""
    if value is None:
        return "null", True
    if value is True or value is False:
        return ("true" if value else "false"), True
    if isinstance(value, int):
        return str(value), True
    if isinstance(value, float):
        if value != value:
            return ".nan", True
        if value in (float("inf"), float("-inf")):
            return (".inf" if value > 0 else "-.inf"), True
        text = repr(value).lower()
        if "." not in text and "e" in text:
            text = text.replace("e", ".0e", 1)
        return text, True
    if isinstance(value, str):
        return value, _resolves_to_str(value)
    raise TypeError(f"cannot emit {type(value).__name__}")


def _resolves_to_str(text: str) -> bool:
    if text == "":
        return False
    for regexp, first in _IMPLICIT:
        if text[0] in first and regexp.match(text):
            return False
    return True


def _analyze(text: str) -> dict:
    """Which styles ``text`` allows (PyYAML ``Emitter.analyze_scalar``
    with ``allow_unicode`` off)."""
    if not text:
        return {"multiline": False, "plain": False, "single": True,
                "empty": True}
    block_ind = text.startswith(("---", "..."))
    line_breaks = special = False
    leading_space = leading_break = trailing_space = trailing_break = False
    break_space = space_break = False
    preceded_ws = True
    followed_ws = len(text) == 1 or text[1] in _SPACE
    prev_space = prev_break = False
    for index, ch in enumerate(text):
        if index == 0:
            if ch in "#,[]{}&*!|>'\"%@`":
                block_ind = True
            if ch in "?:" and followed_ws:
                block_ind = True
            if ch == "-" and followed_ws:
                block_ind = True
        else:
            if ch == ":" and followed_ws:
                block_ind = True
            if ch == "#" and preceded_ws:
                block_ind = True
        if ch in _BREAKS:
            line_breaks = True
        if not (ch == "\n" or "\x20" <= ch <= "\x7E"):
            special = True
        if ch == " ":
            if index == 0:
                leading_space = True
            if index == len(text) - 1:
                trailing_space = True
            if prev_break:
                break_space = True
            prev_space, prev_break = True, False
        elif ch in _BREAKS:
            if index == 0:
                leading_break = True
            if index == len(text) - 1:
                trailing_break = True
            if prev_space:
                space_break = True
            prev_space, prev_break = False, True
        else:
            prev_space = prev_break = False
        preceded_ws = ch in _SPACE
        followed_ws = index + 2 >= len(text) or text[index + 2] in _SPACE
    plain = not (leading_space or leading_break or trailing_space
                 or trailing_break or break_space or space_break or special
                 or line_breaks or block_ind)
    single = not (break_space or space_break or special)
    return {"multiline": line_breaks, "plain": plain, "single": single,
            "empty": False}


class _Emitter:
    def __init__(self):
        self.out: List[str] = []
        self.column = 0
        self.whitespace = True
        self.indention = True
        self.indent: Optional[int] = None
        self.indents: List[Optional[int]] = []

    # ---------------------------------------------------------- writers

    def _write(self, data: str) -> None:
        self.column += len(data)
        self.out.append(data)

    def _indicator(self, indicator, need_ws, whitespace=False,
                   indention=False):
        data = indicator if (self.whitespace or not need_ws) \
            else " " + indicator
        self.whitespace = whitespace
        self.indention = self.indention and indention
        self._write(data)

    def _line_break(self):
        self.whitespace = True
        self.indention = True
        self.column = 0
        self.out.append("\n")

    def _write_indent(self):
        indent = self.indent or 0
        if (not self.indention or self.column > indent
                or (self.column == indent and not self.whitespace)):
            self._line_break()
        if self.column < indent:
            self.whitespace = True
            self._write(" " * (indent - self.column))

    def _increase(self, flow=False, indentless=False):
        self.indents.append(self.indent)
        if self.indent is None:
            self.indent = BEST_INDENT if flow else 0
        elif not indentless:
            self.indent += BEST_INDENT

    # ---------------------------------------------------------- scalars

    def _plain(self, text, split):
        if not text:
            return
        if not self.whitespace:
            self._write(" ")
        self.whitespace = self.indention = False
        spaces = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch != " ":
                    if (start + 1 == end and self.column > BEST_WIDTH
                            and split):
                        self._write_indent()
                        self.whitespace = self.indention = False
                    else:
                        self._write(text[start:end])
                    start = end
            elif ch is None or ch in " " + _BREAKS:
                self._write(text[start:end])
                start = end
            if ch is not None:
                spaces = ch == " "
            end += 1

    def _single(self, text, split):
        self._indicator("'", True)
        spaces = breaks = False
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if spaces:
                if ch is None or ch != " ":
                    if (start + 1 == end and self.column > BEST_WIDTH
                            and split and start != 0 and end != len(text)):
                        self._write_indent()
                    else:
                        self._write(text[start:end])
                    start = end
            elif breaks:
                if ch is None or ch not in _BREAKS:
                    # Only "\n" gets here: the other breaks are special
                    # characters, which rule single quotes out.
                    if text[start] == "\n":
                        self._line_break()
                    for _ in text[start:end]:
                        self._line_break()
                    self._write_indent()
                    start = end
            else:
                if ch is None or ch in " " + _BREAKS or ch == "'":
                    if start < end:
                        self._write(text[start:end])
                        start = end
            if ch == "'":
                self._write("''")
                start = end + 1
            if ch is not None:
                spaces = ch == " "
                breaks = ch in _BREAKS
            end += 1
        self._indicator("'", False)

    def _double(self, text, split):
        self._indicator('"', True)
        start = end = 0
        while end <= len(text):
            ch = text[end] if end < len(text) else None
            if (ch is None or ch in '"\\\x85\u2028\u2029\uFEFF'
                    or not "\x20" <= ch <= "\x7E"):
                if start < end:
                    self._write(text[start:end])
                    start = end
                if ch is not None:
                    if ch in _ESCAPES:
                        data = "\\" + _ESCAPES[ch]
                    elif ch <= "\xFF":
                        data = "\\x%02X" % ord(ch)
                    elif ch <= "\uFFFF":
                        data = "\\u%04X" % ord(ch)
                    else:
                        data = "\\U%08X" % ord(ch)
                    self._write(data)
                    start = end + 1
            if (0 < end < len(text) - 1 and (ch == " " or start >= end)
                    and self.column + (end - start) > BEST_WIDTH and split):
                data = text[start:end] + "\\"
                if start < end:
                    start = end
                self._write(data)
                self._write_indent()
                self.whitespace = self.indention = False
                if text[start] == " ":
                    self._write("\\")
            end += 1
        self._indicator('"', False)

    def _scalar(self, value, simple_key):
        text, implicit = _text(value)
        a = _analyze(text)
        self._increase(flow=True)
        split = not simple_key
        if (implicit and a["plain"]
                and not (simple_key and (a["empty"] or a["multiline"]))):
            self._plain(text, split)
        elif a["single"] and not (simple_key and a["multiline"]):
            self._single(text, split)
        else:
            self._double(text, split)
        self.indent = self.indents.pop()

    # ------------------------------------------------------ collections

    def node(self, value, mapping=False, simple_key=False):
        if isinstance(value, dict):
            if not value:
                self._indicator("{", True, whitespace=True)
                self._indicator("}", False)
                return
            self._increase(flow=False)
            for key, val in value.items():
                self._write_indent()
                if isinstance(key, (dict, list, tuple)):
                    raise TypeError("a mapping key must be a scalar")
                text = _text(key)[0]
                if 0 < len(text) < 128 and not _analyze(text)["multiline"]:
                    self.node(key, mapping=True, simple_key=True)
                    self._indicator(":", False)
                else:
                    # A complex key: "? key" then ": value".
                    self._indicator("?", True, indention=True)
                    self.node(key, mapping=True)
                    self._write_indent()
                    self._indicator(":", True, indention=True)
                self.node(val, mapping=True)
            self.indent = self.indents.pop()
        elif isinstance(value, (list, tuple)):
            if not value:
                self._indicator("[", True, whitespace=True)
                self._indicator("]", False)
                return
            self._increase(flow=False,
                           indentless=mapping and not self.indention)
            for item in value:
                self._write_indent()
                self._indicator("-", True, indention=True)
                self.node(item)
            self.indent = self.indents.pop()
        else:
            self._scalar(value, simple_key)


def safe_dump(data) -> str:
    """``yaml.safe_dump(data, sort_keys=False)`` for a mapping or a
    sequence of JSON values."""
    if not isinstance(data, (dict, list, tuple)):
        raise TypeError("the document must be a mapping or a sequence")
    em = _Emitter()
    em.node(data)
    em._write_indent()
    return "".join(em.out)
