"""STEP / ISO-10303-21 parser — toolkit/step.{h,cc} equivalent.

Tokenizes and parses the exchange structure of a STEP Part 21 file into
header records and a data-section entity map {id: (type, args)}, with
nested argument lists, typed references (#id), enumerations (.ENUM.),
strings, and numbers.  Errors raise StepError (the reference uses an
exception error model here too, toolkit/step.h:20-55).

A copy of `eggshell_tpu.utils.step_parser` (pure Python).
"""

from __future__ import annotations

import dataclasses
import re
from typing import Any, Dict, List, Tuple


class StepError(ValueError):
    pass


@dataclasses.dataclass
class Ref:
    id: int

    def __repr__(self):
        return f"#{self.id}"


@dataclasses.dataclass
class Enum:
    name: str

    def __repr__(self):
        return f".{self.name}."


_TOKEN = re.compile(
    r"""
    (?P<ws>\s+)
  | (?P<comment>/\*.*?\*/)
  | (?P<string>'(?:[^']|'')*')
  | (?P<ref>\#\d+)
  | (?P<enum>\.[A-Za-z0-9_]+\.)
  | (?P<number>[+-]?\d+(?:\.\d*)?(?:[eE][+-]?\d+)?)
  | (?P<name>[A-Za-z_][A-Za-z0-9_-]*)
  | (?P<punct>[=();,*$])
    """,
    re.VERBOSE | re.DOTALL,
)


def _tokenize(text: str) -> List[Tuple[str, str]]:
    out = []
    pos = 0
    while pos < len(text):
        m = _TOKEN.match(text, pos)
        if not m:
            raise StepError(f"bad character at offset {pos}: {text[pos:pos+20]!r}")
        pos = m.end()
        kind = m.lastgroup
        if kind in ("ws", "comment"):
            continue
        out.append((kind, m.group()))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i] if self.i < len(self.toks) else ("eof", "")

    def next(self):
        t = self.peek()
        self.i += 1
        return t

    def expect(self, value):
        kind, v = self.next()
        if v != value:
            raise StepError(f"expected {value!r}, got {v!r}")

    def parse_value(self) -> Any:
        kind, v = self.next()
        if kind == "string":
            return v[1:-1].replace("''", "'")
        if kind == "ref":
            return Ref(int(v[1:]))
        if kind == "enum":
            return Enum(v[1:-1])
        if kind == "number":
            return float(v) if any(c in v for c in ".eE") else int(v)
        if kind == "name":
            # typed value: NAME(args)
            if self.peek()[1] == "(":
                return (v, self.parse_list())
            return v
        if v == "(":
            self.i -= 1
            return self.parse_list()
        if v == "*":
            return "*"
        if v == "$":
            return None
        raise StepError(f"unexpected token {v!r}")

    def parse_list(self) -> List[Any]:
        self.expect("(")
        out = []
        if self.peek()[1] == ")":
            self.next()
            return out
        while True:
            out.append(self.parse_value())
            kind, v = self.next()
            if v == ")":
                return out
            if v != ",":
                raise StepError(f"expected , or ), got {v!r}")


@dataclasses.dataclass
class StepFile:
    header: List[Tuple[str, List[Any]]]
    entities: Dict[int, Tuple[str, List[Any]]]

    def of_type(self, name: str) -> Dict[int, List[Any]]:
        name = name.upper()
        return {
            i: args for i, (t, args) in self.entities.items() if t == name
        }


def parse_step(text: str) -> StepFile:
    toks = _tokenize(text)
    p = _Parser(toks)
    kind, v = p.next()
    if v != "ISO-10303-21":
        raise StepError("not a STEP Part 21 file")
    p.expect(";")

    header: List[Tuple[str, List[Any]]] = []
    entities: Dict[int, Tuple[str, List[Any]]] = {}
    section = None
    while True:
        kind, v = p.next()
        if kind == "eof":
            raise StepError("unexpected end of file")
        if v == "HEADER":
            p.expect(";")
            section = "header"
            continue
        if v == "DATA":
            p.expect(";")
            section = "data"
            continue
        if v == "ENDSEC":
            p.expect(";")
            section = None
            continue
        if v == "END-ISO-10303-21":
            p.expect(";")
            break
        if section == "header":
            args = p.parse_list()
            p.expect(";")
            header.append((v, args))
        elif section == "data":
            if kind != "ref":
                raise StepError(f"expected #id in DATA, got {v!r}")
            eid = int(v[1:])
            p.expect("=")
            kind2, name = p.next()
            args = p.parse_list()
            p.expect(";")
            entities[eid] = (name.upper(), args)
        else:
            raise StepError(f"unexpected {v!r} outside a section")
    return StepFile(header=header, entities=entities)


def parse_step_file(path: str) -> StepFile:
    with open(path) as f:
        return parse_step(f.read())
