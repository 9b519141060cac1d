"""Canonical (fast-path) knowledge-base loader.

Loads normalized one-expression-per-line MeTTa files (the format produced
by automated converters — see the assumptions documented at
reference das/distributed_atom_space.py:366-402) without the general
tokenizer: a three-state line scanner (types → terminals → expressions)
plus a single-pass char-level expression parser that computes all hashes
inline (role of reference das/canonical_parser.py:242-365).

Canonical-format specifics:
  * typedef lines   ``(: Name Type)`` then ``(: "terminal name" Type)``
  * expression terminals are written ``"Type name"`` (type prefix inside
    the quotes) so terminal hashes need no symbol-table lookup;
  * flat type hierarchy; no forward references.

Unlike the reference (which re-scans MongoDB afterwards to emit four
kv-files, external-sorts them with sort(1) and SADDs Redis), results land
directly in `AtomSpaceData`; all indexes are derived tensors built by
`finalize()`.  A C++ implementation of this scanner (native/src/) is the
default route of the pipeline — see ingest/native.py.
"""

from __future__ import annotations

import re
from typing import List, Optional

from das_tpu_torch.core.expression import Expression
from das_tpu_torch.core.hashing import ExpressionHasher
from das_tpu_torch.core.schema import BASIC_TYPE, TYPEDEF_MARK
from das_tpu_torch.storage.atom_table import AtomSpaceData

_ASCII_WS = " \t\r\n\f\v"
_ASCII_WS_RE = re.compile(f"[{re.escape(_ASCII_WS)}]+")


class CanonicalParseError(Exception):
    """Base for canonical-loader failures — one contract whether the
    Python scanner or the native C++ scanner (ingest/native.py) ran."""


class CanonicalFormatError(CanonicalParseError):
    def __init__(self, lineno: int, line: str, reason: str):
        super().__init__(f"line {lineno}: {reason}: {line!r}")


class CanonicalLoader:
    _S_TYPES, _S_TERMINALS, _S_EXPRESSIONS = range(3)

    def __init__(self, data: Optional[AtomSpaceData] = None):
        self.data = data if data is not None else AtomSpaceData()
        self._mark_hash = ExpressionHasher.named_type_hash(TYPEDEF_MARK)
        self._base_hash = ExpressionHasher.named_type_hash(BASIC_TYPE)
        self._state = self._S_TYPES

    # -- records -----------------------------------------------------------

    def _typedef(self, name: str, stype: str) -> None:
        t = self.data.table
        stype_hash = t.get_named_type_hash(stype)
        name_hash = t.get_named_type_hash(name)
        t.named_types[name] = stype
        t.parent_type[name_hash] = stype_hash
        composite = [self._mark_hash, stype_hash, self._base_hash]
        expr = Expression(
            toplevel=True,
            typedef_name=name,
            typedef_name_hash=name_hash,
            named_type=TYPEDEF_MARK,
            named_type_hash=self._mark_hash,
            composite_type=composite,
            composite_type_hash=ExpressionHasher.composite_hash(list(composite)),
            elements=[name_hash, stype_hash],
        )
        expr.hash_code = ExpressionHasher.expression_hash(
            self._mark_hash, expr.elements
        )
        t.symbol_hash[name] = expr.hash_code
        self.data.add_typedef(expr)

    def _terminal(self, name: str, stype: str) -> None:
        t = self.data.table
        stype_hash = t.get_named_type_hash(stype)
        # record the terminal's type like the MeTTa parser does on a
        # `(: "name" Type)` declaration: a LATER transaction referencing
        # this terminal by bare name must resolve (last declaration wins)
        t.named_types[name] = stype
        expr = Expression(
            terminal_name=name,
            named_type=stype,
            named_type_hash=stype_hash,
            composite_type=[stype_hash],
            composite_type_hash=stype_hash,
            hash_code=t.get_terminal_hash(stype, name),
        )
        self.data.add_terminal(expr)

    def _emit_link(self, named_type, elements, composite_type, composite_type_hash, toplevel) -> str:
        named_type_hash = self.data.table.get_named_type_hash(named_type)
        hash_code = ExpressionHasher.expression_hash(named_type_hash, elements)
        self.data.add_link(
            Expression(
                toplevel=toplevel,
                named_type=named_type,
                named_type_hash=named_type_hash,
                composite_type=composite_type,
                composite_type_hash=composite_type_hash,
                elements=list(elements),
                hash_code=hash_code,
            )
        )
        return hash_code

    # -- the char-level expression scanner ---------------------------------

    def parse_expression_line(self, line: str, lineno: int = 0) -> None:
        """One canonical expression: heads are bare symbols, targets are
        quoted ``"Type name"`` terminals or nested expressions."""
        # each open frame: [head_symbol, elements, composite_type, ct_hashes]
        frames: List[list] = []
        i, n = 0, len(line)
        token: List[str] = []
        result_emitted = False

        def close_token():
            if token:
                sym = "".join(token)
                token.clear()
                if not frames or frames[-1][0] is not None:
                    raise CanonicalFormatError(
                        lineno, line, f"unexpected symbol {sym!r}"
                    )
                frames[-1][0] = sym

        while i < n:
            c = line[i]
            if c == "(":
                close_token()
                frames.append([None, [], [], []])
            elif c == ")":
                close_token()
                if not frames:
                    raise CanonicalFormatError(lineno, line, "unbalanced ')'")
                head, elements, ctypes, cthashes = frames.pop()
                if head is None:
                    raise CanonicalFormatError(lineno, line, "headless expression")
                head_hash = self.data.table.get_named_type_hash(head)
                composite_type = [head_hash, *ctypes]
                composite_type_hash = ExpressionHasher.composite_hash(
                    [head_hash, *cthashes]
                )
                toplevel = not frames
                h = self._emit_link(
                    head, elements, composite_type, composite_type_hash, toplevel
                )
                if frames:
                    frames[-1][1].append(h)
                    frames[-1][2].append(composite_type)
                    frames[-1][3].append(composite_type_hash)
                else:
                    result_emitted = True
            elif c == '"':
                j = i + 1
                while j < n and not (line[j] == '"' and line[j - 1] != "\\"):
                    j += 1
                if j >= n:
                    raise CanonicalFormatError(lineno, line, "unterminated string")
                body = line[i + 1 : j]
                parts = body.split(" ", 1)
                if len(parts) != 2 or not frames:
                    raise CanonicalFormatError(
                        lineno, line, f"bad canonical terminal {body!r}"
                    )
                stype, name = parts
                stype_hash = self.data.table.get_named_type_hash(stype)
                frames[-1][1].append(
                    self.data.table.get_terminal_hash(stype, name)
                )
                frames[-1][2].append(stype_hash)
                frames[-1][3].append(stype_hash)
                i = j
            elif c == " ":
                close_token()
            else:
                token.append(c)
            i += 1
        if frames or not result_emitted:
            raise CanonicalFormatError(lineno, line, "unbalanced expression")

    # -- the line-state machine --------------------------------------------

    def parse_lines(self, lines) -> None:
        # per-file state reset (reference canonical_parser.py:324 sets
        # READING_TYPES at the top of every parse(); the canonical-format
        # contract is per-file — distributed_atom_space.py:372-375)
        self._state = self._S_TYPES
        for lineno, raw in enumerate(lines, 1):
            # ASCII whitespace only: matches both the native C++ scanner
            # and the reference's char-level parser (canonical_parser.py
            # :242-305 compares against literal ' '), so a name containing
            # a Unicode space byte sequence hashes identically everywhere
            line = raw.strip(_ASCII_WS)
            if not line:
                continue
            parts = [p for p in _ASCII_WS_RE.split(line) if p]
            if self._state == self._S_TYPES:
                if parts[0] != "(:":
                    raise CanonicalFormatError(lineno, line, "expected typedef")
                if len(parts) < 2:
                    raise CanonicalFormatError(lineno, line, "bad typedef")
                if parts[1].startswith('"'):
                    self._state = self._S_TERMINALS
                else:
                    if len(parts) != 3:
                        raise CanonicalFormatError(lineno, line, "bad typedef")
                    self._typedef(parts[1], parts[-1].rstrip(")"))
                    continue
            if self._state == self._S_TERMINALS:
                if parts[0] == "(:":
                    name = " ".join(parts[1:-1]).strip('"')
                    self._terminal(name, parts[-1].rstrip(")"))
                    continue
                self._state = self._S_EXPRESSIONS
            if self._state == self._S_EXPRESSIONS:
                if parts[0] == "(:" or not (
                    line.startswith("(") and line.endswith(")")
                ):
                    raise CanonicalFormatError(lineno, line, "bad expression line")
                self.parse_expression_line(line, lineno)

    def parse_file(self, path: str) -> None:
        with open(path, "r") as fh:
            self.parse_lines(fh)

    def parse_text(self, text: str) -> None:
        self.parse_lines(text.splitlines())


def load_canonical_file(path: str, data: Optional[AtomSpaceData] = None) -> AtomSpaceData:
    loader = CanonicalLoader(data)
    loader.parse_file(path)
    return loader.data


def load_canonical_text(text: str, data: Optional[AtomSpaceData] = None) -> AtomSpaceData:
    loader = CanonicalLoader(data)
    loader.parse_text(text)
    return loader.data
