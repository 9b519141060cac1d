"""Atomese (.scm, OpenCog scheme) parser — dependency-free.

Same behavior as the reference PLY pair
(reference das/atomese_lex.py, atomese_yacc.py):

  * type names lose a trailing ``Node``/``Link`` suffix
    (``ConceptNode`` → ``Concept``);
  * ``(stv 0.9 0.8)`` truth-value sub-expressions are skipped;
  * node names become ``"{Type}:{name}"`` terminals;
  * typedefs are auto-generated on first sight of each type / node
    (every type inherits directly from Type);
  * ``;`` comments ignored.

Reuses the MettaParser hashing actions (ingest/metta.py) so handles are
identical to what the reference produces for the same .scm input.
"""

from __future__ import annotations

import re
from typing import List, Optional

from das_tpu_torch.core.exceptions import AtomeseLexerError, AtomeseSyntaxError
from das_tpu_torch.core.expression import Expression
from das_tpu_torch.core.schema import BASIC_TYPE
from das_tpu_torch.ingest.metta import MettaParser, SymbolTable

_TOKEN_RE = re.compile(
    r"""
    (?P<WS>[ \t]+)
  | (?P<NL>\n+)
  | (?P<COMMENT>;[^\n]*)
  | (?P<OPEN>\()
  | (?P<CLOSE>\))
  | (?P<NAME>"[^"]+")
  | (?P<FLOAT>\d+\.\d+)
  | (?P<TYPE>[^\W0-9]\w*)
    """,
    re.VERBOSE,
)

_OPEN, _CLOSE, _NAME, _FLOAT, _TYPE, _STV = range(6)


def tokenize(text: str):
    pos, lineno, n = 0, 1, len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            near = text[pos : pos + 30]
            raise AtomeseLexerError(
                f"Illegal character at line {lineno}: '{text[pos]}' Near: '{near}...'"
            )
        pos = m.end()
        kind = m.lastgroup
        if kind in ("WS", "COMMENT"):
            continue
        if kind == "NL":
            lineno += len(m.group())
            continue
        if kind == "OPEN":
            yield (_OPEN, "(", lineno)
        elif kind == "CLOSE":
            yield (_CLOSE, ")", lineno)
        elif kind == "NAME":
            yield (_NAME, m.group()[1:-1], lineno)
        elif kind == "FLOAT":
            yield (_FLOAT, m.group(), lineno)
        else:
            value = m.group()
            if value in ("STV", "stv"):
                yield (_STV, value, lineno)
            else:
                if value.endswith("Node") or value.endswith("Link"):
                    value = value[:-4]
                yield (_TYPE, value, lineno)


class AtomeseParser(MettaParser):
    """Recursive-descent Atomese parser on top of the MeTTa hashing core."""

    def __init__(self, symbol_table: Optional[SymbolTable] = None, **callbacks):
        super().__init__(symbol_table=symbol_table, **callbacks)
        self._seen_types = set()
        self._seen_nodes = set()

    def _ensure_type(self, type_name: str) -> None:
        if type_name in self._seen_types:
            return
        self._seen_types.add(type_name)
        expr = self._typedef(type_name, BASIC_TYPE)
        expr.toplevel = True
        if self.on_typedef:
            self.on_typedef(expr)

    def _node(self, node_type: str, node_name: str) -> Expression:
        self._ensure_type(node_type)
        terminal_name = f"{node_type}:{node_name}"
        if terminal_name not in self._seen_nodes:
            self._seen_nodes.add(terminal_name)
            expr = self._typedef(terminal_name, node_type)
            expr.toplevel = True
            if self.on_typedef:
                self.on_typedef(expr)
            terminal = self._terminal(terminal_name)
            if self.on_terminal:
                self.on_terminal(terminal)
            return terminal
        return self._terminal(terminal_name)

    def parse(self, text: str) -> str:
        tokens = list(tokenize(text))
        pos, n = 0, len(tokens)

        def fail(msg, tok):
            raise AtomeseSyntaxError(f"Syntax error in line {tok[2]}: {msg}")

        def parse_atom(toplevel: bool) -> Expression:
            nonlocal pos
            tok = tokens[pos]
            if tok[0] != _OPEN:
                fail(f"expected '(' got {tok[1]!r}", tok)
            pos += 1
            tok = tokens[pos]
            if tok[0] != _TYPE:
                fail(f"expected atom type got {tok[1]!r}", tok)
            atom_type = tok[1]
            pos += 1
            # node?
            if tokens[pos][0] == _NAME:
                node_name = tokens[pos][1]
                pos += 1
                if tokens[pos][0] != _CLOSE:
                    fail("expected ')' after node name", tokens[pos])
                pos += 1
                return self._node(atom_type, node_name)
            # link: optional stv sub-expression, then target atoms
            targets: List[Expression] = []
            while tokens[pos][0] != _CLOSE:
                if (
                    tokens[pos][0] == _OPEN
                    and pos + 1 < n
                    and tokens[pos + 1][0] == _STV
                ):
                    # skip (stv f f)
                    pos += 2
                    while tokens[pos][0] == _FLOAT:
                        pos += 1
                    if tokens[pos][0] != _CLOSE:
                        fail("bad stv definition", tokens[pos])
                    pos += 1
                    continue
                targets.append(parse_atom(False))
            pos += 1  # consume ')'
            if not targets:
                fail(f"link {atom_type} with no targets", tok)
            self._ensure_type(atom_type)
            head = self._symbol(atom_type)
            expr = self._nested([head, *targets])
            for target in targets:
                if target.elements is not None and self.on_expression:
                    self.on_expression(target)
            expr.toplevel = toplevel
            if toplevel and expr.elements is not None and self.on_toplevel:
                self.on_toplevel(expr)
            return expr

        while pos < n:
            parse_atom(True)
        self._finish()
        return "SUCCESS"
