"""MeTTa knowledge-base parser (dependency-free).

Replaces the reference's PLY lexer+LALR grammar
(reference das/metta_lex.py, metta_yacc.py, base_yacc.py) with a
hand-rolled tokenizer and recursive-descent parser producing hash-identical
`Expression` records.  The grammar:

    START            -> TOP_LEVEL*
    TOP_LEVEL        -> '(' ':' NAME TYPE_DESIGNATOR ')'     (typedef)
                      | '(' EXPRESSION+ ')'                  (expression)
    EXPRESSION       -> '(' EXPRESSION+ ')' | SYMBOL | TERMINAL
    TERMINAL         -> '"' [^"]+ '"'
    SYMBOL           -> [^\\W0-9]\\w*            ('Type' is the basic type)

Hashing semantics (reference base_yacc.py:68-161):
  * typedef ``(: N D)``:   handle = md5-expr(h(':'), [h(N), h(D)]);
    registers N's parent type and, for terminals, N's named type.
  * terminal ``"n"`` of registered type T:  handle = md5("T n").
  * symbol ``S`` (head position): handle = its typedef's handle;
    named_type is S itself.
  * nested ``(S e1..ek)``:  handle = md5-expr(h(S), [handle(e1)..]);
    composite_type = [h(S), ct(e1).., ] with singleton lists unwrapped.

Forward references are legal: symbols/terminals/typedefs referring to
not-yet-defined names go onto pending lists resolved to a fixpoint at EOF
(reference base_yacc.py:163-201); anything still unresolved raises
`UndefinedSymbolError`.

Unlike the PLY machinery this parser is thread-safe and re-entrant (no
global parser tables), so the load pipeline needs no 10-second staggered
thread starts (reference distributed_atom_space.py:352-357).
"""

from __future__ import annotations

import re
from typing import Callable, List, Optional, Tuple

from das_tpu_torch.core.exceptions import MettaLexerError, MettaSyntaxError, UndefinedSymbolError
from das_tpu_torch.core.expression import Expression
from das_tpu_torch.core.hashing import ExpressionHasher
from das_tpu_torch.core.schema import BASIC_TYPE, TYPEDEF_MARK

#: the bare-SYMBOL token grammar — shared with convert/dump.py, which must
#: decide whether a typedef name can render unquoted
SYMBOL_PATTERN = r"[^\W0-9]\w*"

_TOKEN_RE = re.compile(
    r"""
    (?P<WS>[ \t]+)
  | (?P<NL>\n+)
  | (?P<OPEN>\()
  | (?P<CLOSE>\))
  | (?P<SETOPEN>\{)
  | (?P<SETCLOSE>\})
  | (?P<MARK>:)
  | (?P<TERMINAL>"[^"]+")
  | (?P<SYMBOL>"""
    + SYMBOL_PATTERN
    + r""")
    """,
    re.VERBOSE,
)

# token kinds
_OPEN, _CLOSE, _MARK, _TERMINAL, _SYMBOL, _SETOPEN, _SETCLOSE = range(7)


def tokenize(text: str):
    """Yield (kind, value, lineno) tuples; raises MettaLexerError on junk."""
    pos = 0
    lineno = 1
    n = len(text)
    while pos < n:
        m = _TOKEN_RE.match(text, pos)
        if m is None:
            near = text[pos : pos + 30]
            raise MettaLexerError(
                f"Illegal character at line {lineno}: '{text[pos]}' Near: '{near}...'"
            )
        pos = m.end()
        kind = m.lastgroup
        if kind == "WS":
            continue
        if kind == "NL":
            lineno += len(m.group())
            continue
        if kind == "OPEN":
            yield (_OPEN, "(", lineno)
        elif kind == "CLOSE":
            yield (_CLOSE, ")", lineno)
        elif kind == "SETOPEN":
            yield (_SETOPEN, "{", lineno)
        elif kind == "SETCLOSE":
            yield (_SETCLOSE, "}", lineno)
        elif kind == "MARK":
            yield (_MARK, TYPEDEF_MARK, lineno)
        elif kind == "TERMINAL":
            yield (_TERMINAL, m.group()[1:-1], lineno)
        else:
            yield (_SYMBOL, m.group(), lineno)


class SymbolTable:
    """Shared hashing caches (reference base_yacc.py:34-59).  May be shared
    across parser instances (e.g. incremental transaction commits reusing the
    store's accumulated type knowledge)."""

    def __init__(self):
        self.named_type_hash = {}   # type name -> md5
        self.named_types = {}       # defined name -> its type designator name
        self.symbol_hash = {}       # defined name -> typedef expression hash
        self.terminal_hash = {}     # (type, name) -> md5
        self.parent_type = {}       # type hash -> parent type hash
        #: optional fallback: terminal name -> type name for terminals the
        #: table has never parsed a declaration for.  The columnar ingest
        #: path sets this to a store probe (storage/columnar.py
        #: attach_columnar): it deliberately does NOT materialize millions
        #: of terminal symbols into these dicts, so a later transaction
        #: referencing a pre-loaded terminal (`(Inheritance "lion"
        #: "mammal")` style) resolves through the store instead of dying
        #: with UndefinedSymbolError.
        self.terminal_resolver = None
        basic = ExpressionHasher.named_type_hash(BASIC_TYPE)
        self.named_type_hash[BASIC_TYPE] = basic
        self.parent_type[basic] = basic

    def get_named_type_hash(self, name: str) -> str:
        h = self.named_type_hash.get(name)
        if h is None:
            h = ExpressionHasher.named_type_hash(name)
            self.named_type_hash[name] = h
        return h

    def get_terminal_hash(self, named_type: str, terminal_name: str) -> str:
        key = (named_type, terminal_name)
        h = self.terminal_hash.get(key)
        if h is None:
            h = ExpressionHasher.terminal_hash(named_type, terminal_name)
            self.terminal_hash[key] = h
        return h


class MettaParser:
    """Recursive-descent MeTTa parser with reference-identical hashing.

    Callbacks (all optional) mirror the reference ParserActions broker
    (reference das/parser_actions.py:7-31):
      on_typedef(expr)     — top-level ``(: N D)``
      on_terminal(expr)    — each terminal occurrence
      on_expression(expr)  — each non-toplevel nested expression
      on_toplevel(expr)    — each top-level regular expression
    """

    def __init__(
        self,
        symbol_table: Optional[SymbolTable] = None,
        on_typedef: Optional[Callable[[Expression], None]] = None,
        on_terminal: Optional[Callable[[Expression], None]] = None,
        on_expression: Optional[Callable[[Expression], None]] = None,
        on_toplevel: Optional[Callable[[Expression], None]] = None,
    ):
        self.table = symbol_table if symbol_table is not None else SymbolTable()
        self.on_typedef = on_typedef
        self.on_terminal = on_terminal
        self.on_expression = on_expression
        self.on_toplevel = on_toplevel
        self.pending_terminals: List[Tuple[str, Expression]] = []
        self.pending_symbols: List[Tuple[str, Expression]] = []
        self.pending_typedefs: List[Tuple[Tuple[str, str], Expression]] = []
        self.pending_expressions: List[Tuple[List[Expression], Expression]] = []
        # the implicit (: Type Type) root typedef
        root = self._typedef(BASIC_TYPE, BASIC_TYPE)
        if self.on_typedef:
            self.on_typedef(root)

    # -- hashing actions ---------------------------------------------------

    def _typedef(self, name: str, designator: str, expression: Optional[Expression] = None) -> Expression:
        if expression is None:
            expression = Expression()
        t = self.table
        designator_hash = t.named_type_hash.get(designator)
        if designator_hash is None:
            self.pending_typedefs.append(((name, designator), expression))
            return expression
        mark_hash = t.get_named_type_hash(TYPEDEF_MARK)
        name_hash = t.get_named_type_hash(name)
        t.parent_type[name_hash] = designator_hash
        t.named_types[name] = designator
        expression.typedef_name = name
        expression.typedef_name_hash = name_hash
        expression.named_type = TYPEDEF_MARK
        expression.named_type_hash = mark_hash
        expression.composite_type = [
            mark_hash,
            designator_hash,
            t.parent_type[designator_hash],
        ]
        expression.composite_type_hash = ExpressionHasher.composite_hash(
            expression.composite_type
        )
        expression.elements = [name_hash, designator_hash]
        expression.hash_code = ExpressionHasher.expression_hash(
            mark_hash, expression.elements
        )
        t.symbol_hash[name] = expression.hash_code
        return expression

    def _terminal(self, terminal_name: str, expression: Optional[Expression] = None) -> Expression:
        if expression is None:
            expression = Expression(terminal_name=terminal_name)
        t = self.table
        named_type = t.named_types.get(terminal_name)
        if named_type is None and t.terminal_resolver is not None:
            named_type = t.terminal_resolver(terminal_name)
            if named_type is not None:
                t.named_types[terminal_name] = named_type
        if named_type is None:
            self.pending_terminals.append((terminal_name, expression))
            return expression
        nth = t.get_named_type_hash(named_type)
        expression.named_type = named_type
        expression.named_type_hash = nth
        expression.composite_type = [nth]
        expression.composite_type_hash = nth
        expression.hash_code = t.get_terminal_hash(named_type, terminal_name)
        return expression

    def _symbol(self, name: str, expression: Optional[Expression] = None) -> Expression:
        if expression is None:
            expression = Expression()
        t = self.table
        named = t.named_types.get(name)
        if named is None and t.terminal_resolver is not None:
            # same store fallback as _terminal: a columnar-loaded
            # terminal's bare name must behave like it does on the
            # dict-backed loaders (which record every terminal)
            named = t.terminal_resolver(name)
            if named is not None:
                t.named_types[name] = named
        if named is None:
            self.pending_symbols.append((name, expression))
            return expression
        nth = t.get_named_type_hash(name)
        expression.symbol_name = name
        expression.named_type = name
        expression.named_type_hash = nth
        expression.composite_type = [nth]
        expression.composite_type_hash = nth
        h = t.symbol_hash.get(name)
        if h is None:
            # the canonical loaders record a terminal's TYPE without its
            # declaration hash (computing one md5 per terminal up front
            # would cost ~a minute at reference scale); the typedef
            # expression hash is a pure function of the names, so compute
            # it here — identical to what _typedef would have stored
            h = ExpressionHasher.expression_hash(
                t.get_named_type_hash(TYPEDEF_MARK),
                [nth, t.get_named_type_hash(t.named_types[name])],
            )
            t.symbol_hash[name] = h
        expression.hash_code = h
        return expression

    def _nested(self, subs: List[Expression], expression: Optional[Expression] = None, lineno: int = 0) -> Expression:
        if expression is None:
            expression = Expression()
        if any(s.hash_code is None for s in subs):
            self.pending_expressions.append((subs, expression))
            return expression
        head = subs[0]
        if head.named_type is None:
            raise MettaSyntaxError(
                f"Syntax error in line {lineno}: non-typed expressions are not supported"
            )
        expression.named_type = head.named_type
        expression.named_type_hash = head.named_type_hash
        expression.composite_type = [
            s.composite_type if len(s.composite_type) > 1 else s.composite_type[0]
            for s in subs
        ]
        expression.composite_type_hash = ExpressionHasher.composite_hash(
            [s.composite_type_hash for s in subs]
        )
        expression.elements = [s.hash_code for s in subs[1:]]
        expression.hash_code = ExpressionHasher.expression_hash(
            expression.named_type_hash, expression.elements
        )
        return expression

    # -- pending-symbol fixpoint (reference base_yacc.py:163-201) ----------

    def _revisit_pending(self):
        while True:
            pending = self.pending_typedefs
            self.pending_typedefs = []
            dirty = False
            for (name, designator), expr in pending:
                if self._typedef(name, designator, expr).hash_code is not None:
                    dirty = True
            if not dirty:
                break
        pending = self.pending_terminals
        self.pending_terminals = []
        for name, expr in pending:
            self._terminal(name, expr)
        pending = self.pending_symbols
        self.pending_symbols = []
        for name, expr in pending:
            self._symbol(name, expr)
        while True:
            pending = self.pending_expressions
            self.pending_expressions = []
            dirty = False
            for subs, expr in pending:
                if self._nested(subs, expr).hash_code is not None:
                    dirty = True
            if not dirty:
                break

    def _finish(self):
        self._revisit_pending()
        missing = [name for name, _ in self.pending_terminals]
        missing += [name for name, _ in self.pending_symbols]
        missing += [designator for (name, designator), _ in self.pending_typedefs]
        if missing:
            raise UndefinedSymbolError(sorted(set(missing)))
        assert not self.pending_expressions

    # -- recursive descent -------------------------------------------------

    def parse(self, text: str) -> str:
        tokens = list(tokenize(text))
        pos = 0
        n = len(tokens)

        def expect(kind):
            nonlocal pos
            if pos >= n or tokens[pos][0] != kind:
                got = tokens[pos] if pos < n else ("EOF", "EOF", -1)
                raise MettaSyntaxError(
                    f"Syntax error in line {got[2]}: unexpected token {got[1]!r}"
                )
            tok = tokens[pos]
            pos += 1
            return tok

        def parse_expr(toplevel: bool) -> Expression:
            nonlocal pos
            kind, value, lineno = tokens[pos]
            if kind == _TERMINAL:
                pos += 1
                expr = self._terminal(value)
                if self.on_terminal:
                    self.on_terminal(expr)
                return expr
            if kind == _SYMBOL:
                pos += 1
                return self._symbol(value)
            if kind == _SETOPEN:
                # `{a b ...}` multiset sugar (the atomese2metta converter's
                # MSet output, reference translator.py:63-71) — parsed as a
                # `Set` expression, the unordered link type
                pos += 1
                subs = [self._symbol("Set")]
                while pos < n and tokens[pos][0] != _SETCLOSE:
                    subs.append(parse_expr(False))
                expect(_SETCLOSE)
                if len(subs) == 1:
                    raise MettaSyntaxError(
                        f"Syntax error in line {lineno}: empty multiset"
                    )
                expr = self._nested(subs, lineno=lineno)
                expr.toplevel = toplevel
                if toplevel and self.on_toplevel:
                    self.on_toplevel(expr)
                elif not toplevel and self.on_expression:
                    self.on_expression(expr)
                return expr
            if kind != _OPEN:
                raise MettaSyntaxError(
                    f"Syntax error in line {lineno}: unexpected token {value!r}"
                )
            pos += 1  # consume '('
            if pos < n and tokens[pos][0] == _MARK:
                # typedef — legal only at top level (reference metta_yacc.py:137-149)
                if not toplevel:
                    raise MettaSyntaxError(
                        f"Error in line {tokens[pos][2]}: invalid nested type definition"
                    )
                pos += 1
                k, name, ln = tokens[pos]
                if k not in (_SYMBOL, _TERMINAL):
                    raise MettaSyntaxError(
                        f"Syntax error in line {ln}: bad typedef name {name!r}"
                    )
                pos += 1
                k, designator, ln = tokens[pos]
                if k != _SYMBOL:
                    raise MettaSyntaxError(
                        f"Syntax error in line {ln}: bad type designator {designator!r}"
                    )
                pos += 1
                if designator == BASIC_TYPE:
                    bh = self.table.get_named_type_hash(BASIC_TYPE)
                    self.table.parent_type[bh] = bh
                expect(_CLOSE)
                expr = self._typedef(name, designator)
                expr.toplevel = True
                if self.on_typedef:
                    self.on_typedef(expr)
                return expr
            subs = []
            while pos < n and tokens[pos][0] != _CLOSE:
                subs.append(parse_expr(False))
            expect(_CLOSE)
            if not subs:
                raise MettaSyntaxError(f"Syntax error in line {lineno}: empty expression")
            expr = self._nested(subs, lineno=lineno)
            expr.toplevel = toplevel
            if toplevel:
                if self.on_toplevel:
                    self.on_toplevel(expr)
            else:
                if self.on_expression:
                    self.on_expression(expr)
            return expr

        while pos < n:
            parse_expr(True)
        self._finish()
        return "SUCCESS"

    def parse_file(self, path: str) -> str:
        with open(path, "r") as fh:
            return self.parse(fh.read())

    def check(self, text: str) -> str:
        """Syntax-check only (no hashing side effects leak: uses a scratch
        parser on a copied symbol table).  type(self): a subclass (the
        Atomese parser) must check with ITS grammar, not MeTTa's."""
        scratch = type(self)()
        scratch.table.named_type_hash.update(self.table.named_type_hash)
        scratch.table.named_types.update(self.table.named_types)
        scratch.table.symbol_hash.update(self.table.symbol_hash)
        scratch.table.parent_type.update(self.table.parent_type)
        # columnar stores resolve pre-loaded terminals through the store
        # probe, never through named_types — a check() without it would
        # reject commits the real parse accepts
        scratch.table.terminal_resolver = self.table.terminal_resolver
        return scratch.parse(text)


def knowledge_base_file_list(source: str) -> List[str]:
    """File-or-directory expansion to the `.metta` files of a knowledge
    base (reference distributed_atom_space.py:81-99)."""
    import os

    if os.path.isfile(source):
        answer = [source]
    elif os.path.isdir(source):
        answer = [os.path.join(source, f) for f in sorted(os.listdir(source))]
    else:
        raise ValueError(f"Invalid knowledge base path: {source}")
    answer = [f for f in answer if f.endswith(".metta")]
    if not answer:
        raise ValueError(f"No MeTTa files found in {source}")
    return answer


def load_knowledge_base(data, source: str):
    """Parse the `.metta` file(s) at `source` into the AtomSpaceData."""
    from das_tpu_torch.storage.atom_table import load_metta_file

    for path in knowledge_base_file_list(source):
        load_metta_file(path, data)
    return data
