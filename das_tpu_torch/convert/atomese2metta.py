"""Atomese (.scm) → MeTTa document converter.

Role of reference das/atomese2metta/translator.py:100-266, built
over a single streaming s-expression walker instead of the reference's
Expression/AtomType object zoo:

* link/node **type whitelists** (same type names, with and without the
  ``Node``/``Link`` suffix) — unknown symbols raise `InvalidSymbol`;
* ``Node``/``Link`` suffixes stripped from type names
  (translator.py:183-184);
* ``SetLink`` → MeTTa multiset braces ``{...}`` (translator.py:63-71);
* ``stv`` truth-value annotations skipped (IGNORED_SYMBOLS,
  translator.py:134);
* node typedefs ``(: Concept Type)`` + node declarations
  ``(: "name" Concept)`` emitted before the body, deduplicated in first-
  seen order (MettaDocument.expressions, translator.py:232-239).

Output loads directly through `das_tpu_torch.ingest.metta.MettaParser`.
"""

from __future__ import annotations

import re
from typing import Iterable, List, Optional, Tuple, Union

from das_tpu_torch.core.exceptions import DasError

ALLOWED_LINKS = (
    "ContextLink",
    "EvaluationLink",
    "InheritanceLink",
    "ListLink",
    "MemberLink",
    "SetLink",
    "SimilarityLink",
    "LazyExecutionOutputLink",
)

ALLOWED_NODES = (
    "CellNode",
    "ChebiNode",
    "ChebiOntologyNode",
    "PredicateNode",
    "BiologicalProcessNode",
    "CellularComponentNode",
    "ConceptNode",
    "MolecularFunctionNode",
    "NcbiTaxonomyNode",
    "GeneNode",
    "ReactomeNode",
    "SmpNode",
    "UberonNode",
    "EntrezNode",
    "EnstNode",
    "UniprotNode",
    "RefseqNode",
    "PharmGkbNode",
    "SchemaNode",
    "PatientNode",
)

IGNORED_SYMBOLS = ("stv",)

_SUFFIX = re.compile(r"\s*(Node|Link)$")


class InvalidSymbol(DasError):
    pass


def strip_suffix(symbol: str) -> str:
    """ConceptNode -> Concept, MemberLink -> Member."""
    return _SUFFIX.sub("", symbol)


def parse_sexpr(text: str) -> List[list]:
    """Parse scheme s-expressions into nested lists of str tokens.
    Comments (;...) are dropped; quoted strings are single tokens."""
    out: List[list] = []
    stack: List[list] = []
    token = []
    in_string = False
    in_comment = False
    for ch in text:
        if in_comment:
            if ch == "\n":
                in_comment = False
            continue
        if in_string:
            token.append(ch)
            if ch == '"':
                in_string = False
            continue
        if ch == ";":
            in_comment = True
            continue
        if ch == '"':
            token.append(ch)
            in_string = True
            continue
        if ch in "()" or ch.isspace():
            if token:
                (stack[-1] if stack else out).append("".join(token))
                token = []
            if ch == "(":
                new: list = []
                (stack[-1] if stack else out).append(new)
                stack.append(new)
            elif ch == ")":
                if not stack:
                    raise InvalidSymbol("unbalanced ')'")
                stack.pop()
            continue
        token.append(ch)
    if stack:
        raise InvalidSymbol("unbalanced '('")
    if token:
        out.append("".join(token))
    return out


class Translator:
    """Walks parsed Atomese trees, accumulating node typedefs and node
    declarations, and renders MeTTa body expressions."""

    def __init__(self):
        self.node_types: List[str] = []       # first-seen order
        self.nodes: List[Tuple[str, str]] = []  # (name, type)
        self._seen_types = set()
        self._seen_nodes = set()

    def _is_node(self, symbol: str) -> bool:
        return symbol in ALLOWED_NODES or symbol + "Node" in ALLOWED_NODES

    def _is_link(self, symbol: str) -> bool:
        return symbol in ALLOWED_LINKS or symbol + "Link" in ALLOWED_LINKS

    def _add_type(self, mtype: str) -> None:
        if mtype not in self._seen_types:
            self._seen_types.add(mtype)
            self.node_types.append(mtype)

    def _add_node(self, name: str, mtype: str) -> None:
        key = (name, mtype)
        if key not in self._seen_nodes:
            self._seen_nodes.add(key)
            self.nodes.append(key)

    def translate(self, tree: Union[str, list]) -> Optional[str]:
        """One Atomese tree -> MeTTa text (None for ignored subtrees)."""
        if isinstance(tree, str):
            raise InvalidSymbol(tree)
        if not tree:
            raise InvalidSymbol("()")
        head = tree[0]
        if isinstance(head, list):
            parts = [self.translate(sub) for sub in tree]
            return f"({' '.join(p for p in parts if p is not None)})"
        if head in IGNORED_SYMBOLS:
            return None
        mtype = strip_suffix(head)
        if self._is_node(head):
            if len(tree) < 2 or not isinstance(tree[1], str):
                raise InvalidSymbol(f"node {head} without a name")
            name = tree[1]
            if not (name.startswith('"') and name.endswith('"')):
                name = f'"{name}"'
            self._add_type(mtype)
            self._add_node(name, mtype)
            return name
        if self._is_link(head):
            parts = [self.translate(sub) for sub in tree[1:]]
            parts = [p for p in parts if p is not None]
            if mtype == "Set":
                self._add_type("Set")  # the implicit type of `{...}` sugar
                return "{" + " ".join(parts) + "}"
            self._add_type(mtype)
            return f"({mtype} {' '.join(parts)})"
        raise InvalidSymbol(head)

    def header_lines(self) -> Iterable[str]:
        for mtype in self.node_types:
            yield f"(: {mtype} Type)"
        for name, mtype in self.nodes:
            yield f"(: {name} {mtype})"


def translate_text(atomese_text: str, processes: int = 1) -> str:
    """Full document conversion: returns MeTTa text (typedefs, node
    declarations, then body expressions).  With processes > 1 the
    tokenize+tree stage fans out over paren-balanced chunks in a process
    pool (convert/chunked.py — SURVEY §2.10 P3); translation stays
    single-threaded (it owns the shared symbol tables)."""
    if processes > 1:
        from das_tpu_torch.convert.chunked import parse_multiprocess

        trees = parse_multiprocess(atomese_text, processes=processes)
    else:
        trees = parse_sexpr(atomese_text)
    translator = Translator()
    body = []
    for tree in trees:
        rendered = translator.translate(tree)
        if rendered is not None:
            body.append(rendered)
    return "\n".join([*translator.header_lines(), *body]) + "\n"


def translate_file(scm_path: str, metta_path: str, processes: int = 1) -> None:
    with open(scm_path) as f:
        text = f.read()
    with open(metta_path, "w") as out:
        out.write(translate_text(text, processes=processes))


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Atomese .scm -> MeTTa converter")
    ap.add_argument("input")
    ap.add_argument("output")
    ap.add_argument(
        "--processes", type=int, default=1,
        help="fan the parse stage out over a process pool",
    )
    args = ap.parse_args(argv)
    translate_file(args.input, args.output, processes=args.processes)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
