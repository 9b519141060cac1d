"""Human-readable store export/import in the reference's mongoexport
format (interop tool).

The reference's `mongodump` script (reference mongodump:1-8) exports
the Mongo collections `nodes`, `links_2`, `atom_types` as one JSON document
per line and sorts each file with sort(1).  The document shapes are exactly
`Expression.to_dict()` (reference das/expression.py:25-53): terminals
carry {_id, composite_type_hash, name, named_type}; typedefs carry
{_id, composite_type_hash, named_type, named_type_hash}; regular
expressions additionally carry is_toplevel, composite_type and the
key_0/key_1 (arity <= 2) or keys (arity > 2) element split.

This module emits byte-compatible dumps from a store — every Mongo
collection the reference populates (mongo_schema.py CollectionNames:
nodes, atom_types, links_1, links_2, links_n), each sorted with C-locale
(codepoint) order, i.e. `LC_ALL=C sort` — and loads such a dump back into
an `AtomSpaceData` by reconstructing canonical MeTTa text and re-running
the normal parser path, so every hash in the loaded store is re-derived
and re-verified rather than trusted.

A dump produced by the reference stack lacks one piece of information this
loader needs: the typedef's type-designator NAME (the document only holds
its md5 inside `_id`).  `_recover_designator` resolves it by hash-checking
every type name present in the dump (plus the basic marks) against the
document's `_id` — exact, since `_id` is the expression hash over
[mark, name_hash, designator_hash].

`write_canonical` (the port's own) writes a store as a canonical
knowledge-base file, the converter format of ingest/canonical.py that the
native scanner reads: type declarations, terminal declarations, then one
toplevel expression per line with terminals written ``"Type name"``.
"""

from __future__ import annotations

import json
import os
import re
from typing import Dict, List

from das_tpu_torch.core.expression import Expression
from das_tpu_torch.core.hashing import ExpressionHasher
from das_tpu_torch.core.schema import BASIC_TYPE, TYPEDEF_MARK

#: reference mongo_schema.py CollectionNames -> file suffixes used by the
#: reference's mongodump script ("$1.nodes" etc.)
COLLECTIONS = ("nodes", "atom_types", "links_1", "links_2", "links_n")

#: what the MeTTa lexer accepts as a bare SYMBOL (the lexer's own rule)
from das_tpu_torch.ingest.metta import SYMBOL_PATTERN

_SYMBOL_RE = re.compile(SYMBOL_PATTERN)


def _node_doc(handle: str, rec) -> dict:
    # terminal composite_type_hash == named_type_hash (base_yacc.py:140-141)
    return Expression(
        terminal_name=rec.name,
        named_type=rec.named_type,
        composite_type_hash=rec.named_type_hash,
        hash_code=handle,
    ).to_dict()


def _typedef_doc(handle: str, rec) -> dict:
    return Expression(
        typedef_name=rec.name,
        typedef_name_hash=rec.name_hash,
        composite_type_hash=rec.composite_type_hash,
        hash_code=handle,
    ).to_dict()


def _link_doc(handle: str, rec) -> dict:
    return Expression(
        toplevel=rec.is_toplevel,
        named_type=rec.named_type,
        named_type_hash=rec.named_type_hash,
        composite_type=rec.composite_type,
        composite_type_hash=rec.composite_type_hash,
        elements=list(rec.elements),
        hash_code=handle,
    ).to_dict()


def _jsonl(doc: dict) -> str:
    # mongoexport is a Go program: its encoding/json writes raw UTF-8
    # (no \uXXXX for non-ASCII) but HTML-escapes < > & as \u003c \u003e
    # \u0026 (json.Marshal's SetEscapeHTML default) — reproduce both so
    # the byte-compat contract holds beyond ASCII names
    line = json.dumps(doc, separators=(",", ":"), ensure_ascii=False)
    return (
        line.replace("<", "\\u003c")
        .replace(">", "\\u003e")
        .replace("&", "\\u0026")
        # Go also escapes the JS line separators U+2028/U+2029
        .replace("\u2028", "\\u2028")
        .replace("\u2029", "\\u2029")
    )


def store_documents(data) -> Dict[str, List[str]]:
    """All mongoexport-shaped document lines of a store, keyed by
    collection name, UNSORTED (dump_store sorts at write time)."""
    out: Dict[str, List[str]] = {name: [] for name in COLLECTIONS}
    for handle, rec in data.nodes.items():
        out["nodes"].append(_jsonl(_node_doc(handle, rec)))
    for handle, rec in data.typedefs.items():
        out["atom_types"].append(_jsonl(_typedef_doc(handle, rec)))
    for handle, rec in data.links.items():
        arity = len(rec.elements)
        name = "links_1" if arity == 1 else (
            "links_2" if arity == 2 else "links_n"
        )
        out[name].append(_jsonl(_link_doc(handle, rec)))
    return out


def dump_store(data, prefix: str, include_empty: bool = False) -> List[str]:
    """Write `<prefix>.<collection>` files, each C-locale sorted (the
    reference pipes mongoexport through sort(1)).  Returns written paths;
    empty collections are skipped unless include_empty."""
    docs = store_documents(data)
    written = []
    for name in COLLECTIONS:
        lines = docs[name]
        if not lines and not include_empty:
            continue
        path = f"{prefix}.{name}"
        with open(path, "w", encoding="utf-8") as f:
            for line in sorted(lines):
                f.write(line + "\n")
        written.append(path)
    return written


# ---------------------------------------------------------------------------
# loading a dump back into a store
# ---------------------------------------------------------------------------


def _read_collection(prefix: str, name: str) -> List[dict]:
    path = f"{prefix}.{name}"
    if not os.path.exists(path):
        return []
    with open(path, encoding="utf-8") as f:
        return [json.loads(line) for line in f if line.strip()]


def _recover_designator(doc: dict, name_by_hash: Dict[str, str]) -> str:
    """Type-designator name of a typedef document, by exact hash check:
    _id == expression_hash(mark, [named_type_hash, designator_hash])
    (base_yacc.py:108-126)."""
    mark_hash = ExpressionHasher.named_type_hash(TYPEDEF_MARK)
    for cand_hash, cand_name in name_by_hash.items():
        if (
            ExpressionHasher.expression_hash(
                mark_hash, [doc["named_type_hash"], cand_hash]
            )
            == doc["_id"]
        ):
            return cand_name
    raise ValueError(
        f"cannot recover type designator of typedef {doc['named_type']!r} "
        f"({doc['_id']}): no known type name hashes to it"
    )


def _quote(name: str) -> str:
    if '"' in name or "\n" in name:
        raise ValueError(
            f"terminal name {name!r} is not representable in canonical "
            "MeTTa (embedded quote/newline)"
        )
    return f'"{name}"'


def read_dump(prefix: str) -> Dict[str, List[dict]]:
    """Parse every collection file of a dump ONCE.  Raises when no
    collection file exists at all — a typo'd prefix must not load as a
    valid empty store."""
    docs = {name: _read_collection(prefix, name) for name in COLLECTIONS}
    if not any(os.path.exists(f"{prefix}.{name}") for name in COLLECTIONS):
        raise FileNotFoundError(
            f"no dump files found at prefix {prefix!r} "
            f"(expected <prefix>.{{{','.join(COLLECTIONS)}}})"
        )
    return docs


def dump_to_metta(prefix: str, docs: Dict[str, List[dict]] = None) -> str:
    """Reconstruct canonical MeTTa text from a dump: typedefs first, then
    terminal declarations, then every TOPLEVEL expression with sub-links
    rendered inline (non-toplevel links exist in the dump exactly because
    a toplevel one references them)."""
    if docs is None:
        docs = read_dump(prefix)
    typedefs = docs["atom_types"]
    nodes = docs["nodes"]
    links = docs["links_1"] + docs["links_2"] + docs["links_n"]

    name_by_hash = {
        ExpressionHasher.named_type_hash(d["named_type"]): d["named_type"]
        for d in typedefs
    }
    for base in (BASIC_TYPE, TYPEDEF_MARK):
        name_by_hash.setdefault(ExpressionHasher.named_type_hash(base), base)

    lines: List[str] = []
    # a TERMINAL declaration `(: "human" Concept)` records BOTH a node and
    # a typedef (name hashed as a named type, base_yacc.py:108-126 /
    # metta.py _typedef) — the quoted node declaration below recreates
    # both records, so its typedef doc must NOT also be emitted as a bare
    # symbol line (the name may not even lex as a SYMBOL, e.g. "a<b")
    node_names = {(d["name"], d["named_type"]) for d in nodes}
    for d in typedefs:
        designator = _recover_designator(d, name_by_hash)
        if (d["named_type"], designator) not in node_names:
            name = d["named_type"]
            # a terminal DECLARED but never used leaves a typedef doc
            # with no node doc (true of reference dumps too: the node
            # atom is created on use, base_yacc.py:132-145).  The
            # typedef record is IDENTICAL for `(: x T)` and `(: "x" T)`
            # (name md5'd either way), so quote whenever the name cannot
            # lex as a bare SYMBOL — same record, and names like "a.b"
            # become expressible
            if _SYMBOL_RE.fullmatch(name) is None:
                name = _quote(name)
            lines.append(f"(: {name} {designator})")
    node_text = {d["_id"]: _quote(d["name"]) for d in nodes}
    # a link element may be a bare SYMBOL (the grammar allows it): its
    # handle is the typedef's own expression hash, rendered unquoted
    symbol_text = {d["_id"]: d["named_type"] for d in typedefs}
    for d in nodes:
        lines.append(f"(: {_quote(d['name'])} {d['named_type']})")

    link_by_id = {d["_id"]: d for d in links}

    def elements(d: dict) -> List[str]:
        if "keys" in d:
            return d["keys"]
        return [d["key_0"]] + ([d["key_1"]] if "key_1" in d else [])

    rendered: Dict[str, str] = {}

    def render(handle: str) -> str:
        if handle in node_text:
            return node_text[handle]
        if handle in symbol_text:
            return symbol_text[handle]
        if handle in rendered:
            return rendered[handle]
        d = link_by_id.get(handle)
        if d is None:
            raise ValueError(
                f"dump references unknown atom {handle}: corrupt dump"
            )
        inner = " ".join(render(e) for e in elements(d))
        text = f"({d['named_type']} {inner})"
        rendered[handle] = text
        return text

    for d in links:
        if d.get("is_toplevel"):
            lines.append(render(d["_id"]))
    return "\n".join(lines) + "\n"


def load_dump(prefix: str):
    """Parse a dump back into a fresh AtomSpaceData via the normal MeTTa
    parser path — all hashes re-derived, then VERIFIED against the dump's
    _id sets, so silent loss (e.g. the same terminal name declared under
    two types, which canonical MeTTa text cannot express — the parser's
    last-declaration-wins symbol table keeps one) fails loudly."""
    from das_tpu_torch.storage.atom_table import AtomSpaceData, load_metta_text

    docs = read_dump(prefix)
    data = AtomSpaceData()
    load_metta_text(dump_to_metta(prefix, docs), data)

    node_ids = {d["_id"] for d in docs["nodes"]}
    link_ids = {
        d["_id"]
        for name in ("links_1", "links_2", "links_n")
        for d in docs[name]
    }
    typedef_ids = {d["_id"] for d in docs["atom_types"]}
    problems = []
    if set(data.nodes) != node_ids:
        problems.append(
            f"nodes: {len(node_ids - set(data.nodes))} lost, "
            f"{len(set(data.nodes) - node_ids)} extra"
        )
    if set(data.links) != link_ids:
        problems.append(
            f"links: {len(link_ids - set(data.links))} lost, "
            f"{len(set(data.links) - link_ids)} extra"
        )
    if not typedef_ids <= set(data.typedefs):  # parser may add base marks
        problems.append(
            f"atom_types: {len(typedef_ids - set(data.typedefs))} lost"
        )
    if problems:
        raise ValueError(
            "dump does not reconstruct faithfully ("
            + "; ".join(problems)
            + ") — e.g. a terminal name declared under several types "
            "cannot round-trip through canonical MeTTa text"
        )
    return data


# ---------------------------------------------------------------------------
# a store as a canonical knowledge-base file
# ---------------------------------------------------------------------------


def write_canonical(data, path: str) -> int:
    """Write `data` as a canonical file (ingest/canonical.py): every type
    declaration that names no terminal, every terminal declaration, then
    each toplevel link on its own line with its sub-links inline.  Loading
    the file (CanonicalLoader or the native scanner) gives the same node
    and link handles.  Raises ValueError for what the format cannot hold:
    a bare symbol as a link element, a type name that is not a bare
    symbol, or a quote or newline in a terminal name.  Returns the number
    of expression lines written."""
    node_names = {(rec.name, rec.named_type) for rec in data.nodes.values()}
    lines: List[str] = []
    for rec in data.typedefs.values():
        if (rec.name, rec.designator_name) in node_names:
            continue
        if _SYMBOL_RE.fullmatch(rec.name) is None or " " in rec.name:
            raise ValueError(f"type name {rec.name!r} is not a bare symbol")
        lines.append(f"(: {rec.name} {rec.designator_name})")
    terminal: Dict[str, str] = {}
    for handle, rec in data.nodes.items():
        lines.append(f"(: {_quote(rec.name)} {rec.named_type})")
        terminal[handle] = _quote(f"{rec.named_type} {rec.name}")
    rendered: Dict[str, str] = {}

    def render(handle: str) -> str:
        text = terminal.get(handle) or rendered.get(handle)
        if text is not None:
            return text
        rec = data.links.get(handle)
        if rec is None:
            raise ValueError(
                f"link element {handle} is no terminal or link: a bare "
                "symbol cannot be written in canonical form"
            )
        text = f"({rec.named_type} {' '.join(render(e) for e in rec.elements)})"
        rendered[handle] = text
        return text

    n_expr = 0
    for handle, rec in data.links.items():
        if rec.is_toplevel:
            lines.append(render(handle))
            n_expr += 1
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(lines) + "\n")
    return n_expr
