"""FlyBase (PostgreSQL dump) → MeTTa converter.

Role of reference flybase2metta/sql_reader.py:77-646 — stream a full
``pg_dump`` SQL file and emit a MeTTa knowledge base — with the same
emission vocabulary (sql_reader.py:36-45): node types ``Concept``,
``Schema``, ``Number``, ``Verbatim``, link types ``Inheritance``,
``Execution``.  Differences from the reference, by design:

* schema discovery is a dedicated streaming pass with stdlib parsing of
  ``CREATE TABLE`` / ``ALTER TABLE .. ADD CONSTRAINT`` blocks, run BEFORE
  the data pass — real ``pg_dump`` output adds every PRIMARY KEY / FOREIGN
  KEY constraint AFTER the COPY data, so single-pass emission would see no
  keys at all (the reference needs simple_ddl_parser + sqlparse + 5
  passes for the same reason, sql_reader.py:645+ parse());
* relevance filtering is either an explicit ``tables=`` allowlist or, with
  ``precomputed_dir=``, discovered from the release's precomputed report
  files by value-coverage column matching (convert/precomputed.py,
  role of the reference precomputed_tables.py) in one extra streaming pass.

Dump-robustness semantics (each matched to the reference where its
behavior is well-defined):

* tables with NO primary key are discarded with a logged warning
  (sql_reader.py:589-592 "Discarded table ... No PRIMARY KEY defined");
* composite primary keys — the reference hard-asserts them away
  (sql_reader.py:222) — identify rows by ALL pk columns joined with ':';
* quoted identifiers (``"order"``, mixed case) are unquoted everywhere
  (table names, column lists, constraint columns);
* ``\\N`` SQL NULLs are skipped per column and rows with a NULL/empty
  primary key are dropped (sql_reader value handling);
* ``ALTER TABLE`` constraints parse whether they arrive on one line or
  spread across continuation lines, before or after the table's data.

Per data row the converter emits:
    (: "table:<pk>" Concept)                    row node
    (Inheritance "table:<pk>" "table")          row → table concept
    (Execution (Schema "table.column") "table:<pk>" <value>)
where <value> is a referenced row node for FK columns, a Number node for
numeric columns, else a Verbatim node.  Output is chunked into
``file_NNN.metta`` checkpoint files (sql_reader.py:147-207) so a crashed
conversion resumes at file granularity.
"""

from __future__ import annotations

import logging
import os
import re
from dataclasses import dataclass, field
from typing import Dict, Iterable, List, Optional, TextIO, Tuple

ATOM_TYPES = ("Concept", "Schema", "Number", "Verbatim", "Inheritance", "Execution")

EXPRESSION_CHUNK_SIZE = 500_000

_NUMERIC_TYPES = (
    "integer", "bigint", "smallint", "numeric", "real", "double precision",
    "serial", "bigserial", "float",
)

_CREATE_TABLE = re.compile(r"^CREATE TABLE (\S+)\s*\($")
_ALTER_HEAD = re.compile(r"^ALTER TABLE (?:ONLY )?(\S+)(\s.*)?$")
_PRIMARY_KEY = re.compile(r"ADD CONSTRAINT \S+ PRIMARY KEY \(([^)]+)\)")
_FOREIGN_KEY = re.compile(
    r"ADD CONSTRAINT \S+ FOREIGN KEY \(([^)]+)\) REFERENCES (\S+)\s*\(([^)]+)\)"
)
_COPY = re.compile(r"^COPY (\S+) \((.+)\) FROM stdin;$")


def unquote(identifier: str) -> str:
    """Strip PostgreSQL double-quoting from an identifier (quoted names
    keep case and may be SQL keywords — e.g. ``"order"``)."""
    identifier = identifier.strip()
    if identifier.startswith('"') and identifier.endswith('"'):
        return identifier[1:-1].replace('""', '"')
    return identifier


@dataclass
class TableSchema:
    name: str
    columns: List[Tuple[str, str]] = field(default_factory=list)  # (name, sql_type)
    #: ALL primary-key columns (composite keys keep every column; rows are
    #: identified by the ':'-joined values)
    primary_key: List[str] = field(default_factory=list)
    #: single-column FKs: column -> (ref_table, ref_column)
    foreign_keys: Dict[str, Tuple[str, str]] = field(default_factory=dict)
    #: composite FKs: (local_cols, ref_table) — referencing the target's
    #: compound row identity; per-column Concept refs would dangle
    composite_fks: List[Tuple[Tuple[str, ...], str]] = field(default_factory=list)

    def column_type(self, column: str) -> str:
        for name, sql_type in self.columns:
            if name == column:
                return sql_type
        return "text"


def short_name(table: str) -> str:
    return unquote(table.split(".")[-1])


class FlybaseConverter:
    def __init__(
        self,
        sql_path: str,
        output_dir: str,
        tables: Optional[Iterable[str]] = None,
        precomputed_dir: Optional[str] = None,
        chunk_size: int = EXPRESSION_CHUNK_SIZE,
    ):
        self.sql_path = sql_path
        self.output_dir = output_dir
        self.tables = set(tables) if tables else None
        self.precomputed_dir = precomputed_dir
        self.precomputed = None
        self.chunk_size = chunk_size
        self.schema: Dict[str, TableSchema] = {}
        self._out: Optional[TextIO] = None
        self._file_number = 0
        self._chunk_count = 0
        self._typedefs: set = set()
        self._nodes: set = set()
        self._links: List[str] = []
        self._discarded: set = set()
        self.row_count = 0

    # -- schema pass (streamed together with data) -------------------------

    def _parse_create_table(self, header_line: str, lines: Iterable[str]) -> None:
        name = short_name(_CREATE_TABLE.match(header_line).group(1))
        table = TableSchema(name)
        for raw in lines:
            line = raw.strip().rstrip(",")
            if line.startswith(")"):
                break
            upper = line.upper()
            if upper.startswith("PRIMARY KEY"):
                # inline table-level PK (hand-written SQL; pg_dump emits
                # it as a later ALTER) — skipping it would discard the
                # whole table at emission time
                m = re.search(r"\(([^)]+)\)", line)
                if m:
                    table.primary_key = [
                        unquote(c) for c in m.group(1).split(",")
                    ]
                continue
            if not line or upper.startswith(("CONSTRAINT", "FOREIGN", "UNIQUE", "CHECK", "EXCLUDE")):
                continue
            # quoted column names may contain spaces: take the identifier
            # by quote-aware split, the rest is the SQL type
            if line.startswith('"'):
                end = line.index('"', 1)
                while end + 1 < len(line) and line[end + 1] == '"':
                    end = line.index('"', end + 2)
                col, rest = line[: end + 1], line[end + 1 :]
            else:
                col, _, rest = line.partition(" ")
            table.columns.append((unquote(col), rest.strip().lower()))
        self.schema[name] = table

    def _apply_constraint(self, table: TableSchema, text: str) -> None:
        pk = _PRIMARY_KEY.search(text)
        if pk:
            table.primary_key = [
                unquote(c) for c in pk.group(1).split(",")
            ]
        fk = _FOREIGN_KEY.search(text)
        if fk:
            local = [unquote(c) for c in fk.group(1).split(",")]
            remote = [unquote(c) for c in fk.group(3).split(",")]
            ref_table = short_name(fk.group(2))
            if len(local) == 1:
                table.foreign_keys[local[0]] = (ref_table, remote[0])
            else:
                # a composite FK references the target's COMPOUND row
                # identity; mapping the columns individually would emit
                # Concept refs no row node carries
                table.composite_fks.append((tuple(local), ref_table))

    def _parse_alter(self, header_line: str, lines: Iterable[str]) -> None:
        m = _ALTER_HEAD.match(header_line)
        table = self.schema.get(short_name(m.group(1))) if m else None
        # accumulate the WHOLE statement to the terminating ';' first: a
        # PRIMARY KEY (a,\n b) clause broken across continuation lines
        # must still match (dropping it would discard the whole table)
        text = (m.group(2) or "").strip() if m else ""
        if not text.endswith(";"):
            for raw in lines:
                line = raw.strip()
                if not line:
                    break
                text = f"{text} {line}" if text else line
                if line.endswith(";"):
                    break
        if table is not None:
            self._apply_constraint(table, text)

    # -- emission ----------------------------------------------------------

    def _open_next_file(self) -> None:
        if self._out:
            self._out.close()
        self._file_number += 1
        path = os.path.join(
            self.output_dir, f"file_{self._file_number:03d}.metta"
        )
        self._out = open(path, "w")
        for t in ATOM_TYPES:
            self._out.write(f"(: {t} Type)\n")

    def _flush(self, reopen: bool) -> None:
        for line in sorted(self._typedefs):
            self._out.write(line + "\n")
        for line in sorted(self._nodes):
            self._out.write(line + "\n")
        for line in self._links:
            self._out.write(line + "\n")
        self._typedefs.clear()
        self._nodes.clear()
        self._links.clear()
        self._chunk_count = 0
        if reopen:
            self._open_next_file()

    def _node(self, node_type: str, name: str) -> str:
        quoted = f'"{name}"'
        self._nodes.add(f"(: {quoted} {node_type})")
        self._chunk_count += 1
        return quoted

    def _value_node(self, table: TableSchema, column: str, value: str) -> str:
        fk = table.foreign_keys.get(column)
        if fk is not None:
            ref_table, _ref_col = fk
            return self._node("Concept", f"{ref_table}:{value}")
        sql_type = table.column_type(column)
        if any(sql_type.startswith(t) for t in _NUMERIC_TYPES):
            return self._node("Number", value)
        return self._node("Verbatim", value)

    def _emit_row(self, table: TableSchema, columns: List[str], values: List[str]) -> None:
        row: Dict[str, str] = dict(zip(columns, values))
        pk_cols = table.primary_key
        pk_values = [row.get(c, "") for c in pk_cols]
        if any(v in ("", "\\N") for v in pk_values):
            return  # NULL/absent (part of a) primary key: no row identity
        pk_value = ":".join(pk_values)
        row_node = self._node("Concept", f"{table.name}:{pk_value}")
        table_node = self._node("Concept", table.name)
        self._links.append(f"(Inheritance {row_node} {table_node})")
        pk_set = set(pk_cols)
        comp_fk_cols = set()
        for local_cols, ref_table in table.composite_fks:
            vals = [row.get(c, "") for c in local_cols]
            if any(v in ("", "\\N") for v in vals):
                continue
            comp_fk_cols.update(local_cols)
            schema_node = self._node(
                "Schema", f"{table.name}.{':'.join(local_cols)}"
            )
            ref_node = self._node(
                "Concept", f"{ref_table}:{':'.join(vals)}"
            )
            self._links.append(
                f"(Execution (Schema {schema_node}) {row_node} {ref_node})"
            )
            self._chunk_count += 1
        for column, value in row.items():
            if column in pk_set or column in comp_fk_cols:
                continue
            if value == "\\N" or value == "":
                continue
            schema_node = self._node("Schema", f"{table.name}.{column}")
            value_node = self._value_node(table, column, value)
            self._links.append(
                f"(Execution (Schema {schema_node}) {row_node} {value_node})"
            )
            self._chunk_count += 1
        self.row_count += 1
        if self._chunk_count >= self.chunk_size:
            self._flush(reopen=True)

    def _table_wanted(self, name: str) -> Optional[TableSchema]:
        table = self.schema.get(name)
        if table is None or (self.tables is not None and name not in self.tables):
            return None
        if not table.primary_key:
            # reference parity: tables without a PRIMARY KEY are discarded
            # with a logged error (sql_reader.py:589-592)
            if name not in self._discarded:
                self._discarded.add(name)
                logging.getLogger("das_tpu_torch").warning(
                    "Discarded table %s: no PRIMARY KEY defined", name
                )
            return None
        return table

    def _parse_copy(self, header_line: str, lines: Iterable[str]) -> None:
        m = _COPY.match(header_line)
        name = short_name(m.group(1))
        columns = [unquote(c) for c in m.group(2).split(",")]
        table = self._table_wanted(name)
        for raw in lines:
            line = raw.rstrip("\n")
            if line == "\\.":
                break
            if table is not None:
                self._emit_row(table, columns, line.split("\t"))

    # -- the passes ------------------------------------------------------------

    def discover_relevant_tables(self) -> None:
        """Value-coverage discovery (reference sql_reader's first passes +
        precomputed_tables.check_field_value): under run(), COPY
        observations were already fed to the report matcher DURING the
        schema pass (one shared read of the dump); called standalone, the
        matcher streams the dump itself here."""
        if self.precomputed is None:
            from das_tpu_torch.convert.precomputed import PrecomputedTables

            self.precomputed = PrecomputedTables(self.precomputed_dir)
            if not self.precomputed.preloaded:
                self._schema_pass(observe=self.precomputed.observe)
        if not self.precomputed.preloaded:
            self.precomputed.resolve()
            self.precomputed.save_mapping()
        relevant = self.precomputed.relevant_sql_tables()
        if not relevant:
            raise ValueError(
                "precomputed-report discovery matched no SQL tables "
                f"(dir={self.precomputed_dir}): the report files likely "
                "belong to a different release than the dump — refusing to "
                "convert the whole dump unfiltered; pass tables= explicitly "
                "to override"
            )
        self.tables = relevant if self.tables is None else (self.tables | relevant)

    def _schema_pass(self, observe=None) -> None:
        """Stream the whole dump collecting CREATE TABLE columns and ALTER
        TABLE constraints.  Real pg_dump output puts every constraint
        AFTER the data, so emission cannot know primary or foreign keys
        until this pass completes.  COPY bodies are skimmed — or, when
        `observe` is given, fed to it as (table, column, value) for the
        precomputed-report matcher (sharing this read instead of adding a
        third pass over a multi-GB dump)."""
        with open(self.sql_path) as f:
            it = iter(f)
            for raw in it:
                line = raw.rstrip("\n")
                if _CREATE_TABLE.match(line):
                    self._parse_create_table(line, it)
                elif _ALTER_HEAD.match(line):
                    self._parse_alter(line, it)
                elif _COPY.match(line):
                    m = _COPY.match(line)
                    name = short_name(m.group(1))
                    columns = [unquote(c) for c in m.group(2).split(",")]
                    for data in it:
                        row = data.rstrip("\n")
                        if row == "\\.":
                            break
                        if observe is not None:
                            for col, value in zip(columns, row.split("\t")):
                                observe(name, col, value)

    def run(self) -> Dict[str, int]:
        os.makedirs(self.output_dir, exist_ok=True)
        observe = None
        if self.precomputed_dir and self.tables is None:
            from das_tpu_torch.convert.precomputed import PrecomputedTables

            self.precomputed = PrecomputedTables(self.precomputed_dir)
            if not self.precomputed.preloaded:
                observe = self.precomputed.observe
        self._schema_pass(observe=observe)
        if self.precomputed is not None:
            self.discover_relevant_tables()
        self._open_next_file()
        with open(self.sql_path) as f:
            it = iter(f)
            for raw in it:
                line = raw.rstrip("\n")
                if _COPY.match(line):
                    self._parse_copy(line, it)
        self._flush(reopen=False)
        self._out.close()
        return {
            "tables": len(self.schema),
            "discarded_tables": len(self._discarded),
            "rows": self.row_count,
            "files": self._file_number,
        }


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(description="FlyBase SQL dump -> MeTTa")
    ap.add_argument("sql_file")
    ap.add_argument("output_dir")
    ap.add_argument("--tables", nargs="*", help="allowlist of table names")
    ap.add_argument(
        "--precomputed-dir",
        help="FlyBase precomputed-report dir: discover relevant tables by "
        "value-coverage column matching instead of an allowlist",
    )
    ap.add_argument("--chunk-size", type=int, default=EXPRESSION_CHUNK_SIZE)
    args = ap.parse_args(argv)
    stats = FlybaseConverter(
        args.sql_file, args.output_dir, args.tables,
        precomputed_dir=args.precomputed_dir, chunk_size=args.chunk_size,
    ).run()
    print(stats)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
