"""FlyBase precomputed-report column matching (value-coverage discovery).

Role of reference flybase2metta/precomputed_tables.py:9-361: a
FlyBase release ships "precomputed files" — TSV reports (plus an ncRNA
JSON) whose columns are *unlabeled* with respect to the SQL schema.  To
reproduce the reference KB from a raw release, the converter must discover
which ``table.field`` of the SQL dump each report column corresponds to.

Discovery is by VALUE COVERAGE: while streaming the dump's COPY rows,
every (sql_table, sql_field, value) observation is checked against the
still-unmapped report columns; a column maps to the (table, field) whose
observed values cover at least ``NEAR_MATCH_THRESHOLD`` (90%, the
reference's check_near_match bar, precomputed_tables.py:86-102) of the
column's distinct values.  FlyBase identifiers are normalized to their
bare ``FBxx…`` accession before comparison (the reference's
``flybase_id_re``).  Resolved mappings persist to ``mapping.txt`` in the
reference's tab-separated format (file, column, table, field) so later
conversions preload instead of rediscovering.

The union of mapped tables is the converter's *relevant table* set — the
capability round 1 replaced with a hand-written allowlist."""

from __future__ import annotations

import csv
import glob
import json
import os
import re
from typing import Dict, Iterable, List, Optional, Set, Tuple

NEAR_MATCH_THRESHOLD = 0.9

_FLYBASE_ID = re.compile(r"^(\S+:)?(FB[a-zA-Z]{2}[0-9]{5,10})$")


def normalize_value(value: str) -> str:
    value = value.strip()
    m = _FLYBASE_ID.search(value)
    return m.group(2) if m is not None else value


class ReportTable:
    """One precomputed report: per-column distinct values plus, per
    candidate (sql_table, sql_field), the subset of values seen there."""

    def __init__(self, name: str):
        self.name = name
        self.header: List[str] = []
        self.values: Dict[str, Set[str]] = {}
        # column -> (sql_table, sql_field) -> covered value subset
        self.hits: Dict[str, Dict[Tuple[str, str], Set[str]]] = {}
        self.mapping: Dict[str, Tuple[str, str]] = {}

    def set_header(self, header: Iterable[str]) -> None:
        self.header = [h.strip() for h in header]
        for column in self.header:
            self.values[column] = set()
            self.hits[column] = {}

    def add_row(self, row: Iterable[str]) -> None:
        for column, value in zip(self.header, row):
            value = normalize_value(value)
            if value:
                self.values[column].add(value)

    @property
    def unmapped_columns(self) -> List[str]:
        return [c for c in self.header if c not in self.mapping]

    def observe(self, sql_table: str, sql_field: str, value: str) -> None:
        tag = (sql_table, sql_field)
        for column in self.header:
            if column in self.mapping:
                continue
            if value in self.values[column]:
                self.hits[column].setdefault(tag, set()).add(value)

    def resolve_near_matches(self) -> None:
        """Map every still-unmapped column whose best candidate covers
        >= NEAR_MATCH_THRESHOLD of its distinct values."""
        for column in self.unmapped_columns:
            total = len(self.values[column])
            if total == 0:
                continue
            best_tag, best_cover = None, 0
            for tag, covered in self.hits[column].items():
                if len(covered) > best_cover:
                    best_tag, best_cover = tag, len(covered)
            if best_tag is not None and best_cover >= NEAR_MATCH_THRESHOLD * total:
                self.mapping[column] = best_tag

    def all_mapped(self) -> bool:
        return bool(self.header) and not self.unmapped_columns


class PrecomputedTables:
    def __init__(self, dir_name: str):
        self.dir_name = dir_name
        self.tables: Dict[str, ReportTable] = {}
        self.preloaded = False
        # a NON-EMPTY mapping.txt short-circuits discovery entirely: report
        # files (GBs on a real release) are not even read — stub tables are
        # reconstructed from the mapping lines.  An empty file (a previous
        # run that resolved nothing) does NOT count as preloaded, so fixing
        # the release pairing and re-running rediscovers.  Delete
        # mapping.txt to force rediscovery.
        mapping_path = os.path.join(dir_name, "mapping.txt")
        if os.path.exists(mapping_path) and os.path.getsize(mapping_path) > 0:
            self.load_mapping(mapping_path)
            self.preloaded = bool(self.tables)
            if self.preloaded:
                return
        for path in sorted(glob.glob(os.path.join(dir_name, "*.tsv"))):
            table = ReportTable(os.path.basename(path))
            self._load_tsv(path, table)
            self.tables[table.name] = table
        for path in sorted(glob.glob(os.path.join(dir_name, "ncRNA_genes_*.json"))):
            for table in self._load_ncrna(path):
                self.tables[table.name] = table

    # -- loading -----------------------------------------------------------

    def _load_tsv(self, path: str, table: ReportTable) -> None:
        """FlyBase report TSVs carry the header as the LAST '#' comment
        line before the data (the reference's `previous` trick,
        precomputed_tables.py:190-204)."""
        previous: Optional[List[str]] = None
        with open(path, newline="") as fh:
            for row in csv.reader(fh, delimiter="\t", quotechar='"'):
                if not row:
                    continue
                if row[0].startswith("#"):
                    if not row[0].startswith("#-----"):
                        previous = row
                    continue
                if not table.header:
                    header = previous or [f"c{i}" for i in range(len(row))]
                    table.set_header([header[0].lstrip("#"), *header[1:]])
                table.add_row(row)

    def _load_ncrna(self, path: str) -> List[ReportTable]:
        """Flatten the ncRNA genes JSON into the reference's derived
        sub-tables (main + synonyms + related sequences + publications +
        genome locations, precomputed_tables.py:207-260)."""
        with open(path) as fh:
            doc = json.load(fh)
        main = ReportTable("ncRNA_main")
        main.set_header(
            ["primaryId", "symbol", "sequence", "taxonId", "soTermId",
             "gene_geneId", "gene_symbol", "gene_locusTag"]
        )
        synonyms = ReportTable("ncRNA_synonyms")
        synonyms.set_header(["symbol1", "symbol2"])
        publications = ReportTable("ncRNA_publications")
        publications.set_header(["primaryId", "publication"])
        related = ReportTable("ncRNA_related_sequences")
        related.set_header(["primaryId", "sequenceId", "relationship"])
        for row in doc.get("data", []):
            gene = row.get("gene", {})
            main.add_row([
                row.get("primaryId", ""), row.get("symbol", ""),
                row.get("sequence", ""), row.get("taxonId", ""),
                row.get("soTermId", ""), gene.get("geneId", ""),
                gene.get("symbol", ""), gene.get("locusTag", ""),
            ])
            for syn in row.get("symbolSynonyms", []):
                synonyms.add_row([row.get("symbol", ""), syn])
            for pub in row.get("publications", []):
                publications.add_row([row.get("primaryId", ""), pub])
            for rel in row.get("relatedSequences", []):
                related.add_row([
                    row.get("primaryId", ""),
                    rel.get("sequenceId", ""),
                    rel.get("relationship", ""),
                ])
        return [main, synonyms, publications, related]

    # -- discovery ---------------------------------------------------------

    def observe(self, sql_table: str, sql_field: str, value: str) -> None:
        value = normalize_value(value)
        if not value or value == "\\N":
            return
        for table in self.tables.values():
            if not table.all_mapped():
                table.observe(sql_table, sql_field, value)

    def resolve(self) -> None:
        for table in self.tables.values():
            table.resolve_near_matches()

    def relevant_sql_tables(self) -> Set[str]:
        out: Set[str] = set()
        for table in self.tables.values():
            for sql_table, _field in table.mapping.values():
                out.add(sql_table)
        return out

    # -- persistence (reference mapping.txt TSV format) --------------------

    def save_mapping(self, path: Optional[str] = None) -> str:
        path = path or os.path.join(self.dir_name, "mapping.txt")
        with open(path, "w") as fh:
            for name, table in sorted(self.tables.items()):
                for column, (sql_table, sql_field) in sorted(table.mapping.items()):
                    fh.write(f"{name}\t{column}\t{sql_table}\t{sql_field}\n")
        return path

    def load_mapping(self, path: str) -> None:
        with open(path) as fh:
            for line in fh:
                parts = line.rstrip("\n").split("\t")
                if len(parts) != 4:
                    continue
                fname, column, sql_table, sql_field = parts
                table = self.tables.get(fname)
                if table is None:
                    # preload without report files: stub table from mapping
                    table = ReportTable(fname)
                    self.tables[fname] = table
                if column not in table.header:
                    table.header.append(column)
                    table.values[column] = set()
                    table.hits[column] = {}
                table.mapping[column] = (sql_table, sql_field)

    def mappings_str(self) -> str:
        lines = []
        mapped = {n: t for n, t in self.tables.items() if t.all_mapped()}
        lines.append(f"Fully mapped tables: {len(mapped)}")
        for name, table in sorted(self.tables.items()):
            lines.append(name)
            for column in table.header:
                tag = table.mapping.get(column)
                tgt = f"{tag[0]} {tag[1]}" if tag else "???"
                lines.append(f"\t{column} -> {tgt}")
        return "\n".join(lines) + "\n"
