"""AtomSpace checkpoint / resume (port of the flat, single-device half of
`das_tpu/storage/checkpoint.py`).

A checkpoint directory holds

* ``records.json`` — the mutable source of truth (`AtomSpaceData` node,
  typedef and link records plus the symbol table), enough to rebuild
  everything;
* ``indexes.npz`` — the finalized probe indexes (`Finalized` buckets and
  the incoming CSR), so that a resume skips the argsort rebuild;
* ``registry.json`` — the row registry (`hex_of_row`) and the type
  registry the indexes refer to;
* ``MANIFEST.json`` — each section's byte count and CRC-32.

The JAX package encodes the records and the registry with msgpack; the
port writes the same payloads as JSON (storage/durable.py `encode`), so
the decoded payloads are equal and the files differ in bytes.

`load()` verifies every present section against the manifest, uses the
saved indexes when they still describe the records (atom counts), and
re-finalizes otherwise: a checkpoint is never wrong, only possibly slower
to open.  On a generational snapshot root (storage/durable.py) it loads
the newest valid generation and replays its write-ahead log at the
host-data level.  A checkpoint with no manifest is read once with a
warning, and the next save records the digests.

Every file is written through `durable.atomic_write` (write a temporary
file, fsync, rename, fsync the directory).  A columnar store
(storage/columnar.py) saves through its lazy views: its records are
reconstructed and its registry listed from the digest columns, and it
restores as a dict store with the same records and tables.

A sharded store (parallel/sharded_db.py) also saves its slabs
(`save_sharded`, ``sharded_S.npz``: every bucket's capacity-padded slab
columns and slab-local sorted indexes, stacked over the S shards);
`try_restore_sharded` uploads them directly when the shard count, the
counts and the content fingerprint still match the finalized store, and
declines otherwise (the store then re-partitions)."""

from __future__ import annotations

import hashlib
import json
import logging
import os
from typing import Dict, Optional

import numpy as np

from das_tpu_torch.ingest.metta import SymbolTable
from das_tpu_torch.storage.atom_table import (
    AtomSpaceData,
    Finalized,
    LinkBucket,
    LinkRec,
    NodeRec,
    TypedefRec,
)

log = logging.getLogger("das_tpu_torch")

RECORDS_FILE = "records.json"
INDEXES_FILE = "indexes.npz"
REGISTRY_FILE = "registry.json"
FORMAT_VERSION = 1


def _records_payload(data: AtomSpaceData) -> Dict:
    t = data.table
    return {
        "version": FORMAT_VERSION,
        "nodes": {
            h: (r.name, r.named_type, r.named_type_hash)
            for h, r in data.nodes.items()
        },
        "typedefs": {
            h: (r.name, r.name_hash, r.composite_type_hash, r.designator_name)
            for h, r in data.typedefs.items()
        },
        "links": {
            h: (
                r.named_type,
                r.named_type_hash,
                r.composite_type,
                r.composite_type_hash,
                list(r.elements),
                r.is_toplevel,
            )
            for h, r in data.links.items()
        },
        "symbol_table": {
            "named_type_hash": t.named_type_hash,
            "named_types": t.named_types,
            "symbol_hash": t.symbol_hash,
            "terminal_hash": [[k[0], k[1], v] for k, v in t.terminal_hash.items()],
            "parent_type": t.parent_type,
        },
        "pattern_black_list": data.pattern_black_list,
    }


def _restore_records(payload: Dict) -> AtomSpaceData:
    if payload.get("version") != FORMAT_VERSION:
        raise ValueError(f"Unsupported checkpoint version: {payload.get('version')}")
    table = SymbolTable()
    st = payload["symbol_table"]
    table.named_type_hash.update(st["named_type_hash"])
    table.named_types.update(st["named_types"])
    table.symbol_hash.update(st["symbol_hash"])
    table.terminal_hash.update({(a, b): v for a, b, v in st["terminal_hash"]})
    table.parent_type.update(st["parent_type"])
    data = AtomSpaceData(table)
    for h, (name, named_type, nth) in payload["nodes"].items():
        data.nodes[h] = NodeRec(name, named_type, nth)
    for h, (name, nh, cth, desig) in payload["typedefs"].items():
        data.typedefs[h] = TypedefRec(name, nh, cth, desig)
    for h, (nt, nth, ct, cth, elements, top) in payload["links"].items():
        data.links[h] = LinkRec(nt, nth, ct, cth, tuple(elements), top)
    data.pattern_black_list = list(payload.get("pattern_black_list", []))
    return data


#: LinkBucket array fields saved per bucket, and the per-position families
_BUCKET_FIELDS = ("rows", "type_id", "ctype", "targets", "targets_sorted",
                  "order_by_type", "key_type", "order_by_ctype", "key_ctype")
_BUCKET_POS_FIELDS = ("order_by_type_pos", "key_type_pos", "order_by_pos", "key_pos",
                      "order_by_type_spos", "key_type_spos")


def _indexes_payload(fin: Finalized) -> Dict[str, np.ndarray]:
    arrays: Dict[str, np.ndarray] = {
        "node_type_id": fin.node_type_id,
        "incoming_offsets": fin.incoming_offsets,
        "incoming_links": fin.incoming_links,
        "arities": np.array(sorted(fin.buckets), dtype=np.int32),
        "atom_count": np.array([fin.atom_count], dtype=np.int64),
        "node_count": np.array([fin.node_count], dtype=np.int64),
    }
    for arity, b in fin.buckets.items():
        p = f"b{arity}_"
        for name in _BUCKET_FIELDS:
            arrays[p + name] = getattr(b, name)
        for pos in range(arity):
            for name in _BUCKET_POS_FIELDS:
                arrays[f"{p}{name}{pos}"] = getattr(b, name)[pos]
    return arrays


def _restore_indexes(npz, registry: Dict, data: AtomSpaceData) -> Optional[Finalized]:
    """Rebuild a Finalized from saved arrays; None when stale."""
    atom_count = int(npz["atom_count"][0])
    node_count = int(npz["node_count"][0])
    if node_count != len(data.nodes) or atom_count != len(data.nodes) + len(data.links):
        return None  # the records changed since the indexes were saved
    hex_of_row = registry["hex_of_row"]
    if len(hex_of_row) != atom_count:
        return None
    buckets: Dict[int, LinkBucket] = {}
    for arity in npz["arities"].tolist():
        p = f"b{arity}_"
        fields = {name: npz[p + name] for name in _BUCKET_FIELDS}
        for name in _BUCKET_POS_FIELDS:
            fields[name] = [npz[f"{p}{name}{i}"] for i in range(arity)]
        buckets[arity] = LinkBucket(arity=arity, **fields)
    # dangling element hexes are not persisted: with no sentinel target the
    # set is provably empty, otherwise None marks it unknown (the first
    # commit then rebuilds in full)
    has_sentinels = any(bool((b.targets < 0).any()) for b in buckets.values())
    return Finalized(
        atom_count=atom_count,
        node_count=node_count,
        hex_of_row=hex_of_row,
        row_of_hex={h: i for i, h in enumerate(hex_of_row)},
        type_names=registry["type_names"],
        type_id_of_hash=registry["type_id_of_hash"],
        node_type_id=npz["node_type_id"],
        buckets=buckets,
        incoming_offsets=npz["incoming_offsets"],
        incoming_links=npz["incoming_links"],
        dangling_hexes=None if has_sentinels else set(),
    )


def _registry_payload(fin: Finalized) -> Dict:
    return {
        "hex_of_row": list(fin.hex_of_row),
        "type_names": fin.type_names,
        "type_id_of_hash": fin.type_id_of_hash,
    }


def _record_manifest(path: str, sections: Dict[str, Dict]) -> None:
    """Merge per-section digests into the directory's MANIFEST.json
    (created if absent), so the next load verifies what this save wrote."""
    from das_tpu_torch.storage import durable

    mpath = os.path.join(path, durable.MANIFEST_FILE)
    manifest = {
        "format": durable.MANIFEST_FORMAT,
        "generation": 0,
        "delta_version": 0,
        "sections": {},
    }
    if os.path.exists(mpath):
        try:
            manifest = durable.read_manifest(path)
        except Exception:  # noqa: BLE001 — a torn manifest is replaced
            pass
    manifest["sections"].update(sections)
    durable.atomic_write_bytes(mpath, json.dumps(manifest, sort_keys=True, indent=1).encode())


def save(data: AtomSpaceData, path: str, with_indexes: bool = True) -> None:
    """Write a checkpoint directory, every file through the atomic write
    (a crash mid-save leaves the previous file whole), and record each
    section's CRC-32 in MANIFEST.json."""
    from das_tpu_torch.storage import durable

    os.makedirs(path, exist_ok=True)
    sections = {
        RECORDS_FILE: durable.atomic_write_bytes(
            os.path.join(path, RECORDS_FILE), durable.encode(_records_payload(data))
        )
    }
    if with_indexes:
        fin = data.finalize()
        sections[INDEXES_FILE] = durable.atomic_write(
            os.path.join(path, INDEXES_FILE),
            lambda f: np.savez(f, **_indexes_payload(fin)),
        )
        sections[REGISTRY_FILE] = durable.atomic_write_bytes(
            os.path.join(path, REGISTRY_FILE), durable.encode(_registry_payload(fin))
        )
    _record_manifest(path, sections)


def _content_sig(fin: Finalized) -> str:
    """Content fingerprint of a finalized store: md5 over every bucket's
    defining columns (counts alone survive a change that keeps them, such
    as one renamed node; the fingerprint does not)."""
    h = hashlib.md5()
    h.update(np.ascontiguousarray(fin.node_type_id).tobytes())
    for arity in sorted(fin.buckets):
        b = fin.buckets[arity]
        for arr in (b.rows, b.type_id, b.ctype, b.targets):
            h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


#: checkpoint directories already warned about missing digests: the
#: unverified read is accepted once per path per process
_UNVERIFIED_WARNED = set()


def load(path: str, _verified: bool = False) -> AtomSpaceData:
    """Read a checkpoint; the saved indexes are used when fresh, else the
    store re-finalizes.

    * a generational root (``gen-NNNNNN`` directories, no top-level records
      file) loads the newest valid generation and replays its WAL onto the
      host data (`durable.restore` is the spelling that also tracks
      `delta_version`);
    * a flat directory with a MANIFEST.json has every present section
      CRC-checked (`SnapshotCorruptError` on a mismatch);
    * a flat directory with no manifest is accepted once with a warning.
    `_verified` skips the check when the caller (durable.restore) already
    verified this directory."""
    from das_tpu_torch.storage import durable

    if not _verified:
        if not os.path.exists(os.path.join(path, RECORDS_FILE)):
            if durable.list_generations(path):
                data, manifest, gen_dir = durable.newest_valid_generation(path)
                # the generation's WAL holds acknowledged commits made after
                # the snapshot: a records-only read would serve a stale store
                records, _torn = durable.read_wal(
                    os.path.join(gen_dir, manifest.get("wal", durable.WAL_FILE)),
                    truncate=False,
                )
                seen_v = int(manifest.get("delta_version", 0))
                applied = 0
                for rec in records:
                    v = int(rec.get("v", 0))
                    if v <= seen_v:
                        continue  # before the snapshot, or a retried twin
                    durable._replay_record(data, rec)
                    seen_v = v
                    applied += 1
                if applied:
                    log.info(f"checkpoint {path!r}: replayed {applied} WAL commit(s) "
                             f"past generation {manifest.get('generation')}")
                return data
        if os.path.exists(os.path.join(path, durable.MANIFEST_FILE)):
            # a flat checkpoint: an absent optional section (a deleted
            # indexes.npz) is the re-finalize path, not corruption
            durable.verify_generation(path, missing_ok=True)
        elif path not in _UNVERIFIED_WARNED:
            _UNVERIFIED_WARNED.add(path)
            log.warning(f"checkpoint {path!r} has no MANIFEST.json: accepting it "
                        "unverified once; the next save records per-section CRCs")
    with open(os.path.join(path, RECORDS_FILE), "rb") as f:
        data = _restore_records(durable.decode(f.read()))
    indexes = os.path.join(path, INDEXES_FILE)
    registry_path = os.path.join(path, REGISTRY_FILE)
    if os.path.exists(indexes) and os.path.exists(registry_path):
        with open(registry_path, "rb") as f:
            registry = durable.decode(f.read())
        with np.load(indexes) as npz:
            fin = _restore_indexes(npz, registry, data)
        if fin is not None:
            data._fin = fin
    return data


SHARDED_FILE_FMT = "sharded_{}.npz"


def _sharded_payload(db) -> Dict[str, np.ndarray]:
    """The arrays of one ``sharded_S.npz`` section (save_sharded and the
    generational snapshot, storage/durable.py write_snapshot)."""
    arrays: Dict[str, np.ndarray] = {
        "atom_count": np.array([db.fin.atom_count], dtype=np.int64),
        "node_count": np.array([db.fin.node_count], dtype=np.int64),
        "arities": np.array(sorted(db.tables.buckets), dtype=np.int32),
        "content_sig": np.frombuffer(bytes.fromhex(_content_sig(db.fin)), dtype=np.uint8),
    }
    for arity, b in db.tables.buckets.items():
        p = f"b{arity}_"
        arrays[p + "meta"] = np.array([b.m_local, b.size], dtype=np.int64)
        arrays[p + "slab_sizes"] = b.slab_sizes
        for name, arr in b.host().items():
            arrays[p + name] = arr
    return arrays


def save_sharded(db, path: str) -> None:
    """A checkpoint of a sharded store including its slabs: the records and
    indexes checkpoint plus one npz of the stacked slabs, so a restore
    uploads them with no re-partition and no per-slab argsort.  One process
    only (checked before anything is written): the other processes hold
    the other slabs."""
    from das_tpu_torch.storage import durable

    db.mesh.require_one_process("a snapshot")
    save(db.data, path)
    arrays = _sharded_payload(db)
    name = SHARDED_FILE_FMT.format(db.tables.n_shards)
    digest = durable.atomic_write(os.path.join(path, name), lambda f: np.savez(f, **arrays))
    _record_manifest(path, {name: digest})


def try_restore_sharded(path: str, fin: Finalized, mesh):
    """ShardedTables built from the saved slabs, or None when no matching
    ones exist (another shard count, or a store that moved on since the
    save: counts, sizes or the content fingerprint differ); the caller
    then re-partitions.  A sharded checkpoint is never wrong, only
    possibly absent or stale."""
    from das_tpu_torch.parallel.sharded_db import ShardedTables, bucket_from_host

    target = os.path.join(path, SHARDED_FILE_FMT.format(mesh.size))
    if not os.path.exists(target):
        return None
    with np.load(target) as npz:
        if (int(npz["atom_count"][0]) != fin.atom_count
                or int(npz["node_count"][0]) != fin.node_count):
            return None
        # counts survive a content change (one renamed node); the
        # fingerprint does not
        if "content_sig" not in npz or npz["content_sig"].tobytes().hex() != _content_sig(fin):
            return None
        arities = npz["arities"].tolist()
        if sorted(arities) != sorted(fin.buckets):
            return None
        buckets = {}
        for arity in arities:
            p = f"b{arity}_"
            m_local, size = (int(x) for x in npz[p + "meta"])
            if size != fin.buckets[arity].size:
                return None
            arrays = {k[len(p):]: npz[k] for k in npz.files if k.startswith(p)}
            buckets[arity] = bucket_from_host(arity, m_local, size, arrays["slab_sizes"],
                                              arrays, mesh)
    return ShardedTables.from_buckets(buckets, mesh)
