"""Crash-consistent snapshots, a checksummed write-ahead delta log, and
restore with WAL replay and the warm-state bundle (port of
`das_tpu/storage/durable.py`, single device).

* **Generational snapshots.** `write_snapshot(db, root)` writes every
  section (records, indexes, registry, warm bundle) through `atomic_write`
  into a dot-temporary directory, the manifest last, fsyncs it and renames
  it to ``gen-NNNNNN``.  A crash at any point leaves the complete new
  generation or the untouched prior one, never a mix.  The manifest holds
  each section's byte count and CRC-32, the store's `delta_version` and
  the content fingerprint (storage/checkpoint.py `_content_sig`).

* **Write-ahead delta log.** `DeltaLog.append` runs inside
  `IncrementalCommitMixin._apply_delta` after every arity is staged and
  before the first swap (and in `TensorDB.refresh`'s full rebuild before
  the rebuild): one framed record (`<III` magic, length, CRC-32) of the
  insertion-ordered tails of every record and symbol dict since the last
  append, fsynced before anything becomes visible.  `restore(root)` is the
  newest valid generation plus the replay of its WAL, each record checked
  against `delta_version` continuity; a torn tail (a crash mid-append) is
  truncated and never replayed, and a corrupt frame in the middle of the
  file raises and touches nothing.

* **Warm-state bundle.** Learned capacities (query/fused.py `CapStore`),
  the planner estimator's statistics and count-only cache entries persist
  beside the snapshot, keyed by `delta_version`; a bundle older than the
  restored store (the WAL replayed past it) is discarded.

The JAX package frames msgpack payloads; the port frames the same
payloads as JSON (`encode` / `decode`), so a decoded payload equals the
JAX package's and the bytes differ.

Fault seams (fault.FAULT_SITES): `snapshot_write` before a section's first
byte, `snapshot_rename` before a section's and the generation's rename,
`wal_append` before a record is framed, `wal_fsync` between its write and
its fsync, `restore_read` before each section and WAL read.  Reads retry on
`fault.fetch_retry()`; verification failures are typed and not retried.
The `dur.*` spans, events, counters and the `dur.restore_ms` histogram are
obs/'s.

Layout under a snapshot root:

    root/
      gen-000001/
        MANIFEST.json      format, generation, delta_version, content_sig,
                           sections {name: {bytes, crc32}}, wal,
                           warm_delta_version, created_unix
        records.json       host records (checkpoint.py payload)
        indexes.npz        finalized probe indexes
        registry.json      hex_of_row and the type registry
        sharded_S.npz      (sharded store) the S slabs, checkpoint.py
        warm.json          warm-state bundle
        wal.log            commits since this generation
      gen-000002/ ...      newer generations; `DasConfig.snapshot_keep`
                           bounds how many survive pruning
"""

from __future__ import annotations

import io
import json
import logging
import os
import shutil
import struct
import time
import zlib
from itertools import islice
from typing import Callable, Dict, List, Optional, Tuple

from das_tpu_torch.core.exceptions import SnapshotCorruptError

log = logging.getLogger("das_tpu_torch")

MANIFEST_FILE = "MANIFEST.json"
WAL_FILE = "wal.log"
WARM_FILE = "warm.json"
GEN_PREFIX = "gen-"
MANIFEST_FORMAT = 1

#: the modules the persist discipline covers (daslint DL017): in them
#: every byte written flows through the PERSIST_SITES functions below (no
#: bare `open(..., "w")`, `np.savez(path)` or `torch.save(obj, path)`),
#: and a function that renames a file into place fsyncs it first.
#: Matched by path suffix.
PERSIST_SCOPES = (
    "das_tpu_torch/storage/durable.py",
    "das_tpu_torch/storage/checkpoint.py",
    "das_tpu_torch/service/seed_checkpoint.py",
)

#: the closed set of functions allowed to open persist files for writing:
#: `atomic_write`, the write-temp -> fsync -> rename helper every snapshot
#: section and checkpoint file rides; `DeltaLog.append`, the WAL's
#: append-fsync path; `_truncate_wal`, which cuts a torn tail; and
#: `_publish_generation`, the generation directory's fsync and rename
PERSIST_SITES = (
    "atomic_write",
    "DeltaLog.append",
    "_truncate_wal",
    "_publish_generation",
)

#: WAL record framing: "<III" = magic, payload length, payload CRC-32
WAL_MAGIC = 0x5744_414C  # "WDAL"
_WAL_HEADER = struct.Struct("<III")

#: process-wide durability counters
DUR_STATS: Dict[str, object] = {
    "generation": 0,          # newest generation written or restored
    "snapshots": 0,           # write_snapshot completions
    "wal_records": 0,         # WAL records appended
    "recovery_replayed": 0,   # WAL records replayed by restore()
    "torn_tail_truncations": 0,
    "corrupt_generations": 0,  # generations rejected by verification
    "last_restore_s": None,   # wall seconds of the last restore()
}


def snapshot_stats() -> Dict[str, object]:
    """A copy of DUR_STATS."""
    return dict(DUR_STATS)


def reset_stats() -> None:
    DUR_STATS.update(
        generation=0, snapshots=0, wal_records=0, recovery_replayed=0,
        torn_tail_truncations=0, corrupt_generations=0, last_restore_s=None,
    )


# -- payload codec -----------------------------------------------------------


def _assert_str_keys(obj) -> None:
    """Every dict key in the payload is a str (JSON would turn an int key
    into a string silently).  Lists are not walked: no payload holds a
    dict inside a list."""
    if type(obj) is dict:
        if not set(map(type, obj)) <= {str}:
            raise TypeError("a persisted payload has a dict key that is not a str")
        for v in obj.values():
            if type(v) is dict:
                _assert_str_keys(v)


def encode(payload) -> bytes:
    """JSON bytes of a payload made of str-keyed dicts, lists, tuples, str,
    int, bool and None (bytes, floats' NaN and numpy scalars raise)."""
    _assert_str_keys(payload)
    return json.dumps(payload, separators=(",", ":"), allow_nan=False).encode()


def decode(blob: bytes):
    """The payload of `encode` (tuples come back as lists)."""
    return json.loads(blob)


# -- atomic write ------------------------------------------------------------


class _CrcWriter:
    """File wrapper tallying the CRC-32 and byte count of everything
    written, so `atomic_write` returns the manifest digest without reading
    the file back."""

    __slots__ = ("f", "crc", "nbytes")

    def __init__(self, f):
        self.f = f
        self.crc = 0
        self.nbytes = 0

    def write(self, b):
        self.crc = zlib.crc32(b, self.crc)
        self.nbytes += len(b)
        return self.f.write(b)

    # np.savez wraps the target in a ZipFile; refusing to seek makes
    # zipfile stream every byte through write(), so the running CRC sees
    # the whole file, and `read` need only exist for numpy to accept it
    def read(self, *a):
        raise io.UnsupportedOperation("persist writers are write-only")

    def tell(self):
        raise io.UnsupportedOperation("persist writers are append-only")

    def seek(self, *a):
        raise io.UnsupportedOperation("persist writers are append-only")

    def flush(self):
        self.f.flush()

    @property
    def mode(self):
        return self.f.mode

    def fileno(self):
        return self.f.fileno()

    def seekable(self):
        return False

    def readable(self):
        return False

    def writable(self):
        return True


def _fsync_dir(path: str) -> None:
    """fsync a directory, so that an entry just renamed into it survives a
    power loss."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        return  # a platform without directory descriptors
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


def atomic_write(path: str, writer: Callable) -> Dict[str, int]:
    """Stream `writer(fileobj)` into a temporary file, flush and fsync it,
    rename it into place and fsync the directory: a crash leaves the
    complete new file or the untouched old one.  Returns the manifest
    digest `{"bytes": n, "crc32": crc}` of what was written.  Seams:
    `snapshot_write` before any byte lands, `snapshot_rename` between the
    fsync and the rename."""
    from das_tpu_torch import fault

    fault.maybe_fail("snapshot_write")
    tmp = f"{path}.tmp{os.getpid()}"
    try:
        with open(tmp, "wb") as f:
            cw = _CrcWriter(f)
            writer(cw)
            f.flush()
            os.fsync(f.fileno())
        fault.maybe_fail("snapshot_rename")
        os.replace(tmp, path)
    except BaseException:
        try:
            os.remove(tmp)
        except OSError:
            pass
        raise
    _fsync_dir(os.path.dirname(path) or ".")
    return {"bytes": cw.nbytes, "crc32": cw.crc}


def atomic_write_bytes(path: str, data: bytes) -> Dict[str, int]:
    return atomic_write(path, lambda f: f.write(data))


def _publish_generation(tmp_dir: str, gen_dir: str, root: str) -> None:
    """Make a fully written generation visible: fsync its temporary
    directory (each entry was fsynced by `atomic_write`), rename it into
    place, fsync the root."""
    from das_tpu_torch import fault

    fd = os.open(tmp_dir, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)
    fault.maybe_fail("snapshot_rename")
    os.replace(tmp_dir, gen_dir)
    _fsync_dir(root)


# -- write-ahead delta log ---------------------------------------------------

#: AtomSpaceData record dicts whose tail a WAL record captures
_DATA_DICTS = ("nodes", "links", "typedefs")
#: SymbolTable dicts captured with them (a replayed store must resolve
#: handles and parse later transactions as the writer did)
_SYMBOL_DICTS = ("named_type_hash", "named_types", "symbol_hash", "terminal_hash",
                 "parent_type")


def _data_sizes(data) -> Dict[str, int]:
    sizes = {k: len(getattr(data, k)) for k in _DATA_DICTS}
    for k in _SYMBOL_DICTS:
        sizes[k] = len(getattr(data.table, k))
    return sizes


def _dict_tail(d, prev: int) -> List:
    """Keys inserted after position `prev` of an insertion-ordered dict."""
    n = len(d) - prev
    if n <= 0:
        return []
    return list(islice(reversed(d), n))[::-1]


class DeltaLog:
    """Append-only checksummed log of commits, one file per generation
    (`gen-NNNNNN/wal.log`).

    A record carries the commit's `delta_version` after it lands, its kind
    ("delta", or "full" for a rebuild) and the insertion-ordered tail of
    every record and symbol dict since the previous append, so replay
    re-inserts atoms in the writer's order (row interning, and with it the
    device tables, depends on that order).  Logged-but-not-swapped and
    swapped-and-logged are both consistent: replay applies the record
    either way, and a retried commit's twin is skipped by its version."""

    __slots__ = ("path", "_sizes")

    def __init__(self, path: str, data):
        self.path = path
        self._sizes = _data_sizes(data)

    def _capture(self, data) -> Tuple[Dict, Dict[str, int]]:
        """(payload fragment, new sizes) of everything inserted since the
        last append; the sizes commit only once the record is durable."""
        sizes = _data_sizes(data)
        nodes = [
            [h, r.name, r.named_type, r.named_type_hash]
            for h, r in ((h, data.nodes[h])
                         for h in _dict_tail(data.nodes, self._sizes["nodes"]))
        ]
        links = [
            [h, r.named_type, r.named_type_hash, r.composite_type,
             r.composite_type_hash, list(r.elements), r.is_toplevel]
            for h, r in ((h, data.links[h])
                         for h in _dict_tail(data.links, self._sizes["links"]))
        ]
        typedefs = [
            [h, r.name, r.name_hash, r.composite_type_hash, r.designator_name]
            for h, r in ((h, data.typedefs[h])
                         for h in _dict_tail(data.typedefs, self._sizes["typedefs"]))
        ]
        t = data.table
        symbols = {}
        for k in _SYMBOL_DICTS:
            d = getattr(t, k)
            tail = _dict_tail(d, self._sizes[k])
            if k == "terminal_hash":  # keys are (type, name) tuples
                symbols[k] = [[a, b, d[(a, b)]] for a, b in tail]
            else:
                symbols[k] = [[key, d[key]] for key in tail]
        return ({"nodes": nodes, "links": links, "typedefs": typedefs, "symbols": symbols},
                sizes)

    def append(self, data, version: int, kind: str = "delta") -> None:
        """Frame, append and fsync one commit record.  Seams: `wal_append`
        before anything is framed (the file is untouched), `wal_fsync`
        after the write and before the fsync (replay skips a retried
        commit's twin by its version)."""
        from das_tpu_torch import fault, obs

        fault.maybe_fail("wal_append")
        fragment, sizes = self._capture(data)
        fragment["v"] = int(version)
        fragment["kind"] = kind
        payload = encode(fragment)
        rec = _WAL_HEADER.pack(WAL_MAGIC, len(payload), zlib.crc32(payload)) + payload
        with open(self.path, "ab") as f:
            f.write(rec)
            f.flush()
            fault.maybe_fail("wal_fsync")
            os.fsync(f.fileno())
        self._sizes = sizes
        DUR_STATS["wal_records"] = int(DUR_STATS["wal_records"]) + 1
        if obs.enabled():
            obs.event("dur.wal_append", version=version, kind=kind, bytes=len(rec))
            obs.counter("dur.wal_records").inc()


def _truncate_wal(path: str, offset: int) -> None:
    """Cut a torn tail record at the last valid frame boundary and fsync,
    so that the next append starts on a clean frame."""
    from das_tpu_torch import obs

    with open(path, "r+b") as f:
        f.truncate(offset)
        f.flush()
        os.fsync(f.fileno())
    DUR_STATS["torn_tail_truncations"] = int(DUR_STATS["torn_tail_truncations"]) + 1
    if obs.enabled():
        obs.event("dur.wal_truncate", offset=offset)


def read_wal(path: str, truncate: bool = True) -> Tuple[List[Dict], bool]:
    """Parse a WAL into (records, torn), every frame verified (magic,
    length, CRC).  A torn tail (a frame that runs past the end of the
    file: a crash mid-append) is truncated in place when `truncate`, so it
    can never replay.  A corrupt frame that is fully present may have
    acknowledged records behind it: that raises `SnapshotCorruptError`
    and the file is left as it is.  Seam: `restore_read`."""
    from das_tpu_torch import fault

    if not os.path.exists(path):
        return [], False
    fault.maybe_fail("restore_read")
    with open(path, "rb") as f:
        buf = f.read()
    records: List[Dict] = []
    off = 0
    torn = False
    while off < len(buf):
        if len(buf) - off < _WAL_HEADER.size:
            torn = True  # the header itself ran past the end
            break
        magic, ln, crc = _WAL_HEADER.unpack_from(buf, off)
        payload = buf[off + _WAL_HEADER.size: off + _WAL_HEADER.size + ln]
        if magic == WAL_MAGIC and len(payload) < ln:
            torn = True  # the framed length runs past the end
            break
        if magic != WAL_MAGIC or zlib.crc32(payload) != crc:
            raise SnapshotCorruptError(
                f"WAL {path} corrupt at offset {off}: "
                f"{'bad magic' if magic != WAL_MAGIC else 'CRC mismatch'} on a fully "
                "present frame; acknowledged records may follow, refusing to truncate"
            )
        records.append(decode(payload))
        off += _WAL_HEADER.size + ln
    if torn and truncate:
        _truncate_wal(path, off)
    return records, torn


def _replay_record(data, rec: Dict) -> None:
    """Re-insert one WAL record's atoms and symbol-table tail into a host
    store, in the writer's insertion order."""
    from das_tpu_torch.storage.atom_table import LinkRec, NodeRec, TypedefRec

    t = data.table
    for k in _SYMBOL_DICTS:
        d = getattr(t, k)
        for entry in rec["symbols"].get(k, ()):
            if k == "terminal_hash":
                a, b, v = entry
                d[(a, b)] = v
            else:
                key, v = entry
                d[key] = v
    for h, name, nh, cth, desig in rec.get("typedefs", ()):
        if h not in data.typedefs:
            data.typedefs[h] = TypedefRec(name, nh, cth, desig)
    for h, name, nt, nth in rec.get("nodes", ()):
        if h not in data.nodes:
            data.nodes[h] = NodeRec(name, nt, nth)
    for h, nt, nth, ct, cth, elements, top in rec.get("links", ()):
        if h not in data.links:
            data.links[h] = LinkRec(nt, nth, ct, cth, tuple(elements), top)
    data._fin = None


# -- generations -------------------------------------------------------------


def _gen_name(n: int) -> str:
    return f"{GEN_PREFIX}{n:06d}"


def list_generations(root: str) -> List[Tuple[int, str]]:
    """(number, directory) of every completed generation, ascending.  A
    generation is complete once renamed into place (temporary directories
    start with a dot and never match)."""
    if not os.path.isdir(root):
        return []
    out = []
    for name in os.listdir(root):
        if not name.startswith(GEN_PREFIX):
            continue
        try:
            n = int(name[len(GEN_PREFIX):])
        except ValueError:
            continue
        out.append((n, os.path.join(root, name)))
    out.sort()
    return out


def _verified_bytes(path: str, meta: Dict) -> bytes:
    """One manifest section, its byte count and CRC-32 verified.  Seam:
    `restore_read`."""
    from das_tpu_torch import fault

    fault.maybe_fail("restore_read")
    with open(path, "rb") as f:
        b = f.read()
    if len(b) != int(meta["bytes"]) or zlib.crc32(b) != int(meta["crc32"]):
        raise SnapshotCorruptError(
            f"section {os.path.basename(path)} failed verification: {len(b)} bytes / crc "
            f"{zlib.crc32(b):#x} vs manifest {meta['bytes']} / {int(meta['crc32']):#x}"
        )
    return b


def read_manifest(gen_dir: str) -> Dict:
    mpath = os.path.join(gen_dir, MANIFEST_FILE)
    if not os.path.exists(mpath):
        raise SnapshotCorruptError(f"{gen_dir}: no manifest (torn write)")
    try:
        with open(mpath, "rb") as f:
            manifest = json.loads(f.read().decode())
    except (ValueError, OSError) as exc:
        raise SnapshotCorruptError(f"{gen_dir}: unreadable manifest: {exc}")
    if manifest.get("format") != MANIFEST_FORMAT:
        raise SnapshotCorruptError(
            f"{gen_dir}: unsupported manifest format {manifest.get('format')!r}")
    return manifest


def verify_generation(gen_dir: str, missing_ok: bool = False) -> Dict:
    """The manifest, with every section verified.  `missing_ok` is the
    flat-checkpoint mode: a deleted optional section (indexes.npz) is the
    re-finalize path there; in a generation a missing section is a torn
    write."""
    manifest = read_manifest(gen_dir)
    for name, meta in manifest["sections"].items():
        path = os.path.join(gen_dir, name)
        if missing_ok and not os.path.exists(path):
            continue
        _verified_bytes(path, meta)
    return manifest


# -- snapshot write ----------------------------------------------------------


def _warm_payload(db) -> Optional[bytes]:
    """The warm-state bundle of a live store (query/fused.py
    export_warm_state), or None: it is a performance hint, so a store
    that cannot export one has none."""
    try:
        from das_tpu_torch.query.fused import export_warm_state

        state = export_warm_state(db)
        if state is None:
            return None
        return encode(state)
    except Exception:  # noqa: BLE001 — warm state is a hint only
        return None


def write_snapshot(db, root: str, keep: Optional[int] = None) -> str:
    """One atomic generational snapshot of a live store: build
    `gen-NNNNNN` in a dot-temporary directory (records, finalized indexes,
    registry, warm bundle, then the manifest), fsync everything, rename it
    into place.  The store's WAL moves to the new generation, and
    generations beyond `keep` (DasConfig.snapshot_keep) are pruned.
    Returns the generation directory.

    The indexes are `data.finalize()`'s: after commits that is a fresh
    host finalize, whose row order differs from the live store's interned
    one; the live store keeps its own `fin`.  A mesh store spanning
    processes raises before anything is written (its other slabs live in
    other processes)."""
    from das_tpu_torch import obs
    from das_tpu_torch.query.fused import is_sharded

    if is_sharded(db):
        db.mesh.require_one_process("a snapshot")
    cfg = getattr(db, "config", None)
    if keep is None:
        keep = int(getattr(cfg, "snapshot_keep", 2) or 2)
    os.makedirs(root, exist_ok=True)
    gens = list_generations(root)
    gen = (gens[-1][0] + 1) if gens else 1
    gen_dir = os.path.join(root, _gen_name(gen))
    tmp_dir = os.path.join(root, f".{_gen_name(gen)}.tmp{os.getpid()}")
    version = int(getattr(db, "delta_version", 0))
    with obs.span("dur.snapshot", generation=gen, version=version):
        _write_generation(db, root, gen, gen_dir, tmp_dir, version)
    # the new generation is durable: commits from here log into its WAL
    db._wal = DeltaLog(os.path.join(gen_dir, WAL_FILE), db.data)
    db._snapshot_root = root
    DUR_STATS["generation"] = gen
    DUR_STATS["snapshots"] = int(DUR_STATS["snapshots"]) + 1
    if obs.enabled():
        obs.counter("dur.snapshots").inc()
    prune_generations(root, keep)
    return gen_dir


def _write_generation(db, root: str, gen: int, gen_dir: str, tmp_dir: str,
                      version: int) -> None:
    """Every section of generation `gen` into `tmp_dir`, the manifest last,
    then the rename to `gen_dir`; the temporary directory is removed if
    anything fails."""
    from das_tpu_torch.query.fused import is_sharded
    from das_tpu_torch.storage import checkpoint

    import numpy as np

    os.makedirs(tmp_dir, exist_ok=True)
    try:
        data = db.data
        fin = data.finalize()
        sections: Dict[str, Dict[str, int]] = {}
        sections[checkpoint.RECORDS_FILE] = atomic_write_bytes(
            os.path.join(tmp_dir, checkpoint.RECORDS_FILE),
            encode(checkpoint._records_payload(data)),
        )
        sections[checkpoint.INDEXES_FILE] = atomic_write(
            os.path.join(tmp_dir, checkpoint.INDEXES_FILE),
            lambda f: np.savez(f, **checkpoint._indexes_payload(fin)),
        )
        sections[checkpoint.REGISTRY_FILE] = atomic_write_bytes(
            os.path.join(tmp_dir, checkpoint.REGISTRY_FILE),
            encode(checkpoint._registry_payload(fin)),
        )
        if is_sharded(db):
            # a sharded store's slabs: restore uploads them directly when
            # the shard count and content still match
            # (checkpoint.try_restore_sharded)
            name = checkpoint.SHARDED_FILE_FMT.format(db.tables.n_shards)
            sections[name] = atomic_write(
                os.path.join(tmp_dir, name),
                lambda f: np.savez(f, **checkpoint._sharded_payload(db)),
            )
        warm = _warm_payload(db)
        if warm is not None:
            sections[WARM_FILE] = atomic_write_bytes(os.path.join(tmp_dir, WARM_FILE), warm)
        manifest = {
            "format": MANIFEST_FORMAT,
            "generation": gen,
            "delta_version": version,
            "content_sig": checkpoint._content_sig(fin),
            "sections": sections,
            "wal": WAL_FILE,
            "warm_delta_version": None if warm is None else version,
            "created_unix": time.time(),
        }
        atomic_write_bytes(os.path.join(tmp_dir, MANIFEST_FILE),
                           json.dumps(manifest, sort_keys=True, indent=1).encode())
        _publish_generation(tmp_dir, gen_dir, root)
    except BaseException:
        shutil.rmtree(tmp_dir, ignore_errors=True)
        raise


def prune_generations(root: str, keep: int) -> None:
    """Drop the oldest completed generations beyond `keep` (each owns its
    WAL, so pruning never strands a survivor's replay state)."""
    gens = list_generations(root)
    for _n, path in gens[:-keep] if keep > 0 else []:
        shutil.rmtree(path, ignore_errors=True)


# -- restore -----------------------------------------------------------------


def _load_generation(gen_dir: str):
    """(AtomSpaceData with its restored indexes, manifest) of one verified
    generation.  A read failure retries on `fault.fetch_retry()`; a
    verification failure is typed and not retried (the caller falls back
    a generation)."""
    from das_tpu_torch import fault
    from das_tpu_torch.storage import checkpoint

    def attempt():
        manifest = verify_generation(gen_dir)
        data = checkpoint.load(gen_dir, _verified=True)
        return data, manifest

    return fault.fetch_retry().run(attempt)


def newest_valid_generation(root: str):
    """(data, manifest, gen_dir) of the newest generation that passes
    verification, walking back past torn or corrupt ones;
    `SnapshotCorruptError` when none is left."""
    gens = list_generations(root)
    if not gens:
        raise SnapshotCorruptError(f"no snapshot generations under {root}")
    last_exc: Optional[Exception] = None
    for _n, gen_dir in reversed(gens):
        try:
            data, manifest = _load_generation(gen_dir)
            return data, manifest, gen_dir
        except Exception as exc:  # noqa: BLE001 — logged, then the prior generation
            DUR_STATS["corrupt_generations"] = int(DUR_STATS["corrupt_generations"]) + 1
            log.warning(f"snapshot generation {gen_dir} rejected "
                        f"({type(exc).__name__}: {exc}); falling back")
            last_exc = exc
    raise SnapshotCorruptError(f"no valid snapshot generation under {root}: {last_exc}")


def replay_wal(db, gen_dir: str, manifest: Dict) -> int:
    """Replay the generation's WAL onto a freshly restored store through
    its own `refresh()`.  Records at or below the store's delta_version
    are skipped (the snapshot holds them, or a retried commit's twin);
    every applied record must land the store exactly on its version, else
    `SnapshotCorruptError`."""
    from das_tpu_torch import fault

    records, _torn = fault.fetch_retry().run(
        lambda: read_wal(os.path.join(gen_dir, manifest["wal"])))
    replayed = 0
    for rec in records:
        v = int(rec["v"])
        if v <= db.delta_version:
            continue
        if v != db.delta_version + 1:
            raise SnapshotCorruptError(
                f"WAL continuity broken: record v{v} after store v{db.delta_version}")
        _replay_record(db.data, rec)
        db.refresh()
        if db.delta_version != v:
            raise SnapshotCorruptError(
                f"WAL replay diverged: store v{db.delta_version} after applying record v{v}")
        replayed += 1
    DUR_STATS["recovery_replayed"] = int(DUR_STATS["recovery_replayed"]) + replayed
    return replayed


def restore(root: str, config=None, backend: Optional[str] = None, device=None):
    """The newest valid generation under `root`, its WAL replayed to the
    head, and its warm bundle where it still matches: a live store on
    `device` (None = CUDA, which raises without a card) whose commits
    append to the generation's WAL."""
    from das_tpu_torch import obs
    from das_tpu_torch.core.config import DasConfig

    t0 = time.perf_counter()
    config = config or DasConfig()
    backend = backend or config.backend
    if backend not in ("tensor", "sharded"):
        raise ValueError(f"restore: no device backend {backend!r}")
    with obs.span("dur.restore", backend=backend):
        data, manifest, gen_dir = newest_valid_generation(root)
        if backend == "sharded":
            import dataclasses

            from das_tpu_torch.parallel.sharded_db import ShardedDB

            # checkpoint_path points the store's slab restore at the
            # verified generation
            db = ShardedDB(data, dataclasses.replace(config, checkpoint_path=gen_dir),
                           device=device)
        else:
            from das_tpu_torch.storage.tensor_db import TensorDB

            db = TensorDB(data, config, device=device)
        db.delta_version = int(manifest["delta_version"])
        replayed = replay_wal(db, gen_dir, manifest)
        db._wal = DeltaLog(os.path.join(gen_dir, WAL_FILE), db.data)
        db._snapshot_root = root
        warm_applied = _apply_warm(db, gen_dir, manifest)
    elapsed = time.perf_counter() - t0
    DUR_STATS["generation"] = int(manifest["generation"])
    DUR_STATS["last_restore_s"] = round(elapsed, 4)
    if obs.enabled():
        obs.counter("dur.recovery_replayed").inc(replayed)
        obs.histogram("dur.restore_ms").observe(elapsed * 1e3)
    log.info(f"restore: generation {manifest['generation']} + {replayed} WAL commits in "
             f"{elapsed:.3f}s (warm bundle {'applied' if warm_applied else 'absent/stale'})")
    return db


def _apply_warm(db, gen_dir: str, manifest: Dict) -> bool:
    """Apply the warm bundle when its delta_version still matches the
    restored store (a WAL replayed past the snapshot makes it stale)."""
    warm_v = manifest.get("warm_delta_version")
    meta = manifest["sections"].get(WARM_FILE)
    if meta is None or warm_v is None:
        return False
    if int(warm_v) != int(db.delta_version):
        return False
    from das_tpu_torch import fault

    try:
        state = decode(fault.fetch_retry().run(
            lambda: _verified_bytes(os.path.join(gen_dir, WARM_FILE), meta)))
        from das_tpu_torch.query.fused import apply_warm_state

        return apply_warm_state(db, state)
    except SnapshotCorruptError:
        raise
    except Exception:  # noqa: BLE001 — warm state is a hint only
        return False


# -- attach ------------------------------------------------------------------


def attach(db, root: str) -> str:
    """Arm durability on a live store: make the root's newest generation
    describe this store, then point its delta log at that generation's
    WAL.  An empty root gets the first snapshot.  A populated root is
    reused only when its newest generation has an empty WAL and matches
    this store's delta_version and content fingerprint; anything else
    gets a fresh generation (another store's WAL would skip or refuse this
    store's versions at replay).  Returns the active generation
    directory."""
    gens = list_generations(root)
    if gens:
        gen_dir = gens[-1][1]
        try:
            from das_tpu_torch.storage import checkpoint

            manifest = read_manifest(gen_dir)
            wal_records, _torn = read_wal(
                os.path.join(gen_dir, manifest.get("wal", WAL_FILE)), truncate=False)
            matches = (
                not wal_records
                and int(manifest.get("delta_version", -1)) == int(getattr(db, "delta_version", 0))
                and manifest.get("content_sig") == checkpoint._content_sig(db.data.finalize())
            )
        except Exception:  # noqa: BLE001 — unreadable means not this store
            matches = False
        if matches:
            db._wal = DeltaLog(os.path.join(gen_dir, WAL_FILE), db.data)
            db._snapshot_root = root
            DUR_STATS["generation"] = gens[-1][0]
            return gen_dir
    return write_snapshot(db, root)
