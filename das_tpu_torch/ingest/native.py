"""ctypes binding for the native canonical scanner (native/src/das_native.cc
and native/src/das_columnar.cc).

The C++ library parses canonical knowledge-base files on std::thread
workers (GIL-free) and computes all md5 handles inline; this module decodes
its record stream into `AtomSpaceData`, producing records identical to the
pure-Python loader (ingest/canonical.py), or wraps its chunk-parallel
columnar output as the lazy-view store (storage/columnar.py).

The library is compiled on first use from the sources in `native/src/`,
read in place, with the flags of `native/Makefile`: one `g++` per source,
all started together, then one link.  The `.so` goes to this package's own
`ingest/build/`, named by a digest of the sources and the flags, written
under a temporary name and renamed, so processes building at once never
see a torn file.  A failed build (or a missing compiler) raises
`NativeBuildError` with the compiler's output; nothing falls back to the
Python scanner behind the caller's back.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path
from typing import List, Optional

import numpy as np

from das_tpu_torch.ingest.canonical import CanonicalParseError
from das_tpu_torch.obs import proflog
from das_tpu_torch.storage.atom_table import AtomSpaceData

_REPO_ROOT = Path(__file__).resolve().parents[2]
NATIVE_SRC = _REPO_ROOT / "native" / "src"
SOURCES = ("das_native.cc", "das_columnar.cc", "md5.cc")
HEADERS = ("md5.h",)
#: native/Makefile's CXXFLAGS, plus -shared at the link
CXX_FLAGS = ("-O3", "-std=c++17", "-fPIC", "-Wall", "-Wextra", "-pthread")
CXX = "g++"
BUILD_DIR = Path(__file__).resolve().parent / "build"

_lib: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()


class NativeParseError(CanonicalParseError):
    pass


class NativeBuildError(RuntimeError):
    """The scanner library could not be compiled or loaded."""


def _digest() -> str:
    h = hashlib.sha256(" ".join((CXX, *CXX_FLAGS)).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((NATIVE_SRC / name).read_bytes())
    return h.hexdigest()[:16]


def _fail(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)
    raise NativeBuildError(msg)


def library_path() -> Path:
    """Where the scanner library of these sources and flags is (or will
    be) built."""
    return BUILD_DIR / f"libdas_native_{_digest()}.so"


def build() -> Path:
    """Compile the scanner library if no build of these sources and flags
    exists yet; returns its path.  Concurrent builds serialize on a lock
    file in the build directory."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with open(BUILD_DIR / ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():
            return so
        tag = f"{os.getpid()}.{threading.get_ident()}"
        objs = [BUILD_DIR / f"{Path(s).stem}.{tag}.o" for s in SOURCES]
        try:
            try:
                procs = [
                    subprocess.Popen(
                        [CXX, *CXX_FLAGS, "-c", str(NATIVE_SRC / src), "-o", str(obj)],
                        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                    )
                    for src, obj in zip(SOURCES, objs)
                ]
            except OSError as exc:
                _fail(f"das_tpu_torch native scanner: cannot run {CXX!r}: {exc}")
            failed = []
            for src, proc in zip(SOURCES, procs):
                out, _ = proc.communicate()
                if proc.returncode != 0:
                    failed.append(f"{src}:\n{out}")
            if failed:
                _fail("das_tpu_torch native scanner build failed:\n" + "\n".join(failed))
            tmp = so.with_name(f"{so.name}.{tag}.tmp")
            link = subprocess.run(
                [CXX, "-shared", "-pthread", *map(str, objs), "-o", str(tmp)],
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            )
            if link.returncode != 0:
                tmp.unlink(missing_ok=True)
                _fail("das_tpu_torch native scanner link failed:\n" + link.stdout)
            os.replace(tmp, so)
        finally:
            for obj in objs:
                obj.unlink(missing_ok=True)
    return so


def get_lib() -> ctypes.CDLL:
    """The loaded scanner library, built at first use; raises
    NativeBuildError when it cannot be built or loaded."""
    global _lib
    with _LOCK:
        if _lib is not None:
            return _lib
        t0 = time.perf_counter()
        fresh = not library_path().exists()
        path = build()
        try:
            lib = ctypes.CDLL(str(path))
        except OSError as exc:
            _fail(f"das_tpu_torch native scanner: cannot load {path}: {exc}")
        # the program ledger's cold start: a fresh build or a load
        proflog.record_build("scanner_build", path.name, time.perf_counter() - t0, fresh)
        lib.das_parse_files.restype = ctypes.c_void_p
        lib.das_parse_files.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.das_parse_text.restype = ctypes.c_void_p
        lib.das_parse_text.argtypes = [ctypes.c_char_p, ctypes.c_uint64]
        lib.das_buffer_count.restype = ctypes.c_int
        lib.das_buffer_count.argtypes = [ctypes.c_void_p]
        lib.das_buffer.restype = ctypes.POINTER(ctypes.c_uint8)
        lib.das_buffer.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.das_error.restype = ctypes.c_char_p
        lib.das_error.argtypes = [ctypes.c_void_p]
        lib.das_free.argtypes = [ctypes.c_void_p]
        lib.das_buffer_release.argtypes = [ctypes.c_void_p, ctypes.c_int]
        lib.das_md5_hex.argtypes = [
            ctypes.c_char_p,
            ctypes.c_uint64,
            ctypes.c_char_p,
        ]
        lib.das_parse_files_columnar.restype = ctypes.c_void_p
        lib.das_parse_files_columnar.argtypes = [
            ctypes.POINTER(ctypes.c_char_p),
            ctypes.c_int,
            ctypes.c_int,
        ]
        lib.das_col_error.restype = ctypes.c_char_p
        lib.das_col_error.argtypes = [ctypes.c_void_p]
        lib.das_col_get.restype = ctypes.c_int
        lib.das_col_get.argtypes = [
            ctypes.c_void_p,
            ctypes.c_int,
            ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8)),
            ctypes.POINTER(ctypes.c_uint64),
        ]
        lib.das_col_free.argtypes = [ctypes.c_void_p]
        _lib = lib
        return _lib


def native_md5_hex(data: bytes) -> str:
    lib = get_lib()
    out = ctypes.create_string_buffer(32)
    lib.das_md5_hex(data, len(data), out)
    return out.raw.decode("ascii")


# ---------------------------------------------------------------------------
# record-stream decoding
# ---------------------------------------------------------------------------


def _decode_into(buf: bytes, data: AtomSpaceData) -> None:
    """Replay one record stream into the store.

    Produces records identical to the Python loader's (mirrors the
    construction in ingest/canonical.py) but builds
    NodeRec/LinkRec/TypedefRec directly with inline dedup — the
    per-record `Expression` hop and `add_*` dispatch are pure overhead at
    millions of records — and decodes each record's contiguous hex block
    with a single bytes.decode.
    """
    from das_tpu_torch.storage.atom_table import LinkRec, NodeRec, TypedefRec

    table = data.table
    nodes = data.nodes
    links = data.links
    typedefs = data.typedefs
    named_type_hash = table.named_type_hash
    terminal_hash = table.terminal_hash
    pos = 0
    end = len(buf)
    u16 = struct.Struct("<H").unpack_from
    u32 = struct.Struct("<I").unpack_from
    # same-type links arrive in long runs (converter output is grouped);
    # caching the previous type's decoded string + interned hash removes
    # two dict probes and a utf-8 decode from most hot-path iterations
    last_type_raw = None
    last_type = last_nth = ""
    while pos < end:
        tag = buf[pos]
        pos += 1
        if tag == 3:  # link (hot path)
            (tlen,) = u16(buf, pos)
            pos += 2
            type_raw = buf[pos : pos + tlen]
            pos += tlen
            toplevel = buf[pos] != 0
            pos += 1
            (ne,) = u16(buf, pos)
            pos += 2
            kinds = buf[pos : pos + ne]
            pos += ne
            nterm = kinds.count(1)  # kind ∈ {0, 1}
            blk_chars = 32 * (3 + ne + nterm)
            blk = buf[pos : pos + blk_chars].decode("ascii")
            pos += blk_chars
            if type_raw == last_type_raw:
                named_type, nth = last_type, last_nth
            else:
                named_type = type_raw.decode("utf-8")
                nth = blk[:32]
                named_type_hash.setdefault(named_type, nth)
                last_type_raw, last_type, last_nth = type_raw, named_type, nth
            elements: List[str] = []
            composite_type: List = [nth]
            off = 32
            soff = 32 * (1 + ne)
            for kind in kinds:
                ehash = blk[off : off + 32]
                off += 32
                elements.append(ehash)
                if kind:
                    composite_type.append(blk[soff : soff + 32])
                    soff += 32
                else:
                    # sub-expression record always precedes its parent
                    composite_type.append(links[ehash].composite_type)
            ct_hash = blk[-64:-32]
            hash_code = blk[-32:]
            prev = links.get(hash_code)
            if prev is None:
                links[hash_code] = LinkRec(
                    named_type=named_type,
                    named_type_hash=nth,
                    composite_type=composite_type,
                    composite_type_hash=ct_hash,
                    elements=tuple(elements),
                    is_toplevel=toplevel,
                )
            elif toplevel:
                set_top = getattr(links, "set_toplevel", None)
                if set_top is not None:
                    # columnar view (a second load onto a columnar-backed
                    # store): the reconstructed LinkRec is a copy, so the
                    # flag must write through to the column
                    set_top(hash_code)
                else:
                    prev.is_toplevel = True
        elif tag == 2:  # terminal
            (slen,) = u16(buf, pos)
            pos += 2
            stype = buf[pos : pos + slen].decode("utf-8")
            pos += slen
            (nlen,) = u32(buf, pos)
            pos += 4
            name = buf[pos : pos + nlen].decode("utf-8")
            pos += nlen
            blk = buf[pos : pos + 64].decode("ascii")
            pos += 64
            stype_hash = blk[:32]
            h = blk[32:]
            named_type_hash.setdefault(stype, stype_hash)
            terminal_hash[(stype, name)] = h
            # like the MeTTa parser on a terminal declaration: later
            # transactions referencing the bare name must resolve
            table.named_types[name] = stype
            if h not in nodes:
                nodes[h] = NodeRec(
                    name=name, named_type=stype, named_type_hash=stype_hash
                )
        elif tag == 1:  # typedef
            (nlen,) = u16(buf, pos)
            pos += 2
            name = buf[pos : pos + nlen].decode("utf-8")
            pos += nlen
            (slen,) = u16(buf, pos)
            pos += 2
            stype = buf[pos : pos + slen].decode("utf-8")
            pos += slen
            blk = buf[pos : pos + 128].decode("ascii")
            pos += 128
            name_hash = blk[:32]
            stype_hash = blk[32:64]
            ct_hash = blk[64:96]
            hash_code = blk[96:]
            named_type_hash.setdefault(name, name_hash)
            named_type_hash.setdefault(stype, stype_hash)
            table.named_types[name] = stype
            table.parent_type[name_hash] = stype_hash
            table.symbol_hash[name] = hash_code
            if hash_code not in typedefs:
                typedefs[hash_code] = TypedefRec(
                    name=name,
                    name_hash=name_hash,
                    composite_type_hash=ct_hash,
                    designator_name=stype,
                )
        else:  # pragma: no cover — stream corruption
            raise NativeParseError(f"bad record tag {tag} at offset {pos - 1}")
    data._fin = None


def _buffer_bytes(ptr, size: int) -> bytes:
    """Copy a native buffer of ANY size.  `ctypes.string_at` declares its
    size parameter as a C int: a >2 GiB record stream (one flybase-scale
    file is ~4-5 GB) wrapped negative and raised SystemError deep inside
    PyBytes_FromStringAndSize."""
    if size < (1 << 31) - 1:
        return ctypes.string_at(ptr, size)
    return bytes((ctypes.c_char * size).from_address(
        ctypes.cast(ptr, ctypes.c_void_p).value
    ))


def _drain_result(lib: ctypes.CDLL, handle: int, data: AtomSpaceData) -> None:
    try:
        err = lib.das_error(handle)
        if err:
            raise NativeParseError(err.decode("utf-8", "replace"))
        size = ctypes.c_uint64()
        for i in range(lib.das_buffer_count(handle)):
            ptr = lib.das_buffer(handle, i, ctypes.byref(size))
            if size.value:
                buf = _buffer_bytes(ptr, size.value)
                lib.das_buffer_release(handle, i)  # free before decode:
                # buffer + copy would otherwise coexist for the whole
                # decode of a multi-GB stream
                _decode_into(buf, data)
            else:
                lib.das_buffer_release(handle, i)
    finally:
        lib.das_free(handle)


def load_canonical_files_native(
    paths: List[str],
    data: Optional[AtomSpaceData] = None,
    n_threads: Optional[int] = None,
) -> AtomSpaceData:
    """Parse canonical files with the native scanner (C++ threads), then
    replay the record streams into the store in input order.

    Files are processed in waves of `n_threads` so at most one wave's
    encoded record streams (which expand nested expressions) is resident
    at once — large multi-file KBs stay within host memory the way the
    streaming Python fallback does."""
    lib = get_lib()
    if data is None:
        data = AtomSpaceData()
    if not paths:
        return data
    workers = n_threads or min(len(paths), os.cpu_count() or 1)
    for start in range(0, len(paths), workers):
        wave = paths[start : start + workers]
        arr = (ctypes.c_char_p * len(wave))(*[p.encode("utf-8") for p in wave])
        handle = lib.das_parse_files(arr, len(wave), workers)
        _drain_result(lib, handle, data)
    return data


def _col_field(lib, handle, field: int):
    """(pointer, nbytes) of one columnar field in the native result."""
    ptr = ctypes.POINTER(ctypes.c_uint8)()
    size = ctypes.c_uint64()
    rc = lib.das_col_get(handle, field, ctypes.byref(ptr), ctypes.byref(size))
    if rc != 0:
        raise NativeParseError(f"bad columnar field {field}")
    return ptr, int(size.value)


def _col_array(lib, handle, field: int, dtype, width: int = 0):
    """ONE copy of a columnar field, straight off the native pointer into
    a numpy array ([n, width] when width > 0) — these are multi-GB at
    reference scale, so no intermediate bytes object."""
    ptr, nbytes = _col_field(lib, handle, field)
    if nbytes == 0:
        arr = np.empty(0, dtype=dtype)
    else:
        arr = np.ctypeslib.as_array(ptr, shape=(nbytes,)).view(dtype).copy()
    if width:
        arr = arr.reshape(-1, width)
    return arr


def _col_bytes(lib, handle, field: int) -> bytes:
    """ONE copy of a blob field as bytes."""
    ptr, nbytes = _col_field(lib, handle, field)
    return _buffer_bytes(ptr, nbytes) if nbytes else b""


def load_canonical_files_columnar(
    paths: List[str],
    data: Optional[AtomSpaceData] = None,
    n_threads: Optional[int] = None,
) -> AtomSpaceData:
    """Chunk-parallel columnar parse (native/src/das_columnar.cc): files are
    split at newline boundaries, parsed on C++ threads, deduped and
    index-resolved natively; Python receives flat numpy columns and builds
    the lazy-view store (storage/columnar.py) with zero per-record work."""
    from das_tpu_torch.storage.columnar import ColumnarCore, attach_columnar

    lib = get_lib()
    if data is None:
        data = AtomSpaceData()
    if not paths:
        return data
    workers = n_threads or (os.cpu_count() or 1)
    arr = (ctypes.c_char_p * len(paths))(*[p.encode("utf-8") for p in paths])
    handle = lib.das_parse_files_columnar(arr, len(paths), workers)
    try:
        err = lib.das_col_error(handle)
        if err:
            raise NativeParseError(err.decode("utf-8", "replace"))
        type_off = _col_array(lib, handle, 0, np.uint32)
        type_blob = _col_bytes(lib, handle, 1)
        type_hash16 = _col_array(lib, handle, 2, np.uint8, width=16)
        type_names = [
            type_blob[type_off[i] : type_off[i + 1]].decode("utf-8")
            for i in range(len(type_off) - 1)
        ]
        core = ColumnarCore(
            type_names=type_names,
            type_hash16=type_hash16,
            td_name_tid=_col_array(lib, handle, 3, np.int32),
            td_stype_tid=_col_array(lib, handle, 4, np.int32),
            td_ct=_col_array(lib, handle, 5, np.uint8, width=16),
            td_hash=_col_array(lib, handle, 6, np.uint8, width=16),
            node_hash=_col_array(lib, handle, 7, np.uint8, width=16),
            node_tid=_col_array(lib, handle, 8, np.int32),
            node_name_off=_col_array(lib, handle, 9, np.uint64).astype(np.int64),
            node_name_blob=_col_bytes(lib, handle, 10),
            link_hash=_col_array(lib, handle, 11, np.uint8, width=16),
            link_tid=_col_array(lib, handle, 12, np.int32),
            link_ct=_col_array(lib, handle, 13, np.uint8, width=16),
            link_top=_col_array(lib, handle, 14, np.uint8),
            link_elem_off=_col_array(lib, handle, 15, np.uint64).astype(np.int64),
            link_elem=_col_array(lib, handle, 16, np.int32),
            dangling=[
                d.decode("ascii") for d in _chunk32(_col_bytes(lib, handle, 17))
            ],
        )
    finally:
        lib.das_col_free(handle)
    return attach_columnar(data, core)


def _chunk32(blob: bytes) -> List[bytes]:
    return [blob[i : i + 32] for i in range(0, len(blob), 32)]


def load_canonical_text_native(
    text: str, data: Optional[AtomSpaceData] = None
) -> AtomSpaceData:
    lib = get_lib()
    if data is None:
        data = AtomSpaceData()
    raw = text.encode("utf-8")
    handle = lib.das_parse_text(raw, len(raw))
    _drain_result(lib, handle, data)
    return data
