"""Build, load and launch the hand-written CUDA kernels.

The sources under `csrc/` are compiled for Hopper (`sm_90a`) at first use
with `nvcc`, one process per source started together, and linked into one
shared library with a plain C interface that is loaded with `ctypes`.  The
library lands in `kernels/build/`, named by a digest of the sources and
flags, so a changed source rebuilds and an unchanged one loads.  A failed
build raises; nothing falls back.

`LAUNCH_COUNTS` counts kernel launches by wrapper: each wrapper adds one
where it launches its kernel on a CUDA tensor, and nowhere else (its plain
PyTorch version, taken for CPU tensors, does not count).  A wrapper whose
kernel has regimes (a design its C entry picks from the shapes alone) also
adds one to `REGIME_COUNTS[(kernel, regime)]`, and keeps in
`DEVICE_LAUNCHES[kernel]` and `LAST_REGIME[kernel]` how many CUDA kernels
its last call launched and in which regime (the C entry reports both).

Every wrapper also notes each call in the program ledger
(obs/proflog.py) through `mark` and `noted`: kind "cuda" where it launched
its kernel, "plain" where it ran the plain version, with the wrapper's
host time; both cost one attribute read while the ledger is off.  The
library's build is the ledger's cold start: a fresh `nvcc` build, or a
load of the library an earlier process built."""

from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import math
import os
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import torch

from das_tpu_torch.obs import proflog

CSRC = Path(__file__).with_name("csrc")
#: most columns of a table and most var_cols / fixed positions / eq pairs of
#: a probed term (csrc/common.cuh DAS_MAXC)
MAX_COLS = 16
BUILD_DIR = Path(__file__).with_name("build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCH_COUNTS: Dict[str, int] = {
    "probe": 0, "index_join": 0, "join_tables": 0, "anti_join": 0, "multiway": 0,
}


REGIME_COUNTS: Dict[Tuple[str, str], int] = {
    ("probe", "warp_search"): 0, ("index_join", "block"): 0, ("index_join", "global"): 0,
    ("join_tables", "block"): 0, ("join_tables", "global"): 0,
    ("anti_join", "shared"): 0, ("anti_join", "global"): 0,
    ("multiway", "block"): 0, ("multiway", "filter"): 0, ("multiway", "global"): 0,
}
DEVICE_LAUNCHES: Dict[str, int] = {}
LAST_REGIME: Dict[str, str] = {}


def reset_launch_counts() -> None:
    for counts in (LAUNCH_COUNTS, REGIME_COUNTS):
        for k in counts:
            counts[k] = 0


def count_call(kernel: str, regime, device_launches) -> None:
    """Record one launched call of a wrapper with regimes, from the
    out-parameters its C entry wrote (regime_out, launches_out)."""
    name = regime.value.decode()
    LAUNCH_COUNTS[kernel] += 1
    REGIME_COUNTS[(kernel, name)] += 1
    DEVICE_LAUNCHES[kernel] = int(device_launches.value)
    LAST_REGIME[kernel] = name


_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)
_PP = ctypes.POINTER(ctypes.c_void_p)
_I64P = ctypes.POINTER(ctypes.c_int64)
_SP = ctypes.POINTER(ctypes.c_char_p)

#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so no pointer is ever cut to 32 bits)
_SIGNATURES = {
    "das_probe_terms": [_I32, ctypes.c_char_p, _IP, _SP, _P],
    "das_index_join_scratch": [_I64, _I64],
    "das_index_join": [
        _P, _P, _I64, _I32, _I32, _I64, _P, _I64, _P, _P, _I64, _I32,
        _IP, _IP, _I32, _IP, _I32, _I64, _P, _P, _P, _P, _IP, _SP, _P,
    ],
    "das_join_tables_scratch": [_I64, _I64, _I64],
    "das_join_tables": [
        _P, _P, _I64, _I32, _P, _P, _I64, _I32, _IP, _IP, _I32, _IP, _I32, _I64,
        _P, _P, _P, _P, _IP, _SP, _P,
    ],
    "das_anti_join_scratch": [_I64],
    "das_anti_join": [
        _P, _P, _I64, _I32, _P, _P, _I64, _I32, _IP, _IP, _I32, _P, _P, _IP, _SP, _P,
    ],
    "das_multiway_scratch": [_I64, _I32, _I64P, _I64],
    "das_multiway": [
        _P, _P, _I64, _I32, _I32, _I32, _PP, _PP, _I64P, _IP, _IP, _IP, _IP, _I64,
        _P, _P, _P, _P, _IP, _SP, _P,
    ],
    "das_scan_inclusive_i64": [_P, _P, _I64, _P, _I64, _P],
    "das_error_name": [_I32],
}
#: result types other than the int error code
_RESTYPES = {"das_anti_join_scratch": _I64, "das_multiway_scratch": _I64,
             "das_join_tables_scratch": _I64, "das_index_join_scratch": _I64,
             "das_error_name": ctypes.c_char_p}


def _sources():
    return sorted(CSRC.glob("*.cu")), sorted(CSRC.glob("*.cuh"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    cu, cuh = _sources()
    for p in cu + cuh:
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME is None:
        raise RuntimeError("das_tpu_torch: nvcc not found (no CUDA toolkit)")
    return os.path.join(CUDA_HOME, "bin", "nvcc")


def library_path() -> Path:
    """Where the library of these sources and flags is (or will be) built."""
    return BUILD_DIR / f"libdas_kernels_{_digest()}.so"


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path.  The compiler's `-Xptxas -v` report (registers,
    shared memory, spills per kernel) is kept beside it as `.ptxas.txt`."""
    so = library_path()
    if so.exists():
        return so
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu, _ = _sources()
    tag = f"{os.getpid()}"
    objs = [BUILD_DIR / f"{p.stem}.{tag}.o" for p in cu]
    procs = [
        subprocess.Popen(
            [nvcc(), *NVCC_FLAGS, "-c", str(src), "-o", str(obj)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        for src, obj in zip(cu, objs)
    ]
    report = []
    failed = []
    for src, proc in zip(cu, procs):
        out, _ = proc.communicate()
        report.append(f"== {src.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("das_tpu_torch kernel build failed:\n" + "\n".join(failed))
    tmp = so.with_name(so.name + f".{tag}.tmp")
    link = subprocess.run(
        [nvcc(), *ARCH_FLAGS, "-shared", *map(str, objs), "-o", str(tmp)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError("das_tpu_torch kernel link failed:\n" + link.stdout)
    so.with_suffix(".ptxas.txt").write_text("\n".join(report))
    os.replace(tmp, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built at first use (noted in the program
    ledger as a fresh build or a load of a built library)."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            t0 = time.perf_counter()
            fresh = not library_path().exists()
            path = build()
            lib = ctypes.CDLL(str(path))
            proflog.record_build("kernel_build", path.name, time.perf_counter() - t0, fresh)
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            _LIB = lib
        return _LIB


def ptxas_report() -> str:
    return build().with_suffix(".ptxas.txt").read_text()


# -- wrapper helpers ------------------------------------------------------------


def mark() -> float:
    """The start of a wrapper call for `noted` (0.0 with the ledger off)."""
    return proflog.launch_mark()


def noted(kernel: str, t0: float, cuda: bool, shape, result):
    """Note one wrapper call in the program ledger and return `result`."""
    proflog.record_launch("kernel", kernel, shape, t0, cuda)
    return result


def is_cuda(t: torch.Tensor) -> bool:
    """Route of a kernel wrapper: True for a CUDA tensor (launch the
    kernel), False for a CPU tensor (the plain version); anything else
    raises."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"das_tpu_torch kernels take CUDA or CPU tensors, not {t.device}")


def check(t: torch.Tensor, name: str, dtype, ndim: int, device) -> None:
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: {t.dim()}-d, expected {ndim}-d")
    if not t.is_contiguous():
        raise ValueError(f"{name}: not contiguous")


def int_array(values: Sequence[int]):
    """A C int array for the small static column lists (None when empty)."""
    values = [int(v) for v in values]
    if not values:
        return None
    return (ctypes.c_int * len(values))(*values)


def ptr_array(tensors: Sequence[torch.Tensor]):
    """A C array of device pointers."""
    return (ctypes.c_void_p * len(tensors))(*[t.data_ptr() for t in tensors])


def launches_out():
    """The out-parameter a C entry writes its launch count into."""
    return ctypes.c_int(0)


def regime_out():
    """The out-parameter a C entry writes its regime's name into."""
    return ctypes.c_char_p()


def scratch(nbytes: int, device):
    """A byte buffer of the size a C entry asked for, or None for 0."""
    return empty(nbytes, torch.uint8, device) if nbytes > 0 else None


def ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def int64_array(values: Sequence[int]):
    return (ctypes.c_int64 * len(values))(*[int(v) for v in values])


def stream_of(device) -> int:
    """The raw handle of the current stream on `device` (the current device
    when it names no index), without building a Stream object."""
    index = device.index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if index is None else index)


def on_device(device):
    """A context that makes `device` current; no-op when it already is."""
    if device.index is None or device.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(device)


def raise_on(err: int, what: str) -> None:
    if err != 0:
        name = library().das_error_name(err).decode()
        raise RuntimeError(f"das_tpu_torch {what} kernel launch failed: CUDA error {err} ({name})")


def scan_scratch(n: int) -> int:
    """int64 elements of block sums das_scan_i64 needs for n inputs (the
    C side checks the same count)."""
    tile, total = 2048, 0
    while n > 0:
        nb = -(-n // tile)
        total += nb
        if nb <= 1:
            break
        n = nb
    return total


def empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


@functools.lru_cache(maxsize=1024)
def _layout(specs):
    """(bytes, [(dtype, shape, strides, element offset)]) of `carve`'s
    buffer for one specs tuple, computed once per tuple."""
    views, total = [], 0
    for shape, dtype in specs:
        strides = [1] * len(shape)
        for i in range(len(shape) - 2, -1, -1):
            strides[i] = strides[i + 1] * shape[i + 1]
        views.append((dtype, shape, tuple(strides), total // dtype.itemsize))
        total += -(-math.prod(shape) * dtype.itemsize // 16) * 16
    return total, views


def carve(device, specs):
    """One allocation for several outputs: a view per (shape, dtype) of
    `specs` (a tuple), each starting on a 16-byte boundary of one byte
    buffer."""
    total, views = _layout(specs)
    buf = empty(total, torch.uint8, device)
    typed = {torch.uint8: buf}
    out = []
    for dtype, shape, strides, offset in views:
        base = typed.get(dtype)
        if base is None:
            base = typed[dtype] = buf.view(dtype)
        out.append(base.as_strided(shape, strides, offset))
    return out
