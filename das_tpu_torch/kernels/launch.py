"""Build, load and launch the hand-written CUDA kernels.

The sources under `csrc/` are compiled for Hopper (`sm_90a`) at first use
with `nvcc`, one process per source started together, and linked into one
shared library with a plain C interface that is loaded with `ctypes`.  The
library lands in `kernels/build/`, named by a digest of the sources and
flags, so a changed source rebuilds and an unchanged one loads.  A failed
build raises; nothing falls back.

`LAUNCH_COUNTS` counts kernel launches by wrapper: each wrapper adds one
where it launches its kernel on a CUDA tensor, and nowhere else (its plain
PyTorch version, taken for CPU tensors, does not count)."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence

import torch

CSRC = Path(__file__).with_name("csrc")
BUILD_DIR = Path(__file__).with_name("build")
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = ARCH_FLAGS + ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCH_COUNTS: Dict[str, int] = {
    "probe": 0, "index_join": 0, "join_tables": 0, "anti_join": 0,
}


def reset_launch_counts() -> None:
    for k in LAUNCH_COUNTS:
        LAUNCH_COUNTS[k] = 0


_LIB: Optional[ctypes.CDLL] = None
_LOCK = threading.Lock()
_P, _I64, _I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
_IP = ctypes.POINTER(ctypes.c_int)

#: C entry points and their argument types (pointers and the stream as
#: c_void_p, so no pointer is ever cut to 32 bits)
_SIGNATURES = {
    "das_probe_term_table": [
        _P, _I32, _I64, _I64, _P, _P, _I64, _I32, _I64,
        _IP, _I32, _IP, _IP, _I32, _IP, _IP, _I32,
        _P, _P, _P, _P, _P,
    ],
    "das_index_join": [
        _P, _P, _I64, _I32, _I32, _I64, _P, _I64, _P, _P, _I64, _I32,
        _IP, _IP, _I32, _IP, _I32, _I64,
        _P, _P, _P, _P, _I64, _P, _P, _P, _P,
    ],
    "das_join_tables": [
        _P, _P, _I64, _I32, _P, _P, _I64, _I32, _IP, _IP, _I32, _IP, _I32, _I64,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P, _P, _P,
    ],
    "das_anti_join": [
        _P, _P, _I64, _I32, _P, _P, _I64, _I32, _IP, _IP, _I32,
        _P, _P, _P, _P, _P, _P, _P, _P, _P, _I64, _P, _P,
    ],
    "das_scan_inclusive_i64": [_P, _P, _I64, _P, _I64, _P],
    "das_argsort_i64": [_P, _I64, _P, _P, _P, _P, _P, _P, _P, _I64, _P],
}


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


def build() -> Path:
    """Compile every source in parallel and link the shared library;
    returns its path.  The compiler's `-Xptxas -v` report (registers,
    shared memory, spills per kernel) is kept beside it as `.ptxas.txt`."""
    so = BUILD_DIR / f"libdas_kernels_{_digest()}.so"
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
    """The loaded kernel library, built at first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
        return _LIB


def ptxas_report() -> str:
    return build().with_suffix(".ptxas.txt").read_text()


# -- wrapper helpers ------------------------------------------------------------


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


def stream_of(device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def raise_on(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"das_tpu_torch {what} kernel launch failed: CUDA error {err}")


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


def sort_tiles(n: int) -> int:
    return -(-n // 4096)


def empty(shape, dtype, device) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=device)


def sort_scratch(n_right: int, n_left: int, device):
    """The radix sort's buffers for n_right keys plus one scan scratch big
    enough for both its histogram scan and an n_left offsets scan."""
    tiles = sort_tiles(n_right)
    scan_len = max(scan_scratch(256 * tiles), scan_scratch(n_left), 1)
    return dict(
        key_r=empty(max(n_right, 1), torch.int64, device),
        key_r_sorted=empty(max(n_right, 1), torch.int64, device),
        order=empty(max(n_right, 1), torch.int32, device),
        tmp_keys=empty(max(n_right, 1), torch.int64, device),
        tmp_idx=empty(max(n_right, 1), torch.int32, device),
        hist=empty(max(256 * tiles, 1), torch.int64, device),
        hist_incl=empty(max(256 * tiles, 1), torch.int64, device),
        scan=empty(scan_len, torch.int64, device),
        scan_len=scan_len,
    )
