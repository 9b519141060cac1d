"""A light reader of the port's CUDA sources, for the rules that pin
them (DL005 shared memory, DL011 the kernel-entry contract).

It is not a C++ parser: it strips comments (keeping every line where it
was), then finds `__global__` kernels with their bodies, the
`__shared__` declarations in them, the `<<<grid, block, smem, stream>>>`
launches and the `extern "C"` entry points, by the shapes the sources
under `kernels/csrc/` use.  Every position it reports is a 1-based line
of the original file.  The results are cached on the CudaFile, which the
parse cache keeps per (path, mtime, size).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field
from typing import List, Optional, Tuple

from das_tpu_torch.analysis.core import CudaFile

#: attribute macros that may sit between `__global__` and a kernel's name
_ATTRIBUTES = frozenset((
    "__launch_bounds__", "__cluster_dims__", "__maxnreg__", "__noinline__",
    "__forceinline__", "static", "inline", "void",
))

_WORD = re.compile(r"[A-Za-z_]\w*")
_SHARED = re.compile(r"(extern\s+)?__shared__\s+([^;]*);")
_ALIGN = re.compile(r"__align__\s*\([^)]*\)")
_DECL_NAME = re.compile(r"([A-Za-z_]\w*)\s*((?:\[[^\]]*\]\s*)*)$")
_LAUNCH = re.compile(r"\b([A-Za-z_]\w*)\s*(<[^;{}]*?>)?\s*<<<(.*?)>>>", re.S)
_EXTERN_C = re.compile(r'extern\s+"C"\s+([^;{(]*?)\b([A-Za-z_]\w*)\s*\(')


def strip_comments(text: str) -> str:
    """`text` with every comment and string literal blanked to spaces,
    newlines kept, so offsets and lines stay those of the file."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            for k in range(i, j):
                out[k] = " "
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            for k in range(i, j):
                if out[k] != "\n":
                    out[k] = " "
            i = j
        elif c in "\"'":
            j = i + 1
            while j < n and text[j] != c and text[j] != "\n":
                j += 2 if text[j] == "\\" else 1
            # keep the quotes (extern "C" is matched on them), blank the rest
            for k in range(i + 1, min(j, n)):
                out[k] = " "
            if text[i:j + 1] == '"C"':
                out[i + 1] = "C"
            i = j + 1
        else:
            i += 1
    return "".join(out)


def _match(text: str, i: int, open_c: str, close_c: str) -> int:
    """Index just past the bracket that closes the one at `i`."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_c:
            depth += 1
        elif text[j] == close_c:
            depth -= 1
            if depth == 0:
                return j + 1
    return len(text)


def line_of(text: str, offset: int) -> int:
    return text.count("\n", 0, offset) + 1


def split_args(s: str) -> List[str]:
    """Top-level comma split of an argument list (brackets nest; angle
    brackets do not, a launch configuration shifts with `<<`)."""
    out, depth, cur = [], 0, []
    for c in s:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur))
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        out.append("".join(cur))
    return [a.strip() for a in out]


def normalize(expr: str) -> str:
    """An expression with its whitespace collapsed: the form manifests
    and messages quote."""
    return " ".join(expr.split())


@dataclass
class Kernel:
    name: str
    line: int
    #: `__shared__` declarations in the body, in order: "name[dims]" for
    #: a static buffer, "extern name[]" for the dynamic one
    shared: List[Tuple[int, str]] = field(default_factory=list)
    body: Tuple[int, int] = (0, 0)


@dataclass
class Launch:
    kernel: str
    line: int
    config: List[str]

    @property
    def dynamic_smem(self) -> Optional[str]:
        """The launch's dynamic shared-memory size, None when it gives
        none (two arguments, or a literal 0)."""
        if len(self.config) < 3 or self.config[2] in ("0", "0u", "0ul"):
            return None
        return normalize(self.config[2])


@dataclass
class CudaModel:
    kernels: List[Kernel]
    launches: List[Launch]
    #: (line, name) of every `extern "C"` entry point
    entries: List[Tuple[int, str]]
    #: (line, declaration) of `__shared__` declarations outside every kernel
    stray_shared: List[Tuple[int, str]]


def _shared_decl(extern: bool, decl: str) -> str:
    decl = normalize(_ALIGN.sub(" ", decl))
    m = _DECL_NAME.search(decl)
    if m is None:
        return normalize(decl)
    name, dims = m.group(1), "".join(m.group(2).split())
    return f"extern {name}[]" if extern else f"{name}{dims}"


def model(cf: CudaFile) -> CudaModel:
    cached = getattr(cf, "_cuda_model", None)
    if cached is not None:
        return cached
    text = strip_comments(cf.text)
    kernels: List[Kernel] = []
    for m in re.finditer(r"\b__global__\b", text):
        i = m.end()
        name = None
        while i < len(text):
            w = _WORD.search(text, i)
            if w is None:
                break
            rest = text[w.end():].lstrip()
            i = w.end()
            if w.group(0) in _ATTRIBUTES:
                if rest.startswith("("):
                    i = _match(text, text.index("(", w.end()), "(", ")")
                continue
            if rest.startswith("("):
                name = w.group(0)
                break
        if name is None:
            continue
        params_end = _match(text, text.index("(", i), "(", ")")
        brace = text.find("{", params_end)
        semi = text.find(";", params_end)
        if brace < 0 or (0 <= semi < brace):
            continue  # a declaration, not a definition
        end = _match(text, brace, "{", "}")
        k = Kernel(name, line_of(text, m.start()), body=(brace, end))
        for s in _SHARED.finditer(text, brace, end):
            k.shared.append((line_of(text, s.start()),
                             _shared_decl(bool(s.group(1)), s.group(2))))
        kernels.append(k)
    stray = []
    for s in _SHARED.finditer(text):
        if not any(k.body[0] <= s.start() < k.body[1] for k in kernels):
            stray.append((line_of(text, s.start()),
                          _shared_decl(bool(s.group(1)), s.group(2))))
    launches = [
        Launch(m.group(1), line_of(text, m.start()), split_args(m.group(3)))
        for m in _LAUNCH.finditer(text)
    ]
    entries = [(line_of(text, m.start()), m.group(2)) for m in _EXTERN_C.finditer(text)]
    result = CudaModel(kernels, launches, entries, stray)
    cf._cuda_model = result
    return result
