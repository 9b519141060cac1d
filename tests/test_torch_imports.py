"""The port stands alone: no module of das_tpu_torch/ and not
chip_smoke.py imports JAX or any module of the JAX package das_tpu, nor
msgpack, and none but the four transport modules imports grpc or protobuf,
which the card machine lacks (pinned by an AST scan, one case per file);
the import closure of chip_smoke.py and of tests/test_torch_gpu.py holds
no transport module; no file reads the environment; the analyzer
(das_tpu_torch/analysis/) imports the standard library and itself only;
and an entry point
left to its default device raises without a CUDA card instead of falling
back to the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "das_tpu")
#: the only modules of the port that import grpc or protobuf: the gRPC wire
#: and the client, which the card's path never imports
TRANSPORT = (
    "das_tpu_torch/service/transport.py",
    "das_tpu_torch/service/client.py",
    "das_tpu_torch/service/service_spec/das_pb2.py",
    "das_tpu_torch/service/service_spec/das_pb2_grpc.py",
)


def _port_files():
    files = sorted((ROOT / "das_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _main_blocks(tree):
    """Statements under `if __name__ == "__main__":`, which run only when
    the file is the program, never on import."""
    skip = set()
    for node in tree.body:
        if (isinstance(node, ast.If) and isinstance(node.test, ast.Compare)
                and getattr(node.test.left, "id", "") == "__name__"):
            for sub in node.body:
                skip.update(id(n) for n in ast.walk(sub))
    return skip


def _imports(path, on_import_only=False):
    tree = ast.parse(path.read_text(), filename=str(path))
    skip = _main_blocks(tree) if on_import_only else set()
    for node in ast.walk(tree):
        if id(node) in skip:
            continue
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom):
            if node.level == 0 and node.module:
                yield node.module
        elif isinstance(node, ast.Call) and getattr(node.func, "id", "") == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                yield str(node.args[0].value)


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_das_tpu_import(path):
    for name in _imports(path):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path.name} imports {name}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_msgpack_import(path):
    """The port's snapshots and WAL are JSON: msgpack is not installed on
    the card machine, so an import of it would end the run there."""
    for name in _imports(path):
        assert name.split(".")[0] != "msgpack", f"{path.name} imports {name}"


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_grpc_import(path):
    """grpcio and protobuf are not installed on the card machine either:
    only the four transport modules import them."""
    if str(path.relative_to(ROOT)) in TRANSPORT:
        return
    for name in _imports(path):
        assert name.split(".")[0] not in ("grpc", "google", "msgpack"), \
            f"{path.name} imports {name}"


def test_transport_modules_exist():
    for rel in TRANSPORT:
        assert ROOT / rel in _port_files(), rel


def _module_file(name):
    """The file of a das_tpu_torch module or package, else None."""
    base = ROOT.joinpath(*name.split("."))
    for cand in (base.with_suffix(".py"), base / "__init__.py"):
        if cand.exists():
            return cand
    return None


def _closure(start):
    """Every das_tpu_torch file that importing `start` can load, function-
    level imports included (they run when the function does), the parent
    packages' __init__ files too; `__main__` blocks are left out."""
    seen, todo, foreign = set(), [start], set()
    while todo:
        path = todo.pop()
        if path in seen:
            continue
        seen.add(path)
        tree = ast.parse(path.read_text(), filename=str(path))
        skip = _main_blocks(tree)
        for node in ast.walk(tree):
            if id(node) in skip:
                continue
            names = []
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                if node.level:
                    pkg = ".".join(path.relative_to(ROOT).with_suffix("").parts[:-node.level])
                    mod = f"{pkg}.{node.module}" if node.module else pkg
                else:
                    mod = node.module or ""
                names = [mod] + [f"{mod}.{a.name}" for a in node.names]
            for name in names:
                top = name.split(".")[0]
                if top != "das_tpu_torch":
                    foreign.add(top)
                    continue
                parts = name.split(".")
                for i in range(1, len(parts) + 1):
                    f = _module_file(".".join(parts[:i]))
                    if f is not None:
                        todo.append(f)
    return seen, foreign


@pytest.mark.parametrize("start", ["chip_smoke.py", "tests/test_torch_gpu.py"])
def test_card_path_closure_has_no_transport(start):
    files, foreign = _closure(ROOT / start)
    rels = {str(f.relative_to(ROOT)) for f in files}
    assert "das_tpu_torch/service/server.py" in rels or start.startswith("tests")
    assert not rels & set(TRANSPORT), sorted(rels & set(TRANSPORT))
    assert not foreign & {"grpc", "google", "msgpack", "jax", "das_tpu"}, sorted(foreign)


def _env_reads(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Attribute) and node.attr in ("environ", "getenv", "putenv"):
            yield node.lineno
        elif isinstance(node, ast.Name) and node.id in ("environ", "getenv"):
            yield node.lineno


@pytest.mark.parametrize("path", sorted((ROOT / "das_tpu_torch").rglob("*.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_environment_read(path):
    """Every switch of the port is a DasConfig field or an argument."""
    assert not list(_env_reads(path)), f"{path.name} reads the environment"


@pytest.mark.parametrize("module", ["das_tpu_torch/query/starcount.py",
                                    "das_tpu_torch/mining/__init__.py",
                                    "das_tpu_torch/mining/miner.py"])
def test_star_and_miner_modules_are_scanned(module):
    """Star counting and the miner are among the scanned files, and their
    imports stay inside torch, numpy, the standard library and the port."""
    assert ROOT / module in _port_files()
    for name in _imports(ROOT / module):
        top = name.split(".")[0]
        assert top in ("torch", "numpy", "das_tpu_torch", "random", "dataclasses",
                       "itertools", "typing", "__future__"), f"{module} imports {name}"


SERVING_MODULES = sorted(
    str(p.relative_to(ROOT)) for sub in ("service", "fault", "obs")
    for p in (ROOT / "das_tpu_torch" / sub).rglob("*.py")
    if str(p.relative_to(ROOT)) not in TRANSPORT)


@pytest.mark.parametrize("module", SERVING_MODULES)
def test_serving_modules_are_scanned(module):
    """The service, fault and obs modules (but the transport) are among the
    scanned files, and their imports stay inside torch, numpy, the
    standard library and the port."""
    assert ROOT / module in _port_files()
    stdlib = ("argparse", "concurrent", "dataclasses", "enum", "hashlib", "http", "json",
              "logging", "math", "os", "queue", "random", "re", "shutil", "string", "tarfile",
              "tempfile", "threading", "time", "traceback", "typing", "zlib", "collections",
              "__future__")
    for name in _imports(ROOT / module):
        top = name.split(".")[0]
        assert top in ("torch", "numpy", "das_tpu_torch") + stdlib, f"{module} imports {name}"


ANALYSIS_MODULES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "das_tpu_torch" / "analysis").rglob("*.py"))


@pytest.mark.parametrize("module", ANALYSIS_MODULES)
def test_analysis_modules_are_scanned(module):
    """The port's analyzer (das_tpu_torch/analysis/) is among the scanned
    files, and it imports the standard library and itself only: no jax,
    nothing of das_tpu, no torch, and nothing of the modules it checks."""
    assert ROOT / module in _port_files()
    stdlib = ("__future__", "argparse", "ast", "collections", "dataclasses", "io", "json",
              "pathlib", "re", "sys", "tokenize", "typing")
    for name in _imports(ROOT / module):
        assert name.split(".")[0] in stdlib or name.startswith("das_tpu_torch.analysis"), \
            f"{module} imports {name}"


def test_analysis_is_a_complete_package():
    """Seventeen rule modules, one per contract, beside the core."""
    rules = sorted(p.name for p in (ROOT / "das_tpu_torch/analysis/rules").glob("dl*.py"))
    assert [r[:5] for r in rules] == [f"dl{i:03d}" for i in range(1, 18)]
    assert len(ANALYSIS_MODULES) == len(rules) + 6


def test_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedAtomSpace(backend="tensor")
    # the host-algebra backend needs no device
    assert DistributedAtomSpace(backend="memory").count_atoms() == (0, 0)


def test_wrappers_take_only_cuda_or_cpu_tensors():
    """The plain route is chosen by a CPU tensor alone: any other device
    (here the meta device) raises instead of answering."""
    from das_tpu_torch import kernels

    meta = torch.empty((4, 2), dtype=torch.int32, device="meta")
    mask = torch.empty(4, dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.join_tables(meta, mask, meta, mask, ((0, 0),), (1,), 16)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        kernels.anti_join(meta, mask, meta, mask, ((0, 0),))


INGEST_MODULES = sorted(
    str(p.relative_to(ROOT)) for sub in ("ingest", "convert", "research", "utils")
    for p in (ROOT / "das_tpu_torch" / sub).rglob("*.py")) + [
    "das_tpu_torch/storage/columnar.py", "das_tpu_torch/models/bio.py"]


@pytest.mark.parametrize("module", INGEST_MODULES)
def test_ingest_modules_are_scanned(module):
    """The bulk-ingest path (pipeline, parsers, native scanner binding,
    columnar store), the converters, research/ and utils/ are among the
    scanned files, and their imports stay inside numpy, the standard
    library and the port: no torch either, so converting or parsing never
    loads CUDA."""
    assert ROOT / module in _port_files()
    stdlib = ("__future__", "abc", "argparse", "concurrent", "copy", "csv", "ctypes",
              "dataclasses", "fcntl", "glob", "hashlib", "io", "json", "logging",
              "multiprocessing", "os", "pathlib", "random", "re", "statistics", "struct",
              "subprocess", "sys", "threading", "time", "typing")
    for name in _imports(ROOT / module):
        top = name.split(".")[0]
        assert top in ("numpy", "das_tpu_torch") + stdlib, f"{module} imports {name}"


PARALLEL_MODULES = sorted(
    str(p.relative_to(ROOT)) for p in (ROOT / "das_tpu_torch" / "parallel").rglob("*.py"))


@pytest.mark.parametrize("module", PARALLEL_MODULES)
def test_parallel_modules_are_scanned(module):
    """The mesh (parallel/) is among the scanned files, and its imports stay
    inside torch, numpy, the standard library and the port: no JAX, no
    das_tpu, and torch.distributed only in mesh.py, the one module that
    crosses processes."""
    assert ROOT / module in _port_files()
    for name in _imports(ROOT / module):
        top = name.split(".")[0]
        assert top in ("torch", "numpy", "das_tpu_torch", "contextlib", "dataclasses",
                       "datetime", "functools", "time", "typing", "__future__"), \
            f"{module} imports {name}"
        if not module.endswith("parallel/mesh.py"):
            assert not name.startswith("torch.distributed"), f"{module} imports {name}"


def test_sharded_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default device is valid here")
    from das_tpu_torch.api.atomspace import DistributedAtomSpace

    with pytest.raises(RuntimeError, match="no CUDA device"):
        DistributedAtomSpace(backend="sharded")
