"""The port stands alone: no module of das_tpu_torch/ and not
chip_smoke.py imports JAX or any module of the JAX package das_tpu
(pinned by an AST scan), and an entry point left to its default device
raises without a CUDA card instead of falling back to the CPU."""

import ast
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "das_tpu")


def _port_files():
    files = sorted((ROOT / "das_tpu_torch").rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 20
    return files


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
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
