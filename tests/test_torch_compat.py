"""The `das` shim of the PyTorch port (compat_torch/das) against das_tpu's
(compat/das):

  * one script in the reference's own style (tests/reference_style_script.py:
    `das` imports only, `expr.matched(das.db, answer)`, a commit and a
    syntax error) runs in two processes, `PYTHONPATH=compat:.` with
    DAS_TPU_BACKEND=memory (das_tpu) and `PYTHONPATH=compat_torch:.` after
    `das.configure(backend="tensor", device="cpu")` (the port, its device
    path); the normalized outputs are equal;
  * every DBInterface method of the two StubDBs on the reference's fixture
    gives the same result;
  * `configure` picks what a bare `DistributedAtomSpace()` builds, and
    `_get_file_list` is das_tpu's.

The shim modules are loaded by path under private names, so no `das`
package enters this process's sys.modules."""

import importlib.util
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from das_tpu.api.atomspace import DistributedAtomSpace as JxDAS
from das_tpu_torch.query import compiler
from das_tpu_torch.storage.memory_db import MemoryDB
from das_tpu_torch.storage.tensor_db import TensorDB

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import regression_torch  # noqa: E402

SCRIPT = "tests/reference_style_script.py"
KB = "data/samples/animals.metta"
#: runs the script through the port's shim, then reports the router's
#: counts on stderr
PORT_RUNNER = f"""
import json, runpy, sys
import das
das.configure(backend="tensor", device="cpu")
sys.argv = [{SCRIPT!r}, {KB!r}]
runpy.run_path({SCRIPT!r}, run_name="__main__")
from das_tpu_torch.query import compiler
print(json.dumps(dict(compiler.ROUTE_COUNTS)), file=sys.stderr)
"""


def load_by_path(rel, name):
    """The module at ROOT/rel, imported under `name` (the two shims' modules
    share their names, so neither is imported as `das` here)."""
    spec = importlib.util.spec_from_file_location(name, ROOT / rel)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _env(path, **extra):
    env = {k: v for k, v in os.environ.items() if not k.startswith("DAS_TPU_")}
    env["PYTHONPATH"] = f"{ROOT / path}:{ROOT}"
    env["JAX_PLATFORMS"] = "cpu"
    env.update(extra)
    return env


def test_reference_style_script_same_on_both_shims():
    procs = [
        subprocess.Popen([sys.executable, SCRIPT, KB], cwd=ROOT, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         env=_env("compat", DAS_TPU_BACKEND="memory")),
        subprocess.Popen([sys.executable, "-c", PORT_RUNNER], cwd=ROOT, text=True,
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE, env=_env("compat_torch")),
    ]
    (jx, jerr), (pt, perr) = (p.communicate(timeout=300) for p in procs)
    assert procs[0].returncode == 0, jerr[-3000:]
    assert procs[1].returncode == 0, perr[-3000:]
    want = regression_torch.normalize_regression_output(jx)
    assert len(want) == 19
    assert regression_torch.normalize_regression_output(pt) == want
    assert pt.splitlines()[-1] == jx.splitlines()[-1] == "MettaSyntaxError"
    # the port's run answered on its device path: fused conjunctions and trees
    routes = json.loads(perr.strip().splitlines()[-1])
    assert routes["fused"] > 0 and routes["tree"] > 0


@pytest.fixture(scope="module")
def stubs():
    jx = load_by_path("compat/das/database/stub_db.py", "_jx_stub_db").StubDB()
    pt = load_by_path("compat_torch/das/database/stub_db.py", "_torch_stub_db").StubDB()
    return jx, pt


def _norm(x):
    if isinstance(x, (list, tuple)):
        return sorted((_norm(v) for v in x), key=repr)
    return x


LINKS = [
    ("Inheritance", ["<Concept: human>", "<Concept: mammal>"]),
    ("Inheritance", ["<Concept: mammal>", "<Concept: human>"]),
    ("Similarity", ["<Concept: human>", "<Concept: monkey>"]),
    ("Similarity", ["<Concept: monkey>", "<Concept: human>"]),
    ("Set", ["<Concept: human>", "<Concept: monkey>", "<Concept: chimp>"]),
    ("Set", ["<Concept: chimp>", "<Concept: human>", "<Concept: monkey>"]),
    ("List", ["<Concept: human>", "<Concept: monkey>", "<Concept: chimp>"]),
    ("List", ["<Concept: chimp>", "<Concept: human>", "<Concept: monkey>"]),
]
PATTERNS = [
    ("Inheritance", ["*", "<Concept: mammal>"]),
    ("Inheritance", ["<Concept: human>", "*"]),
    ("Inheritance", ["*", "*"]),
    ("Similarity", ["<Concept: human>", "*"]),
    ("Similarity", ["*", "<Concept: human>"]),
    ("List", ["<Concept: human>", "*", "*", "*"]),
    ("Set", ["<Concept: human>", "*", "*", "*"]),
    ("Set", ["*", "*"]),
]
TEMPLATES = [["Inheritance", "Concept", "Concept"], ["Similarity", "Concept", "Concept"],
             ["List", "Concept", "Concept", "Concept", "Concept"],
             ["Set", ["Inheritance", "Concept", "Concept"], ["Inheritance", "Concept", "Concept"]]]


def _calls(db):
    """(method, result) of every DBInterface method on the fixture."""
    out = [("count_atoms", db.count_atoms())]
    for name in ("human", "mammal", "plant", "blah"):
        out.append(("node_exists", db.node_exists("Concept", name)))
        out.append(("get_node_handle", db.get_node_handle("Concept", name)))
    for t, targets in LINKS:
        out.append(("link_exists", db.link_exists(t, targets)))
        h = db.get_link_handle(t, targets)
        out.append(("get_link_handle", h))
        if db.link_exists(t, targets):
            out.append(("get_link_targets", db.get_link_targets(h)))
            out.append(("is_ordered", db.is_ordered(h)))
            out.append(("get_atom_as_dict", db.get_atom_as_dict(h)))
            out.append(("get_atom_as_deep_representation",
                        db.get_atom_as_deep_representation(h)))
    for t, targets in PATTERNS:
        out.append(("get_matched_links", _norm(db.get_matched_links(t, targets))))
    for template in TEMPLATES:
        out.append(("get_matched_type_template", _norm(db.get_matched_type_template(template))))
    for t in ("Inheritance", "Similarity", "List", "Set", "Blah"):
        out.append(("get_matched_type", _norm(db.get_matched_type(t))))
    out.append(("get_all_nodes", _norm(db.get_all_nodes("Concept"))))
    out.append(("get_all_nodes", _norm(db.get_all_nodes("Concept", names=True))))
    out.append(("get_node_name", db.get_node_name("<Concept: human>")))
    out.append(("get_atom_as_dict", db.get_atom_as_dict("<Concept: human>")))
    out.append(("get_atom_as_deep_representation",
                db.get_atom_as_deep_representation("<Concept: human>")))
    for sub in ("h", "^m", "o.*e"):
        out.append(("get_matched_node_name", _norm(db.get_matched_node_name("Concept", sub))))
    return out


METHODS = ["count_atoms", "node_exists", "get_node_handle", "link_exists", "get_link_handle",
           "get_link_targets", "is_ordered", "get_atom_as_dict",
           "get_atom_as_deep_representation", "get_matched_links", "get_matched_type_template",
           "get_matched_type", "get_all_nodes", "get_node_name", "get_matched_node_name"]


@pytest.mark.parametrize("method", METHODS)
def test_stub_db_method_equals_das_tpu(stubs, method):
    jx, pt = stubs
    want = [r for m, r in _calls(jx) if m == method]
    got = [r for m, r in _calls(pt) if m == method]
    assert want and got == want


def test_configure_picks_the_store(tmp_path):
    dmod = load_by_path("compat_torch/das/distributed_atom_space.py", "_torch_shim_das")
    try:
        dmod.configure(backend="memory")
        assert isinstance(dmod.DistributedAtomSpace().db, MemoryDB)
        dmod.configure(backend="tensor", device="cpu")
        das = dmod.DistributedAtomSpace()
        assert isinstance(das.db, TensorDB) and das.db.device.type == "cpu"
        das.load_knowledge_base(str(ROOT / KB))
        das.save_checkpoint(str(tmp_path / "ckpt"))
        dmod.configure(backend="tensor", device="cpu", checkpoint_path=str(tmp_path / "ckpt"))
        assert dmod.DistributedAtomSpace().count_atoms() == (14, 26)
        # keyword arguments win over the configured settings
        assert isinstance(dmod.DistributedAtomSpace(backend="memory").db, MemoryDB)
        with pytest.raises(ValueError):
            dmod.configure(backend="mongo")
        dmod.configure()
        assert dmod._SETTINGS == {"backend": "tensor", "device": None, "checkpoint_path": None}
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="no CUDA device"):
                dmod.DistributedAtomSpace()
        kb_dir = str(ROOT / "data/samples")
        assert das._get_file_list(kb_dir) == JxDAS(backend="memory")._get_file_list(kb_dir)
    finally:
        dmod.configure()
    compiler.reset_route_counts()
