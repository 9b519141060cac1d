"""BENCHMARK.json against the contract's shapes, every cell resolving by
name, the import rules, and a mix added with new files alone."""

import ast
import json
import re
import shutil

import pytest

from dasbench import run

BENCH = run.read_json(run.ROOT / "BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def test_benchmark_keys_and_names():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["dasbench"] and 1 <= BENCH["run_seconds"] <= 51
    names = [c["name"] for c in BENCH["configs"]] + [w["name"] for w in BENCH["workloads"]] \
        + [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))
    for w in BENCH["workloads"]:
        for key in ("name", "config", "traffic"):
            assert NAME.match(w[key]), w[key]
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]), m
        assert m["better"] in ("lower", "higher") and m["source"] in SOURCES
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e and "\n" not in m["layer"]
        assert set(m["workloads"]) <= {w["name"] for w in BENCH["workloads"]}
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_every_cell_resolves_by_name(cell):
    spec = run.resolve(cell)
    assert hasattr(spec.generator, "generate") and hasattr(spec.driver, "Driver")
    assert spec.families and all(hasattr(f, "answer") for f in spec.families)
    for m in spec.e2e + spec.layer:
        assert hasattr(spec.readers[m["name"]], "read")
    assert any(m["name"] == "setup_s" for m in spec.e2e) and len(spec.e2e) >= 2
    assert spec.layer


def _imports(path):
    out = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            out |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module and not node.level:
            out.add(node.module.split(".")[0])
    return out


def test_no_module_imports_jax_or_das_tpu():
    for path in run.HERE.rglob("*.py"):
        found = _imports(path) & set(run.FORBIDDEN)
        assert not found, f"{path.name} imports {found}"


def test_the_reference_imports_nothing_of_the_program():
    for path in (run.HERE / "reference").rglob("*.py"):
        assert not _imports(path) & {"das_tpu_torch", "torch"}, path.name
    for name in ("kb.py", "bio.py"):
        assert not _imports(run.HERE / name) & {"das_tpu_torch", "torch"}

def test_forbidden_names_compare_whole(monkeypatch):
    import sys
    import types

    monkeypatch.setitem(sys.modules, "das_tpu_torch.fake", types.ModuleType("x"))
    assert "das_tpu" not in run.forbidden_modules() or "das_tpu" in sys.modules
    monkeypatch.setitem(sys.modules, "jaxlib.fake", types.ModuleType("y"))
    assert "jaxlib" in run.forbidden_modules()


def test_a_mix_added_with_files_alone_runs(tmp_path, tiny):
    """A new traffic file and a new workload entry, in a copy, resolve and
    run (on the CPU, at a tiny size) without touching any file there."""
    root = tmp_path / "repo"
    shutil.copytree(run.HERE, root / "dasbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    bench = json.loads(json.dumps(BENCH))
    bench["workloads"].append({"name": "flybase.serve-stars", "config": BENCH["configs"][0]["name"],
                               "traffic": "serve-stars", "chips": 1, "why": "stars only"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    mix = json.loads((run.HERE / "traffic" / "serve-mix.json").read_text())
    mix["families"] = [["grounded_star", 1]]
    (root / "dasbench" / "traffic" / "serve-stars.json").write_text(json.dumps(mix))
    for entry in bench["configs"]:
        (root / entry["file"]).parent.mkdir(parents=True, exist_ok=True)
    out = run.run_cell("flybase.serve-stars", 5, 1.0, False, device="cpu",
                       config_overrides=tiny, root=root)
    assert out["correct"] and out["attempted"] > 0
    assert set(out["metrics"]) == {"served_qps", "setup_s"}
