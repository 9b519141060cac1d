"""The port's command-line entry points and examples, in-process on the
CPU at a small size:

  * scripts/load_das_torch.py loads the animals KB into a CPU store and
    writes a checkpoint that a later construction loads;
  * scripts/dump_das_torch.py's dump of that checkpoint, and of the .metta
    file, is byte-identical to das_tpu's scripts/dump_das.py dump of the
    same KB, and a load of the dump dumps back to the same bytes;
  * scripts/dump_trace_torch.py writes Chrome trace JSON whose span names
    are obs/registry.py's, the serving lifecycle and the ledger's compile
    lane among them;
  * each examples/*_torch.py runs with --device cpu."""

import json
import sys
from pathlib import Path

import pytest

from das_tpu_torch import obs
from das_tpu_torch.api.atomspace import DistributedAtomSpace
from das_tpu_torch.core.config import DasConfig
from das_tpu_torch.obs.registry import SPAN_NAMES

from tests.test_torch_compat import load_by_path

ROOT = Path(__file__).resolve().parents[1]
KB = str(ROOT / "data/samples/animals.metta")
COLLECTIONS = ("nodes", "atom_types", "links_2")


def _files(prefix):
    return {c: Path(f"{prefix}.{c}").read_bytes() for c in COLLECTIONS}


def test_load_and_dump_equal_das_tpu(tmp_path, monkeypatch, capsys):
    load = load_by_path("scripts/load_das_torch.py", "_load_das_torch")
    dump = load_by_path("scripts/dump_das_torch.py", "_dump_das_torch")
    ckpt = str(tmp_path / "ckpt")
    assert load.run(["--knowledge-base", KB, "--device", "cpu", "--checkpoint", ckpt]) == 0
    assert "Loaded 14 nodes, 26 links" in capsys.readouterr().out
    das = DistributedAtomSpace(config=DasConfig(checkpoint_path=ckpt), device="cpu")
    assert das.count_atoms() == (14, 26)

    jx = load_by_path("scripts/dump_das.py", "_jx_dump_das")
    monkeypatch.setattr(sys, "argv", ["dump_das.py", "dump", "--metta", KB,
                                      str(tmp_path / "jx" / "animals")])
    (tmp_path / "jx").mkdir()
    assert jx.main() == 0
    want = _files(tmp_path / "jx" / "animals")
    assert all(want.values())
    for name, args in (("ckpt", ["--checkpoint", ckpt]), ("metta", ["--metta", KB])):
        prefix = str(tmp_path / name / "animals")
        assert dump.main(["dump", *args, prefix]) == 0
        assert _files(prefix) == want, name
    ckpt2 = str(tmp_path / "ckpt2")
    assert dump.main(["load", str(tmp_path / "ckpt" / "animals"), "--checkpoint-out", ckpt2]) == 0
    assert DistributedAtomSpace(config=DasConfig(checkpoint_path=ckpt2),
                                device="cpu").count_atoms() == (14, 26)
    again = str(tmp_path / "again" / "animals")
    assert dump.main(["dump", "--checkpoint", ckpt2, again]) == 0
    assert _files(again) == want


def test_dump_trace_writes_registry_spans(tmp_path, capsys):
    trace = load_by_path("scripts/dump_trace_torch.py", "_dump_trace_torch")
    out = str(tmp_path / "trace.json")
    try:
        assert trace.main(["-o", out, "--device", "cpu", "--clients", "4",
                           "--scale", "0.05"]) == 0
    finally:
        obs.configure(enabled=False)
        obs.proflog.configure(enabled=False)
        obs.reset()
        obs.proflog.reset()
    assert "trace events" in capsys.readouterr().out
    events = json.loads(Path(out).read_text())["traceEvents"]
    names = {e["name"] for e in events} - {"process_name", "thread_name"}
    assert names <= set(SPAN_NAMES)
    assert {"serve.submit", "serve.drain", "serve.plan", "serve.dispatch", "serve.settle",
            "serve.answer", "exec.dispatch", "exec.settle_fetch", "exec.materialize",
            "cache.hit", "cache.invalidate", "commit.delta", "prof.compile"} <= names
    # --self dumps this process's (now empty) recorder
    assert trace.main(["-o", out, "--self"]) == 0
    assert json.loads(Path(out).read_text())["traceEvents"] == []


EXAMPLES = {
    "query_das_torch": ([], "== Or(Inheritance($V1, reptile), Inheritance($V1, plant))"),
    "load_knowledge_base_torch": ([KB], "loaded"),
    "query_flybase_torch": (["--genes", "64"], "co-process + interaction:"),
    "pattern_miner_torch": (["--genes", "64", "--epochs", "20"], "mined in"),
}


@pytest.mark.parametrize("name", sorted(EXAMPLES))
def test_example_runs_on_cpu(name, capsys):
    args, marker = EXAMPLES[name]
    mod = load_by_path(f"examples/{name}.py", f"_example_{name}")
    mod.main([*args, "--device", "cpu"])
    out = capsys.readouterr().out
    assert marker in out
    assert "KB:" in out or "loaded" in out or "==" in out
