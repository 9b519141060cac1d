"""The port's regression battery (scripts/regression_torch.py) against
das_tpu's scripts/regression.py --backend memory, as 56 normalized blocks:

  * the committed expected output (data/samples/regression_expected.txt)
    is regenerated from das_tpu here, so it cannot go stale;
  * the port's battery on its MemoryDB, a CPU TensorDB and a 2-slab CPU
    mesh, through the facade's router and, with the `das` shim's routed
    classes, through `expr.matched(das.db, answer)`, equals it in every
    block."""

import sys
from pathlib import Path

import pytest

from tests.test_torch_compat import load_by_path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import regression_torch  # noqa: E402


@pytest.fixture(scope="module")
def expected():
    return regression_torch.EXPECTED.read_text()


def test_expected_output_is_das_tpu_memory(expected, capsys):
    jx = load_by_path("scripts/regression.py", "_jx_regression")
    capsys.readouterr()
    assert jx.main(["--backend", "memory"]) == 0
    fresh = capsys.readouterr().out
    want = regression_torch.normalize_regression_output(fresh)
    assert len(want) == regression_torch.N_BLOCKS
    assert regression_torch.normalize_regression_output(expected) == want
    # only the order of set elements may differ from the committed file
    assert sorted(fresh.splitlines()) == sorted(expected.splitlines())


@pytest.mark.parametrize("style", ["router", "shim"])
@pytest.mark.parametrize("backend", ["memory", "tensor", "sharded"])
def test_port_battery_equals_das_tpu(expected, backend, style):
    pm = None
    if style == "shim":
        pm = load_by_path("compat_torch/das/pattern_matcher/pattern_matcher.py", "_torch_shim_pm")
    das = regression_torch.animals_das(backend, device="cpu", shards=2)
    out = regression_torch.run(das, pm)
    assert len(regression_torch.normalize_regression_output(out)) == regression_torch.N_BLOCKS
    assert regression_torch.differing_blocks(out, expected) == []


def test_main_prints_the_battery(expected, capsys):
    assert regression_torch.main(["--backend", "tensor", "--device", "cpu"]) == 0
    assert regression_torch.differing_blocks(capsys.readouterr().out, expected) == []
