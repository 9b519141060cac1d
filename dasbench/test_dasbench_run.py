"""A run end to end on the CPU at a tiny size (the harness's look for a
card skipped), sound and with the timed path broken underneath, the
control at the cell's own size, and a run without a card."""

import json
import os
import subprocess
import sys

import pytest

from dasbench import control, run

CELLS = [w["name"] for w in run.read_json(run.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell, tiny):
    out = run.run_cell(cell, 2**31 + 21, 1.0, True, device="cpu", config_overrides=tiny)
    assert out["correct"] and out["failed"] == 0 and out["attempted"] > 0
    assert out["checks"] == {"wrong_answers": {"value": 0, "limit": 0},
                             "unanswered": {"value": 0, "limit": 0}}
    assert list(out)[-1] == "checks"
    assert "service.batch_width" in out["metrics"] and "breakdown" in out


def _alter_an_answer():
    """Each materialized answer loses one binding where it is produced."""
    from das_tpu_torch.query import compiler

    real = compiler.materialize

    def dropping(db, table, answer):
        matched = real(db, table, answer)
        if answer.assignments:
            answer.assignments.pop()
        return matched

    compiler.materialize = dropping
    return lambda: setattr(compiler, "materialize", real)


def _leave_out_half_the_batch():
    """The second half of every coalesced batch is answered empty."""
    from das_tpu_torch.api import atomspace

    real = atomspace._QueryManyJob.settle_iter

    def half(self):
        n = len(self.queries)
        for i, ans in real(self):
            yield i, ans if i < (n + 1) // 2 else ""

    atomspace._QueryManyJob.settle_iter = half
    return lambda: setattr(atomspace._QueryManyJob, "settle_iter", real)


@pytest.mark.parametrize("fault", [_alter_an_answer, _leave_out_half_the_batch])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_timed_path_is_not_correct(cell, fault, tiny):
    undo = []
    try:
        out = run.run_cell(cell, 2**31 + 23, 1.0, False, device="cpu", config_overrides=tiny,
                           faults=lambda: undo.append(fault()))
    finally:
        for u in undo:
            u()
    assert not out["correct"]
    assert out["checks"]["wrong_answers"]["value"] > 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct_at_the_cells_size(cell):
    readings = control.control_readings(cell, 2**31 + 29, n_requests=200)
    assert readings["wrong_answers"] > readings["limit"]


def test_a_run_without_a_card_exits_non_zero():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, str(run.HERE / "run.py"), "--workload", CELLS[0],
                           "--seed", "1", "--seconds", "1", "--trace", "0"],
                          capture_output=True, text=True, env=env, timeout=300)
    assert proc.returncode != 0
    assert not [line for line in proc.stdout.splitlines() if line.startswith("{")]
    assert "CUDA" in proc.stderr


@pytest.mark.gpu
def test_each_cell_runs_on_the_card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for cell in CELLS:
        proc = subprocess.run([sys.executable, str(run.HERE / "run.py"), "--workload", cell,
                               "--seed", "3", "--seconds", "2", "--trace", "0"],
                              capture_output=True, text=True, timeout=600)
        assert proc.returncode == 0, proc.stderr[-2000:]
        assert json.loads(proc.stdout.splitlines()[-1])["correct"]
