"""Shared fixtures of the benchmark's CPU tests: a tiny size of each
configuration, small enough for the port's plain PyTorch kernels."""

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

#: every configuration's counts cut to a few thousand atoms
TINY = dict(n_genes=3000, n_processes=300, n_interactions=3000, n_evaluations=200,
            n_reactomes=300, n_uniprots=900)


@pytest.fixture
def tiny():
    return dict(TINY)
