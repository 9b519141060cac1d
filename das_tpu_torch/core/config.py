"""Configuration of the PyTorch port.

A trimmed copy of `das_tpu.core.config.DasConfig`: only the fields this
port reads.  There are no routing knobs — a CUDA tensor goes to the
hand-written kernel and a CPU tensor to its plain PyTorch version — and
no planner or multiway switches (the port runs the greedy join order and
the binary join chain)."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List


@dataclass
class DasConfig:
    backend: str = "tensor"          # "memory" | "tensor"
    # capacity (rows) for padded device result buffers; doubled on overflow
    initial_result_capacity: int = 1 << 14
    max_result_capacity: int = 1 << 24
    pattern_black_list: List[str] = field(default_factory=list)
