"""Wall-clock accumulators (port of the part of `das_tpu/utils/timing.py`
that research/incoming_builder.py uses).

The roles of the reference's ad-hoc timing helpers (das/util.py Clock and
Statistics): a restartable wall clock and a sample list with its mean,
median, deviation and percentiles.  Host time only: a caller timing CUDA
work synchronizes the stream itself.
"""

from __future__ import annotations

import statistics as _stats
import time
from typing import List


class Clock:
    def __init__(self):
        self.start()

    def start(self):
        self._t0 = time.perf_counter()

    def elapsed(self) -> float:
        return time.perf_counter() - self._t0


class Statistics:
    def __init__(self):
        self.samples: List[float] = []

    def add(self, v: float):
        self.samples.append(v)

    def mean(self) -> float:
        return _stats.fmean(self.samples) if self.samples else 0.0

    def median(self) -> float:
        return _stats.median(self.samples) if self.samples else 0.0

    def stdev(self) -> float:
        return _stats.stdev(self.samples) if len(self.samples) > 1 else 0.0

    def percentile(self, p: float) -> float:
        if not self.samples:
            return 0.0
        xs = sorted(self.samples)
        k = min(len(xs) - 1, max(0, int(round(p / 100.0 * (len(xs) - 1)))))
        return xs[k]
