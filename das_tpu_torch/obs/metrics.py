"""Typed metric layer: counters and fixed log-bucket histograms (port of
`das_tpu/obs/metrics.py`).

The histograms answer p50/p95/p99 without keeping samples: values land in
geometrically spaced buckets (ratio 2^(1/4) per bucket, so a reported
quantile is within ~19% of the exact sample quantile), and a percentile
interpolates inside the bucket that crosses the requested rank.  Memory
per histogram is one fixed int vector whatever the traffic.

Names are declared in obs/registry.py and the dicts here are built from
it; an undeclared name is a KeyError.  Counters are a plain int += under
the GIL and histograms bump one list slot per observe: torn reads are
tolerated, the distribution's shape is the contract.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

from das_tpu_torch.obs.registry import COUNTER_NAMES, HISTOGRAM_NAMES

#: bucket ratio: 4 buckets per doubling — quantile error bound ~2^0.25
_BUCKET_RATIO = 2.0 ** 0.25
_LOG_RATIO = math.log(_BUCKET_RATIO)
#: lowest bucket upper edge (ms): 1 microsecond
_LOW_MS = 1e-3
#: bucket count: top edge 1e-3 * 2^(127/4) ms ≈ 55 minutes, far past any
#: latency the serving path reports; beyond it values clamp to the last
#: bucket
_N_BUCKETS = 128


def bucket_index(ms: float) -> int:
    """Bucket for a millisecond value; clamped to the fixed range."""
    if ms <= _LOW_MS:
        return 0
    idx = int(math.log(ms / _LOW_MS) / _LOG_RATIO) + 1
    return idx if idx < _N_BUCKETS else _N_BUCKETS - 1


def bucket_upper(idx: int) -> float:
    """Upper edge (ms) of bucket `idx`."""
    return _LOW_MS * (_BUCKET_RATIO ** idx)


class Counter:
    __slots__ = ("name", "value")

    def __init__(self, name: str):
        self.name = name
        self.value = 0

    def inc(self, n: int = 1) -> None:
        self.value += n

    def reset(self) -> None:
        self.value = 0


class Histogram:
    """Fixed log-bucket histogram over millisecond samples."""

    __slots__ = ("name", "counts", "total", "sum_ms", "min_ms", "max_ms")

    def __init__(self, name: str = ""):
        self.name = name
        self.counts: List[int] = [0] * _N_BUCKETS
        self.total = 0
        self.sum_ms = 0.0
        self.min_ms: Optional[float] = None
        self.max_ms = 0.0

    def observe(self, ms: float) -> None:
        self.counts[bucket_index(ms)] += 1
        self.total += 1
        self.sum_ms += ms
        if self.min_ms is None or ms < self.min_ms:
            self.min_ms = ms
        if ms > self.max_ms:
            self.max_ms = ms

    def reset(self) -> None:
        self.counts = [0] * _N_BUCKETS
        self.total = 0
        self.sum_ms = 0.0
        self.min_ms = None
        self.max_ms = 0.0

    def percentile(self, q: float) -> Optional[float]:
        """Approximate q-quantile (q in [0, 1]): geometric interpolation
        inside the bucket whose cumulative count crosses rank q*total.
        None on an empty histogram.  The true min/max tighten the edge
        buckets, so p0/p100 are exact."""
        if self.total == 0:
            return None
        rank = q * self.total
        cum = 0
        for idx, c in enumerate(self.counts):
            if c == 0:
                continue
            prev = cum
            cum += c
            if cum >= rank:
                lo = bucket_upper(idx - 1) if idx > 0 else 0.0
                hi = bucket_upper(idx)
                if self.min_ms is not None:
                    lo = max(lo, self.min_ms) if prev == 0 else lo
                    hi = min(hi, self.max_ms)
                if hi <= lo:
                    return hi
                # linear interpolation of the rank within the bucket
                frac = (rank - prev) / c
                return lo + (hi - lo) * frac
        return self.max_ms

    def percentiles(self) -> Dict[str, Optional[float]]:
        """The serving headline triple."""
        return {
            "p50": self.percentile(0.50),
            "p95": self.percentile(0.95),
            "p99": self.percentile(0.99),
        }

    def nonzero_buckets(self) -> List[Tuple[float, int]]:
        """(upper edge ms, count) for occupied buckets — the compact
        bucket-vector form the full bench record carries."""
        return [
            (round(bucket_upper(i), 6), c)
            for i, c in enumerate(self.counts)
            if c
        ]


#: the metric dicts are built from the registry, so the declared set and
#: the live set cannot drift
COUNTERS: Dict[str, Counter] = {n: Counter(n) for n in COUNTER_NAMES}
HISTOGRAMS: Dict[str, Histogram] = {n: Histogram(n) for n in HISTOGRAM_NAMES}


def counter(name: str) -> Counter:
    """The declared counter; KeyError on an undeclared name."""
    return COUNTERS[name]


def histogram(name: str) -> Histogram:
    """The declared histogram — KeyError on an undeclared name."""
    return HISTOGRAMS[name]


def reset_metrics() -> None:
    for c in COUNTERS.values():
        c.reset()
    for h in HISTOGRAMS.values():
        h.reset()
