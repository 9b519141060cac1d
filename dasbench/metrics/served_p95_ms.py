"""served_p95_ms: the 95th percentile, over every request answered inside
the window, of submit -> answer on the benchmark's clock.  A per-layer
metric: every cell is a closed loop at saturation, where a tail moves
with the rate and is no bound of its own."""

import numpy as np


def read(run):
    w = run.window
    ms = [(w.ends[i] - w.starts[i]) * 1e3 for i in run.done]
    return float(np.percentile(np.asarray(ms), 95)) if ms else None
