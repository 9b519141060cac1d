"""exec.materialize_ms: the summed `exec.materialize` spans (device
binding table -> assignments) inside the window over the requests
answered in it."""

from dasbench.metrics_util import span_seconds


def read(run):
    o = run.observed
    return 1e3 * span_seconds(o, "exec.materialize") / o.completed if o.completed else None
