"""exec.format_ms: the summed `exec.format` spans (an answer's
assignments rendered to its string) inside the window over the requests
answered in it.  Nothing when the program records no such span."""

from dasbench.metrics_util import span_seconds


def read(run):
    o = run.observed
    if not o.completed or not any(n == "exec.format" for n, *_rest in o.spans):
        return None
    return 1e3 * span_seconds(o, "exec.format") / o.completed
