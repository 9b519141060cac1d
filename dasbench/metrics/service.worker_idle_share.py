"""service.worker_idle_share: the coalescer worker's blocking waits for
work (`serve.idle` spans, recorded only while nothing is in flight or
grouped) inside the window, as a share of the window.  Nothing when no
span came from a named worker thread, or the program names none (a
program that does not record the waits)."""

from dasbench.metrics_util import span_seconds


def read(run):
    try:
        from das_tpu_torch.service.coalesce import WORKER_THREAD
    except ImportError:
        return None
    o = run.observed
    if not any(th.startswith(WORKER_THREAD) for _n, _ph, _t0, _d, th, _a in o.spans):
        return None
    return 100.0 * span_seconds(o, "serve.idle") / o.window_s
