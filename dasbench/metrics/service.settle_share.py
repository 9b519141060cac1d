"""service.settle_share: the summed `serve.settle` spans of the coalescer
worker inside the window, as a share of the window."""

from dasbench.metrics_util import span_seconds


def read(run):
    o = run.observed
    return 100.0 * span_seconds(o, "serve.settle") / o.window_s
