"""service.queue_ms: the mean wait of a query in the coalescer's submit
queue, from `serve.submit` to its group's dispatch: the `queue_s` of the
`serve.dispatch` spans that start in the window over their `queued`
members.  Nothing when no dispatch carries the wait."""


def read(run):
    o = run.observed
    waits = [(attrs["queue_s"], attrs["queued"]) for name, ph, t0, _d, _th, attrs in o.spans
             if name == "serve.dispatch" and ph == "X" and o.t_start <= t0 < o.t_end
             and attrs and "queued" in attrs]
    n = sum(q for _s, q in waits)
    return 1e3 * sum(s for s, _q in waits) / n if n else None
