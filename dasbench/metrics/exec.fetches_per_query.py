"""exec.fetches_per_query: the fused executor's host fetches
(`FETCH_COUNTS`) over the traced window, per request answered in it."""


def read(run):
    o = run.observed
    return o.fetches / o.completed if o.completed else None
