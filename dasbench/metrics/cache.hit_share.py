"""cache.hit_share: the result cache's hits over its lookups (obs counters
`cache.hits`, `cache.misses`) in the traced window."""


def read(run):
    c = run.observed.counters
    n = c.get("cache.hits", 0) + c.get("cache.misses", 0)
    return 100.0 * c.get("cache.hits", 0) / n if n else None
