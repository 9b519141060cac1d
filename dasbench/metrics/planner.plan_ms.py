"""planner.plan_ms: the summed `serve.plan` spans (the facade's batch job
planning each query of a group) over the queries they planned."""


def read(run):
    o = run.observed
    spans = [(dur, (attrs or {}).get("queries") or 0) for name, ph, t0, dur, _th, attrs
             in o.spans if name == "serve.plan" and ph == "X"]
    n = sum(q for _d, q in spans)
    return 1e3 * sum(d for d, _q in spans) / n if n else None
