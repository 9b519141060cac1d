"""service.settle_self_share: the coalescer worker's time in
`serve.settle` that the other spans nested in it on its thread do not
cover (fetch, materialize, format and staged dispatch are the children),
inside the window, as a share of the window.  Nothing when the program
records no `exec.format` span, since formatting would then count as self
time."""

import bisect

from dasbench.trace import union_s


def read(run):
    o = run.observed
    if not any(n == "exec.format" for n, *_rest in o.spans):
        return None
    settles, others = {}, {}
    for name, ph, t0, dur, th, _a in o.spans:
        if ph == "X":
            (settles if name == "serve.settle" else others).setdefault(th, []).append(
                (t0, t0 + dur))
    self_s = 0.0
    for th, spans in settles.items():
        children = sorted(others.get(th, []))
        starts = [s for s, _e in children]
        for s, e in spans:
            lo, hi = max(s, o.t_start), min(e, o.t_end)
            if hi > lo:
                nested = children[bisect.bisect_left(starts, s):bisect.bisect_right(starts, e)]
                self_s += (hi - lo) - union_s(nested, lo, hi)
    return 100.0 * self_s / o.window_s
