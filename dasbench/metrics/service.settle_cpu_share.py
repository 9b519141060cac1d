"""service.settle_cpu_share: the coalescer worker thread's CPU seconds
over its `serve.settle` spans (`cpu_s`) as a share of their wall time,
for the spans that start in the window; the rest is time the worker
waited, for the interpreter lock or blocked in the fetch.  Nothing when
no settle span carries `cpu_s`."""


def read(run):
    o = run.observed
    settles = [(attrs["cpu_s"], dur) for name, ph, t0, dur, _th, attrs in o.spans
               if name == "serve.settle" and ph == "X" and o.t_start <= t0 < o.t_end
               and attrs and "cpu_s" in attrs]
    wall = sum(d for _c, d in settles)
    return 100.0 * sum(c for c, _d in settles) / wall if wall > 0 else None
