"""kernels.launches_per_query: the five kernel wrappers' launches
(`LAUNCH_COUNTS`) over the traced window, per request answered in it."""


def read(run):
    o = run.observed
    return sum(o.launches.values()) / o.completed if o.completed else None
