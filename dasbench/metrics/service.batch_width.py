"""service.batch_width: the coalescer's items over its batches, as deltas
over the traced window (`coalescer_stats()`)."""


def read(run):
    s = run.observed.serving
    return s["items"] / s["batches"] if s.get("batches") else None
