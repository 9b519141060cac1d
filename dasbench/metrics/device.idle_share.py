"""device.idle_share: the share of the traced window in which no kernel,
copy or memset ran on the card (torch.profiler)."""


def read(run):
    o = run.observed
    if not o.device or o.busy_s is None:
        return None
    return 100.0 * (1.0 - o.busy_s / o.window_s)
