"""Arithmetic the metric readers share."""

from __future__ import annotations

from dasbench import roofline


def span_seconds(observed, name: str) -> float:
    """Summed seconds of the spans called `name`, clipped to the window."""
    lo, hi = observed.t_start, observed.t_end
    return sum(max(0.0, min(t0 + dur, hi) - max(t0, lo))
               for n, ph, t0, dur, _th, _a in observed.spans if n == name and ph == "X")


def roofline_share(observed):
    """Sum of least times over sum of device seconds, in %, for the kernel
    calls whose kernel events were given to them; None when no event
    was."""
    calls = observed.calls
    device_s, counted = 0.0, set()
    for e in observed.device:
        k = e.get("call")
        if k is None or calls[k]["bytes"] is None:
            continue
        device_s += e["end"] - e["start"]
        counted.add(k)
    if not counted or device_s <= 0:
        return None
    least = sum(roofline.least_s(calls[k]["bytes"], calls[k]["ops"]) for k in counted)
    return 100.0 * least / device_s
