"""served_qps: requests answered inside the window, and not found wrong,
over the window's seconds (host clock)."""


def read(run):
    ok = sum(1 for i in run.done if run.window.statuses[i]["success"] and i not in run.wrong)
    return ok / run.seconds
