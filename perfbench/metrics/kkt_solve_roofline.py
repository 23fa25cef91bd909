"""kkt_solve_roofline: the least time of the work (`roofline.solve_work`
at each call's (B, K, w, r, dtype)) over the device time of every
operation launched inside the calls that solve with the factor, in %."""


def read(run):
    calls = run.trace.solve_calls if run.trace is not None else []
    device = sum(d for _least, d in calls)
    return 100.0 * sum(least for least, _d in calls) / device if device > 0 else None
