"""kkt_factor_roofline: the least time of the work (`roofline.factor_work`
at each call's (B, K, w, dtype)) over the device time of every operation
launched inside the calls that factor the staged systems, in %."""


def read(run):
    calls = run.trace.factor_calls if run.trace is not None else []
    device = sum(d for _least, d in calls)
    return 100.0 * sum(least for least, _d in calls) / device if device > 0 else None
