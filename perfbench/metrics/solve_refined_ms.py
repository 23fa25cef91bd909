"""solve_refined_ms: device milliseconds per iteration of the operations
launched inside the pb.solve_refined spans of the profiled stretch."""


def read(run):
    t = run.trace
    if t is None or not run.stretch_steps or "solve_refined" not in t.span_s:
        return None
    return 1e3 * t.span_s["solve_refined"] / run.stretch_steps
