"""eval_derivs_ms: device milliseconds per iteration of the operations
launched inside the pb.eval_derivs spans of the profiled stretch."""


def read(run):
    t = run.trace
    if t is None or not run.stretch_steps or "eval_derivs" not in t.span_s:
        return None
    return 1e3 * t.span_s["eval_derivs"] / run.stretch_steps
