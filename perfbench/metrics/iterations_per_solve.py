"""iterations_per_solve: solver iterations per request over the window
(`Problem.last_solve_stats.iterations`; for a multistart call its
batched iterations, the most any lane took)."""


def read(run):
    return run.steps / run.requests if run.requests else None
