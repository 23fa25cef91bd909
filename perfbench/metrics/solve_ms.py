"""solve_ms: the window's whole length over the solves completed in it."""


def read(run):
    return 1e3 * run.elapsed_s / run.solves if run.solves else None
