"""lane_solves_per_s: every lane solve of every call, over the window's
whole length."""


def read(run):
    return run.solves / run.elapsed_s if run.solves else None
