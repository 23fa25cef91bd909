"""setup_s: process start to the first timed request (imports, the CUDA
library's build or cache load, the problem's build and the warm-up)."""


def read(run):
    return run.setup_s
