"""setup_s: seconds from the start of the process to the end of the warm-up:
imports, the kernels' build or load, the operator's set-up, the requests and
the warm-up request."""


def read(run):
    return run.setup_s
