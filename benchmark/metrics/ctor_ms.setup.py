"""ctor_ms.setup: the benchmark's span around ``DDH(...)`` per new model, in ms."""


def read(run):
    return 1e3 * sum(r["ctor_s"] for r in run.requests) / len(run.requests)
