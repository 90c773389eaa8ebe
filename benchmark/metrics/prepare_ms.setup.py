"""prepare_ms.setup: the benchmark's span around ``DDH.prepare`` (ending in a
device synchronisation) per new model, in ms; nothing where no request
prepared (a configuration without ``transfer``)."""


def read(run):
    if not run.requests or any("prepare_s" not in r for r in run.requests):
        return None
    return 1e3 * sum(r["prepare_s"] for r in run.requests) / len(run.requests)
