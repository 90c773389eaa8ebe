"""graphed_apply_pct.lambda: the share of the window's DDH transfer applies
that replayed a captured CUDA graph, 100 x graphed / (graphed + eager), from
the program counters ``ddh.action.graphed`` and ``ddh.action.eager``."""

from benchmark.program_spans import count


def read(run):
    graphed, eager = count(run, "ddh.action.graphed"), count(run, "ddh.action.eager")
    if not graphed and not eager:
        return None
    return 100.0 * graphed / (graphed + eager)
