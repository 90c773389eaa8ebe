"""graphed_step_pct.lambda: the share of the window's λ-GMRES Arnoldi steps
whose bookkeeping replayed a captured CUDA graph, 100 x graphed / (graphed +
eager), from the program counters ``gmres.step.graphed`` and
``gmres.step.eager`` (a block step of ``block_gmres`` counts as eager);
nothing from a program that counts neither."""

from benchmark.program_spans import count


def read(run):
    graphed, eager = count(run, "gmres.step.graphed"), count(run, "gmres.step.eager")
    if not graphed and not eager:
        return None
    return 100.0 * graphed / (graphed + eager)
