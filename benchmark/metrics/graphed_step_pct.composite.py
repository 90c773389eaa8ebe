"""graphed_step_pct.composite: the share of the window's Arnoldi steps, of
the outer float64 FGMRES and of the inner GMRES in every application of P,
whose bookkeeping replayed a captured CUDA graph, 100 x graphed / (graphed +
eager), from the program counters ``gmres.step.graphed`` and
``gmres.step.eager``; nothing from a program that counts neither."""

from benchmark.program_spans import count


def read(run):
    graphed, eager = count(run, "gmres.step.graphed"), count(run, "gmres.step.eager")
    if not graphed and not eager:
        return None
    return 100.0 * graphed / (graphed + eager)
