"""graphed_step_pct.direct: the share of the window's λ-GMRES Arnoldi steps on
the direct path (one K1 launch a matvec) whose bookkeeping replayed a
captured CUDA graph, 100 x graphed / (graphed + eager), from the program
counters ``gmres.step.graphed`` and ``gmres.step.eager``; nothing from a
program that counts neither."""

from benchmark.program_spans import count


def read(run):
    graphed, eager = count(run, "gmres.step.graphed"), count(run, "gmres.step.eager")
    if not graphed and not eager:
        return None
    return 100.0 * graphed / (graphed + eager)
