"""direct_apply_pct.direct: the share of the window's DDH applies that ran the
direct path (one wave cycle each), 100 x direct / (direct + graphed + eager),
from the program counters ``ddh.action.direct``, ``ddh.action.graphed`` and
``ddh.action.eager``; nothing from a program that counts no direct apply."""

from benchmark.program_spans import count


def read(run):
    direct = count(run, "ddh.action.direct")
    if not direct:
        return None
    transfer = count(run, "ddh.action.graphed") + count(run, "ddh.action.eager")
    return 100.0 * direct / (direct + transfer)
