"""The comparison that decides ``correct``.

It judges what the timed window produced, at the timed sizes, against the
plain references under ``reference/``, after the window has closed and the
program's state is freed.  The cell's own file, ``cells/<cell>.json``, names
the numbers compared and the limit of each (``check``) and how many of the
window's requests are compared (``sample``: the slowest and a seeded draw of
the others, or ``"all"``).  Each number is ``numbers/<number>.py``.
"""

from __future__ import annotations

import numpy as np
import torch


def sample(log: list, k, seed: int) -> list:
    """The logged requests to compare: all of them, or the slowest and a
    seeded draw of the others, ``k`` in all."""
    if k == "all" or len(log) <= k:
        return list(log)
    slowest = max(range(len(log)), key=lambda i: log[i].latency_s)
    rest = [i for i in range(len(log)) if i != slowest]
    pick = np.random.default_rng([seed, 7]).choice(len(rest), k - 1, replace=False)
    return [log[slowest]] + [log[rest[j]] for j in sorted(pick)]


def compare(cell, grid, items: list, device) -> dict:
    """{number: (reading, limit)} for the cell's check.  ``items`` are
    (request, canonical U) pairs."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return {name: (cell.number(name)(cell, grid, items, device), limit)
            for name, limit in cell.check.items()}
