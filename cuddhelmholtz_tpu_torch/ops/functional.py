"""Right-hand-side assembly F[i] = (f, phi_i), collocated at the GLL nodes.

Counterpart of the fast path of ``linear_functional`` in
``cuddhelmholtz_tpu/ops/functional.py``.  The full-quadrature path and the
face functional are not on the direct DDH path and are not ported yet.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..spaces.h1 import H1Space


def linear_functional(space: H1Space, f: Callable, dtype=torch.float64) -> torch.Tensor:
    """F[i] = (f, phi_i) on the host.  ``f`` maps a coordinate tensor
    (..., 2) to values (...)."""
    q = space.basis.quadrature
    metrics = space.mesh.element_metrics(q)
    detj = metrics.measures.transpose(0, 2, 1)  # (nel, iy, ix)
    coords = metrics.coords.transpose(0, 2, 1, 3)  # (nel, iy, ix, 2)
    w2 = np.outer(q.w, q.w)
    fe = f(torch.as_tensor(coords, dtype=dtype)) * torch.as_tensor(w2[None] * detj, dtype=dtype)
    idx = torch.as_tensor(space.dofs.reshape(-1), dtype=torch.int64)
    return torch.zeros(space.ndof, dtype=dtype).index_add_(0, idx, fe.reshape(-1))
