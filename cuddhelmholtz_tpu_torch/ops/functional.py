"""Right-hand-side assembly F[i] = (f, phi_i) over elements and faces.

Counterpart of ``linear_functional`` and ``face_linear_functional`` in
``cuddhelmholtz_tpu/ops/functional.py``.  Two paths, as there: collocation
at the GLL basis nodes (``quad=None``) and full quadrature with the basis
interpolation matrices.  Both run on the host (CPU tensors) in ``dtype``;
``f`` maps a coordinate tensor (..., 2) to values (...).
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..spaces.h1 import FaceSpace, H1Space
from ..utils.quadrature import QuadratureRule


def _assemble(ids: np.ndarray, vals: torch.Tensor, n: int) -> torch.Tensor:
    """Sum ``vals`` into an n-vector at ``ids`` (host; sequential order)."""
    idx = torch.as_tensor(ids.reshape(-1), dtype=torch.int64)
    return torch.zeros(n, dtype=vals.dtype).index_add_(0, idx, vals.reshape(-1))


def linear_functional(
    space: H1Space, f: Callable, quad: QuadratureRule | None = None, dtype=torch.float64
) -> torch.Tensor:
    """F[i] = (f, phi_i) on the host."""
    q = space.basis.quadrature if quad is None else quad
    metrics = space.mesh.element_metrics(q)
    detj = metrics.measures.transpose(0, 2, 1)  # (nel, qy, qx)
    coords = metrics.coords.transpose(0, 2, 1, 3)  # (nel, qy, qx, 2)
    w2 = np.outer(q.w, q.w)
    g = f(torch.as_tensor(coords, dtype=dtype)) * torch.as_tensor(w2[None] * detj, dtype=dtype)
    if quad is not None:
        P = torch.as_tensor(space.basis.eval(quad.x), dtype=dtype)  # (nq, nb)
        t = torch.einsum("qi,erq->eri", P, g)  # integrate x
        g = torch.einsum("rj,eri->eji", P, t)  # integrate y -> (nel, iy, ix)
    return _assemble(space.dofs, g, space.ndof)


def face_linear_functional(
    fs: FaceSpace, f: Callable, quad: QuadratureRule | None = None, dtype=torch.float64
) -> torch.Tensor:
    """F[i] = <f, phi_i> over the face space, on the host."""
    q = fs.h1.basis.quadrature if quad is None else quad
    metrics = fs.h1.mesh.edge_metrics(q, fs.faces)
    wds = metrics.measures * q.w[None, :]  # (nf, nq)
    g = f(torch.as_tensor(metrics.coords, dtype=dtype)) * torch.as_tensor(wds, dtype=dtype)
    if quad is not None:
        P = torch.as_tensor(fs.h1.basis.eval(quad.x), dtype=dtype)
        g = torch.einsum("qi,fq->fi", P, g)
    return _assemble(fs.face_dofs, g, fs.fdof)
