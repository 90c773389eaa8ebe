"""Lumped (GLL-collocated) mass diagonal and its inverse.

Counterpart of ``lumped_mass_diagonal``, ``make_diag_inv_mass_op`` and
``apply_diag_inv_mass`` in ``cuddhelmholtz_tpu/ops/mass.py``.  The diagonal is
assembled on the host in float64; the inverse is a tensor.  The matrix-free
mass operator is not on the direct DDH path and is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..spaces.h1 import H1Space


def lumped_mass_diagonal(space: H1Space) -> np.ndarray:
    """Global lumped mass diagonal sum_e w_i w_j detJ."""
    quad = space.basis.quadrature
    detj = space.mesh.element_metrics(quad).measures.transpose(0, 2, 1)  # (nel, iy, ix)
    m_e = np.outer(quad.w, quad.w)[None] * detj
    diag = np.zeros(space.ndof, dtype=np.float64)
    np.add.at(diag, space.dofs.reshape(-1), m_e.reshape(-1))
    return diag


class DiagInvMassOp(NamedTuple):
    """p = 1 / diag(M) via GLL collocation lumping."""

    p: torch.Tensor


def make_diag_inv_mass_op(space: H1Space, dtype=torch.float64) -> DiagInvMassOp:
    return DiagInvMassOp(p=torch.as_tensor(1.0 / lumped_mass_diagonal(space), dtype=dtype))


def apply_diag_inv_mass(op: DiagInvMassOp, x: torch.Tensor) -> torch.Tensor:
    return op.p * x
