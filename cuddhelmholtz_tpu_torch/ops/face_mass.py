"""Face (trace) mass operator on a FaceSpace and its lumped inverse.

Counterpart of ``cuddhelmholtz_tpu/ops/face_mass.py``: setup collocates
``a * w * ds`` on a 1D Gauss-Legendre rule per face on the host in float64;
the action is a 1D interpolate -> scale -> integrate per face, batched over
faces, with the deterministic table assembly of ``ops/mass.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..spaces.h1 import FaceSpace
from ..utils.quadrature import QuadratureRule
from .mass import assemble, assembly_table


class FaceMassOp(NamedTuple):
    """fdofs (nf, nb) face-space ids; P (nq, nb); wds (nf, nq); fdof;
    table (fdof, k), the assembly table of fdofs."""

    fdofs: torch.Tensor
    P: torch.Tensor
    wds: torch.Tensor
    fdof: int
    table: torch.Tensor


def make_face_mass_op(
    fs: FaceSpace,
    coeff: np.ndarray | None = None,
    dtype=torch.float64,
    n_quad: int | None = None,
    *,
    device="cpu",
) -> FaceMassOp:
    """``coeff`` is a face-space nodal vector (a on the face GLL nodes)."""
    nb = fs.h1.n_basis
    order = fs.h1.mesh.max_element_order
    if n_quad is None:
        n_quad = nb + order if coeff is None else 1 + (3 * nb) // 2 + order
    quad = QuadratureRule(n_quad, QuadratureRule.GaussLegendre)
    P = fs.h1.basis.eval(quad.x)  # (nq, nb)
    wds = fs.h1.mesh.edge_metrics(quad, fs.faces).measures * quad.w[None, :]  # (nf, nq)
    if coeff is not None:
        wds = wds * (np.asarray(coeff)[fs.face_dofs] @ P.T)
    return FaceMassOp(
        fdofs=torch.as_tensor(fs.face_dofs, dtype=torch.int64, device=device),
        P=torch.as_tensor(P, dtype=dtype, device=device),
        wds=torch.as_tensor(wds, dtype=dtype, device=device),
        fdof=fs.fdof,
        table=torch.as_tensor(assembly_table(fs.face_dofs, fs.fdof), device=device),
    )


def apply_face_mass(op: FaceMassOp, x: torch.Tensor) -> torch.Tensor:
    """y = H x on the face space."""
    u = torch.einsum("qi,fi->fq", op.P, x[op.fdofs]) * op.wds
    return assemble(op.table, torch.einsum("qi,fq->fi", op.P, u))


class DiagInvFaceMassOp(NamedTuple):
    p: torch.Tensor


def make_diag_inv_face_mass_op(
    fs: FaceSpace, coeff: np.ndarray | None = None, dtype=torch.float64, *, device="cpu"
) -> DiagInvFaceMassOp:
    """Lumped inverse from the GLL collocation weights."""
    quad = fs.h1.basis.quadrature
    m_f = fs.h1.mesh.edge_metrics(quad, fs.faces).measures * quad.w[None, :]  # (nf, nb)
    if coeff is not None:
        m_f = m_f * np.asarray(coeff)[fs.face_dofs]
    diag = np.zeros(fs.fdof, dtype=np.float64)
    np.add.at(diag, fs.face_dofs.reshape(-1), m_f.reshape(-1))
    return DiagInvFaceMassOp(p=torch.as_tensor(1.0 / diag, dtype=dtype, device=device))


def apply_diag_inv_face_mass(op: DiagInvFaceMassOp, x: torch.Tensor) -> torch.Tensor:
    return op.p * x
