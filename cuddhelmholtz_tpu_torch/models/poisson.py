"""Poisson model with Dirichlet boundary conditions by lifting.

Counterpart of ``cuddhelmholtz_tpu/models/poisson.py``: solve -lap u = f with
u = g on the boundary by writing u = w + G, where G extends the face-space
projection of g; the operator is the stiffness action with the boundary
DOFs zeroed (restriction to H^1_0).
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..ops.face_mass import (
    apply_diag_inv_face_mass,
    apply_face_mass,
    make_diag_inv_face_mass_op,
    make_face_mass_op,
)
from ..ops.functional import face_linear_functional, linear_functional
from ..ops.stiffness import StiffnessOp, apply_stiffness, make_stiffness_op
from ..solvers.gmres import GmresResult, gmres
from ..spaces.h1 import FaceSpace, H1Space
from ..utils.device import check_device


class PoissonOp(NamedTuple):
    stiffness: StiffnessOp
    face_proj: torch.Tensor  # (fdof,) int64 boundary DOFs


def make_poisson_op(space: H1Space, fs: FaceSpace, dtype=torch.float64, *,
                    device="cuda") -> PoissonOp:
    """Poisson-operator data on ``device``: the card unless the caller asks
    for the CPU."""
    device = check_device(device)
    return PoissonOp(
        stiffness=make_stiffness_op(space, dtype=dtype, device=device),
        face_proj=torch.as_tensor(fs.proj, dtype=torch.int64, device=device),
    )


def apply_poisson(op: PoissonOp, x: torch.Tensor) -> torch.Tensor:
    """y = orth(S x): the stiffness action restricted to interior DOFs."""
    return apply_stiffness(op.stiffness, x).index_fill(0, op.face_proj, 0.0)


def solve_poisson(
    space: H1Space,
    fs: FaceSpace,
    f: Callable,
    g: Callable,
    *,
    m: int = 20,
    maxit: int = 20,
    tol: float = 1e-6,
    dtype=torch.float64,
    device="cuda",
) -> tuple[torch.Tensor, GmresResult]:
    """The Poisson solve with Dirichlet lifting: (u, GMRES result).  The
    boundary projection and the functionals run on the host; the lifted
    solve on ``device``."""
    op = make_poisson_op(space, fs, dtype=dtype, device=device)

    # project the boundary data onto the face space: <q, phi> = <g, phi>
    y = face_linear_functional(fs, g, dtype=dtype)
    fmass = make_face_mass_op(fs, dtype=dtype, device="cpu")
    fpinv = make_diag_inv_face_mass_op(fs, dtype=dtype, device="cpu")
    out_q = gmres(lambda x: apply_face_mass(fmass, x), y, m=5, maxit=10, tol=1e-12,
                  precond=lambda x: apply_diag_inv_face_mass(fpinv, x))

    # lift to H1: b = orth((f, phi) - (grad G, grad phi))
    G = torch.zeros(space.ndof, dtype=dtype, device=device).index_add(
        0, op.face_proj, out_q.x.to(device))
    b = linear_functional(space, f, dtype=dtype).to(device) - apply_stiffness(op.stiffness, G)
    b = b.index_fill(0, op.face_proj, 0.0)

    out = gmres(lambda x: apply_poisson(op, x), b, m=m, maxit=maxit, tol=tol)
    return out.x + G, out
