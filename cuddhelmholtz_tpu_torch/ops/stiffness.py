"""Matrix-free stiffness operator y = (grad u, grad v).

Counterpart of ``cuddhelmholtz_tpu/ops/stiffness.py``: setup collocates the
symmetric contravariant metric ``G = w J^{-T} J^{-1} det J`` (entries A, B,
C) on a Gauss-Legendre grid on the host in float64; the action is gather ->
1D interpolate and differentiate -> contravariant flux -> transpose
integrate -> assembly, as batched einsums and the deterministic table
assembly of ``ops/mass.py``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..spaces.h1 import H1Space
from ..utils.quadrature import QuadratureRule
from .mass import element_tables, gather_elements, scatter_elements


class StiffnessOp(NamedTuple):
    """dofs (nel, nb, nb); P, D (nq, nb); A, B, C (nel, nq, nq) at
    [el, qy, qx]; ndof; table (ndof, k), the assembly table of dofs."""

    dofs: torch.Tensor
    P: torch.Tensor
    D: torch.Tensor
    A: torch.Tensor
    B: torch.Tensor
    C: torch.Tensor
    ndof: int
    table: torch.Tensor


def geometric_factors(space: H1Space, quad: QuadratureRule) -> tuple[np.ndarray, ...]:
    """A, B, C with layout (nel, qy, qx).

    With J[..., a, b] = d x_a / d xi_b:
      A =  w (y_eta^2 + x_eta^2) / detJ      (multiplies u_xi in flux_xi)
      B = -w (x_xi x_eta + y_xi y_eta) / detJ
      C =  w (x_xi^2 + y_xi^2) / detJ
    """
    J = space.mesh.element_metrics(quad).jacobians  # (nel, qx_i, qy_j, a, b)
    x_xi, x_eta = J[..., 0, 0], J[..., 0, 1]
    y_xi, y_eta = J[..., 1, 0], J[..., 1, 1]
    detj = x_xi * y_eta - x_eta * y_xi
    w2 = np.outer(quad.w, quad.w)  # (qx, qy)
    A = w2 * (y_eta * y_eta + x_eta * x_eta) / detj
    B = -w2 * (y_xi * y_eta + x_xi * x_eta) / detj
    C = w2 * (y_xi * y_xi + x_xi * x_xi) / detj
    return A.transpose(0, 2, 1), B.transpose(0, 2, 1), C.transpose(0, 2, 1)


def make_stiffness_op(
    space: H1Space, dtype=torch.float64, quad: QuadratureRule | None = None, *, device="cpu"
) -> StiffnessOp:
    if quad is None:
        quad = QuadratureRule(space.n_basis + space.mesh.max_element_order,
                              QuadratureRule.GaussLegendre)
    A, B, C = geometric_factors(space, quad)
    dofs, table = element_tables(space, device)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return StiffnessOp(
        dofs=dofs, P=t(space.basis.eval(quad.x)), D=t(space.basis.deriv(quad.x)),
        A=t(A), B=t(B), C=t(C), ndof=space.ndof, table=table,
    )


def stiffness_element_kernel(op, xe: torch.Tensor) -> torch.Tensor:
    """(nel, iy, ix) element tensors -> weak-Laplacian element contributions:
    the sum-factorised einsum chain shared by the generic and the structured
    assembly."""
    tP = torch.einsum("qi,eji->ejq", op.P, xe)  # (nel, iy, qx)
    tD = torch.einsum("qi,eji->ejq", op.D, xe)
    ux = torch.einsum("rj,ejq->erq", op.P, tD)  # du/dxi  at (qy, qx)
    uy = torch.einsum("rj,ejq->erq", op.D, tP)  # du/deta at (qy, qx)
    fx = op.A * ux + op.B * uy
    fy = op.B * ux + op.C * uy
    sx = torch.einsum("qi,erq->eri", op.D, fx)  # integrate flux_xi against dphi/dxi
    sy = torch.einsum("qi,erq->eri", op.P, fy)
    return torch.einsum("rj,eri->eji", op.P, sx) + torch.einsum("rj,eri->eji", op.D, sy)


def apply_stiffness(op: StiffnessOp, x: torch.Tensor) -> torch.Tensor:
    """y = S x: weak Laplacian with the collocated metric."""
    return scatter_elements(op.table, stiffness_element_kernel(op, gather_elements(op.dofs, x)))
