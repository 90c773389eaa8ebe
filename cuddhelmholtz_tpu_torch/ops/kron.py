"""Kronecker (tensor-product) fast path for global operators on rectilinear grids.

Counterpart of ``cuddhelmholtz_tpu/ops/kron.py``.  On a ``uniform_rect``
mesh every element is an axis-aligned rectangle, so the global stiffness
factorises exactly into assembled 1D operators,

    S  =  K1x (x) M1y  +  M1x (x) K1y,

and the weighted mass is ``E^T diag(Wq) E`` with per-direction block-banded
quadrature-evaluation matrices.  Stored dense (N x N, N = nx*(nb-1)+1, 385
at nx 128, deg 3), an apply is a handful of dense ``torch.matmul`` calls with
no gathers.  Same quadrature and collocated data as the generic path.  The
matmuls are full FP32 in float32 because the package pins TF32 off.  Only
valid on a ``GridH1Space`` whose mesh is rectilinear; the ``make_*``
functions check.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..utils.quadrature import QuadratureRule
from .mass import collocate_mass
from .structured import GridH1Space


def _grid_1d(space: GridH1Space) -> tuple[np.ndarray, np.ndarray]:
    """1D node coordinates (xs, ys) of the grid numbering; raises unless the
    mesh is the tensor product of the two 1D grids."""
    nx, ny = space.grid
    s = space.n_basis - 1
    Nx, Ny = nx * s + 1, ny * s + 1
    X = space.coords[:, 0].reshape(Ny, Nx)
    Y = space.coords[:, 1].reshape(Ny, Nx)
    xs, ys = X[0], Y[:, 0]
    if not (np.allclose(X, xs[None, :]) and np.allclose(Y, ys[:, None])):
        raise ValueError("kron fast path requires a rectilinear grid mesh")
    return xs, ys


class KronStiffnessOp(NamedTuple):
    """S = K1x (x) M1y + M1x (x) K1y, all four 1D operators dense."""

    Kx: torch.Tensor  # (Nx, Nx) assembled 1D stiffness along x
    Mx: torch.Tensor  # (Nx, Nx) assembled 1D mass along x
    Ky: torch.Tensor  # (Ny, Ny)
    My: torch.Tensor  # (Ny, Ny)


def _assemble_1d(nodes: np.ndarray, s: int, Khat: np.ndarray, Mhat: np.ndarray):
    """Global 1D stiffness and mass from the reference-element matrices;
    element e spans nodes[e*s .. (e+1)*s] (stiffness ~ 2/h, mass ~ h/2)."""
    N = len(nodes)
    K = np.zeros((N, N))
    M = np.zeros((N, N))
    for e in range((N - 1) // s):
        h = nodes[(e + 1) * s] - nodes[e * s]
        sl = slice(e * s, e * s + s + 1)
        K[sl, sl] += (2.0 / h) * Khat
        M[sl, sl] += (h / 2.0) * Mhat
    return K, M


def make_kron_stiffness_op(
    space: GridH1Space, dtype=torch.float64, quad: QuadratureRule | None = None, *, device="cpu"
) -> KronStiffnessOp:
    """1D-factorised equivalent of ``make_stiffness_op`` (same quadrature)."""
    nb = space.n_basis
    if quad is None:
        quad = QuadratureRule(nb + space.mesh.max_element_order, QuadratureRule.GaussLegendre)
    P = space.basis.eval(quad.x)  # (nq, nb)
    D = space.basis.deriv(quad.x)
    Khat = D.T @ (quad.w[:, None] * D)
    Mhat = P.T @ (quad.w[:, None] * P)
    xs, ys = _grid_1d(space)
    Kx, Mx = _assemble_1d(xs, nb - 1, Khat, Mhat)
    Ky, My = _assemble_1d(ys, nb - 1, Khat, Mhat)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return KronStiffnessOp(Kx=t(Kx), Mx=t(Mx), Ky=t(Ky), My=t(My))


def apply_stiffness_kron(op: KronStiffnessOp, x: torch.Tensor) -> torch.Tensor:
    """y = S x as four dense matmuls (K, M symmetric, so no transposes)."""
    X = x.reshape(op.Ky.shape[0], op.Kx.shape[0])
    return (op.My @ X @ op.Kx + op.Ky @ X @ op.Mx).reshape(-1)


class KronMassOp(NamedTuple):
    """M = (Ey (x) Ex)^T diag(Wq) (Ey (x) Ex): per-direction quadrature
    evaluation matrices and the collocated ``a * w * detJ`` grid."""

    Ex: torch.Tensor  # (nx*nq, Nx) block-banded 1D evaluation
    Ey: torch.Tensor  # (ny*nq, Ny)
    Wq: torch.Tensor  # (ny*nq, nx*nq) collocated weights


def _eval_matrix(P: np.ndarray, n_el: int, s: int) -> np.ndarray:
    """(n_el*nq, n_el*s+1) block matrix with P in each element row block."""
    nq, nb = P.shape
    E = np.zeros((n_el * nq, n_el * s + 1))
    for e in range(n_el):
        E[e * nq:(e + 1) * nq, e * s:e * s + nb] = P
    return E


def make_kron_mass_op(
    space: GridH1Space,
    coeff: np.ndarray | None = None,
    dtype=torch.float64,
    n_quad: int | None = None,
    *,
    device="cpu",
) -> KronMassOp:
    """1D-factorised equivalent of ``make_mass_op``, on its collocated
    ``wdetj`` (the same data as the generic path)."""
    _grid_1d(space)  # rectilinearity check
    nx, ny = space.grid
    s = space.n_basis - 1
    P, wdetj = collocate_mass(space, coeff=coeff, n_quad=n_quad)
    nq = P.shape[0]
    Wq = wdetj.reshape(ny, nx, nq, nq).transpose(0, 2, 1, 3).reshape(ny * nq, nx * nq)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=device)

    return KronMassOp(Ex=t(_eval_matrix(P, nx, s)), Ey=t(_eval_matrix(P, ny, s)), Wq=t(Wq))


def apply_mass_kron(op: KronMassOp, x: torch.Tensor) -> torch.Tensor:
    """y = M x: evaluate on the quadrature grid, scale, integrate back."""
    X = x.reshape(op.Ey.shape[1], op.Ex.shape[1])
    U = op.Wq * (op.Ey @ X @ op.Ex.T)
    return (op.Ey.T @ U @ op.Ex).reshape(-1)
