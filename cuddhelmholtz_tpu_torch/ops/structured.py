"""Structured-grid numbering and assembly without arbitrary gathers.

Counterpart of ``cuddhelmholtz_tpu/ops/structured.py``.  On a
``uniform_rect`` mesh ``GridH1Space`` numbers DOFs in row-major grid order;
the element gather and scatter then become nb*nb strided slices and
strided adds.  The numbering change is solver-invisible (GMRES and
solutions are permutation-equivariant), and every generic operator also
works on a ``GridH1Space`` through its index tables.
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.mesh2d import Mesh2D
from ..spaces.h1 import H1Space
from ..utils.basis import Basis
from .mass import mass_element_kernel
from .stiffness import stiffness_element_kernel


class GridH1Space(H1Space):
    """H1Space on a uniform_rect mesh with row-major grid DOF numbering.

    dofs[el, iy, ix] = (ey*(nb-1)+iy) * Nx + ex*(nb-1)+ix for el = ex + nx*ey.
    """

    def __init__(self, mesh: Mesh2D, basis: Basis, nx: int, ny: int):
        nb = basis.n
        if mesh.n_elem != nx * ny:
            raise ValueError("mesh does not match nx * ny")
        # the dof table and the strided gather/scatter assume el = ex + nx*ey
        # on an axis-aligned grid: within each row x must increase, rows must
        # be grouped and increasing in y (catches swapped (nx, ny) and
        # permuted element ids; perturbed vertices pass, only the kron path
        # needs an exact tensor-product grid)
        v0 = mesh.vertices[mesh.elem_vertices[:, 0]]
        xs = v0[:, 0].reshape(ny, nx)
        ys = v0[:, 1].reshape(ny, nx)
        ordered = bool(np.all(np.diff(xs, axis=1) > 0) and np.all(np.diff(ys, axis=0) > 0))
        if ordered and ny > 1:
            ordered = bool(np.all(ys.max(axis=1)[:-1] < ys.min(axis=1)[1:]))
        if not ordered:
            raise ValueError(
                "element order is not row-major x-fastest (el = ex + nx*ey); "
                "build the mesh with Mesh2D.uniform_rect(nx, ..., ny, ...)"
            )
        self.mesh = mesh
        self.basis = basis
        self.grid = (nx, ny)
        s = nb - 1
        Nx, Ny = nx * s + 1, ny * s + 1
        ex, ey = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
        iy, ix = np.meshgrid(np.arange(nb), np.arange(nb), indexing="ij")
        gx = ex[:, :, None, None] * s + ix[None, None]
        gy = ey[:, :, None, None] * s + iy[None, None]
        self.dofs = (gy * Nx + gx).transpose(1, 0, 2, 3).reshape(nx * ny, nb, nb).astype(np.int32)
        self.ndof = Nx * Ny
        self._set_coords()


def grid_gather(x: torch.Tensor, nx: int, ny: int, nb: int) -> torch.Tensor:
    """(ndof,) grid-ordered vector -> (nel, nb, nb) element tensors, from
    four block reshapes (interior, right edge, top edge, corner)."""
    s = nb - 1
    x2 = x.reshape(ny * s + 1, nx * s + 1)
    core = x2[: ny * s, : nx * s].reshape(ny, s, nx, s).permute(0, 2, 1, 3)
    right = x2[: ny * s, s::s].reshape(ny, s, nx, 1).permute(0, 2, 1, 3)
    top = x2[s::s, : nx * s].reshape(ny, 1, nx, s).permute(0, 2, 1, 3)
    corner = x2[s::s, s::s].reshape(ny, nx, 1, 1)
    upper = torch.cat([core, right], dim=-1)  # (ny, nx, s, nb)
    lower = torch.cat([top, corner], dim=-1)  # (ny, nx, 1, nb)
    return torch.cat([upper, lower], dim=-2).reshape(ny * nx, nb, nb)


def grid_scatter(ye: torch.Tensor, nx: int, ny: int, nb: int) -> torch.Tensor:
    """(nel, nb, nb) element tensors -> (ndof,) grid-ordered overlap-add:
    four strided-slice adds (the inverse of grid_gather's block split)."""
    s = nb - 1
    y2 = ye.new_zeros((ny * s + 1, nx * s + 1))
    ye = ye.reshape(ny, nx, nb, nb)
    y2[: ny * s, : nx * s] += ye[:, :, :s, :s].permute(0, 2, 1, 3).reshape(ny * s, nx * s)
    y2[: ny * s, s::s] += ye[:, :, :s, s].permute(0, 2, 1).reshape(ny * s, nx)
    y2[s::s, : nx * s] += ye[:, :, s, :s].reshape(ny, nx * s)
    y2[s::s, s::s] += ye[:, :, s, s]
    return y2.reshape(-1)


def apply_stiffness_structured(op, grid: tuple[int, int], x: torch.Tensor) -> torch.Tensor:
    """y = S x with strided-slice assembly (op from ``make_stiffness_op`` on
    a GridH1Space)."""
    nx, ny = grid
    nb = op.P.shape[1]
    return grid_scatter(stiffness_element_kernel(op, grid_gather(x, nx, ny, nb)), nx, ny, nb)


def apply_mass_structured(op, grid: tuple[int, int], x: torch.Tensor) -> torch.Tensor:
    """y = M x with strided-slice assembly (op from ``make_mass_op`` on a
    GridH1Space)."""
    nx, ny = grid
    nb = op.P.shape[1]
    return grid_scatter(mass_element_kernel(op, grid_gather(x, nx, ny, nb)), nx, ny, nb)
