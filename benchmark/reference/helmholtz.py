"""Plain reference of the coupled Helmholtz operator of upstream ``Helmholtz.cpp``.

For U = [u; v] (U = u + i v) on the structured grid of ``grid.Grid``:

    A U = [ K u - w^2 M_a2 u - w H_a v ;
           -(K v - w^2 M_a2 v + w H_a u) ]

with K the exact Galerkin stiffness, M_a2 the mass weighted by a^2 and H_a
the boundary (first-order absorbing) face mass weighted by a.  The
coefficients are the upstream's L2 projections: a^2 onto the H1 space and a
onto the boundary trace space, from 8-point Gauss-Legendre functionals and
the exact consistent mass matrices; the weighted masses interpolate the
projected nodal coefficient to the same 8-point rule.  Float64, matrix-free
over elements, written from these formulas and independent of the program
under test.
"""

from __future__ import annotations

import numpy as np
import torch
from numpy.polynomial import legendre as L

from .grid import Grid, gll, lagrange


def _cg(apply, b: torch.Tensor, diag: torch.Tensor, tol: float = 1e-14, maxit: int = 500):
    """Jacobi-preconditioned conjugate gradients for an SPD ``apply``."""
    x = torch.zeros_like(b)
    r = b.clone()
    z = r / diag
    p = z.clone()
    rz = torch.dot(r, z)
    bn = float(b.norm())
    for _ in range(maxit):
        Ap = apply(p)
        alpha = rz / torch.dot(p, Ap)
        x += alpha * p
        r -= alpha * Ap
        if float(r.norm()) <= tol * bn:
            return x
        z = r / diag
        rz_new = torch.dot(r, z)
        p = z + (rz_new / rz) * p
        rz = rz_new
    raise RuntimeError("reference mass solve did not converge")


class ReferenceHelmholtz:
    """The coupled operator for the wave-speed function ``speed`` (a = 1/c,
    evaluated at physical points (..., 2) -> (...)), float64 on ``device``."""

    def __init__(self, grid: Grid, omega: float, speed, device):
        self.grid, self.omega, self.device = grid, float(omega), device
        nb, h = grid.nb, grid.h
        xi, _ = gll(nb)
        dev = dict(device=device, dtype=torch.float64)

        def t(a):
            return torch.as_tensor(np.asarray(a), **dev)

        x5, w5 = L.leggauss(nb + 1)  # exact for every constant-coefficient form here
        x8, w8 = L.leggauss(1 + (3 * nb) // 2 + 1)  # the variable-coefficient rule
        P5, dP5 = lagrange(xi, x5)
        P8, _ = lagrange(xi, x8)
        self.M1 = t(P5.T @ np.diag(w5) @ P5)  # reference-interval mass
        self.K1 = t(dP5.T @ np.diag(w5) @ dP5)  # reference-interval stiffness
        self.P8, self.w8 = t(P8), t(w8)
        self.E = torch.as_tensor(grid.element_nodes().reshape(grid.nx ** 2, -1), device=device)
        self.jac = 0.25 * h * h  # area of an element over the reference square's
        self.half = 0.5 * h  # length of an edge over the reference interval's

        # quadrature points of every element (nel, 8, 8, 2) and boundary edge
        x1 = -1.0 + h * np.arange(grid.nx)
        q = 0.5 * h * (x8 + 1.0)
        ex, ey = np.meshgrid(x1, x1, indexing="xy")
        qx = ex.reshape(-1)[:, None, None] + q[None, None, :]
        qy = ey.reshape(-1)[:, None, None] + q[None, :, None]
        qx, qy = np.broadcast_arrays(qx, qy)
        a_el = speed(t(np.stack([qx, qy], axis=-1)))  # (nel, qy, qx)

        # boundary edges: node ids along each edge and its quadrature points
        n1, s = grid.n1, grid.deg
        i = np.arange(nb)
        edges, pts = [], []
        for e in range(grid.nx):
            along = e * s + i
            xs = x1[e] + q
            edges += [along, (n1 - 1) * n1 + along, along * n1, along * n1 + n1 - 1]
            pts += [np.stack([xs, -np.ones_like(xs)], 1), np.stack([xs, np.ones_like(xs)], 1),
                    np.stack([-np.ones_like(xs), xs], 1), np.stack([np.ones_like(xs), xs], 1)]
        bnodes, F = np.unique(np.stack(edges), return_inverse=True)
        self.Fg = torch.as_tensor(bnodes, device=device)  # face dof -> grid node
        self.F = torch.as_tensor(F.reshape(len(edges), nb), device=device)  # edge -> face dofs
        a_edge = speed(t(np.stack(pts)))  # (nedge, 8)

        # L2 projections of a^2 (volume) and a (boundary trace)
        b2 = self._assemble(torch.einsum("qi,rj,erq->eji", self.P8, self.P8,
                                         self.jac * self.w8[:, None] * self.w8 * a_el ** 2))
        self.a2 = _cg(self._mass, b2, self._mass_diag())
        bf = self._assemble_face(torch.einsum("qi,fq->fi", self.P8,
                                              self.half * self.w8 * a_edge))
        self.af = _cg(self._face_mass, bf, self._face_mass_diag())
        # the weights of the coefficient masses at the 8-point rule
        a2q = torch.einsum("qi,rj,eji->erq", self.P8, self.P8, self.a2[self.E].reshape(-1, nb, nb))
        self.Wm = self.jac * self.w8[:, None] * self.w8 * a2q
        self.Wf = self.half * self.w8 * (self.af[self.F] @ self.P8.T)

    # ------------------------------------------------------------ assembly

    def _assemble(self, ye: torch.Tensor) -> torch.Tensor:
        y = ye.new_zeros(self.grid.ndof)
        return y.index_add_(0, self.E.reshape(-1), ye.reshape(-1))

    def _assemble_face(self, yf: torch.Tensor) -> torch.Tensor:
        y = yf.new_zeros(len(self.Fg))
        return y.index_add_(0, self.F.reshape(-1), yf.reshape(-1))

    def _elements(self, x: torch.Tensor) -> torch.Tensor:
        nb = self.grid.nb
        return x[self.E].reshape(-1, nb, nb)  # [e, iy, ix]

    def _mass(self, x: torch.Tensor) -> torch.Tensor:
        xe = self._elements(x)
        return self._assemble(self.jac * self.M1 @ xe @ self.M1.T)

    def _mass_diag(self) -> torch.Tensor:
        d = torch.outer(torch.diagonal(self.M1), torch.diagonal(self.M1)) * self.jac
        return self._assemble(d.expand(self.grid.nx ** 2, -1, -1))

    def _face_mass(self, x: torch.Tensor) -> torch.Tensor:
        return self._assemble_face(self.half * x[self.F] @ self.M1.T)

    def _face_mass_diag(self) -> torch.Tensor:
        return self._assemble_face((self.half * torch.diagonal(self.M1)).expand(len(self.F), -1))

    # ------------------------------------------------------------ the operator

    def _K(self, x: torch.Tensor) -> torch.Tensor:
        xe = self._elements(x)
        return self._assemble(self.M1 @ xe @ self.K1.T + self.K1 @ xe @ self.M1.T)

    def _Ma2(self, x: torch.Tensor) -> torch.Tensor:
        xq = torch.einsum("qi,rj,eji->erq", self.P8, self.P8, self._elements(x))
        return self._assemble(torch.einsum("qi,rj,erq->eji", self.P8, self.P8, self.Wm * xq))

    def _Ha(self, x: torch.Tensor) -> torch.Tensor:
        xq = x[self.Fg][self.F] @ self.P8.T
        hf = self._assemble_face((self.Wf * xq) @ self.P8)
        return x.new_zeros(self.grid.ndof).index_add_(0, self.Fg, hf)

    def apply(self, U: torch.Tensor) -> torch.Tensor:
        n, w = self.grid.ndof, self.omega
        u, v = U[:n], U[n:]
        Au = self._K(u) - w * w * self._Ma2(u) - w * self._Ha(v)
        Av = -(self._K(v) - w * w * self._Ma2(v) + w * self._Ha(u))
        return torch.cat([Au, Av])

    def residual(self, U: torch.Tensor, b: torch.Tensor) -> float:
        """||b - A U|| / ||b|| in float64."""
        return float((b - self.apply(U)).norm() / b.norm())
