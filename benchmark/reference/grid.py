"""The plain reference's discretisation of a structured deployment.

A uniform ``nx`` x ``nx`` grid of square quads on [-1, 1]^2 with the
tensor-product Lagrange basis of degree ``deg`` on Gauss-Lobatto-Legendre
(GLL) nodes.  Nodes are numbered row-major over the (deg nx + 1)^2 grid
(``gid = iy * n1 + ix``), the canonical numbering every reference quantity
and every benchmark input is written in.  Plain NumPy and PyTorch: nothing
here imports the program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import numpy as np
import torch
from numpy.polynomial import legendre as L


def gll(nb: int) -> tuple[np.ndarray, np.ndarray]:
    """The ``nb`` GLL nodes on [-1, 1] (ascending) and their weights."""
    n = nb - 1
    inner = L.legroots(L.legder([0] * n + [1])) if n > 1 else np.zeros(0)
    x = np.concatenate([[-1.0], np.sort(inner), [1.0]])
    w = 2.0 / (n * (n + 1) * L.legval(x, [0] * n + [1]) ** 2)
    return x, w


def lagrange(nodes: np.ndarray, x: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Values and derivatives of the Lagrange basis on ``nodes`` at ``x``:
    two (len(x), len(nodes)) matrices."""
    nb = len(nodes)
    P = np.ones((len(x), nb))
    dP = np.zeros((len(x), nb))
    for i in range(nb):
        others = [j for j in range(nb) if j != i]
        den = np.prod([nodes[i] - nodes[j] for j in others])
        for j in others:
            P[:, i] *= (x - nodes[j])
        P[:, i] /= den
        for k in others:
            term = np.ones(len(x))
            for j in others:
                if j != k:
                    term *= (x - nodes[j])
            dP[:, i] += term
        dP[:, i] /= den
    return P, dP


@dataclass(frozen=True)
class Grid:
    """Node coordinates and element tables of the structured grid."""

    nx: int
    deg: int

    @property
    def nb(self) -> int:
        return self.deg + 1

    @property
    def n1(self) -> int:
        return self.deg * self.nx + 1

    @property
    def ndof(self) -> int:
        return self.n1 * self.n1

    @property
    def h(self) -> float:
        return 2.0 / self.nx

    def x1(self) -> np.ndarray:
        """The 1D node coordinates (n1,), ascending."""
        xi, _ = gll(self.nb)
        e = np.arange(self.nx)[:, None]
        x = -1.0 + self.h * e + 0.5 * self.h * (xi[None, :] + 1.0)
        return np.concatenate([x[:, :-1].reshape(-1), [1.0]])

    def coords(self) -> np.ndarray:
        """(ndof, 2) node coordinates in the canonical numbering."""
        x = self.x1()
        X, Y = np.meshgrid(x, x, indexing="xy")
        return np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)

    def element_nodes(self) -> np.ndarray:
        """(nel, nb, nb) canonical node ids of each element, [e, iy, ix],
        elements x fastest."""
        s, nb = self.deg, self.nb
        ex, ey = np.meshgrid(np.arange(self.nx), np.arange(self.nx), indexing="xy")
        i = np.arange(nb)
        gx = ex.reshape(-1)[:, None, None] * s + i[None, None, :]
        gy = ey.reshape(-1)[:, None, None] * s + i[None, :, None]
        return gy * self.n1 + gx

    def lumped_mass(self) -> np.ndarray:
        """The GLL-collocated (lumped) global mass diagonal (ndof,)."""
        _, w = gll(self.nb)
        m = np.zeros(self.ndof)
        np.add.at(m, self.element_nodes().reshape(-1),
                  np.tile((0.25 * self.h * self.h * np.outer(w, w)).reshape(-1), self.nx ** 2))
        return m

    def match(self, coords: np.ndarray) -> np.ndarray:
        """Canonical id of each of ``coords`` (n, 2), matched to a grid node
        within 1e-9; raises where a point is not a node, or two points are
        the same node."""
        x = self.x1()
        idx = []
        for c in (coords[:, 0], coords[:, 1]):
            k = np.clip(np.searchsorted(x, c), 1, len(x) - 1)
            k = np.where(np.abs(x[k - 1] - c) < np.abs(x[k] - c), k - 1, k)
            if np.abs(x[k] - c).max() > 1e-9:
                raise ValueError("a program node does not lie on the reference grid")
            idx.append(k)
        gid = idx[1] * self.n1 + idx[0]
        if len(np.unique(gid)) != len(gid):
            raise ValueError("two program nodes match one reference node")
        return gid


def gaussians(xy: torch.Tensor, centers: torch.Tensor, amps: torch.Tensor,
              omega: float) -> torch.Tensor:
    """sum_s amps[s] omega^2/pi exp(-omega^2 |x - c_s|^2): the upstream's
    point-source forcing of width 1/omega at each centre.  ``xy`` (..., 2),
    ``centers`` (S, 2), ``amps`` (S,)."""
    s = omega * omega
    r = ((xy[..., None, :] - centers) ** 2).sum(-1)
    return (amps * (s / math.pi) * torch.exp(-s * r)).sum(-1)


def disc_speed(xy: torch.Tensor) -> torch.Tensor:
    """The upstream's wave-speed model a = 1/c: 0.2 inside the r = 0.25
    disc, 1 outside."""
    r = xy[..., 0] ** 2 + xy[..., 1] ** 2
    return torch.where(r < 0.0625, xy.new_tensor(0.2), xy.new_tensor(1.0))


def bumped_speed(base: torch.Tensor, xy: torch.Tensor, centers: torch.Tensor,
                 amps: torch.Tensor, widths: torch.Tensor, scale: float) -> torch.Tensor:
    """The model ``base`` (at the points ``xy``) times 1 + scale * sum_k amps[k] exp(-|x - p_k|^2 /
    (2 widths[k]^2)) / n_bumps: a smooth heterogeneous perturbation of at
    most ``scale`` either way."""
    r = ((xy[..., None, :] - centers) ** 2).sum(-1)
    bumps = (amps * torch.exp(-r / (2 * widths * widths))).sum(-1) / len(amps)
    return base * (1.0 + scale * bumps)
