"""1D nodal Lagrange basis on Gauss-Lobatto nodes (host-side, float64 NumPy).

Counterpart of ``cuddhelmholtz_tpu/utils/basis.py``: barycentric
interpolation and differentiation of the Lagrange basis, the exact 1D mass
matrix and the derivative matrix ``D`` at the nodes.
"""

from __future__ import annotations

import numpy as np

from .quadrature import QuadratureRule


def barycentric_weights(x: np.ndarray) -> np.ndarray:
    """Barycentric weights for nodes ``x``, normalised for stability."""
    diff = x[:, None] - x[None, :]
    np.fill_diagonal(diff, 1.0)
    w = 1.0 / diff.prod(axis=1)
    return w / (w.max() - w.min())


def lagrange_eval_matrix(x_nodes: np.ndarray, wb: np.ndarray, x_out: np.ndarray) -> np.ndarray:
    """P[j, i] = value of the i-th Lagrange basis function at x_out[j]
    (second barycentric form; points on a node give the Kronecker delta)."""
    x_out = np.asarray(x_out, dtype=np.float64)
    d = x_out[:, None] - x_nodes[None, :]
    at_node = np.abs(d) <= np.finfo(np.float64).eps
    hit = at_node.any(axis=1)
    d_safe = np.where(at_node, 1.0, d)
    c = wb[None, :] / d_safe
    P = c / c.sum(axis=1, keepdims=True)
    if hit.any():
        P[hit] = at_node[hit].astype(np.float64)
    return P


def lagrange_deriv_matrix(x_nodes: np.ndarray, wb: np.ndarray, x_out: np.ndarray) -> np.ndarray:
    """D[j, i] = derivative of the i-th Lagrange basis function at x_out[j]."""
    x_out = np.asarray(x_out, dtype=np.float64)
    n = x_nodes.size
    P = lagrange_eval_matrix(x_nodes, wb, x_out)

    d = x_out[:, None] - x_nodes[None, :]
    at_node = np.abs(d) <= np.finfo(np.float64).eps
    hit = at_node.any(axis=1)

    # off-node points: derivative of the second barycentric form,
    # p'(x0) = sum_j t_j (p(x0) - y_j)/(x0 - x_j) / sum_j t_j, t_j = w_j/(x0-x_j)
    with np.errstate(divide="ignore", invalid="ignore"):
        t = wb[None, :] / d
        B = t.sum(axis=1)
        s = (t / d).sum(axis=1)
        D = (P * s[:, None] - t / d) / B[:, None]

    if hit.any():
        # on-node points x0 == x_k:
        # p'(x_k) = -1/w_k * sum_{j != k} w_j (p(x_k)-y_j)/(x_k-x_j)
        idx = np.argmax(at_node[hit], axis=1)
        for row, k in zip(np.nonzero(hit)[0], idx):
            dk = x_out[row] - x_nodes
            dk[k] = 1.0
            for i in range(n):
                pk = 1.0 if i == k else 0.0
                terms = wb * (pk - (np.arange(n) == i)) / dk
                terms[k] = 0.0
                D[row, i] = -terms.sum() / wb[k]
    return D


class Basis:
    """Nodal Lagrange basis of size ``n`` on Gauss-Lobatto nodes."""

    def __init__(self, n: int):
        self.n = int(n)
        self.quadrature = QuadratureRule(n, QuadratureRule.GaussLobatto)
        self.wb = barycentric_weights(self.quadrature.x)
        # exact 1D mass matrix: an n-point Gauss-Legendre rule integrates the
        # degree 2n-2 product of two basis functions exactly
        gl = QuadratureRule(n, QuadratureRule.GaussLegendre)
        P = self.eval(gl.x)
        self.mass_matrix = (P * gl.w[:, None]).T @ P
        self.derivative_matrix = self.deriv(self.quadrature.x)

    @property
    def nodes(self) -> np.ndarray:
        return self.quadrature.x

    def eval(self, x_out: np.ndarray) -> np.ndarray:
        """(len(x_out), n) matrix of basis values at ``x_out``."""
        return lagrange_eval_matrix(self.quadrature.x, self.wb, x_out)

    def deriv(self, x_out: np.ndarray) -> np.ndarray:
        """(len(x_out), n) matrix of basis derivatives at ``x_out``."""
        return lagrange_deriv_matrix(self.quadrature.x, self.wb, x_out)

    def __repr__(self) -> str:
        return f"Basis(n={self.n})"
