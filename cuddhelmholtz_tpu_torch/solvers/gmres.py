"""Restarted GMRES(m) on torch tensors.

Counterpart of ``gmres`` in ``cuddhelmholtz_tpu/solvers/gmres.py`` in its
default mode: CGS2 orthogonalisation (``reorth=True``), Givens least squares
with accumulated rotations, early exit on the rotated-residual estimate and a
true-residual recomputation after every restart.  The counting rules are the
JAX package's, so restart and matvec counts compare one to one:

  * ``num_matvec`` starts at 1 for r0 = b - A x0 (one real operator call);
  * each Arnoldi step adds 1, and no matvec runs after the early exit;
  * each restart's true residual adds 1;
  * restarts run while ``it < maxit - 1`` (at most maxit - 1 restarts);
  * ``res_norm`` has maxit + 1 entries, NaN after the last restart.

The restart loop runs on the host and reads the convergence flag once per
Arnoldi step; the vectors and the small Hessenberg algebra stay on ``b``'s
device.  The ``deferred`` and ``unroll`` variants are not ported yet.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from ..utils.linalg import norm


class GmresResult(NamedTuple):
    x: torch.Tensor
    success: bool
    num_iter: int  # restart count
    num_matvec: int
    res_norm: torch.Tensor  # (maxit+1,) residual history; NaN-padded after exit
    n_hist: int  # number of valid entries in res_norm


def _restart(matvec, r, r_nrm, m, tol_bnrm, nmv):
    """One Arnoldi/Givens cycle from residual ``r``; returns the correction
    V[:k] y and the updated matvec count."""
    dtype, dev = r.dtype, r.device
    m1 = m + 1
    V = torch.zeros((m1, r.shape[0]), dtype=dtype, device=dev)
    V[0] = r / torch.where(r_nrm > 0.0, r_nrm, torch.ones_like(r_nrm))
    Q = torch.eye(m1, dtype=dtype, device=dev)
    R = torch.zeros((m, m), dtype=dtype, device=dev)
    eta = torch.zeros(m1, dtype=dtype, device=dev)
    eta[0] = r_nrm
    k_used = 0
    for k in range(m):
        w = matvec(V[k])
        nmv += 1
        # CGS2: rows beyond k are zero, so only the populated rows are read
        Vk = V[: k + 1]
        h = Vk @ w
        w = w - Vk.T @ h
        h2 = Vk @ w
        w = w - Vk.T @ h2
        h = h + h2
        hk1 = norm(w)
        breakdown = hk1 == 0.0
        V[k + 1] = torch.where(breakdown, w, w / torch.where(breakdown, torch.ones_like(hk1), hk1))
        # rotate the new Hessenberg column by the accumulated rotations
        hc = torch.zeros(m1, dtype=dtype, device=dev)
        hc[: k + 1] = h
        hc[k + 1] = hk1
        col = Q @ hc
        a, b = col[k], col[k + 1]
        t = torch.hypot(a, b)
        safe = t > 0.0
        one = torch.ones_like(t)
        c = torch.where(safe, a / torch.where(safe, t, one), one)
        s = torch.where(safe, b / torch.where(safe, t, one), torch.zeros_like(t))
        R[: k + 1, k] = col[: k + 1]
        R[k, k] = c * col[k] + s * col[k + 1]
        # Q <- G Q: only rows k and k+1 change
        qk, qk1 = Q[k].clone(), Q[k + 1].clone()
        Q[k] = c * qk + s * qk1
        Q[k + 1] = -s * qk + c * qk1
        ek = eta[k].clone()
        eta[k + 1] = -s * ek
        eta[k] = c * ek
        k_used = k + 1
        if bool(((eta[k + 1].abs() < tol_bnrm) | breakdown).item()):
            break
    y = torch.linalg.solve_triangular(R[:k_used, :k_used], eta[:k_used, None], upper=True)[:, 0]
    return V[:k_used].T @ y, nmv


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
) -> GmresResult:
    """Solve A x = b with restarted GMRES(m); ``matvec`` maps a vector to a
    vector of the same dtype and device."""
    dtype, dev = b.dtype, b.device
    if x0 is None:
        x0 = torch.zeros_like(b)
    tol_bnrm = torch.tensor(tol, dtype=dtype, device=dev) * norm(b)
    x = x0
    r = b - matvec(x)
    r_nrm = norm(r)
    hist = torch.full((maxit + 1,), float("nan"), dtype=dtype, device=dev)
    hist[0] = r_nrm
    it, nmv = 0, 1
    while bool(((r_nrm >= tol_bnrm) & (r_nrm > 0.0)).item()) and it < maxit - 1:
        dx, nmv = _restart(matvec, r, r_nrm, m, tol_bnrm, nmv)
        x = x + dx
        r = b - matvec(x)
        nmv += 1
        r_nrm = norm(r)
        it += 1
        hist[it] = r_nrm
    success = bool((r_nrm <= tol_bnrm).item())
    return GmresResult(
        x=x, success=success, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )
