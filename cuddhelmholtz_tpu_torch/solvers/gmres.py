"""Restarted GMRES(m) and flexible GMRES(m) on torch tensors.

Counterpart of ``gmres`` and ``fgmres`` in
``cuddhelmholtz_tpu/solvers/gmres.py``.  Both orthogonalise by classical
Gram-Schmidt, twice by default (``reorth=True``, CGS2) or once
(``reorth=False``), and recompute the true residual after every restart.
Two least-squares modes:

  * standard: Givens rotations accumulated in a small matrix, with an early
    exit inside a restart on the rotated-residual estimate (or a breakdown);
  * ``deferred=True``: every restart runs all m steps, then solves the
    least squares once by ridge-regularised normal equations; exits move to
    restart boundaries (up to m - 1 overshoot steps in the last restart).

``gmres(precond=P)`` solves the left-preconditioned system P A x = P b with
a fixed linear P; ``fgmres`` applies a right preconditioner per step and
keeps the preconditioned directions, so P may vary from step to step (an
inner Krylov solve such as the DDH solver).

The counting rules are the JAX package's, so restart and matvec counts
compare one to one:

  * ``num_matvec`` starts at 1 for r0 = b - A x0 (one operator call; a left
    preconditioner's call is part of it, a right one is not counted);
  * each Arnoldi step adds 1, and no matvec runs after an early exit;
  * each restart's true residual adds 1;
  * restarts run while ``it < maxit - 1`` (at most maxit - 1 restarts);
  * ``res_norm`` has maxit + 1 entries, NaN after the last restart.

The loops run on the host.  The standard mode reads its exit flag once per
Arnoldi step; the deferred mode only once per restart.  The vectors and the
small least-squares algebra stay on ``b``'s device.  The JAX package's
``unroll`` option has no counterpart: the eager loop already reads only the
populated rows of the basis.
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


def _orthogonalize(Vk: torch.Tensor, w: torch.Tensor, reorth: bool):
    """Classical Gram-Schmidt of w against the rows of Vk, once or twice:
    (coefficients, remainder)."""
    h = Vk @ w
    w = w - Vk.T @ h
    if reorth:
        h2 = Vk @ w
        w = w - Vk.T @ h2
        h = h + h2
    return h, w


def _basis(r: torch.Tensor, r_nrm: torch.Tensor, m: int, flexible: bool):
    """The Krylov basis V (m+1 rows, V[0] = r / ||r||) and, for a flexible
    solve, the rows Z of the preconditioned directions (else None)."""
    V = torch.zeros((m + 1, r.shape[0]), dtype=r.dtype, device=r.device)
    V[0] = r / torch.where(r_nrm > 0.0, r_nrm, torch.ones_like(r_nrm))
    Z = torch.zeros((m, r.shape[0]), dtype=r.dtype, device=r.device) if flexible else None
    return V, Z


def _step_matvec(matvec, precond, V, Z, k):
    """A v_k, or A P v_k with P v_k stored as Z[k]."""
    if Z is None:
        return matvec(V[k])
    Z[k] = precond(V[k])
    return matvec(Z[k])


def _restart(matvec, r, r_nrm, m, tol_bnrm, nmv, reorth=True, precond=None):
    """One Arnoldi/Givens cycle from residual ``r``; returns the correction
    (V[:k] y, or Z[:k] y with a right preconditioner) and the matvec count."""
    dtype, dev = r.dtype, r.device
    m1 = m + 1
    V, Z = _basis(r, r_nrm, m, precond is not None)
    Q = torch.eye(m1, dtype=dtype, device=dev)
    R = torch.zeros((m, m), dtype=dtype, device=dev)
    eta = torch.zeros(m1, dtype=dtype, device=dev)
    eta[0] = r_nrm
    k_used = 0
    for k in range(m):
        w = _step_matvec(matvec, precond, V, Z, k)
        nmv += 1
        # rows beyond k are zero, so only the populated rows are read
        h, w = _orthogonalize(V[: k + 1], w, reorth)
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
    D = V if Z is None else Z
    return D[:k_used].T @ y, nmv


def _restart_deferred(matvec, r, r_nrm, m, nmv, reorth=True, precond=None):
    """One restart of m unconditional Arnoldi steps, then the least squares
    min ||r_nrm e1 - H y|| by ridge-regularised normal equations."""
    dtype, dev = r.dtype, r.device
    V, Z = _basis(r, r_nrm, m, precond is not None)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    for k in range(m):
        w = _step_matvec(matvec, precond, V, Z, k)
        nmv += 1
        h, w = _orthogonalize(V[: k + 1], w, reorth)
        hk1 = norm(w)
        ok = hk1 > 0.0
        V[k + 1] = torch.where(ok, w / torch.where(ok, hk1, torch.ones_like(hk1)), w)
        H[: k + 1, k] = h
        H[k + 1, k] = hk1
    N = H.T @ H
    ridge = 1e-7 * (torch.trace(N) / m + 1e-30)
    L = torch.linalg.cholesky(N + ridge * torch.eye(m, dtype=dtype, device=dev))
    y = torch.cholesky_solve((r_nrm * H[0, :])[:, None], L)[:, 0]
    D = V[:m] if Z is None else Z
    return D.T @ y, nmv


def _solve(matvec, b, x0, m, maxit, tol, reorth, deferred, precond) -> GmresResult:
    """The restart loop shared by ``gmres`` (``precond`` None: plain Arnoldi
    on ``matvec``) and ``fgmres`` (right preconditioner ``precond``)."""
    dtype, dev = b.dtype, b.device
    x = torch.zeros_like(b) if x0 is None else x0
    tol_bnrm = torch.tensor(tol, dtype=dtype, device=dev) * norm(b)
    r = b - matvec(x)
    r_nrm = norm(r)
    hist = torch.full((maxit + 1,), float("nan"), dtype=dtype, device=dev)
    hist[0] = r_nrm
    it, nmv = 0, 1
    while bool(((r_nrm >= tol_bnrm) & (r_nrm > 0.0)).item()) and it < maxit - 1:
        if deferred:
            dx, nmv = _restart_deferred(matvec, r, r_nrm, m, nmv, reorth, precond)
        else:
            dx, nmv = _restart(matvec, r, r_nrm, m, tol_bnrm, nmv, reorth, precond)
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


def gmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    precond: Callable | None = None,
    reorth: bool = True,
    deferred: bool = False,
) -> GmresResult:
    """Solve A x = b with restarted GMRES(m); ``matvec`` maps a vector to a
    vector of the same dtype and device.  With ``precond`` P the
    left-preconditioned system P A x = P b is solved (tolerance relative to
    ||P b||)."""
    if precond is not None:
        op = matvec

        def matvec(v):
            return precond(op(v))

        b = precond(b)
    return _solve(matvec, b, x0, m, maxit, tol, reorth, deferred, None)


def fgmres(
    matvec: Callable,
    b: torch.Tensor,
    precond: Callable,
    x0: torch.Tensor | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    reorth: bool = True,
    deferred: bool = False,
) -> GmresResult:
    """Flexible GMRES(m) with the right preconditioner ``precond`` applied
    per step: each step stores z_k = P(v_k), applies A to it, and the update
    is Z y, so P may change from step to step."""
    return _solve(matvec, b, x0, m, maxit, tol, reorth, deferred, precond)
