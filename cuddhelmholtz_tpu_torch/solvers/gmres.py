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
small least-squares algebra stay on ``b``'s device.  On a CUDA device the
standard restart (``gmres``, ``fgmres``, ``gmres_host``, ``lgmres``) replays
each step's bookkeeping, everything between the matvec and the exit read, as
one CUDA graph per (step index, n, m, dtype, device, reorth), captured the
first time a solve reaches it (``_StepGraphs``); the matvec stays outside the
graph.  It runs eagerly on the CPU, where ``r`` or the matvec's output needs
grad, and in a solve nested inside another of the same key.  The deferred
restart, ``block_gmres`` and ``gmres_lockstep`` run every step eagerly.  The
counters ``gmres.step.graphed``, ``gmres.step.eager`` (every eager step,
block and lock steps included) and ``gmres.step.captures`` say which ran.
Every blocking host read of every variant goes through ``_read``, which
counts it in ``gmres.host_syncs`` and spans it as ``gmres.sync``
(``utils/spans.py``); each solve is the span ``gmres.solve`` and each
Arnoldi step, its matvec included, ``gmres.step`` (one block step in
``block_gmres``).  The JAX package's ``unroll`` option has no counterpart:
the loop already reads only the populated rows of the basis.

Two variants share the standard restart (``_restart``):

  * ``gmres_host`` (JAX ``gmres_host``): ``gmres`` plus a wall-clock cutoff
    checked after each restart, a ``ProgressBar`` (verbose 1) or one line
    per restart (verbose >= 2), and the per-restart wall times;
  * ``lgmres`` (JAX ``lgmres``): LGMRES(m, k), each restart augmented by the
    k previous restart updates (Baker, Jessup & Manteuffel 2005).

Two solvers take K right-hand sides at once, as rows of a (K, n) block,
with one batched matvec (a (K, n) block to a (K, n) block) per step:

  * ``block_gmres`` (JAX ``block_gmres``): one shared block-Krylov space of
    m K directions per restart, jittered CholQR block orthonormalisation
    and the ridge-regularised normal-equations least squares;
  * ``gmres_lockstep``: K independent GMRES(m) solves in lock step, the
    counterpart of ``jax.vmap(gmres)``: each lane keeps its own Krylov
    space, early exit, counts and history, equal to a solo ``gmres``.
"""

from __future__ import annotations

import math
import sys
import time
from collections import OrderedDict
from typing import Callable, NamedTuple

import torch

from ..utils.graphs import capture
from ..utils.linalg import norm
from ..utils.spans import count, span, spanned


class GmresResult(NamedTuple):
    x: torch.Tensor
    success: bool
    num_iter: int  # restart count
    num_matvec: int
    res_norm: torch.Tensor  # (maxit+1,) residual history; NaN-padded after exit
    n_hist: int  # number of valid entries in res_norm


def _read(t: torch.Tensor):
    """The Python value of a one-element tensor: a blocking host read,
    counted and spanned."""
    count("gmres.host_syncs")
    with span("gmres.sync"):
        return t.item()


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


def _step_matvec(matvec, precond, V, Z, k, vin=None):
    """A v_k; or, with the direction stored as Z[k], A P v_k (right
    preconditioner ``precond``) or A d_k for ``d_k = vin(k, V)`` (the
    counterpart of JAX's ``_arnoldi_step(vin=)``)."""
    if Z is None:
        return matvec(V[k])
    Z[k] = precond(V[k]) if vin is None else vin(k, V)
    return matvec(Z[k])


def _arnoldi_givens(V, Q, R, eta, tol_bnrm, flag, w, k: int, reorth: bool) -> None:
    """Arnoldi/Givens step k of a standard restart, in place: CGS (or CGS2)
    of the matvec's output ``w`` against ``V[: k + 1]``, its normalisation
    into ``V[k + 1]``, the Givens update of ``Q``, ``R`` and ``eta``, and
    into the one-element ``flag`` whether the restart stops here (the
    rotated residual ``|eta[k + 1]|`` under ``tol_bnrm``, or a breakdown).
    It reads nothing on the host, so it can be captured as a CUDA graph."""
    m1 = eta.shape[0]
    # rows beyond k are not read
    h, w = _orthogonalize(V[: k + 1], w, reorth)
    hk1 = norm(w)
    breakdown = hk1 == 0.0
    V[k + 1] = torch.where(breakdown, w, w / torch.where(breakdown, torch.ones_like(hk1), hk1))
    # rotate the new Hessenberg column by the accumulated rotations
    hc = torch.zeros(m1, dtype=V.dtype, device=V.device)
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
    flag.copy_((eta[k + 1].abs() < tol_bnrm) | breakdown)


class _StepGraphs:
    """The static state of the standard restart for one key (n, m, dtype,
    device, reorth), and the graphs of its Arnoldi/Givens steps: graph k
    replays ``_arnoldi_givens`` at step k on the static ``V``, ``Q``, ``R``,
    ``eta``, ``tol``, ``flag`` and the matvec's output copied into ``w``.
    Graph k is captured the first time a restart of this key reaches step
    k.  The same kernels run on the same shapes as the eager step, so a
    replay equals it bit for bit.  ``busy`` marks the state as held by a
    running restart."""

    def __init__(self, r: torch.Tensor, m: int, reorth: bool):
        n, dtype, dev = r.shape[0], r.dtype, r.device
        self.reorth, self.busy = reorth, False
        self.V = torch.zeros((m + 1, n), dtype=dtype, device=dev)
        self.eye = torch.eye(m + 1, dtype=dtype, device=dev)
        self.Q = self.eye.clone()
        self.R = torch.zeros((m, m), dtype=dtype, device=dev)
        self.eta = torch.zeros(m + 1, dtype=dtype, device=dev)
        self.tol = torch.zeros((), dtype=dtype, device=dev)
        self.flag = torch.zeros((), dtype=torch.bool, device=dev)
        self.w = torch.zeros(n, dtype=dtype, device=dev)
        self.graphs: list = [None] * m
        self.pool = torch.cuda.graph_pool_handle()

    def state(self) -> tuple:
        return self.V, self.Q, self.R, self.eta, self.tol, self.flag

    def start(self, r, r_nrm, tol_bnrm) -> None:
        """Fill the state for a new restart from residual ``r``, as
        ``_basis`` and the eager restart do."""
        self.V[0] = r / torch.where(r_nrm > 0.0, r_nrm, torch.ones_like(r_nrm))
        self.Q.copy_(self.eye)
        self.R.zero_()
        self.eta.zero_()
        self.eta[0] = r_nrm
        self.tol.copy_(tol_bnrm)

    def step(self, w: torch.Tensor, k: int) -> None:
        self.w.copy_(w)
        if self.graphs[k] is None:
            self.graphs[k] = self._capture(k)
        self.graphs[k].replay()
        count("gmres.step.graphed")

    def _capture(self, k: int):
        count("gmres.step.captures")
        graph, _ = capture(_arnoldi_givens, (*self.state(), self.w, k, self.reorth), self.pool,
                           in_place=True)
        return graph


_KEEP = 4  # keys whose step graphs are kept, the oldest dropped first
_WORKSPACES: OrderedDict = OrderedDict()


def _workspace(r: torch.Tensor, m: int, reorth: bool) -> _StepGraphs | None:
    """The step graphs of ``r``'s key, marked busy, for a restart on a CUDA
    tensor that needs no grad; None (run eagerly) for any other, or while a
    running restart holds that key's state (a nested solve)."""
    if not r.is_cuda or (torch.is_grad_enabled() and r.requires_grad):
        return None
    key = (r.shape[0], m, r.dtype, r.device, reorth)
    ws = _WORKSPACES.get(key)
    if ws is None:
        ws = _WORKSPACES[key] = _StepGraphs(r, m, reorth)
        while len(_WORKSPACES) > _KEEP:
            _WORKSPACES.popitem(last=False)
    elif ws.busy:
        return None
    _WORKSPACES.move_to_end(key)
    ws.busy = True
    return ws


def _restart(matvec, r, r_nrm, m, tol_bnrm, nmv, reorth=True, precond=None, vin=None):
    """One Arnoldi/Givens cycle of at most m steps from residual ``r``;
    returns the correction (V[:k] y, or Z[:k] y over the directions A was
    applied to, with ``precond`` or ``vin``) and the matvec count.

    On a CUDA ``r`` each step's bookkeeping replays a captured graph
    (``_StepGraphs``) while neither ``r`` nor the matvec's output needs
    grad; otherwise it runs ``_arnoldi_givens`` eagerly."""
    dtype, dev = r.dtype, r.device
    flexible = precond is not None or vin is not None
    ws = _workspace(r, m, reorth)
    try:
        if ws is None:
            V, Z = _basis(r, r_nrm, m, flexible)
            Q = torch.eye(m + 1, dtype=dtype, device=dev)
            R = torch.zeros((m, m), dtype=dtype, device=dev)
            eta = torch.zeros(m + 1, dtype=dtype, device=dev)
            eta[0] = r_nrm
            tol, flag = tol_bnrm, torch.zeros((), dtype=torch.bool, device=dev)
        else:
            ws.start(r, r_nrm, tol_bnrm)
            V, Q, R, eta, tol, flag = ws.state()
            Z = torch.zeros((m, r.shape[0]), dtype=dtype, device=dev) if flexible else None
        k_used = 0
        for k in range(m):
            with span("gmres.step"):
                w = _step_matvec(matvec, precond, V, Z, k, vin)
                nmv += 1
                if ws is not None and torch.is_grad_enabled() and w.requires_grad:
                    # the rest of the restart runs eagerly, on copies
                    V, Q, R, eta, tol, flag = (t.clone() for t in ws.state())
                    ws.busy, ws = False, None
                if ws is None:
                    _arnoldi_givens(V, Q, R, eta, tol, flag, w, k, reorth)
                    count("gmres.step.eager")
                else:
                    ws.step(w, k)
                k_used = k + 1
                stop = _read(flag)
            if stop:
                break
        y = torch.linalg.solve_triangular(R[:k_used, :k_used], eta[:k_used, None],
                                          upper=True)[:, 0]
        D = V if Z is None else Z
        return D[:k_used].T @ y, nmv
    finally:
        if ws is not None:
            ws.busy = False


def _restart_deferred(matvec, r, r_nrm, m, nmv, reorth=True, precond=None):
    """One restart of m unconditional Arnoldi steps, then the least squares
    min ||r_nrm e1 - H y|| by ridge-regularised normal equations."""
    dtype, dev = r.dtype, r.device
    V, Z = _basis(r, r_nrm, m, precond is not None)
    H = torch.zeros((m + 1, m), dtype=dtype, device=dev)
    for k in range(m):
        with span("gmres.step"):
            w = _step_matvec(matvec, precond, V, Z, k)
            nmv += 1
            h, w = _orthogonalize(V[: k + 1], w, reorth)
            hk1 = norm(w)
            ok = hk1 > 0.0
            V[k + 1] = torch.where(ok, w / torch.where(ok, hk1, torch.ones_like(hk1)), w)
            H[: k + 1, k] = h
            H[k + 1, k] = hk1
            count("gmres.step.eager")
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
    while _read((r_nrm >= tol_bnrm) & (r_nrm > 0.0)) and it < maxit - 1:
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
    success = _read(r_nrm <= tol_bnrm)
    return GmresResult(
        x=x, success=success, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )


def _left(matvec, b, precond):
    """(P A, P b) for a left preconditioner P, or (A, b) without one."""
    if precond is None:
        return matvec, b
    return (lambda v: precond(matvec(v))), precond(b)


@spanned("gmres.solve")
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
    matvec, b = _left(matvec, b, precond)
    return _solve(matvec, b, x0, m, maxit, tol, reorth, deferred, None)


class ProgressBar:
    """Fixed-width progress bar for host-loop solves, advanced by
    ``update(fraction)`` (``gmres_host`` at verbosity 1); the JAX package's
    format, byte for byte."""

    def __init__(self, width: int = 40):
        self.width = width
        self._drawn = -1

    def update(self, fraction: float) -> None:
        fraction = min(max(fraction, 0.0), 1.0)
        n = int(self.width * fraction)
        if n != self._drawn:
            self._drawn = n
            bar = "#" * n + "-" * (self.width - n)
            sys.stdout.write(f"\r[{bar}] {100 * fraction:5.1f}%")
            sys.stdout.flush()

    def finish(self) -> None:
        self.update(1.0)
        sys.stdout.write("\n")
        sys.stdout.flush()


@spanned("gmres.solve")
def gmres_host(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    precond: Callable | None = None,
    max_seconds: float = 6 * 60 * 60,
    verbose: int = 0,
    reorth: bool = True,
) -> tuple[GmresResult, list]:
    """``gmres`` (standard mode) with a wall-clock cutoff checked after each
    restart, progress output and the per-restart wall times.

    Returns ``(result, times)``: ``times[i]`` is the wall time since the
    first restart began when restart i ended (``times[0] = 0.0``).  The
    solve stops once ``||r|| <= tol ||b||`` or ``r == 0``, after maxit - 1
    restarts, or when a restart ends past ``max_seconds``.  ``verbose=1``
    draws a ``ProgressBar`` driven by the larger of the log-residual
    progress toward the target and ``it / maxit``; ``verbose >= 2`` prints
    one ``iteration ... || rel. res. = ...`` line per restart.  The same
    restarts as ``gmres``, so the counts and history are ``gmres``'s.
    """
    matvec, b = _left(matvec, b, precond)
    x = torch.zeros_like(b) if x0 is None else x0
    bnrm = norm(b)
    tol_bnrm = torch.tensor(tol, dtype=b.dtype, device=b.device) * bnrm
    tol_f, bnrm_f = _read(tol_bnrm), _read(bnrm)
    r = b - matvec(x)
    r_nrm = norm(r)
    rn = _read(r_nrm)
    hist, times = [rn], [0.0]
    it, nmv = 0, 1
    t0 = time.perf_counter()
    success = rn <= tol_f or rn == 0.0
    bar = ProgressBar() if verbose == 1 else None
    log_start = math.log(max(rn, 1e-300))
    log_goal = math.log(max(tol_f, 1e-300))
    while not success and it < maxit - 1:
        dx, nmv = _restart(matvec, r, r_nrm, m, tol_bnrm, nmv, reorth)
        x = x + dx
        r = b - matvec(x)
        nmv += 1
        r_nrm = norm(r)
        rn = _read(r_nrm)
        it += 1
        hist.append(rn)
        times.append(time.perf_counter() - t0)
        if bar is not None:
            prog = (log_start - math.log(max(rn, 1e-300))) / max(log_start - log_goal, 1e-300)
            bar.update(max(prog, it / maxit))
        elif verbose:
            print(f"iteration {it:6d} / {maxit} || rel. res. = {rn / max(bnrm_f, 1e-300):.5e}",
                  flush=True)
        success = rn <= tol_f or rn == 0.0
        if times[-1] > max_seconds:
            break
    if bar is not None:
        bar.finish()
    res = torch.full((maxit + 1,), float("nan"), dtype=b.dtype, device=b.device)
    res[: len(hist)] = torch.tensor(hist, dtype=b.dtype)
    return GmresResult(x=x, success=success, num_iter=it, num_matvec=nmv, res_norm=res,
                       n_hist=len(hist)), times


@spanned("gmres.solve")
def lgmres(
    matvec: Callable,
    b: torch.Tensor,
    x0: torch.Tensor | None = None,
    *,
    m: int = 20,
    k: int = 3,
    maxit: int = 100,
    tol: float = 1e-6,
    precond: Callable | None = None,
    reorth: bool = True,
) -> GmresResult:
    """LGMRES(m, k): restarted GMRES whose approximation space is augmented
    with the k previous restart updates (Baker, Jessup & Manteuffel 2005).

    Each restart runs up to m + k Arnoldi steps (the standard early exit
    applies).  Steps 0..m-1 apply A to the newest basis vector; step j >= m
    applies A to the stored direction ``Z[j - m]`` while one exists (the
    first restarts have fewer than k), else continues the Krylov recursion
    on ``V[j]``.  The update is ``dx = sum_j y_j d_j`` over the directions
    A was applied to, and ``Z`` rolls in ``dx / ||dx||`` after each restart.
    ``k=0`` is ``gmres(m=m)`` step for step.  ``precond`` is a left
    preconditioner, as in ``gmres``.  Counts as ``gmres``: m + k + 1
    matvecs per full restart.
    """
    matvec, b = _left(matvec, b, precond)
    dtype, dev = b.dtype, b.device
    x = torch.zeros_like(b) if x0 is None else x0
    tol_bnrm = torch.tensor(tol, dtype=dtype, device=dev) * norm(b)
    r = b - matvec(x)
    r_nrm = norm(r)
    hist = torch.full((maxit + 1,), float("nan"), dtype=dtype, device=dev)
    hist[0] = r_nrm
    it, nmv = 0, 1
    Z = torch.zeros((max(k, 1), b.shape[0]), dtype=dtype, device=dev)
    kv = 0  # stored directions in use

    def vin(j, V):
        return Z[j - m] if m <= j < m + kv else V[j]

    while _read((r_nrm >= tol_bnrm) & (r_nrm > 0.0)) and it < maxit - 1:
        dx, nmv = _restart(matvec, r, r_nrm, m + k, tol_bnrm, nmv, reorth, vin=vin)
        x = x + dx
        r = b - matvec(x)
        nmv += 1
        r_nrm = norm(r)
        it += 1
        hist[it] = r_nrm
        if k > 0:
            dxn = norm(dx)
            grew = _read(dxn > 0.0)
            Z = torch.roll(Z, 1, dims=0)
            Z[0] = dx / dxn if grew else 0.0
            kv = min(kv + int(grew), k)
    success = _read(r_nrm <= tol_bnrm)
    return GmresResult(
        x=x, success=success, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )


@spanned("gmres.solve")
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


class BlockGmresResult(NamedTuple):
    x: torch.Tensor  # (K, n) solutions
    success: torch.Tensor  # (K,) bool, per source
    num_iter: int  # shared restart count
    num_matvec: int  # single-vector matvecs: K per block operator call
    res_norm: torch.Tensor  # (maxit+1, K) per-source residual history, NaN after exit
    n_hist: int


def _block_qr(Z: torch.Tensor, eps: float):
    """Factor a K-row block ``Z = F @ V`` with the rows of V orthonormal (up
    to clipped near-null directions): returns (F, V).

    Jittered CholQR: the Cholesky factor L of Z Z^T + 30 eps tr/K I gives
    V = L^-1 Z.  A rank-deficient block (a converged source, coalescing
    directions) can break it; only when the factorisation fails or L comes
    back not finite does the eigh-whitened polar factor (spectrum clipped at
    eps * lambda_max) take over.  That test is read on the host: one sync
    per QR (``_read``; ``cholesky_ex`` itself does not sync).
    """
    K = Z.shape[0]
    eye = torch.eye(K, dtype=Z.dtype, device=Z.device)
    G = Z @ Z.T
    tr = torch.trace(G) / K + 1e-30
    Lc, info = torch.linalg.cholesky_ex(G + (30 * eps * tr) * eye)
    if _read((info == 0) & torch.isfinite(Lc).all()):
        Li = torch.linalg.solve_triangular(Lc, eye, upper=False)
        return Lc, Li @ Z
    s, U = torch.linalg.eigh(G)
    floor = eps * s[-1].clamp_min(1e-30)
    s_c = torch.sqrt(torch.maximum(s, floor))
    return U * s_c[None, :], (U.T / s_c[:, None]) @ Z


@spanned("gmres.solve")
def block_gmres(
    matvec: Callable,
    B: torch.Tensor,
    X0: torch.Tensor | None = None,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    reorth: bool = True,
) -> BlockGmresResult:
    """Restarted block GMRES: solve A x_k = b_k for the K rows of ``B``
    (K, n) in one shared block-Krylov space of m K directions per restart.

    ``matvec`` maps a (K, n) block to a (K, n) block.  Block CGS (twice with
    ``reorth``) against the populated basis rows, ``_block_qr`` for each new
    block, and per restart the least squares min ||E - Hb Y||_F by
    ridge-regularised normal equations.  Convergence is per source (``tol *
    ||b_k||`` on the true residual, recomputed each restart); restarts run
    while any source has not converged and ``it < maxit - 1``.
    """
    dtype, dev = B.dtype, B.device
    K, n = B.shape
    X = torch.zeros_like(B) if X0 is None else X0
    eps = 3e-7 if dtype == torch.float32 else 1e-14
    tol_b = tol * torch.linalg.vector_norm(B, dim=1)
    R = B - matvec(X)
    rn = torch.linalg.vector_norm(R, dim=1)
    hist = torch.full((maxit + 1, K), float("nan"), dtype=dtype, device=dev)
    hist[0] = rn
    q = (m + 1) * K
    it, nmv = 0, K
    while _read(((rn >= tol_b) & (rn > 0.0)).any()) and it < maxit - 1:
        L0, V0 = _block_qr(R, eps)
        W = torch.zeros((q, n), dtype=dtype, device=dev)
        W[:K] = V0
        Hb = torch.zeros((q, m * K), dtype=dtype, device=dev)
        # coordinates of R in the basis: r_k = sum_i L0[k, i] v_i
        E = torch.zeros((q, K), dtype=dtype, device=dev)
        E[:K] = L0.T
        for j in range(m):
            with span("gmres.step"):
                lo, hi = j * K, (j + 1) * K
                Z = matvec(W[lo:hi])
                Wl = W[:hi]  # the populated rows
                h = Wl @ Z.T
                Z = Z - h.T @ Wl
                if reorth:
                    h2 = Wl @ Z.T
                    Z = Z - h2.T @ Wl
                    h = h + h2
                Lj, Vn = _block_qr(Z, eps)
                Hb[:hi, lo:hi] = h
                Hb[hi:hi + K, lo:hi] = Lj.T
                W[hi:hi + K] = Vn
                nmv += K
                count("gmres.step.eager")
        N = Hb.T @ Hb
        ridge = 1e-7 * (torch.trace(N) / N.shape[0] + 1e-30)
        eye = torch.eye(N.shape[0], dtype=dtype, device=dev)
        Ln, _ = torch.linalg.cholesky_ex(N + ridge * eye)
        Y = torch.cholesky_solve(Hb.T @ E, Ln)
        X = X + Y.T @ W[: m * K]
        R = B - matvec(X)
        nmv += K
        rn = torch.linalg.vector_norm(R, dim=1)
        it += 1
        hist[it] = rn
    return BlockGmresResult(
        x=X, success=rn <= tol_b, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )


class LockstepResult(NamedTuple):
    """Per-lane ``GmresResult`` fields of ``gmres_lockstep``: lane k's entry
    is what a solo ``gmres`` of row k gives."""

    x: torch.Tensor  # (K, n)
    success: torch.Tensor  # (K,) bool
    num_iter: torch.Tensor  # (K,) int64 restart counts
    num_matvec: torch.Tensor  # (K,) int64
    res_norm: torch.Tensor  # (K, maxit+1), NaN after each lane's exit
    n_hist: torch.Tensor  # (K,) int64


def _lockstep_restart(matvec, r, r_nrm, m, tol_b, nmv, frozen, reorth):
    """One Arnoldi/Givens cycle of every lane from its residual row of ``r``,
    each lane as ``_restart`` runs it; lanes in ``frozen`` and lanes that
    have exited take no step (their columns of R are identity, their eta 0,
    so the padded triangular solve gives them y = 0).  Returns the
    corrections and the per-lane matvec counts."""
    dtype, dev = r.dtype, r.device
    K, n = r.shape
    m1 = m + 1
    V = torch.zeros((K, m1, n), dtype=dtype, device=dev)
    V[:, 0] = r / torch.where(r_nrm > 0.0, r_nrm, torch.ones_like(r_nrm))[:, None]
    Q = torch.eye(m1, dtype=dtype, device=dev).repeat(K, 1, 1)
    R = torch.eye(m, dtype=dtype, device=dev).repeat(K, 1, 1)
    eta = torch.zeros((K, m1), dtype=dtype, device=dev)
    eta[:, 0] = r_nrm
    done = frozen.clone()
    lanes = torch.arange(K, device=dev)
    used = torch.zeros(K, dtype=torch.int64, device=dev)  # steps each lane took
    for k in range(m):
        if _read(done.all()):
            break
        with span("gmres.step"):
            act = ~done
            w = matvec(V[:, k])
            Vk = V[:, : k + 1]
            h = torch.einsum("kjn,kn->kj", Vk, w)
            w = w - torch.einsum("kjn,kj->kn", Vk, h)
            if reorth:
                h2 = torch.einsum("kjn,kn->kj", Vk, w)
                w = w - torch.einsum("kjn,kj->kn", Vk, h2)
                h = h + h2
            hk1 = torch.linalg.vector_norm(w, dim=1)
            breakdown = hk1 == 0.0
            vnew = torch.where(breakdown[:, None], w,
                               w / torch.where(breakdown, torch.ones_like(hk1), hk1)[:, None])
            hc = torch.zeros((K, m1), dtype=dtype, device=dev)
            hc[:, : k + 1] = h
            hc[:, k + 1] = hk1
            col = torch.einsum("kij,kj->ki", Q, hc)
            a, b = col[:, k], col[:, k + 1]
            t = torch.hypot(a, b)
            safe = t > 0.0
            one = torch.ones_like(t)
            c = torch.where(safe, a / torch.where(safe, t, one), one)
            s = torch.where(safe, b / torch.where(safe, t, one), torch.zeros_like(t))
            rcol = col[:, :m].clone()
            rcol[:, k] = c * col[:, k] + s * col[:, k + 1]
            if k + 1 < m:
                rcol[:, k + 1:] = 0.0
            R[:, :, k] = torch.where(act[:, None], rcol, R[:, :, k])
            qk, qk1 = Q[:, k].clone(), Q[:, k + 1].clone()
            Q[:, k] = torch.where(act[:, None], c[:, None] * qk + s[:, None] * qk1, qk)
            Q[:, k + 1] = torch.where(act[:, None], -s[:, None] * qk + c[:, None] * qk1, qk1)
            ek = eta[:, k].clone()
            eta[:, k + 1] = torch.where(act, -s * ek, eta[:, k + 1])
            eta[:, k] = torch.where(act, c * ek, torch.zeros_like(ek))
            V[:, k + 1] = torch.where(act[:, None], vnew, V[:, k + 1])
            nmv = nmv + act.long()
            used = used + act.long()
            done = done | (act & ((eta[lanes, k + 1].abs() < tol_b) | breakdown))
            count("gmres.step.eager")
    # a lane's rhs past its last step is 0 (the solo solve reads eta[:used])
    rhs = torch.where(torch.arange(m, device=dev) < used[:, None], eta[:, :m], 0.0)
    y = torch.linalg.solve_triangular(R, rhs[..., None], upper=True)[..., 0]
    return torch.einsum("kjn,kj->kn", V[:, :m], y), nmv


def _lockstep_restart_deferred(matvec, r, r_nrm, m, nmv, frozen, reorth):
    """One restart of m unconditional Arnoldi steps for every lane not in
    ``frozen``, each as ``_restart_deferred`` runs it; frozen lanes get a
    zero correction and no count."""
    dtype, dev = r.dtype, r.device
    K, n = r.shape
    V = torch.zeros((K, m + 1, n), dtype=dtype, device=dev)
    V[:, 0] = r / torch.where(r_nrm > 0.0, r_nrm, torch.ones_like(r_nrm))[:, None]
    H = torch.zeros((K, m + 1, m), dtype=dtype, device=dev)
    for k in range(m):
        with span("gmres.step"):
            w = matvec(V[:, k])
            Vk = V[:, : k + 1]
            h = torch.einsum("kjn,kn->kj", Vk, w)
            w = w - torch.einsum("kjn,kj->kn", Vk, h)
            if reorth:
                h2 = torch.einsum("kjn,kn->kj", Vk, w)
                w = w - torch.einsum("kjn,kj->kn", Vk, h2)
                h = h + h2
            hk1 = torch.linalg.vector_norm(w, dim=1)
            ok = hk1 > 0.0
            safe = torch.where(ok, hk1, torch.ones_like(hk1))
            V[:, k + 1] = torch.where(ok[:, None], w / safe[:, None], w)
            H[:, : k + 1, k] = h
            H[:, k + 1, k] = hk1
            count("gmres.step.eager")
    live = (~frozen).nonzero()[:, 0]
    Hl = H[live]
    N = Hl.transpose(1, 2) @ Hl
    eye = torch.eye(m, dtype=dtype, device=dev)
    ridge = 1e-7 * (torch.diagonal(N, dim1=1, dim2=2).sum(1) / m + 1e-30)
    L, _ = torch.linalg.cholesky_ex(N + ridge[:, None, None] * eye)
    y = torch.cholesky_solve((r_nrm[live, None] * Hl[:, 0, :])[..., None], L)[..., 0]
    dx = torch.zeros_like(r)
    dx[live] = torch.einsum("kjn,kj->kn", V[live, :m], y)
    return dx, nmv + m * (~frozen).long()


@spanned("gmres.solve")
def gmres_lockstep(
    matvec: Callable,
    B: torch.Tensor,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    reorth: bool = True,
    deferred: bool = False,
) -> LockstepResult:
    """K independent restarted GMRES(m) solves, one per row of ``B`` (K, n),
    run in lock step with one batched ``matvec`` ((K, n) -> (K, n)) per
    step: the counterpart of ``jax.vmap(gmres)``.

    Each lane keeps its own Krylov space, early exit, restart and matvec
    counts and history, equal to a solo ``gmres`` of that row with the same
    options; a lane that has exited (or converged) is frozen and left
    unchanged while the others run on.  The matvec still sees all K rows,
    so the work per step is the slowest lane's.
    """
    dtype, dev = B.dtype, B.device
    K = B.shape[0]
    x = torch.zeros_like(B)
    tol_b = tol * torch.linalg.vector_norm(B, dim=1)
    r = B - matvec(x)
    r_nrm = torch.linalg.vector_norm(r, dim=1)
    hist = torch.full((K, maxit + 1), float("nan"), dtype=dtype, device=dev)
    hist[:, 0] = r_nrm
    it = torch.zeros(K, dtype=torch.int64, device=dev)
    nmv = torch.ones(K, dtype=torch.int64, device=dev)
    lanes = torch.arange(K, device=dev)
    while True:
        run = (r_nrm >= tol_b) & (r_nrm > 0.0) & (it < maxit - 1)
        if not _read(run.any()):
            break
        if deferred:
            dx, nmv = _lockstep_restart_deferred(matvec, r, r_nrm, m, nmv, ~run, reorth)
        else:
            dx, nmv = _lockstep_restart(matvec, r, r_nrm, m, tol_b, nmv, ~run, reorth)
        x = torch.where(run[:, None], x + dx, x)
        r_new = B - matvec(x)
        r = torch.where(run[:, None], r_new, r)
        r_nrm = torch.where(run, torch.linalg.vector_norm(r_new, dim=1), r_nrm)
        nmv = nmv + run.long()
        it = it + run.long()
        hist[lanes[run], it[run]] = r_nrm[run]
    return LockstepResult(
        x=x, success=r_nrm <= tol_b, num_iter=it, num_matvec=nmv, res_norm=hist, n_hist=it + 1
    )
