"""Implicitly differentiated linear solves: the adjoint method as a
``torch.autograd.Function``.

Counterpart of ``cuddhelmholtz_tpu/solvers/implicit.py``.  For
``x = A(theta)^{-1} b`` the reverse pass is

    lambda    = A(theta)^{-T} x_bar          (one adjoint solve)
    theta_bar = -lambda^T (dA/dtheta) x      (the VJP of one matvec)
    b_bar     = lambda

so the Krylov iteration is never differentiated through: the forward solve
runs under ``torch.no_grad()`` and records no graph.

Signature.  JAX's ``lax.custom_linear_solve`` differentiates every array
that ``matvec`` closes over; an autograd ``Function`` only sees the tensors
passed to it.  So the operator's differentiable tensors are passed
explicitly::

    x = implicit_solve(matvec, b, *params, ...)    # matvec(v, *params) = A(params) v

Gradients reach ``b`` and every tensor of ``params`` that requires one
(tensors that do not are constants of the operator).  theta_bar is the
gradient of ``matvec(x, *params)`` at the detached solution with grad
output ``-lambda``, one matvec recomputed under ``torch.enable_grad()``.
For ``symmetric=True`` the adjoint solve reuses ``solve`` on ``matvec``;
otherwise ``transpose_solve`` (default: ``solve``) runs on ``A^T``, the VJP
of the linear ``matvec`` with respect to its vector.
"""

from __future__ import annotations

from typing import Callable

import torch

from .gmres import gmres


class _ImplicitSolve(torch.autograd.Function):
    @staticmethod
    def forward(ctx, matvec, solve, transpose_solve, symmetric, b, *params):
        with torch.no_grad():
            x = solve(lambda v: matvec(v, *params), b)
        ctx.matvec, ctx.solve, ctx.transpose_solve = matvec, solve, transpose_solve
        ctx.symmetric = symmetric
        ctx.save_for_backward(x, *params)
        return x

    @staticmethod
    def backward(ctx, x_bar):
        x, *params = ctx.saved_tensors
        matvec = ctx.matvec
        consts = [p.detach() for p in params]
        if ctx.symmetric:
            with torch.no_grad():
                lam = ctx.solve(lambda v: matvec(v, *consts), x_bar)
        else:
            with torch.enable_grad():
                v0 = torch.zeros_like(x, requires_grad=True)
                y0 = matvec(v0, *consts)

            def matvec_t(w):  # A^T w: the VJP of the linear matvec
                return torch.autograd.grad(y0, v0, w, retain_graph=True)[0]

            with torch.no_grad():
                lam = ctx.transpose_solve(matvec_t, x_bar)
        need = [i for i in range(len(params)) if ctx.needs_input_grad[5 + i]]
        grads = [None] * len(params)
        if need:
            with torch.enable_grad():
                ps = [p.requires_grad_(i in need) for i, p in enumerate(consts)]
                y = matvec(x.detach(), *ps)
                got = torch.autograd.grad(y, [ps[i] for i in need], -lam, allow_unused=True)
            for i, g in zip(need, got):
                grads[i] = torch.zeros_like(params[i]) if g is None else g
        b_bar = lam if ctx.needs_input_grad[4] else None
        return None, None, None, None, b_bar, *grads


def implicit_solve(
    matvec: Callable,
    b: torch.Tensor,
    *params: torch.Tensor,
    symmetric: bool = False,
    m: int = 30,
    maxit: int = 200,
    tol: float = 1e-10,
    precond: Callable | None = None,
    solve: Callable | None = None,
    transpose_solve: Callable | None = None,
) -> torch.Tensor:
    """Solve ``A(params) x = b`` differentiably in ``b`` and ``params`` by the
    adjoint method: one extra linear solve per reverse pass.

    ``matvec(v, *params)`` must be linear in ``v`` and differentiable in
    ``params``.  Both systems are solved by the library's ``gmres`` at
    (m, maxit, tol, precond) unless ``solve`` / ``transpose_solve``, with
    signature ``(matvec, rhs) -> x``, substitute another solver (such as
    ``models/inverse.py::ddh_solve_hook``'s FGMRES + DDH).  With a
    preconditioner the adjoint solve is preconditioned by the same P (not
    P^T), which changes its iteration path, not its solution.  Returns only
    ``x``; run the solver directly for its iteration counts.
    """
    if solve is None:

        def solve(mv, rhs):
            return gmres(mv, rhs, m=m, maxit=maxit, tol=tol, precond=precond).x

    if transpose_solve is None:
        transpose_solve = solve
    return _ImplicitSolve.apply(matvec, solve, transpose_solve, symmetric, b, *params)
