"""Differentiable Helmholtz solves and wave-speed inversion (FWI).

Counterpart of ``cuddhelmholtz_tpu/models/inverse.py``.  Nodal wave speed
``a`` -> coefficient collocation -> coupled operator -> Krylov solve ->
observation misfit is one torch function, so ``torch.autograd.grad`` gives
the exact discrete adjoint gradient at the cost of one extra linear solve
(``solvers/implicit.py``).  The volume term uses ``a^2`` at the H1 nodes and
the absorbing boundary uses ``a`` at the face nodes, both from one global
nodal field, so the gradient accounts for both paths.

``solve_helmholtz_diff`` passes the operator's differentiable tensors to
``implicit_solve`` explicitly: the coefficient-weighted mass weights
``wdetj``, the face weights ``wds`` and omega.  Their gradients flow back to
``a_nodal`` through the coefficient gathers, whose backward sums through
the host-built assembly tables (``ops/mass.py::gather``), so a gradient
repeats bitwise on the card.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..solvers.ddh import DDHPreconditioner, check_device
from ..solvers.gmres import fgmres
from ..solvers.implicit import implicit_solve
from ..spaces.h1 import FaceSpace, H1Space
from .helmholtz import (
    HelmholtzTemplate,
    apply_helmholtz,
    helmholtz_op_with_coeff,
    make_helmholtz_template,
)


def solve_helmholtz_diff(
    tmpl: HelmholtzTemplate,
    omega,
    a_nodal: torch.Tensor,
    b: torch.Tensor,
    *,
    m: int = 50,
    maxit: int = 400,
    tol: float = 1e-8,
    solve: Callable | None = None,
) -> torch.Tensor:
    """U(a) = A(a)^{-1} b, differentiable in ``a_nodal``, ``omega`` (a float,
    or a 0-d tensor to differentiate) and ``b``.

    The coupled system is symmetric, so the adjoint solve reuses the
    forward solver: GMRES(m) at (maxit, tol), or ``solve=(matvec, rhs) ->
    x`` (such as ``ddh_solve_hook``) for both passes.
    """
    w = omega if torch.is_tensor(omega) else torch.tensor(float(omega), dtype=b.dtype,
                                                          device=b.device)
    # face_proj has no repeated entry, so plain indexing's backward is exact
    op = helmholtz_op_with_coeff(tmpl, w, a_nodal * a_nodal, a_nodal[tmpl.face_proj])

    def matvec(U, wdetj, wds, w):
        return apply_helmholtz(op._replace(mass=op.mass._replace(wdetj=wdetj),
                                           face_mass=op.face_mass._replace(wds=wds),
                                           omega=w), U)

    return implicit_solve(matvec, b, op.mass.wdetj, op.face_mass.wds, w, symmetric=True,
                          m=m, maxit=maxit, tol=tol, solve=solve)


def ddh_solve_hook(
    ddh,
    *,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-8,
    inner_m: int = 20,
    inner_maxit: int = 3,
) -> Callable:
    """A ``solve=(matvec, rhs) -> x`` hook for ``implicit_solve`` /
    ``solve_helmholtz_diff``: FGMRES(m) in the rhs dtype, right-preconditioned
    by one bounded fp32 DDH inner solve (``solvers/ddh.py::DDHPreconditioner``,
    the P of ``run_helmholtz_ddh``).

    The DDH is FROZEN at the coefficient it was built with (typically the
    inversion's starting model): a preconditioner does not change the
    solution the Krylov iteration converges to, so the solution and its
    gradient stay exact to the solve tolerance while the iteration count
    grows as the model drifts from the frozen one.  The coupled system is
    symmetric, so the same hook, with the same P, serves the adjoint solve.
    The returned ``solve`` keeps each solve's ``GmresResult`` (without x) in
    ``solve.results`` and its preconditioner in ``solve.precond`` (whose
    ``calls`` counts the applications).
    """
    P = DDHPreconditioner(ddh, inner_m, inner_maxit)
    results = []

    def solve(mv, rhs):
        out = fgmres(mv, rhs, P, m=m, maxit=maxit, tol=tol)
        results.append(out._replace(x=None))
        return out.x

    solve.results = results
    solve.precond = P
    return solve


def misfit(
    tmpl: HelmholtzTemplate,
    omega,
    a_nodal: torch.Tensor,
    b: torch.Tensor,
    observed: torch.Tensor,
    obs_idx: torch.Tensor | None = None,
    **solve_kwargs,
) -> torch.Tensor:
    """0.5 || R U(a) - observed ||^2, the FWI data misfit.

    ``obs_idx`` (distinct rows of the coupled [u; v] vector) restricts the
    observation operator R to the receivers; None observes everywhere.
    ``torch.autograd.grad`` of it with respect to ``a_nodal`` is the
    adjoint-state gradient.
    """
    U = solve_helmholtz_diff(tmpl, omega, a_nodal, b, **solve_kwargs)
    r = (U if obs_idx is None else U[obs_idx]) - observed
    return 0.5 * torch.dot(r, r)


def invert_wavespeed(
    space: H1Space,
    fs: FaceSpace,
    omega: float,
    b: torch.Tensor,
    observed: torch.Tensor,
    a0_nodal,
    *,
    obs_idx: torch.Tensor | None = None,
    steps: int = 20,
    step_size: float = 1e-2,
    dtype=torch.float64,
    solve_kwargs: dict | None = None,
    device="cuda",
) -> tuple[torch.Tensor, torch.Tensor]:
    """Plain gradient-descent wave-speed inversion (demo driver): ``steps``
    times the misfit and its gradient (one forward and one adjoint solve),
    then ``a <- a - step_size * g``.  Returns ``(a_nodal, loss_history)``.
    """
    device = check_device(device)
    tmpl = make_helmholtz_template(space, fs, dtype=dtype, device=device)
    kw = solve_kwargs or {}
    b = torch.as_tensor(b, dtype=dtype, device=device)
    observed = torch.as_tensor(observed, dtype=dtype, device=device)
    if obs_idx is not None:
        obs_idx = torch.as_tensor(obs_idx, dtype=torch.int64, device=device)
    a = torch.as_tensor(a0_nodal, dtype=dtype, device=device)
    hist = []
    for _ in range(steps):
        a = a.detach().requires_grad_()
        val = misfit(tmpl, omega, a, b, observed, obs_idx, **kw)
        (g,) = torch.autograd.grad(val, a)
        hist.append(val.detach())
        a = a.detach() - step_size * g
    return a, torch.stack(hist)
