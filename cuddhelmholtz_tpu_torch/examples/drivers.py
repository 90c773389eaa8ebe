"""The DDH example drivers.

Counterpart of ``run_config``, ``run_ddh``, ``point_sources``,
``wave_speed_coeff`` and ``DriverResult`` in
``cuddhelmholtz_tpu/examples/drivers.py``.  ``run_ddh`` runs the direct path
(every lambda-GMRES matvec is a full WaveHoltz cycle) or, with
``transfer=True``, the precomputed trace-transfer path.  The setup
functionals run on the host in float64; the solve runs on ``device``, the
card unless the caller asks for the CPU.
"""

from __future__ import annotations

import dataclasses
import math
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..mesh.io import load_unstructured_square
from ..mesh.mesh2d import Mesh2D
from ..models.helmholtz import helmholtz_rhs
from ..ops.functional import linear_functional
from ..ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from ..solvers.ddh import DDH, check_device
from ..spaces.ensemble import coordinate_bisection_labels
from ..spaces.h1 import H1Space
from ..utils.basis import Basis


def point_sources(xy: torch.Tensor, omega: float) -> torch.Tensor:
    """The reference's two-Gaussian forcing."""
    s = omega * omega
    x, y = xy[..., 0], xy[..., 1]
    r1 = (x + 0.5) ** 2 + y**2
    r2 = (x - 0.5) ** 2 + (y + 0.5) ** 2
    return s / math.pi * (torch.exp(-s * r1) + torch.exp(-s * r2))


def wave_speed_coeff(xy: torch.Tensor) -> torch.Tensor:
    """a(x) = 1/c(x): 0.2 inside the r = 0.25 disc, 1 outside."""
    r = xy[..., 0] ** 2 + xy[..., 1] ** 2
    return torch.where(r < 0.0625, r.new_tensor(0.2), r.new_tensor(1.0))


@dataclass
class DriverResult:
    solution: np.ndarray
    coords: np.ndarray
    res_norm: np.ndarray
    num_iter: int
    num_matvec: int
    seconds: float
    success: bool
    extra: dict = field(default_factory=dict)


def run_config(cfg, **overrides) -> DriverResult:
    """Run a ``ProblemConfig`` (``config.DDH_STRUCTURED``,
    ``config.DDH_UNSTRUCTURED_SQUARE`` or ``config.DDH_512_BLOCK32``).

    ``overrides`` replace config fields (``m``, ``maxit`` and ``tol`` go to
    the GMRES settings); ``device`` is passed on to ``run_ddh``.
    """
    device = overrides.pop("device", "cuda")
    gm = {k: overrides.pop(k) for k in ("m", "maxit", "tol") if k in overrides}
    if gm:
        overrides["gmres"] = dataclasses.replace(cfg.gmres, **gm)
    cfg = dataclasses.replace(cfg, **overrides)
    if cfg.kind != "ddh":
        raise NotImplementedError(
            f"config kind {cfg.kind!r}: only the DDH drivers are ported "
            "(ROADMAP queue 1, items 12-14)"
        )
    g = cfg.gmres
    kw = dict(nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
              wh_maxit=cfg.wh_maxit, transfer=cfg.transfer, device=device)
    if cfg.mesh == "unstructured_square":
        mesh = load_unstructured_square()
        labels, _ = coordinate_bisection_labels(mesh, cfg.n_domains or 8)
        return run_ddh(mesh=mesh, element_labels=labels, **kw)
    return run_ddh(block_size=cfg.block_size, **kw)


def run_ddh(
    nx: int = 128,
    deg: int = 3,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-4,
    mesh: Mesh2D | None = None,
    element_labels: np.ndarray | None = None,
    wh_maxit: int = 5,
    transfer: bool = False,
    block_size: int = 16,
    coarse: str | None = None,
    omega: float | None = None,
    *,
    device="cuda",
) -> DriverResult:
    """The DDH substructured-solver example.

    With the default structured mesh this is the reference configuration
    (16x16-DOF subdomains); pass ``mesh`` + ``element_labels`` for other
    partitions; ``omega`` replaces the default 2 pi nx / 10 (the
    ``large_unstructured`` example sets it from the mesh size).
    ``transfer=True`` precomputes the per-subdomain trace-transfer matrices
    (and on a GPU the rhs/postprocess io maps) in ``DDH.prepare``; the solve
    then runs no wave cycle.  ``seconds`` is the
    solve (rhs, lambda-GMRES, postprocess), synchronised on the device;
    ``extra["setup_seconds"]`` includes ``prepare``, whose stats are
    ``extra["precompute"]``.  ``extra["lam"]`` is the substructured solution
    and ``extra["ddh"]`` the operator.
    """
    if coarse:
        raise NotImplementedError(
            "coarse: the two-level coarse space is not ported yet (ROADMAP queue 1, item 15)"
        )
    device = check_device(device)
    if omega is None:
        omega = 2 * np.pi * nx / 10
    if mesh is None:
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))

    # nodal interpolation of the coefficient, and the forcing (host, float64)
    b_a = linear_functional(fem, wave_speed_coeff)
    a_nodal = apply_diag_inv_mass(make_diag_inv_mass_op(fem), b_a).numpy()
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega)).to(device)

    t_setup = time.perf_counter()
    if element_labels is None:
        ddh = DDH(
            omega, a_nodal, fem, nx=nx, ny=nx, wh_maxit=wh_maxit, block_size=block_size,
            device=device,
        )
    else:
        ddh = DDH(omega, a_nodal, fem, element_labels=element_labels, wh_maxit=wh_maxit,
                  device=device)
    pstats = {}
    if transfer:
        # the io maps pay off where the probe cycles are cheap: on the card
        pstats = ddh.prepare(want_io=device.type == "cuda")
    setup_s = time.perf_counter() - t_setup

    solve = ddh.solver(m, maxit, tol)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    out, U = solve(b)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    return DriverResult(
        solution=U.cpu().numpy(),
        coords=fem.coords,
        res_norm=out.res_norm[: out.n_hist].cpu().numpy(),
        num_iter=out.num_iter,
        num_matvec=out.num_matvec,
        seconds=dt,
        success=out.success,
        extra={
            "omega": omega,
            "ndof": fem.ndof,
            "n_lambda": ddh.size,
            "n_domains": ddh.n_domains,
            "nt": ddh.nt,
            "setup_seconds": setup_s,
            "precompute": pstats,
            "ddh": ddh,
            "lam": out.x,
        },
    )
