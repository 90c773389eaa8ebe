"""The example drivers.

Counterpart of ``run_config``, ``run_poisson``, ``run_helmholtz``,
``run_ddh``, ``run_ddh_multi_source``, ``run_helmholtz_ddh``,
``_make_matvec32``, ``write_history``, ``point_sources``,
``wave_speed_coeff``, ``DriverResult`` and the CLI ``main`` in
``cuddhelmholtz_tpu/examples/drivers.py``.  ``run_ddh`` runs the direct path
(every lambda-GMRES matvec is a full WaveHoltz cycle) or, with
``transfer=True``, the precomputed trace-transfer path;
``run_ddh_multi_source`` solves K ring sources in one batched solve (block
GMRES or lock-step GMRES); ``run_helmholtz_ddh`` solves the coupled
Helmholtz system to 1e-6 with FGMRES right-preconditioned by one bounded DDH
solve per step.  The setup (functionals, coefficient projection) runs on the
host in float64; the solves run on ``device``, the card unless the caller
asks for the CPU.

    python -m cuddhelmholtz_tpu_torch.examples.drivers <config> [field=value ...]

runs a named config of ``config.BASELINE_CONFIGS`` on the card and prints
one JSON record.
"""

from __future__ import annotations

import dataclasses
import math
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch

from ..mesh.io import load_unstructured_square, to_file
from ..mesh.mesh2d import Mesh2D
from ..models.helmholtz import (
    apply_helmholtz,
    helmholtz_rhs,
    make_helmholtz_op,
    project_coefficients,
)
from ..models.poisson import solve_poisson
from ..ops.functional import linear_functional
from ..ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from ..ops.structured import GridH1Space
from ..solvers.ddh import DDH, DDHPreconditioner, _sync, check_device
from ..solvers.gmres import fgmres, gmres, gmres_host
from ..spaces.ensemble import coordinate_bisection_labels
from ..spaces.h1 import FaceSpace, H1Space
from ..utils.basis import Basis


def write_history(path: str, res_norm, times=None) -> None:
    """Write the per-restart residual history in the reference's text format
    (``res_norm time`` per line, scientific notation).  Without per-restart
    clock ``times`` the column is ``nan``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as fout:
        for i, r in enumerate(np.asarray(res_norm)):
            t = times[i] if times is not None and i < len(times) else float("nan")
            fout.write(f"{r:.10e} {t:.10e}\n")


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
    """Run a ``ProblemConfig`` (one of the entries of ``config``).

    ``overrides`` replace config fields (``m``, ``maxit`` and ``tol`` go to
    the GMRES settings); ``device`` and ``measure_warm`` are passed on to the
    driver.
    """
    device = overrides.pop("device", "cuda")
    # driver-level (non-config) arguments for the kinds that take them
    fwd = {k: overrides.pop(k) for k in ("measure_warm",) if k in overrides}
    gm = {k: overrides.pop(k) for k in ("m", "maxit", "tol") if k in overrides}
    if gm:
        overrides["gmres"] = dataclasses.replace(cfg.gmres, **gm)
    cfg = dataclasses.replace(cfg, **overrides)
    g = cfg.gmres
    mesh = load_unstructured_square() if cfg.mesh == "unstructured_square" else None
    if cfg.kind == "poisson":
        return run_poisson(nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
                           device=device)
    if cfg.kind == "helmholtz":
        return run_helmholtz(nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
                             dtype=torch.float32, mesh=mesh, device=device)
    if cfg.kind == "helmholtz_ddh":
        return run_helmholtz_ddh(
            nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol, wh_maxit=cfg.wh_maxit,
            transfer=cfg.transfer, mesh=mesh, n_domains=cfg.n_domains, device=device, **fwd,
        )
    if cfg.kind == "ddh_multi":
        return run_ddh_multi_source(
            nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol, n_sources=cfg.n_sources,
            transfer=cfg.transfer, device=device, **fwd,
        )
    if cfg.kind != "ddh":
        raise ValueError(f"unknown config kind: {cfg.kind}")
    kw = dict(nx=cfg.nx, deg=cfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
              wh_maxit=cfg.wh_maxit, transfer=cfg.transfer, device=device, **fwd)
    if mesh is not None:
        labels, _ = coordinate_bisection_labels(mesh, cfg.n_domains or 8)
        return run_ddh(mesh=mesh, element_labels=labels, **kw)
    return run_ddh(block_size=cfg.block_size, coarse=cfg.coarse, **kw)


def run_poisson(
    nx: int = 15,
    deg: int = 3,
    m: int = 20,
    maxit: int = 20,
    tol: float = 1e-6,
    dtype=torch.float64,
    out_dir: str | None = None,
    *,
    device="cuda",
) -> DriverResult:
    """The Poisson example: -lap u = 1 on [-1, 1]^2 with u = 1 - y^2 on
    x = 1, y (1 - y^2) on x = -1 and 0 elsewhere on the boundary.
    ``seconds`` covers the whole solve, boundary projection included."""
    device = check_device(device)
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)

    def f(xy):
        return torch.ones(xy.shape[:-1], dtype=xy.dtype)

    def g(xy):
        x, y = xy[..., 0], xy[..., 1]
        right = (x - 1.0).abs() < 1e-12
        left = (x + 1.0).abs() < 1e-12
        return torch.where(right, 1.0 - y * y,
                           torch.where(left, y * (1.0 - y * y), torch.zeros_like(y)))

    _sync(device)
    t0 = time.perf_counter()
    u, out = solve_poisson(fem, fs, f, g, m=m, maxit=maxit, tol=tol, dtype=dtype, device=device)
    _sync(device)
    dt = time.perf_counter() - t0
    u = u.cpu().numpy()
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        to_file(f"{out_dir}/poisson.0000", u)
    return DriverResult(
        solution=u,
        coords=fem.coords,
        res_norm=out.res_norm[: out.n_hist].cpu().numpy(),
        num_iter=out.num_iter,
        num_matvec=out.num_matvec,
        seconds=dt,
        success=out.success,
    )


def run_helmholtz(
    nx: int = 128,
    deg: int = 3,
    m: int = 200,
    maxit: int = 10_000,
    tol: float = 1e-6,
    dtype=torch.float64,
    mesh: Mesh2D | None = None,
    out_dir: str | None = None,
    max_seconds: float | None = None,
    verbose: int = 0,
    *,
    device="cuda",
) -> DriverResult:
    """The unpreconditioned coupled-Helmholtz example: GMRES(m) on the
    coupled operator (on the default structured mesh a ``GridH1Space`` with
    the kron fast path).  Setting ``max_seconds`` (a wall-clock bound on the
    solve, checked between restarts) or ``verbose`` switches to the
    host-loop solver ``gmres_host``, whose per-restart wall times go to the
    history file and to ``extra["times"]`` (None otherwise)."""
    device = check_device(device)
    omega = 2 * np.pi * nx / 10
    grid = None
    if mesh is None:
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        fem = GridH1Space(mesh, Basis(deg + 1), nx, nx)
        grid = (nx, nx)
    else:
        fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)
    a2, af = project_coefficients(fem, fs, wave_speed_coeff, dtype=dtype)
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega), dtype=dtype).to(device)
    op = make_helmholtz_op(omega, a2, af, fem, fs, dtype=dtype, device=device)

    def matvec(U):
        return apply_helmholtz(op, U, grid=grid)

    times = None
    _sync(device)
    t0 = time.perf_counter()
    if max_seconds is not None or verbose:
        out, times = gmres_host(matvec, b, m=m, maxit=maxit, tol=tol, verbose=verbose,
                                max_seconds=6 * 3600 if max_seconds is None else max_seconds)
    else:
        out = gmres(matvec, b, m=m, maxit=maxit, tol=tol)
    _sync(device)
    dt = time.perf_counter() - t0
    U = out.x.cpu().numpy()
    res_norm = out.res_norm[: out.n_hist].cpu().numpy()
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        to_file(f"{out_dir}/helmholtz.0000", U)
        write_history(f"{out_dir}/h_{nx}_{deg}.txt", res_norm, times)
    return DriverResult(
        solution=U,
        coords=fem.coords,
        res_norm=res_norm,
        num_iter=out.num_iter,
        num_matvec=out.num_matvec,
        seconds=dt,
        success=out.success,
        extra={"omega": omega, "ndof": fem.ndof, "times": times},
    )


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
    out_dir: str | None = None,
    measure_warm: bool = False,
    coarse_n_dir: int = 4,
    coarse_domains_per_super: int = 16,
    coarse_method: str = "direct",
    coarse_solve: tuple = (20, 2, 3e-2),
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
    and ``extra["ddh"]`` the operator.  ``measure_warm`` solves once more on
    the prepared operator and records its time (``extra["warm_seconds"]``;
    the results are the first solve's).  ``out_dir`` receives the
    coordinates, the solution and the residual history in the reference's
    formats.

    ``coarse="additive"`` or ``"multiplicative"`` (needs ``transfer``) adds
    the two-level plane-wave coarse correction (``DDH.make_coarse`` with
    ``coarse_n_dir``, ``coarse_domains_per_super``, ``coarse_method`` and
    the iterative coarse solve's (m, maxit, tol) ``coarse_solve``; FGMRES
    on the lambda system); ``extra["coarse"]`` names the mode and
    ``extra["coarse_seconds"]`` is the build time, part of
    ``setup_seconds``.
    """
    if coarse and not transfer:
        raise ValueError("coarse correction requires transfer=True")
    device = check_device(device)
    if omega is None:
        omega = 2 * np.pi * nx / 10
    if mesh is None:
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))

    # nodal interpolation of the coefficient, and the forcing (host, float64)
    b_a = linear_functional(fem, wave_speed_coeff)
    a_nodal = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"), b_a).numpy()
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
    coarse_info = {}
    if coarse:
        sm, smx, stl = coarse_solve
        t0 = time.perf_counter()
        ddh.make_coarse(n_dir=coarse_n_dir, domains_per_super=coarse_domains_per_super,
                        method=coarse_method, solve_m=sm, solve_maxit=smx, solve_tol=stl)
        _sync(device)
        coarse_info = {"coarse": coarse, "coarse_seconds": time.perf_counter() - t0}
    setup_s = time.perf_counter() - t_setup

    solve = ddh.solver(m, maxit, tol, coarse=coarse)
    out, U, dt = _timed_solve(solve, b, device)
    warm = {}
    if measure_warm:
        warm["warm_seconds"] = _timed_solve(solve, b, device)[2]
    U = U.cpu().numpy()
    res_norm = out.res_norm[: out.n_hist].cpu().numpy()
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        to_file(f"{out_dir}/ddh.0000", U)
        write_history(f"{out_dir}/ddh_{nx}_{deg}.txt", res_norm)
    return DriverResult(
        solution=U,
        coords=fem.coords,
        res_norm=res_norm,
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
            **coarse_info,
            **warm,
        },
    )


def _timed_solve(solve, b: torch.Tensor, device: torch.device):
    """(GMRES result, solution, seconds) of ``solve(b)``, synchronised on
    the device."""
    _sync(device)
    t0 = time.perf_counter()
    out, U = solve(b)
    _sync(device)
    return out, U, time.perf_counter() - t0


def ring_sources(fem, omega: float, n_sources: int, radius: float = 0.5) -> torch.Tensor:
    """(n_sources, 2 ndof) float64 forcings: Gaussians of width 1/omega
    centred at n_sources equally spaced points of the circle of ``radius``."""
    s = omega * omega
    th = 2 * np.pi * np.arange(n_sources) / n_sources
    centers = radius * np.stack([np.cos(th), np.sin(th)], axis=1)

    def source(cx, cy):
        def f(xy):
            r = (xy[..., 0] - cx) ** 2 + (xy[..., 1] - cy) ** 2
            return s / math.pi * torch.exp(-s * r)

        return helmholtz_rhs(fem, f)

    return torch.stack([source(cx, cy) for cx, cy in centers])


def run_ddh_multi_source(
    nx: int = 128,
    deg: int = 3,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-4,
    n_sources: int = 8,
    source_radius: float = 0.5,
    transfer: bool = True,
    shard_sources: bool = False,
    out_dir: str | None = None,
    measure_warm: bool = False,
    method: str = "block",
    gmres_opts: dict | None = None,
    *,
    device="cuda",
) -> DriverResult:
    """Solve the DDH example for ``n_sources`` right-hand sides (Gaussians on
    a ring of ``source_radius``) in one batched substructured solve.

    ``method="block"`` (the default, with ``gmres_opts={"reorth": False}``)
    runs ``block_gmres``: one shared block-Krylov space of m K directions
    per restart.  ``method="vmap"`` runs ``gmres_lockstep``: each source its
    own GMRES(m), as a solo solve, to the slowest source's restart count.
    Either way every rhs, matvec and postprocess is one apply over the K
    ndom subdomain rows: one batched transfer product on the transfer path,
    one wave-cycle launch on the direct path (``transfer=False``).

    ``shard_sources=True`` splits the source axis over the ranks of the
    ``torch.distributed`` default group (one rank per device; one rank when
    it is not initialised): the largest divisor of K that fits the world
    size is the number of shards, rank r < n_shard solves sources [r K /
    n_shard, (r + 1) K / n_shard) on its own device, and every rank gathers
    all the results.  Each source's own space (``method="vmap"``) gives
    every source the solution and counts of the replicated solve; a block
    space spans its shard's sources.

    The top-level ``res_norm``, ``num_iter`` and ``num_matvec`` describe
    source 0; ``success`` holds when every source converged.  ``extra`` has
    the per-source counts and histories, ``lam`` (K, 2 n_lambda), ``n_shard``
    and, with ``measure_warm``, the time of a second solve
    (``warm_seconds``).
    """
    if method not in ("block", "vmap"):
        raise ValueError("method must be 'block' or 'vmap'")
    device = check_device(device)
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))
    b_a = linear_functional(fem, wave_speed_coeff)
    a_nodal = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"), b_a).numpy()
    bs = ring_sources(fem, omega, n_sources, source_radius).to(device)
    n_shard, rank = 1, 0
    if shard_sources:
        n_shard, rank = _source_shards(n_sources)
        per = n_sources // n_shard
        # ranks past the last shard solve nothing and only gather
        bs = bs[rank * per:(rank + 1) * per]

    t_setup = time.perf_counter()
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, device=device)
    pstats = {}
    if transfer:
        pstats = ddh.prepare(want_io=device.type == "cuda")
    setup_s = time.perf_counter() - t_setup

    if gmres_opts is None and method == "block":
        # single-pass CGS: each new block is orthonormalised by the block QR
        gmres_opts = {"reorth": False}
    solve = ddh.solver(m, maxit, tol, gmres_opts=gmres_opts, block=method == "block",
                       vmapped=method == "vmap")
    mine = {"lam": torch.zeros(0, ddh.size, device=device), "hists": [], "restarts": [],
            "matvecs": [], "success": True}
    Us = torch.zeros(0, 2 * fem.ndof, device=device)
    dt, warm = 0.0, {}
    if bs.shape[0]:
        outs, Us, dt = _timed_solve(solve, bs, device)
        if measure_warm:
            warm["warm_seconds"] = _timed_solve(solve, bs, device)[2]
        k_here = bs.shape[0]
        if method == "block":
            # one shared space: one restart count, K matvecs per block operator call
            hists = [outs.res_norm[: outs.n_hist, k].cpu().numpy() for k in range(k_here)]
            restarts = [outs.num_iter] * k_here
            matvecs = [outs.num_matvec // k_here] * k_here
        else:
            n_hist = outs.n_hist.tolist()
            hists = [outs.res_norm[k, : n_hist[k]].cpu().numpy() for k in range(k_here)]
            restarts = outs.num_iter.tolist()
            matvecs = outs.num_matvec.tolist()
        mine = {"lam": outs.x, "hists": hists, "restarts": restarts, "matvecs": matvecs,
                "success": bool(outs.success.all())}
    mine["solution"] = Us.cpu().numpy()
    mine["lam"] = mine["lam"].cpu().numpy()
    parts = [mine]
    if shard_sources and torch.distributed.is_initialized():
        parts = [None] * torch.distributed.get_world_size()
        torch.distributed.all_gather_object(parts, mine)
        parts = parts[:n_shard]
    Us = np.concatenate([q["solution"] for q in parts])
    hists = [h for q in parts for h in q["hists"]]
    per_restarts = [r for q in parts for r in q["restarts"]]
    per_matvecs = [v for q in parts for v in q["matvecs"]]
    lam = torch.as_tensor(np.concatenate([q["lam"] for q in parts]), device=device)
    success = all(q["success"] for q in parts)
    if out_dir:
        to_file(f"{out_dir}/xy.0000", fem.coords.T)
        for k in range(n_sources):
            to_file(f"{out_dir}/ddh_src{k:02d}.0000", Us[k])
            write_history(f"{out_dir}/ddh_src{k:02d}_{nx}_{deg}.txt", hists[k])
    return DriverResult(
        solution=Us,
        coords=fem.coords,
        res_norm=hists[0],
        num_iter=per_restarts[0],
        num_matvec=per_matvecs[0],
        seconds=dt,
        success=success,
        extra={
            "omega": omega,
            "ndof": fem.ndof,
            "n_sources": n_sources,
            "n_shard": n_shard,
            "method": method,
            "per_source_matvecs": per_matvecs,
            "per_source_restarts": per_restarts,
            "max_matvecs": int(np.max(per_matvecs)),
            "histories": hists,
            "n_lambda": ddh.size,
            "n_domains": ddh.n_domains,
            "setup_seconds": setup_s,
            "precompute": pstats,
            "ddh": ddh,
            "lam": lam,
            "rhs": bs,
            **warm,
        },
    )


def _source_shards(n_sources: int) -> tuple[int, int]:
    """(number of source shards, this rank): the largest divisor of
    ``n_sources`` that fits the world size of the ``torch.distributed``
    default group (1 and rank 0 when it is not initialised)."""
    dist = torch.distributed
    if not (dist.is_available() and dist.is_initialized()):
        return 1, 0
    world = dist.get_world_size()
    n_shard = max(d for d in range(1, min(n_sources, world) + 1) if n_sources % d == 0)
    return n_shard, dist.get_rank()


# inner lambda-GMRES options of the preconditioner: single-pass CGS (the
# refinement's fp64 true residual catches any inner sloppiness)
_FAST_INNER = {"reorth": False}


def _make_matvec32(omega, a2, af, fem, fs, mesh, nx=None, *, device="cuda"):
    """fp32 coupled-Helmholtz matvec for the refinement's inner solves.

    With ``nx`` the operator is rebuilt on a ``GridH1Space`` so the kron
    fast path applies, with gather permutations between ``fem``'s H1
    numbering and the grid numbering; without, the generic operator on
    ``fem``.
    """
    a2_32 = np.asarray(a2, np.float32)
    af_32 = np.asarray(af, np.float32)
    if nx is None:
        op32 = make_helmholtz_op(omega, a2_32, af_32, fem, fs, dtype=torch.float32,
                                 device=device)
        return lambda U: apply_helmholtz(op32, U)

    gfem = GridH1Space(mesh, fem.basis, nx, nx)
    # numbering permutations through the shared (el, iy, ix) node tables
    g2h = np.zeros(gfem.ndof, np.int64)  # grid dof -> h1 dof (same node)
    g2h[gfem.dofs.reshape(-1)] = fem.dofs.reshape(-1)
    h2g = np.zeros(fem.ndof, np.int64)
    h2g[fem.dofs.reshape(-1)] = gfem.dofs.reshape(-1)
    fs_g = FaceSpace(gfem, mesh.boundary_edges)
    # face coefficient remap: match face DOFs by their global node
    inv_fs = np.zeros(fem.ndof, np.int64)
    inv_fs[fs.proj] = np.arange(len(fs.proj))
    af_g = af_32[inv_fs[g2h[fs_g.proj]]]
    op32 = make_helmholtz_op(omega, a2_32[g2h], af_g, gfem, fs_g, dtype=torch.float32,
                             device=device)
    g2h_t = torch.as_tensor(g2h, device=device)
    h2g_t = torch.as_tensor(h2g, device=device)
    n = fem.ndof

    def matvec32(U):
        Yg = apply_helmholtz(op32, torch.cat([U[:n][g2h_t], U[n:][g2h_t]]))
        return torch.cat([Yg[:n][h2g_t], Yg[n:][h2g_t]])

    return matvec32


def run_helmholtz_ddh(
    nx: int = 128,
    deg: int = 3,
    m: int = 20,
    maxit: int = 100,
    tol: float = 1e-6,
    inner_m: int = 20,
    inner_maxit: int = 3,
    inner_gmres_opts: dict | None = _FAST_INNER,
    wh_maxit: int = 5,
    transfer: bool = True,
    dtype=torch.float64,
    mesh: Mesh2D | None = None,
    element_labels: np.ndarray | None = None,
    n_domains: int | None = None,
    out_dir: str | None = None,
    refine: bool = True,
    max_refine: int = 6,
    measure_warm: bool = True,
    omega: float | None = None,
    *,
    device="cuda",
) -> DriverResult:
    """Solve the coupled Helmholtz system to ``tol`` with FGMRES
    right-preconditioned by the DDH substructured solver.

    Each outer step applies P: the DDH rhs, one bounded fp32 lambda-GMRES
    (``inner_m``, ``inner_maxit`` restarts, tol 0: no early exit) and the
    DDH postprocess.  ``refine=True`` (float64 ``dtype``) is mixed-precision
    iterative refinement: each step solves A dx = r with fp32 deferred
    FGMRES to a loose tolerance ``min(0.5, max(2e-5, 0.3 tol ||b|| / ||r||))``,
    corrects x in fp64 and recomputes the true residual with the fp64
    operator; it stops at ``tol``, after ``max_refine`` steps, or when a step
    leaves more than 0.9 of the residual (``extra["stagnated"]`` then says
    whether the target was missed).  ``res_norm`` is the true fp64 residual
    per refinement step; ``num_iter`` and ``num_matvec`` sum the inner
    FGMRES counts (plus the fp64 residual per step).  ``refine=False`` runs
    one standard FGMRES in ``dtype``.

    The default structured mesh runs the whole pipeline (DDH, coefficients,
    both operators, kron fast path) on the grid numbering and renumbers the
    solution to the H1 numbering at the end.  Pass ``mesh`` (and optionally
    ``element_labels``, else coordinate bisection into ``n_domains``) for
    another quad mesh.  ``transfer`` precomputes the DDH transfer and
    rhs/postprocess maps in ``prepare`` (as the JAX package does under
    ``CUDDH_IO_MAPS``); P then runs no wave cycle.  ``measure_warm`` runs the
    solve again on the same b (``extra["warm_seconds"]``; the results are the
    second run's, the first run's counts and history are
    ``extra["first_run"]``).
    ``extra["precond"]`` is P and ``extra["n_precond"]`` its applications in
    the last run.
    """
    device = check_device(device)
    if omega is None:
        omega = 2 * np.pi * nx / 10
    structured = mesh is None
    if structured:
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        fem = GridH1Space(mesh, Basis(deg + 1), nx, nx)
    else:
        if element_labels is None:
            element_labels, n_domains = coordinate_bisection_labels(
                mesh, n_domains or max(4, mesh.n_elem // 16))
        fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)

    # host setup, float64
    a2, af = project_coefficients(fem, fs, wave_speed_coeff, dtype=dtype)
    b_a = linear_functional(fem, wave_speed_coeff)
    a_nodal = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"), b_a).numpy()
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega), dtype=dtype).to(device)
    op = make_helmholtz_op(omega, a2, af, fem, fs, dtype=dtype, device=device)

    t_setup = time.perf_counter()
    if structured:
        ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, wh_maxit=wh_maxit, device=device)
    else:
        ddh = DDH(omega, a_nodal, fem, element_labels=element_labels, n_domains=n_domains,
                  wh_maxit=wh_maxit, device=device)
    pstats = {}
    if transfer:
        pstats = ddh.prepare(want_io=True)
    _sync(device)
    setup_s = time.perf_counter() - t_setup

    P = DDHPreconditioner(ddh, inner_m, inner_maxit, inner_gmres_opts)

    use_refine = refine and dtype == torch.float64
    extra = {"omega": omega, "ndof": fem.ndof, "setup_seconds": setup_s,
             "precompute": pstats, "refine": use_refine, "ddh": ddh, "precond": P}

    if use_refine:
        # on the structured mesh fem is grid-numbered, so the kron path
        # applies with no permutation
        matvec32 = _make_matvec32(omega, a2, af, fem, fs, mesh, device=device)

        def solve_once(bv):
            x = torch.zeros(2 * fem.ndof, dtype=torch.float64, device=device)
            bnrm = float(torch.linalg.vector_norm(bv))
            r, rn = bv, bnrm
            outer_hist, inner_hists, tols = [rn], [], []
            iters = mvs = steps = 0
            stagnated = False
            while rn > tol * bnrm and steps < max_refine:
                # contract toward the target with 0.3 safety, but never deeper
                # than 2e-5 per inner solve (the fp32 representation floor)
                tl = min(0.5, max(2e-5, 0.3 * tol * bnrm / rn))
                out = fgmres(matvec32, r.to(torch.float32), P, m=m, maxit=maxit, tol=tl,
                             deferred=True)
                x = x + out.x.to(torch.float64)
                r = bv - apply_helmholtz(op, x)
                rn_new = float(torch.linalg.vector_norm(r))
                outer_hist.append(rn_new)
                inner_hists.append(out.res_norm[: out.n_hist].cpu().numpy())
                tols.append(tl)
                iters += out.num_iter
                mvs += out.num_matvec + 1
                steps += 1
                if rn_new >= 0.9 * rn:  # stagnation guard
                    rn = rn_new
                    stagnated = rn > tol * bnrm
                    break
                rn = rn_new
            return x, outer_hist, inner_hists, tols, iters, mvs, steps, rn <= tol * bnrm, stagnated

        def run():
            P.calls = 0
            _sync(device)
            t0 = time.perf_counter()
            res = solve_once(b)
            _sync(device)
            return res, time.perf_counter() - t0

        (x, outer_hist, inner_hists, tols, iters, mvs, steps, ok, stag), dt = run()
        if measure_warm:
            extra["first_run"] = {"num_iter": iters, "num_matvec": mvs, "res_norm": outer_hist}
            (x, outer_hist, inner_hists, tols, iters, mvs, steps, ok, stag), extra[
                "warm_seconds"] = run()
        U = x.cpu().numpy()
        res_hist = np.asarray(outer_hist)
        extra.update(refine_steps=steps, stagnated=stag, inner_tols=tols,
                     inner_histories=[h.tolist() for h in inner_hists])
        num_iter, num_matvec, success = iters, mvs, ok
    else:
        def run():
            P.calls = 0
            _sync(device)
            t0 = time.perf_counter()
            out = fgmres(lambda U: apply_helmholtz(op, U), b, P, m=m, maxit=maxit, tol=tol)
            _sync(device)
            return out, time.perf_counter() - t0

        out, dt = run()
        if measure_warm:
            extra["first_run"] = {"num_iter": out.num_iter, "num_matvec": out.num_matvec,
                                  "res_norm": out.res_norm[: out.n_hist].tolist()}
            out, extra["warm_seconds"] = run()
        U = out.x.cpu().numpy()
        res_hist = out.res_norm[: out.n_hist].cpu().numpy()
        num_iter, num_matvec, success = out.num_iter, out.num_matvec, out.success
    extra["n_precond"] = P.calls

    coords_out = fem.coords
    if structured:
        # renumber grid -> H1 ordering once (the solve ran grid-native)
        fem_ref = H1Space(mesh, Basis(deg + 1))
        r2g = np.zeros(fem.ndof, np.int64)
        r2g[fem_ref.dofs.reshape(-1)] = fem.dofs.reshape(-1)
        nd = fem.ndof
        U = np.concatenate([U[:nd][r2g], U[nd:][r2g]])
        coords_out = fem_ref.coords
    if out_dir:
        to_file(f"{out_dir}/xy.0000", np.asarray(coords_out).T)
        to_file(f"{out_dir}/helmholtz_ddh.0000", U)
        write_history(f"{out_dir}/hddh_{nx}_{deg}.txt", res_hist)
    return DriverResult(
        solution=U,
        coords=coords_out,
        res_norm=res_hist,
        num_iter=num_iter,
        num_matvec=num_matvec,
        seconds=dt,
        success=success,
        extra=extra,
    )


def cli_record(name: str, res: DriverResult) -> dict:
    """The CLI's JSON record of one run (the JAX package's keys); the
    optional keys appear when the driver records them."""
    rec = {
        "config": name,
        "success": bool(res.success),
        "iters": int(res.num_iter),
        "matvecs": int(res.num_matvec),
        "seconds": res.seconds,
        "final_rel_res": float(res.res_norm[-1] / res.res_norm[0]),
    }
    for k in ("warm_seconds", "compile_seconds", "refine_steps", "stagnated", "setup_seconds"):
        if k in res.extra:
            rec[k] = res.extra[k]
    return rec


def main(argv=None, *, device="cuda") -> int:
    """CLI: run a named config of ``config.BASELINE_CONFIGS`` and print one
    JSON record (the JAX package's keys).

    python -m cuddhelmholtz_tpu_torch.examples.drivers <name> [field=value ...]
    """
    import json
    import sys

    from ..config import BASELINE_CONFIGS

    argv = sys.argv[1:] if argv is None else argv
    by_name = {c.name: c for c in BASELINE_CONFIGS}
    if not argv or argv[0] not in by_name:
        print(f"usage: drivers <{'|'.join(by_name)}> [nx=..] [m=..] [maxit=..] [tol=..]")
        return 1
    cfg = by_name[argv[0]]
    overrides = {}
    for kv in argv[1:]:
        k, v = kv.split("=", 1)
        overrides[k] = float(v) if k == "tol" else int(v)
    print(json.dumps(cli_record(cfg.name, run_config(cfg, device=device, **overrides))))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
