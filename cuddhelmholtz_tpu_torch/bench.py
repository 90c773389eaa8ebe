"""The port's benchmark: the flagship DDH solve and every named config.

Counterpart of the repository's root ``bench.py``, which drives the JAX
package.  Run on the card as

    python -m cuddhelmholtz_tpu_torch.bench

It prints diagnostics to stderr and one JSON line to stdout, with the JAX
bench's keys:

  * the headline: the flagship (nx 128, deg 3, omega = 2 pi 12.8) on the
    transfer/io path, lambda-GMRES(20) to 1e-4 in the deferred mode with
    single-pass CGS; the second solve, on a perturbed rhs, is timed.
    ``value`` is stencil-equivalent operator throughput: (stiffness applies
    the solve stands for) * sum of subdomain DOFs * (2 n_basis - 1)^2 /
    seconds;
  * the kron stiffness apply, in a chain of 50;
  * the executed wave-cycle action: the direct path's matvec, one launch
    of the WaveHoltz kernel at the flagship shape;
  * ``extras.baseline_configs``: one row per config of
    ``config.BASELINE_CONFIGS`` through ``run_config``, in this process
    (``helmholtz_unpreconditioned`` at maxit 10);
  * ``extras.scaling``: the weak-scaling protocol of
    ``examples/scaling.py::capture_scaling`` (the sharded transfer-path
    matvec at every world size the visible cards give, NCCL; gloo ranks on
    the CPU), each record with its backend and world size;
  * ``extras.device``: ``nvidia-smi``'s name and power limit of the card.

``BENCH_SKIP_CONFIGS`` skips the config rows, ``BENCH_SKIP_SCALING`` the
scaling records, ``BENCH_NO_TRANSFER`` runs the headline on the direct
path.  A row (or the scaling run) that raises records its error, and the
bench exits non-zero after printing.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

from .config import BASELINE_CONFIGS
from .examples.drivers import (
    _timed_solve,
    cli_record,
    point_sources,
    run_config,
    wave_speed_coeff,
)
from .mesh.mesh2d import Mesh2D
from .models.helmholtz import helmholtz_rhs
from .ops.functional import linear_functional
from .ops.kron import apply_stiffness_kron, make_kron_stiffness_op
from .ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from .ops.structured import GridH1Space
from .solvers.ddh import DDH, _sync, check_device
from .spaces.h1 import H1Space
from .utils.basis import Basis

# the headline's lambda-GMRES: deferred least squares, single-pass CGS
HEADLINE_GMRES = {"deferred": True, "reorth": False}
# relative perturbation of the timed solve's rhs
PERTURB = 1e-6


def log(*a) -> None:
    print(*a, file=sys.stderr, flush=True)


def card(device: torch.device) -> str | None:
    """``nvidia-smi``'s "name, power limit" of the first card; None on the
    CPU.  On the card a failing ``nvidia-smi`` raises."""
    if device.type != "cuda":
        return None
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]


def _ms_loop(fn, n: int, device) -> float:
    """Milliseconds per call of ``fn`` over ``n`` calls after one warm-up,
    synchronised on the device."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    _sync(device)
    return 1e3 * (time.perf_counter() - t0) / n


def _config_rows(device, secs: float) -> dict:
    """One row per named config, in the JAX bench's order.  A row that
    raises holds its error."""
    by_name = {c.name: c for c in BASELINE_CONFIGS}
    rows: dict = {}

    def run(name, note=None, **kw):
        t0 = time.perf_counter()
        try:
            r = run_config(by_name[name], device=device, **kw)
        except Exception as e:  # recorded in the row; the bench then exits non-zero
            rows[name] = {"error": repr(e)[:200]}
            log(f"{name} FAILED: {e!r}")
            return None
        total = time.perf_counter() - t0
        rows[name] = {
            "success": bool(r.success),
            "restarts": int(r.num_iter),
            "matvecs": int(r.num_matvec),
            "solve_seconds": r.seconds,
            "total_seconds": total,
            "final_rel_res": float(r.res_norm[-1] / r.res_norm[0]),
        }
        for k in ("warm_seconds", "compile_seconds", "stagnated"):
            if k in r.extra:
                rows[name][k] = r.extra[k]
        if note:
            rows[name]["note"] = note
        return r, total

    run("ddh_unstructured_square", measure_warm=True)
    run("ddh_structured", measure_warm=True)
    run("ddh_high_frequency", measure_warm=True)
    run("ddh_512_block32", measure_warm=True)
    run("helmholtz_unpreconditioned", maxit=10,
        note="reduced budget maxit=10; records the stagnation level")
    got = run("ddh_multi_source_8", measure_warm=True)
    if got is not None:
        r, total = got
        k = int(r.extra["n_sources"])
        wsec = r.extra["warm_seconds"]
        rows["ddh_multi_source_8"] = {
            "success": bool(r.success),
            "method": r.extra["method"],
            "restarts": int(r.num_iter),
            "n_sources": k,
            "solve_seconds": r.seconds,
            "warm_seconds": wsec,
            "total_seconds": total,
            "sources_per_s": k / wsec,
            "per_source_matvecs": r.extra["per_source_matvecs"],
            # against K of the headline's timed single-source solves
            "speedup_vs_sequential": k * secs / wsec,
        }
    # the JAX bench runs these in fp64 subprocesses (x64 is a global JAX
    # flag); here they run in this process, as the CLI's records
    for name in ("poisson_structured", "helmholtz_ddh_1e6", "helmholtz_ddh_unstructured_1e6"):
        t0 = time.perf_counter()
        try:
            rec = cli_record(name, run_config(by_name[name], device=device))
        except Exception as e:  # recorded in the row; the bench then exits non-zero
            rows[name] = {"error": repr(e)[:200]}
            log(f"{name} FAILED: {e!r}")
            continue
        rows[name] = {**rec, "total_seconds": time.perf_counter() - t0}
    for name, row in rows.items():
        log(f"{name}: {row}")
    return rows


def run_bench(device="cuda", nx: int = 128, skip_configs: bool = False,
              no_transfer: bool = False, skip_scaling: bool = False) -> dict:
    """Run the bench and return its record (the JSON line's object).
    ``nx`` sizes the headline (the config rows keep their own sizes)."""
    device = check_device(device)
    deg = 3
    m, maxit, tol = 20, 100, 1e-4
    omega = 2 * np.pi * nx / 10
    name_power = card(device)
    log(f"device={device} torch {torch.__version__} card={name_power}")

    t0 = time.perf_counter()
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))
    b_a = linear_functional(fem, wave_speed_coeff, dtype=torch.float32)
    mi = make_diag_inv_mass_op(fem, dtype=torch.float32, device="cpu")
    a_nodal = apply_diag_inv_mass(mi, b_a).numpy().astype(np.float64)
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, device=device)
    setup_seconds = time.perf_counter() - t0
    log(f"setup {setup_seconds:.2f} s: ndof={fem.ndof} ndom={ddh.n_domains} "
        f"n_lambda={ddh.size} nt={ddh.nt} pad={ddh.pad} shared_S={ddh.shared_S}")

    pstats: dict = {}
    if not no_transfer:
        t0 = time.perf_counter()
        pstats = ddh.prepare(want_io=device.type == "cuda")
        pstats["precompute_seconds"] = time.perf_counter() - t0
        log(f"transfer/io precompute {pstats['precompute_seconds']:.2f} s")
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega), dtype=torch.float32).to(device)
    solve = ddh.solver(m, maxit, tol, gmres_opts=HEADLINE_GMRES)

    # the global stiffness apply (kron fast path), in a chain
    gfem = GridH1Space(mesh, Basis(deg + 1), nx, nx)
    kop = make_kron_stiffness_op(gfem, dtype=torch.float32, device=device)
    xs = torch.as_tensor(
        np.random.default_rng(0).standard_normal(gfem.ndof).astype(np.float32), device=device)
    chain = 50

    def f_chain():
        w = xs
        for i in range(chain):
            w = apply_stiffness_kron(kop, w) / (1.0 + i)
        return w

    nb = deg + 1
    dt_apply = _ms_loop(f_chain, 5, device) / 1e3 / chain
    log(f"stiffness apply (kron): {dt_apply * 1e6:.1f} us, "
        f"{gfem.ndof * (2 * nb - 1) ** 2 / dt_apply:.3e} nnz/s")

    out, _, first = _timed_solve(solve, b, device)
    log(f"first solve {first:.3f} s; iters={out.num_iter} matvecs={out.num_matvec} "
        f"success={out.success}")
    out, _, secs = _timed_solve(solve, b * (1.0 + PERTURB), device)
    hist = out.res_norm[: out.n_hist].cpu().numpy()
    log(f"timed solve {secs:.3f} s; residual history {hist[0]:.3e} -> {hist[-1]:.3e}")

    sizes = ddh.efem.sizes.astype(np.int64)
    stiffness_applies = out.num_matvec * ddh.wh_maxit * ddh.nt * 2
    nnz_per_apply = int(sizes.sum()) * (2 * nb - 1) ** 2
    nnz_s = stiffness_applies * nnz_per_apply / secs
    flops = out.num_matvec * ddh.wh_maxit * ddh.nt * 2 * ddh.n_domains * ddh.pad ** 2 * 2
    log(f"effective dense GFLOP/s: {flops / secs / 1e9:.1f}; stencil nnz/s: {nnz_s:.3e}")

    # the executed wave-cycle action: the direct path's matvec
    was_transfer = ddh.use_transfer
    ddh.use_transfer = False
    lam = torch.as_tensor(
        np.random.default_rng(1).standard_normal(ddh.size).astype(np.float32), device=device)
    state = {"y": lam}

    def act():
        state["y"] = ddh.action(state["y"])

    cyc_secs = _ms_loop(act, 10, device) / 1e3
    ddh.use_transfer = was_transfer
    cyc_applies = ddh.wh_maxit * ddh.nt * 2
    cyc_nnz_s = cyc_applies * nnz_per_apply / cyc_secs
    cyc_flops = cyc_applies * ddh.n_domains * ddh.pad ** 2 * 2
    log(f"executed wave-cycle action: {cyc_secs * 1e3:.3f} ms/apply, {cyc_nnz_s:.3e} nnz/s, "
        f"{cyc_flops / cyc_secs / 1e12:.2f} TFLOP/s dense-equivalent")

    rows = {} if skip_configs else _config_rows(device, secs)
    scaling = None
    if not skip_scaling:
        from .examples.scaling import capture_scaling

        try:
            scaling = capture_scaling(device=device.type)
            log(f"scaling: {scaling['backend']} world sizes {scaling['devices']}")
        except Exception as e:  # recorded; main() exits non-zero
            scaling = {"error": repr(e)[:500]}
            log(f"scaling FAILED: {e!r}")
    return {
        "metric": "ddh_operator_throughput",
        "value": nnz_s,
        "unit": "nnz/s",
        "vs_baseline": 1.0,
        "solve_seconds": secs,
        "wave_cycle_executed_nnz_s": cyc_nnz_s,
        "extras": {
            "solve_seconds": secs,
            "setup_seconds": setup_seconds,
            "gmres_restarts": out.num_iter,
            "gmres_matvecs": out.num_matvec,
            "wave_cycle_executed_nnz_s": cyc_nnz_s,
            "wave_cycle_ms_per_apply": cyc_secs * 1e3,
            "wave_cycle_dense_tflops": cyc_flops / cyc_secs / 1e12,
            "stiffness_apply_us": dt_apply * 1e6,
            "precompute": pstats,
            "baseline_configs": rows,
            "scaling": scaling,
            "device": {"name_power_limit": name_power, "torch": torch.__version__,
                       "cuda": torch.version.cuda},
        },
    }


def main() -> int:
    rec = run_bench(skip_configs=bool(os.environ.get("BENCH_SKIP_CONFIGS")),
                    no_transfer=bool(os.environ.get("BENCH_NO_TRANSFER")),
                    skip_scaling=bool(os.environ.get("BENCH_SKIP_SCALING")))
    print(json.dumps(rec))
    failed = [k for k, row in rec["extras"]["baseline_configs"].items() if "error" in row]
    if "error" in (rec["extras"].get("scaling") or {}):
        failed.append("scaling")
    if failed:
        log(f"bench: rows failed: {failed}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
