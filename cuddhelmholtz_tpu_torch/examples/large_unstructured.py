"""Large unstructured DDH benchmark.

Counterpart of ``cuddhelmholtz_tpu/examples/large_unstructured.py``: refine
the 119-element ``meshes/unstructured_square`` fixture ``levels`` times (4x
elements per level, irregular topology kept), pick omega for
``elems_per_wavelength`` elements per wavelength (5, the flagship's
resolution), partition by median coordinate bisection and run the
transfer-path lambda-solve to ``tol``; optionally repeat on a matched
jittered-grid control.  At ``--levels 3 --domains 256`` every subdomain has
its own stiffness at pad 320, so the probes run the sparse kernel in the
grouped layout.  ``--composite`` also solves the coupled system to 1e-6
(``run_helmholtz_ddh`` on the same partition) and adds its ``composite``
record.  ``--coarse additive|multiplicative`` adds the two-level
correction (the iterative block-sparse coarse space, ``--coarse-n-dir``
directions, ``--coarse-dps`` subdomains per superdomain) to the lambda-solve
and a ``coarse`` record with its size ``nc`` and ``build_seconds``.

Usage (on the card; ``--device cpu`` runs the CPU path):
  python -m cuddhelmholtz_tpu_torch.examples.large_unstructured \\
      [--levels 3] [--domains 256] [--deg 3] [--composite] [--control] \\
      [--coarse multiplicative [--coarse-n-dir 4] [--coarse-dps 4]] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np

from ..mesh.io import load_unstructured_square
from ..mesh.refine import jittered_grid, refine_quad_mesh
from ..spaces.ensemble import coordinate_bisection_labels
from .drivers import DriverResult, run_ddh, run_helmholtz_ddh


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_h(mesh) -> float:
    """Square root of the median element area."""
    v = mesh.vertices[mesh.elem_vertices]
    x, y = v[..., 0], v[..., 1]
    area = 0.5 * np.abs(np.sum(x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y, axis=1))
    return float(np.sqrt(np.median(area)))


def solve_case(mesh, n_domains: int, deg: int, omega: float, tol: float,
               coarse: str | None = None, coarse_n_dir: int = 4, coarse_dps: int = 4, *,
               device="cuda") -> DriverResult:
    """Bisect ``mesh`` into ``n_domains`` and run the transfer-path DDH solve
    (``run_ddh``: prepare, then rhs, lambda-GMRES(20) and postprocess); with
    ``coarse`` the two-level solve on the iterative coarse space (coarse
    solve m 20, 2 restarts, tol 3e-2)."""
    labels, _ = coordinate_bisection_labels(mesh, n_domains)
    return run_ddh(deg=deg, tol=tol, mesh=mesh, element_labels=labels, omega=omega,
                   transfer=True, coarse=coarse, coarse_n_dir=coarse_n_dir,
                   coarse_domains_per_super=coarse_dps, coarse_method="iterative",
                   coarse_solve=(20, 2, 3e-2), device=device)


def case_record(name: str, mesh, res: DriverResult) -> dict:
    """The JAX example's JSON record of one solved case."""
    ddh = res.extra["ddh"]
    pre = res.extra["precompute"]
    counts = ddh.efem.n_elems[:ddh.n_domains]
    prepare_s = sum(pre.get(k, 0.0) for k in ("transfer_seconds", "io_seconds", "load_seconds"))
    rec = {
        "case": name,
        "n_elem": int(mesh.n_elem),
        "ndof": int(res.extra["ndof"]),
        "omega": float(res.extra["omega"]),
        "n_domains": int(ddh.n_domains),
        "elems_per_domain": [int(counts.min()), int(counts.max())],
        "n_lambda": int(ddh.size),
        "nt": int(ddh.nt),
        "pad": int(ddh.pad),
        "shared_S": bool(ddh.shared_S),
        "ctor_seconds": res.extra["setup_seconds"] - prepare_s
        - res.extra.get("coarse_seconds", 0.0),
        "prepare_seconds": prepare_s,
        "prepare": {k: v for k, v in pre.items() if not isinstance(v, (list, dict))},
        "transfer_nu": pre.get("transfer_nu"),
        "roll_routes": len(ddh.route.offs) if ddh.route is not None else 0,
        "restarts": int(res.num_iter),
        "matvecs": int(res.num_matvec),
        "success": bool(res.success),
        "solve_seconds": float(res.seconds),
        "final_rel_res": float(res.res_norm[-1] / res.res_norm[0]),
    }
    cs = ddh.coarse_space
    if cs is not None:
        meta = ddh._coarse_meta
        rec["coarse"] = {
            "mode": res.extra["coarse"], "n_dir": int(meta[0]), "dps": int(meta[1]),
            "nc": int(2 * cs.members.shape[0] * cs.V.shape[2]),
            "build_seconds": res.extra["coarse_seconds"],
        }
    return rec


def run_case(name: str, mesh, n_domains: int, deg: int, omega: float, tol: float,
             composite: bool = False, coarse: str | None = None, coarse_n_dir: int = 4,
             coarse_dps: int = 4, *, device="cuda") -> dict:
    """Solve one case and return its record."""
    res = solve_case(mesh, n_domains, deg, omega, tol, coarse, coarse_n_dir, coarse_dps,
                     device=device)
    rec = case_record(name, mesh, res)
    if "coarse" in rec:
        log(f"[{name}] coarse space: {rec['coarse']}")
    log(f"[{name}] nel={rec['n_elem']} ndof={rec['ndof']} omega={rec['omega']:.1f} "
        f"ndom={rec['n_domains']} pad={rec['pad']} nt={rec['nt']} nu={rec['transfer_nu']} "
        f"routes={rec['roll_routes']} prepare {rec['prepare_seconds']:.1f}s: "
        f"{rec['restarts']} restarts / {rec['matvecs']} matvecs, solve "
        f"{rec['solve_seconds']:.2f}s success={rec['success']}")
    if composite:
        labels, ndom = coordinate_bisection_labels(mesh, n_domains)
        r = run_helmholtz_ddh(nx=1, deg=deg, m=20, maxit=100, tol=1e-6, mesh=mesh,
                              element_labels=labels, n_domains=ndom, omega=omega,
                              device=device)
        rec["composite"] = {
            "success": bool(r.success),
            "iters": int(r.num_iter),
            "matvecs": int(r.num_matvec),
            "warm_seconds": r.extra.get("warm_seconds"),
            "refine_steps": r.extra.get("refine_steps"),
            "final_rel_res": float(r.res_norm[-1] / r.res_norm[0]),
        }
        log(f"[{name}] composite 1e-6: {rec['composite']}")
    return rec


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--levels", type=int, default=3)
    ap.add_argument("--domains", type=int, default=256)
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--elems-per-wavelength", type=float, default=5.0)
    ap.add_argument("--omega-scale", type=float, default=1.0,
                    help="multiply omega (x2 halves the elements per wavelength)")
    ap.add_argument("--coarse", default=None, choices=["additive", "multiplicative"],
                    help="two-level correction (iterative block-sparse space)")
    ap.add_argument("--coarse-n-dir", type=int, default=4)
    ap.add_argument("--coarse-dps", type=int, default=4)
    ap.add_argument("--composite", action="store_true",
                    help="also run the coupled 1e-6 solve")
    ap.add_argument("--control", action="store_true",
                    help="also run the matched jittered-grid control case")
    ap.add_argument("--out", default=None, help="write JSON records here")
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    mesh = refine_quad_mesh(load_unstructured_square(), args.levels)
    omega = args.omega_scale * 2 * np.pi / (args.elems_per_wavelength * median_h(mesh))
    tag = f"unstructured_L{args.levels}"
    if args.omega_scale != 1.0:
        tag += f"_w{args.omega_scale:g}"
    if args.coarse:
        tag += f"_coarse_{args.coarse[:4]}"
    cases = [(tag, mesh)]
    if args.control:
        nxj = int(round(np.sqrt(mesh.n_elem)))
        cases.append((f"jittered_{nxj}x{nxj}", jittered_grid(nxj, nxj, amount=0.25, seed=1)))
    # as the JAX example: the coarse correction on the main case only
    recs = [
        run_case(name, m, args.domains, args.deg, omega, args.tol, args.composite,
                 args.coarse if i == 0 else None, args.coarse_n_dir, args.coarse_dps,
                 device=args.device)
        for i, (name, m) in enumerate(cases)
    ]
    for r in recs:
        print(json.dumps(r))
    if args.out:
        with open(args.out, "w") as f:
            for r in recs:
                f.write(json.dumps(r) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
