"""Two-level against one-level DDH at the high-frequency wall.

Counterpart of the JAX repository's ``docs/run_coarse_study.py``, with its
flags and its JSON keys per line: ``run_ddh`` on the transfer path at
``--nx`` / ``--block`` (GMRES(``--m``), ``--maxit`` restarts, tol 1e-4),
first one level, then the multiplicative two-level solve on the iterative
block-sparse coarse space (``--n-dir`` plane-wave directions, ``--dps``
subdomains per superdomain, coarse solve ``--solve`` = m,maxit,tol).  Each
case prints one JSON line; a case that raises prints its error instead.
Beyond the JAX keys a line has ``setup_seconds``, the coarse space's
``build_seconds`` and, on the card, ``peak_memory_bytes``
(``torch.cuda.max_memory_allocated`` over the case).  ``compile_seconds``
is the first solve's time less the warm solve's (the port compiles
nothing; the name is the JAX record's).

Usage (on the card; ``--device cpu`` runs the CPU path):
  python -m cuddhelmholtz_tpu_torch.examples.coarse_study \\
      [--nx 512] [--block 16] [--dps 1] [--skip-baseline] [--out FILE]
"""

from __future__ import annotations

import argparse
import json
import sys
import time
import traceback

import torch

from .drivers import run_ddh


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--nx", type=int, default=512)
    ap.add_argument("--block", type=int, default=16)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--maxit", type=int, default=200)
    ap.add_argument("--dps", type=int, default=1)
    ap.add_argument("--n-dir", type=int, default=4)
    ap.add_argument("--solve", default="20,2,3e-2", help="coarse inner solve: m,maxit,tol")
    ap.add_argument("--skip-baseline", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)

    sm, smx, stl = args.solve.split(",")
    solve = (int(sm), int(smx), float(stl))
    cuda = torch.device(args.device).type == "cuda"
    recs = []

    def go(label, **kw):
        t0 = time.perf_counter()
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        try:
            r = run_ddh(nx=args.nx, block_size=args.block, m=args.m, maxit=args.maxit,
                        transfer=True, measure_warm=True, device=args.device, **kw)
            ex = r.extra
            rec = {
                "case": label, "nx": args.nx, "block": args.block,
                "restarts": int(r.num_iter), "matvecs": int(r.num_matvec),
                "success": bool(r.success),
                "warm_seconds": ex["warm_seconds"],
                "compile_seconds": r.seconds - ex["warm_seconds"],
                "final_rel_res": float(r.res_norm[-1] / r.res_norm[0]),
                "n_lambda": ex["n_lambda"], "n_domains": ex["n_domains"],
                "total_seconds": time.perf_counter() - t0,
                "solve_seconds": r.seconds, "setup_seconds": ex["setup_seconds"],
            }
            if kw.get("coarse"):
                cs = ex["ddh"].coarse_space
                rec["coarse"] = {
                    "method": "iterative", "n_dir": args.n_dir, "dps": args.dps,
                    "solve": list(solve), "nc": int(2 * cs.members.shape[0] * cs.V.shape[2]),
                    "build_seconds": ex["coarse_seconds"],
                }
            del r, ex
        except Exception as e:  # record the failure (out of memory, say) and go on
            traceback.print_exc()
            rec = {"case": label, "nx": args.nx, "error": repr(e)[:300],
                   "total_seconds": time.perf_counter() - t0}
        if cuda:
            rec["peak_memory_bytes"] = torch.cuda.max_memory_allocated()
            torch.cuda.empty_cache()
        recs.append(rec)
        log(rec)
        print(json.dumps(rec), flush=True)

    if not args.skip_baseline:
        go("one_level")
    go("two_level_mult", coarse="multiplicative", coarse_method="iterative",
       coarse_n_dir=args.n_dir, coarse_domains_per_super=args.dps, coarse_solve=solve)
    if args.out:
        with open(args.out, "w") as f:
            for rec in recs:
                f.write(json.dumps(rec) + "\n")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
