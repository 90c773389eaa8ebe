"""Readings of the check's numbers over many seeds in one process: the
program as the benchmark runs it, or the check's control.  This is how each
limit in ``cells/*.json`` was set: the lower reading is the largest the
program gives over a dozen seeds or more, the upper the smallest the
control gives.

The control is computed in the precision below the configuration's:

* "ddh" (float32, TF32 off): the program has no TF32 path of its own (it
  pins TF32 off when imported), so the plain reference takes its place,
  in float32 with TF32 matmuls (its subdomain stiffness applies run on the
  tensor cores), solving the configured GMRES to the configured tolerance;
* "helmholtz_ddh" (float64): the program's own float32 path (the coupled
  operator, the right-hand side and FGMRES in float32).

    python3 -m benchmark.control --workload <cell> --seeds 1,2,3 --seconds 5 [--control]

One JSON line per seed on standard output.  Needs a CUDA card.
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from . import check, spec
from .run import log, run_cell
from .traffic import make_pool


def reference_control(cell: spec.Cell, seed: int, device="cuda") -> dict:
    """The "ddh" control: the TF32 reference in the program's place on the
    first requests of the seed's pool, judged by the cell's check."""
    cfg, traffic = cell.config, cell.traffic
    grid = cell.grid()
    solver = dict(cfg["solver"], **traffic.get("solver", {}))
    pool = make_pool(cell, seed, grid, device)[: cell.sample]
    xy = torch.as_tensor(grid.coords(), device=device)
    items, ref = [], None
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        for req in pool:
            if ref is None or req.a is not None:
                a = cell.speed(xy) if req.a is None else req.a
                ref = cell.reference(grid, a.cpu().numpy(), device, torch.float32)
            U = ref.solve(req.b.reshape(-1, req.b.shape[-1]), tol=solver["tol"], m=solver["m"],
                          maxit=solver["maxit"], strict=False)
            items.append((req, U.to(torch.float64).reshape(req.b.shape)))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = False
    del ref
    numbers = check.compare(cell, grid, items, device)
    return {"correct": all(v <= lim for v, lim in numbers.values()),
            "check": {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        log("needs a CUDA device")
        return 2
    cell = spec.load_cell(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        if args.control and cell.config["kind"] == "ddh":
            res = reference_control(cell, seed)
        else:
            res = run_cell(cell, seed, args.seconds, False, control=args.control)
        print(json.dumps({"workload": cell.name, "seed": seed, "control": args.control,
                          **{k: res[k] for k in ("correct", "attempted", "failed", "metrics",
                                                 "check") if k in res}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
