"""Frequency sweep runner: scale omega and n together (JAX
``examples/sweep.py``).

Runs the DDH-preconditioned lambda-solve over a list of nx values (omega =
2 pi nx / 10, the reference drivers' scaling) and reports one JSON record
per size: restarts, matvecs, time and ``nnz_per_s``.

``nnz_per_s`` counts the reference's stencil equivalents, as the JAX
package does: each matvec as ``wh_maxit * nt * 2`` applications of the
subdomain stiffness with ``(2 nb - 1)^2`` non-zeros per DOF, over the solve
seconds.  It is not the work the port does: the transfer path applies no
stiffness in the solve, and the sparse kernel of the direct path applies
S from its exact non-zeros.

Usage:  python -m cuddhelmholtz_tpu_torch.examples.sweep [--transfer] [--block B] [nx ...]

``--transfer`` precomputes the per-subdomain transfer matrices (and on the
card the io maps) in ``DDH.prepare``: the production configuration.  The
records go to stderr one by one and to stdout as one JSON list.
"""

from __future__ import annotations

import json
import sys

import numpy as np

from .drivers import run_ddh


def sweep(nx_list=(32, 64, 128), deg=3, *, device="cuda", **kwargs) -> list[dict]:
    records = []
    for nx in nx_list:
        res = run_ddh(nx=nx, deg=deg, device=device, **kwargs)
        nb = deg + 1
        ddh = res.extra["ddh"]
        applies = res.num_matvec * ddh.wh_maxit * ddh.nt * 2
        nnz = int(ddh.efem.sizes.astype(np.int64).sum()) * (2 * nb - 1) ** 2
        rec = {
            "nx": nx,
            "omega": res.extra["omega"],
            "ndof": res.extra["ndof"],
            "n_domains": res.extra["n_domains"],
            "nt": res.extra["nt"],
            "iters": res.num_iter,
            "matvecs": res.num_matvec,
            "success": res.success,
            "final_rel_res": float(res.res_norm[-1] / res.res_norm[0]),
            "seconds": res.seconds,
            "nnz_per_s": applies * nnz / res.seconds,
            "setup_seconds": res.extra.get("setup_seconds"),
            "precompute": res.extra.get("precompute", {}),
        }
        records.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    return records


def main(argv=None, *, device="cuda") -> int:
    args = sys.argv[1:] if argv is None else list(argv)
    transfer = "--transfer" in args
    block = 16
    rest = []
    it = iter(a for a in args if a != "--transfer")
    for a in it:
        if a == "--block":
            block = int(next(it))
        else:
            rest.append(int(a))
    out = sweep(tuple(rest) or (32, 64, 128), transfer=transfer, block_size=block,
                device=device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
