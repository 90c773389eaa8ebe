"""The DDH example solved with its subdomains sharded over ranks (``ShardedDDH``).

SPMD, one process per device.  On cards, with ``torchrun``:

    torchrun --standalone --nproc_per_node=N \\
        -m cuddhelmholtz_tpu_torch.examples.sharded_solve [--nx 128]

or from Python with ``parallel.spawn_processes(<this file>, 1, N, ...)``
(``spawn_cpu_processes`` and ``--device cpu`` for gloo ranks on the CPU).
Every rank builds the ``run_ddh`` problem (nx, deg 3, 16-DOF subdomains,
the wave-speed disc and the point sources) and then:

  1. holds ``ShardedDDH``'s direct-path ``action``, ``rhs`` and
     ``postprocess`` (a wave cycle over the rank's rows) to the unsharded
     ``DDH``'s on a seeded lambda, relative to the max;
  2. precomputes the transfer matrices (the probes, on every rank) and
     solves: ``rhs`` and ``postprocess`` through the sharded wave cycle,
     lambda-GMRES(20) to ``--tol`` through the sharded transfer action (the
     rolled exchange with halo sends when the route fits);
  3. solves again and compares bitwise;
  4. recomputes the lambda residual with the plain PyTorch cycle.

Rank 0 prints one JSON line: counts, seconds, errors, bitwise flags, the
backend and world size, and every rank's wave-cycle kernel launches in
``ShardedDDH``'s calls alone: step 1's (``launches_direct``; on the card one
each for action, rhs and postprocess) and those of the two solves of steps
2-3 (``launches_solves``; rhs and postprocess per solve, the transfer
action launches none).
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from cuddhelmholtz_tpu_torch.examples.drivers import point_sources, wave_speed_coeff  # noqa: E402
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D  # noqa: E402
from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs  # noqa: E402
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc  # noqa: E402
from cuddhelmholtz_tpu_torch.ops.functional import linear_functional  # noqa: E402
from cuddhelmholtz_tpu_torch.ops.mass import (  # noqa: E402
    apply_diag_inv_mass,
    make_diag_inv_mass_op,
)
from cuddhelmholtz_tpu_torch.parallel import ShardedDDH, initialize_from_env  # noqa: E402
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, _sync, ddh_action, ddh_rhs  # noqa: E402
from cuddhelmholtz_tpu_torch.solvers.gmres import gmres  # noqa: E402
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space  # noqa: E402
from cuddhelmholtz_tpu_torch.utils import spans  # noqa: E402
from cuddhelmholtz_tpu_torch.utils.basis import Basis  # noqa: E402


def _rel(got: torch.Tensor, want: torch.Tensor) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def _launches() -> dict:
    return {k: v for k, v in wc.launch_counts().items() if v}


def solve(nx: int, deg: int, block_size: int, m: int, maxit: int, tol: float,
          device: str) -> dict:
    """Steps 1-4 on this rank; the record rank 0 prints."""
    dist = torch.distributed
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    omega = 2 * np.pi * nx / 10
    fem = H1Space(Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0), Basis(deg + 1))
    a_nodal = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"),
                                  linear_functional(fem, wave_speed_coeff)).numpy()
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega)).to(dev)
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=block_size, device=dev)
    rec = {"backend": dist.get_backend() if dist.is_initialized() else None,
           "world": dist.get_world_size() if dist.is_initialized() else 1,
           "device": str(dev), "nx": nx, "n_domains": ddh.n_domains, "pad": ddh.pad,
           "nt": ddh.nt, "n_lambda": ddh.size}
    if dev.type == "cuda":
        rec["device_name"] = torch.cuda.get_device_name(dev)

    # 1. the direct path against the unsharded operator, computed first so
    # that the launch counts hold the sharded calls alone
    lam = torch.as_tensor(np.random.default_rng(0).standard_normal(ddh.size).astype(np.float32),
                          device=dev)
    bf = b.to(torch.float32)
    want = (ddh.action(lam), ddh.rhs(bf), ddh.postprocess(lam, bf))
    sddh = ShardedDDH(ddh)
    rec["rows_per_rank"] = sddh.rows_per_rank
    spans.reset(wc.LAUNCHES)
    got = (sddh.action(lam), sddh.rhs(bf), sddh.postprocess(lam, bf))
    direct = _launches()
    rec["rel_action"], rec["rel_rhs"], rec["rel_postprocess"] = map(_rel, got, want)

    # 2. the transfer solve (its probes run unsharded on every rank), 3. again
    _sync(dev)
    t0 = time.perf_counter()
    ddh.precompute_transfer()
    _sync(dev)
    rec["transfer_seconds"] = time.perf_counter() - t0
    sddh = ShardedDDH(ddh)
    rec["rolled"] = sddh._roll is not None
    spans.reset(wc.LAUNCHES)
    runs = []
    for _ in range(2):
        _sync(dev)
        t0 = time.perf_counter()
        out = gmres(sddh.action, sddh.rhs(b), m=m, maxit=maxit, tol=tol)
        U = sddh.postprocess(out.x, b)
        _sync(dev)
        runs.append((out, U, time.perf_counter() - t0))
    (o1, U1, s1), (o2, U2, s2) = runs
    rec.update(success=o1.success, restarts=o1.num_iter, matvecs=o1.num_matvec,
               solve_seconds=[s1, s2],
               history=[float(o1.res_norm[0]), float(o1.res_norm[o1.n_hist - 1])],
               bitwise=bool(torch.equal(o1.x, o2.x) and torch.equal(U1, U2)
                            and torch.equal(o1.res_norm[:o1.n_hist], o2.res_norm[:o2.n_hist])),
               solution_finite=bool(torch.isfinite(U1).all()), solution_size=U1.numel())
    solves = _launches()
    if dist.is_initialized():
        per_rank = [None] * dist.get_world_size()
        dist.all_gather_object(per_rank, (direct, solves))
    else:
        per_rank = [(direct, solves)]
    rec["launches_direct"] = [d for d, _ in per_rank]
    rec["launches_solves"] = [s for _, s in per_rank]

    # 4. the lambda residual through the plain cycle
    Y = ddh_rhs(ddh.params, b, ddh.g_ndof, ddh.n_lambda, wh_maxit=ddh.wh_maxit,
                cycle=wc.wave_cycle_plain)
    AX = ddh_action(ddh.params, o1.x, n_own=ddh.n_own, wh_maxit=ddh.wh_maxit,
                    cycle=wc.wave_cycle_plain)
    rec["plain_residual"] = float(torch.linalg.vector_norm(Y - AX) / torch.linalg.vector_norm(Y))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("spawned", nargs="*",
                    help="rank, world size and ranks per host, as spawn_processes passes "
                         "them (the environment carries the same)")
    ap.add_argument("--nx", type=int, default=128)
    ap.add_argument("--deg", type=int, default=3)
    ap.add_argument("--block-size", type=int, default=16)
    ap.add_argument("--m", type=int, default=20)
    ap.add_argument("--maxit", type=int, default=100)
    ap.add_argument("--tol", type=float, default=1e-4)
    ap.add_argument("--device", default="cuda", help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if not initialize_from_env(device=args.device):
        raise SystemExit("sharded_solve: no process group (run under torchrun or "
                         "parallel.spawn_processes)")
    if args.device == "cpu":
        torch.set_num_threads(1)
    rec = solve(args.nx, args.deg, args.block_size, args.m, args.maxit, args.tol, args.device)
    if torch.distributed.get_rank() == 0:
        print(json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
