"""Where the time of a DDH solve goes on the GPU.

Runs a configuration once through ``run_config`` (setup, ``prepare`` on the
transfer path, one solve), then solves again on the prepared operator: once
unprofiled (host clock around work that ends in ``torch.cuda.synchronize``)
and once under ``torch.profiler``.  Prints one JSON line: the unprofiled
solve seconds and counts, the profiled window, device busy time (the union
of the intervals of every kernel, copy and memset on the device), the idle
share, device work and device operations per matvec, and the ten kinds of
device work that took longest.

For a composite configuration (``helmholtz_ddh_1e6``,
``helmholtz_ddh_unstructured_1e6``) the unit is one application of the
preconditioner P (one bounded inner lambda-GMRES between the DDH rhs and
postprocess): after the solve, P runs ``--reps`` times on a seeded vector
unprofiled and ``--reps`` times profiled, and the line gives device work,
idle share and device operations per P.

    python -m cuddhelmholtz_tpu_torch.examples.profile_solve \\
        [--config ddh_structured|ddh_unstructured_square|ddh_512_block32|
                  helmholtz_ddh_1e6|helmholtz_ddh_unstructured_1e6] [--direct] [--reps 5]

Needs a CUDA device; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import numpy as np
import torch

from ..config import (
    DDH_512_BLOCK32,
    DDH_STRUCTURED,
    DDH_UNSTRUCTURED_SQUARE,
    HELMHOLTZ_DDH_1E6,
    HELMHOLTZ_DDH_UNSTRUCTURED_1E6,
)
from ..examples.drivers import point_sources, run_config
from ..models.helmholtz import helmholtz_rhs

CONFIGS = {c.name: c for c in (DDH_STRUCTURED, DDH_UNSTRUCTURED_SQUARE, DDH_512_BLOCK32,
                               HELMHOLTZ_DDH_1E6, HELMHOLTZ_DDH_UNSTRUCTURED_1E6)}


def _device_time(prof, window_s: float) -> dict:
    """Device busy seconds (the union of the device intervals), idle share
    of ``window_s``, the number of device operations and the ten kinds of
    device work that took longest."""
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise SystemExit("profile_solve: the trace holds no device events")
    busy_us, end = 0.0, float("-inf")
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        busy_us += max(0.0, e.time_range.end - start)
        end = max(end, e.time_range.end)
    by_name: dict = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    return {
        "busy_s": busy_us / 1e6,
        "idle_share": 1.0 - busy_us / 1e6 / window_s,
        "n_ops": len(dev_events),
        "top": [{"name": name[:80], "count": n, "ms": us / 1e3} for name, (n, us) in top],
    }


def _profile_precond(res, reps: int) -> dict:
    """Time ``reps`` applications of the composite solve's P unprofiled, then
    ``reps`` under the profiler; per-P device work, idle share and ops."""
    P = res.extra["precond"]
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(2 * res.extra["ndof"])).cuda()
    P(v)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        P(v)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(reps):
            P(v)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    d = _device_time(prof, window_s)
    return {
        "first_solve_s": res.seconds,
        "restarts": res.num_iter,
        "matvecs": res.num_matvec,
        "n_precond": res.extra["n_precond"],
        "reps": reps,
        "wall_ms_per_P": 1e3 * wall_s / reps,
        "profiled_window_s": window_s,
        "device_busy_s": d["busy_s"],
        "device_idle_share": d["idle_share"],
        "device_ms_per_P": 1e3 * d["busy_s"] / reps,
        "device_ops_per_P": d["n_ops"] / reps,
        "top": d["top"],
    }


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="ddh_structured")
    ap.add_argument("--direct", action="store_true", help="the direct path (transfer=False)")
    ap.add_argument("--reps", type=int, default=5, help="applications of P (composite)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve: no CUDA device")
    cfg = CONFIGS[args.config]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
    if cfg.kind == "helmholtz_ddh":
        res = run_config(cfg, measure_warm=False, device="cuda")
        print(json.dumps({"card": smi, "config": cfg.name, "unit": "P",
                          "prepare": res.extra["precompute"],
                          **_profile_precond(res, args.reps)}))
        return
    res = run_config(cfg, transfer=not args.direct, device="cuda")
    ddh = res.extra["ddh"]
    g = cfg.gmres
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, res.extra["omega"])).cuda()
    solve = ddh.solver(g.m, g.maxit, g.tol)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, _ = solve(b)
    torch.cuda.synchronize()
    solve_s = time.perf_counter() - t0

    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        pout, _ = solve(b)
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    d = _device_time(prof, window_s)
    print(json.dumps({
        "card": smi,
        "config": cfg.name,
        "path": "direct" if args.direct else "transfer",
        "prepare": res.extra["precompute"],
        "first_solve_s": res.seconds,
        "solve_s": solve_s,
        "restarts": out.num_iter,
        "matvecs": out.num_matvec,
        "profiled_window_s": window_s,
        "device_busy_s": d["busy_s"],
        "device_idle_share": d["idle_share"],
        "device_ms_per_matvec": 1e3 * d["busy_s"] / pout.num_matvec,
        "wall_ms_per_matvec": 1e3 * solve_s / out.num_matvec,
        "device_ops_per_matvec": d["n_ops"] / pout.num_matvec,
        "top": d["top"],
    }))


if __name__ == "__main__":
    main()
