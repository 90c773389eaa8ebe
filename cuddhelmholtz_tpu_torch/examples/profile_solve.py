"""Where the time of a DDH solve goes on the GPU.

Runs a configuration once through ``run_config`` (setup, ``prepare`` on the
transfer path, one solve), then solves again on the prepared operator: once
unprofiled (host clock around work that ends in ``torch.cuda.synchronize``)
and once under ``torch.profiler``.  Prints one JSON line: the unprofiled
solve seconds and counts, the profiled window, device busy time (the union
of the intervals of every kernel, copy and memset on the device), the idle
share, device work and device operations per matvec, and the ten kinds of
device work that took longest.

    python -m cuddhelmholtz_tpu_torch.examples.profile_solve \\
        [--config ddh_structured|ddh_unstructured_square|ddh_512_block32] [--direct]

Needs a CUDA device; it refuses to run without one.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from ..config import DDH_512_BLOCK32, DDH_STRUCTURED, DDH_UNSTRUCTURED_SQUARE
from ..examples.drivers import point_sources, run_config
from ..models.helmholtz import helmholtz_rhs

CONFIGS = {c.name: c for c in (DDH_STRUCTURED, DDH_UNSTRUCTURED_SQUARE, DDH_512_BLOCK32)}


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--config", choices=sorted(CONFIGS), default="ddh_structured")
    ap.add_argument("--direct", action="store_true", help="the direct path (transfer=False)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_solve: no CUDA device")
    cfg = CONFIGS[args.config]
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
    dev_events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not dev_events:
        raise SystemExit("profile_solve: the trace holds no device events")
    busy_us, end = 0.0, float("-inf")  # union of the device intervals
    for e in sorted(dev_events, key=lambda e: e.time_range.start):
        start = max(e.time_range.start, end)
        busy_us += max(0.0, e.time_range.end - start)
        end = max(end, e.time_range.end)
    by_name: dict = {}
    for e in dev_events:
        n, us = by_name.get(e.name, (0, 0.0))
        by_name[e.name] = (n + 1, us + e.time_range.elapsed_us())
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:10]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    ).stdout.strip()
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
        "device_busy_s": busy_us / 1e6,
        "device_idle_share": 1.0 - busy_us / 1e6 / window_s,
        "device_ms_per_matvec": busy_us / 1e3 / pout.num_matvec,
        "wall_ms_per_matvec": 1e3 * solve_s / out.num_matvec,
        "device_ops_per_matvec": len(dev_events) / pout.num_matvec,
        "top": [{"name": name[:80], "count": n, "ms": us / 1e3} for name, (n, us) in top],
    }))


if __name__ == "__main__":
    main()
