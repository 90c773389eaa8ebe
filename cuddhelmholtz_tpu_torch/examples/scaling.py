"""Scaling harness: the sharded DDH matvec over a growing number of ranks.

Counterpart of ``cuddhelmholtz_tpu/examples/scaling.py``.  BASELINE.json's
scaling protocol is operator-apply nnz/s at 1 device / 1 host / N >= 2
hosts with >= 70 % weak-scaling efficiency.  This harness runs the
subdomain-sharded DDH apply (``parallel.ShardedDDH``, one process per rank
through ``parallel.spawn_processes``) at world sizes 1, 2, 4, ... up to the
visible cards (NCCL) or ``--cpu N`` gloo ranks, and reports per-size matvec
time and efficiency against one rank.

* **Weak scaling** (default): the subdomain grid grows with the ranks (nx =
  base_nx * sqrt(ranks), rounded to a subdomain multiple), so each rank
  keeps about the same work.
* **Strong scaling** (``--strong``): a fixed problem.

``--transfer`` precomputes the per-subdomain trace-transfer matrices, so a
matvec is one small batched product per rank (the production matvec;
throughput is still counted in wave-cycle stencil-equivalent nnz/s, as
the bench counts it).  ``--global`` times the element-sharded coupled
Helmholtz matvec (``parallel.sharded_helmholtz_matvec``) instead.

Every record names its backend, world size and device.  One card gives one
row: a world-1 record, which says nothing about scaling; gloo ranks on the
CPU show that the sharded path runs, not how a cluster scales.

Usage:  python -m cuddhelmholtz_tpu_torch.examples.scaling [--strong]
        [--transfer] [--global] [--cpu N] [base_nx]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np
import torch

from ..parallel.distributed import spawn_processes

WORKER = os.path.join(os.path.dirname(os.path.abspath(__file__)), "scaling_mp_worker.py")


def world_sizes(device: str, cpu_ranks: int) -> list[int]:
    """1, 2, 4, ... up to the visible cards (``"cuda"``) or ``cpu_ranks``."""
    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("scaling: no CUDA device is available; pass device='cpu'")
        n_total = torch.cuda.device_count()
    else:
        n_total = cpu_ranks
    sizes, n = [], 1
    while n <= n_total:
        sizes.append(n)
        n *= 2
    return sizes


def run_ranks(world: int, device: str, mode: str, nx: int, deg: int, reps: int,
              transfer: bool, timeout: float = 900.0) -> dict:
    """One record: ``world`` ranks of ``scaling_mp_worker.py`` on one host."""
    outs = spawn_processes(WORKER, 1, world, device, mode, nx, deg, reps, int(transfer),
                           timeout=timeout, device=device)
    bad = [(r, rc) for r, (rc, _) in enumerate(outs) if rc != 0]
    if bad:
        raise RuntimeError(f"scaling: ranks {bad} failed at world {world}:\n"
                           f"{outs[bad[0][0]][1][-3000:]}")
    for line in outs[0][1].splitlines():
        if line.startswith("SCALING_MP "):
            return json.loads(line[len("SCALING_MP "):])
    raise RuntimeError(f"scaling: rank 0 printed no record:\n{outs[0][1][-3000:]}")


def scaling(base_nx: int = 32, strong: bool = False, deg: int = 3, reps: int = 3,
            transfer: bool = False, global_: bool = False, device: str = "cuda",
            cpu_ranks: int = 2, timeout: float = 900.0) -> list[dict]:
    """Records of the sharded matvec at each world size (see the module)."""
    nb = deg + 1
    epd = 16 // nb  # elements per subdomain side (16-DOF subdomains)
    records, base = [], None
    for nd in world_sizes(device, cpu_ranks):
        if strong:
            nx = base_nx
        elif global_:
            nx = int(round(base_nx * np.sqrt(nd)))
        else:
            nx = int(round(base_nx * np.sqrt(nd) / epd)) * epd
        rec = run_ranks(nd, device, "global" if global_ else "ddh", nx, deg, reps, transfer,
                        timeout)
        base = rec["nnz_per_s_per_device"] if base is None else base
        rec["efficiency_vs_1dev"] = rec["nnz_per_s_per_device"] / base
        records.append(rec)
        print(json.dumps(rec), file=sys.stderr, flush=True)
    return records


def capture_scaling(out_path: str | None = None, base_nx: int = 16, device: str = "cuda",
                    timeout: float = 900.0) -> dict:
    """The weak-scaling protocol with transfer matrices, as the bench's
    ``scaling`` key: every world size the device gives (on the CPU, 1 and 2
    gloo ranks).  Writes ``out_path`` when given; returns the summary."""
    t0 = time.perf_counter()
    recs = scaling(base_nx=base_nx, transfer=True, device=device, timeout=timeout)
    result = {
        "protocol": "weak", "transfer": True, "base_nx": base_nx,
        "backend": recs[0]["backend"], "devices": [r["devices"] for r in recs],
        "records": recs, "seconds": time.perf_counter() - t0,
    }
    if out_path:
        with open(out_path, "w") as f:
            json.dump(result, f, indent=1)
    return result


if __name__ == "__main__":
    args = sys.argv[1:]
    flags = {a for a in args if a in ("--strong", "--transfer", "--global")}
    args = [a for a in args if a not in flags]
    dev, ranks = "cuda", 2
    if "--cpu" in args:
        i = args.index("--cpu")
        dev, ranks = "cpu", int(args[i + 1])
        del args[i: i + 2]
    out = scaling(base_nx=int(args[0]) if args else 32, strong="--strong" in flags,
                  transfer="--transfer" in flags, global_="--global" in flags, device=dev,
                  cpu_ranks=ranks)
    print(json.dumps(out))
