"""Run one cell of the port's benchmark and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up builds the cell's operator from its configuration, makes the cell's
requests from the seed and serves one of them (or, for the composite, a few
applications of its preconditioner) to warm up.  The window then serves
whole requests in a closed loop with one caller, each timed on the host
clock around work that ends in ``torch.cuda.synchronize()``, until
``--seconds`` have passed.  With ``--trace 1`` the window (at most the mix's
``trace_seconds``) runs under ``torch.profiler`` and the line carries the
per-layer metrics; with ``--trace 0`` the end-to-end ones.  After the window
the outputs are compared with the plain reference (``check.py``).

The last line of standard output is one JSON object; the numbers compared,
each with its limit, are the last lines of standard error and the last key
of that object.  Without a CUDA card (or with fewer than the cell asks for),
or with JAX or the JAX package loaded, it prints no result and exits
non-zero.
"""

from __future__ import annotations

import sys
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import subprocess  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402

import torch  # noqa: E402

from . import spec  # noqa: E402
from .trace import DeviceTrace, device_ops  # noqa: E402
from .traffic import make_pool  # noqa: E402


@dataclass
class Logged:
    """One request of the window."""

    req: object
    out: object
    latency_s: float


@dataclass
class Run:
    """What the metric readers read (``metrics/<name>.py::read(run)``)."""

    setup_s: float
    window_s: float
    requests: list  # dicts: latency_s, n_rhs, ok and the request's counts
    trace: DeviceTrace | None = None
    spans: list = field(default_factory=list)


def log(msg: str) -> None:
    print(f"[bench] {msg}", file=sys.stderr, flush=True)


def serve_window(system, pool, seconds: float, device) -> tuple[list, float]:
    """Closed loop, one caller: serve pool requests round-robin until
    ``seconds`` have passed; the window ends when the last request does."""
    from .system import sync

    out, i = [], 0
    sync(device)
    w0 = time.perf_counter()
    while True:
        req = pool[i % len(pool)]
        t0 = time.perf_counter()
        s0 = system.spans.now()
        res = system.serve(req)
        sync(device)
        t1 = time.perf_counter()
        system.spans.add("request", s0)
        out.append(Logged(req, res, t1 - t0))
        i += 1
        if t1 - w0 >= seconds:
            return out, t1 - w0


def run_cell(cell: spec.Cell, seed: int, seconds: float, trace: bool, device="cuda",
             control: bool = False) -> dict:
    """One run of ``cell``; returns the result line's object.  ``control``
    runs a float64 configuration in the program's own float32 path: the
    check's control (``control.py``), which no benchmark run uses."""
    from . import check, system as sut

    cfg, traffic = cell.config, cell.traffic
    grid = cell.grid()
    spans = sut.Spans()
    if control and cfg["kind"] != "helmholtz_ddh":
        raise ValueError("the program has a float32 path only for the float64 coupled solve")
    kw = {"dtype": torch.float32} if control else {}
    t0 = time.perf_counter()
    system = cell.system()(cell, grid, device, spans, **kw)
    t1 = time.perf_counter()
    built = [(n, round((e - s) / 1e9, 3)) for n, s, e in spans.items]
    pool = make_pool(cell, seed, grid, device)
    t2 = time.perf_counter()
    system.warm_up(pool[0])
    setup_s = time.perf_counter() - T_START
    log(f"set-up {setup_s:.3f} s: imports and start {t0 - T_START:.3f}, system {t1 - t0:.3f} "
        f"(of it {built}), requests "
        f"{t2 - t1:.3f}, warm-up {T_START + setup_s - t2:.3f}; window of {seconds} s")

    prof = None
    if trace:
        seconds = min(seconds, float(traffic["trace_seconds"]))
        prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA])
        prof.start()
    w_start = time.time_ns()
    logged, window_s = serve_window(system, pool, seconds, device)
    w_end = time.time_ns()
    dtrace = None
    if prof is not None:
        t0 = time.perf_counter()
        prof.stop()
        dtrace = DeviceTrace(device_ops(prof), w_start, w_end)
        del prof
        log(f"trace of {len(dtrace.ops)} device operations read in "
            f"{time.perf_counter() - t0:.3f} s")
    found = spec.forbidden_modules()
    if found:
        raise SystemExit(f"loaded in the run: {', '.join(found)}")

    requests = [{"latency_s": x.latency_s, "n_rhs": x.req.n_rhs, "ok": x.out.ok, **x.out.counts}
                for x in logged]
    run = Run(setup_s, window_s, requests, dtrace, list(spans.items))
    metrics = {}
    for m in (cell.per_layer if trace else cell.end_to_end):
        v = cell.reader(m["name"])(run)
        if v is not None:
            metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    cuda = torch.device(device).type == "cuda"
    dev = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": cell.chips,
           "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)) if cuda else 0}
    attempted = sum(r["n_rhs"] for r in requests)
    failed = sum(r["n_rhs"] for r in requests if not r["ok"])
    log(f"{len(logged)} requests, {attempted} right-hand sides, {failed} failed, "
        f"window {window_s:.3f} s; counts of the first: {requests[0]}")

    # the comparison, once the program's state is freed
    chosen = check.sample(logged, cell.sample, seed)
    log("compared: " + "; ".join(f"pool request {x.req.index}, {x.out.counts}" for x in chosen))
    items = [(x.req, sut.to_canonical(system.perm, x.out.U.to(torch.float64))) for x in chosen]
    system.close()
    del logged, system
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
    t0 = time.perf_counter()
    numbers = check.compare(cell, grid, items, device)
    log(f"reference check of {len(items)} requests in {time.perf_counter() - t0:.3f} s")
    correct = all(v <= lim for v, lim in numbers.values())

    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": dev}
    if dtrace is not None:
        dev["busy_s"] = dtrace.busy_s
        dev["window_s"] = dtrace.window_s
        result["breakdown"] = {"device_ops": dtrace.top_ops(10),
                               "idle_gaps": dtrace.idle_gaps(run.spans, 10)}
    result["check"] = {k: {"value": v, "limit": lim} for k, (v, lim) in numbers.items()}
    return result


def card() -> str:
    """``nvidia-smi``'s name and power limit of the first card."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    except (OSError, IndexError, subprocess.TimeoutExpired) as e:
        return f"unknown ({e})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    found = spec.forbidden_modules()
    if found:
        log(f"loaded before the run: {', '.join(found)}")
        return 3
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        log(f"needs {cell.chips} CUDA device(s), found {n}")
        return 2
    torch.cuda.set_device(0)
    log(f"workload {cell.name}, seed {args.seed}")
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace))
    log(f"card: {card()}")
    found = spec.forbidden_modules()
    if found:
        log(f"loaded in the run: {', '.join(found)}")
        return 3
    for k, c in result["check"].items():
        log(f"check {k} {c['value']!r} limit {c['limit']!r}")
    log(f"correct {str(result['correct']).lower()}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
