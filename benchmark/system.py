"""What every system under test shares: the benchmark's spans, the outcome of
a request, the numbering between the program and the canonical grid, and
the DDH operator built as a configuration states it.

A configuration's ``kind`` names its system, ``systems/<kind>.py``, whose
``System(cell, grid, device, spans)`` has ``serve(request) -> Outcome``,
``warm_up(request)``, ``close()`` and ``perm`` (the canonical id of each of
the program's nodes).  The systems are the only modules of the benchmark
that import the program (``cuddhelmholtz_tpu_torch``), and they take from it
only the system under test and its counters.

The DDH is built as ``examples/drivers.py::run_ddh`` builds it: ``DDH(...)``
with the configuration's ``ddh_options``; with ``"transfer": true``,
``prepare`` with its ``prepare`` options; with ``make_coarse``, the
two-level coarse space.  The set-up cache stays off
(``prepare(cache_dir="")``): every run builds its operator as a user's first
run does and writes nothing.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np
import torch

from cuddhelmholtz_tpu_torch.solvers.ddh import DDH


@dataclass
class Outcome:
    """What one request produced and counted."""

    U: torch.Tensor  # (2 ndof,) or (K, 2 ndof), the program's numbering
    ok: bool  # every right-hand side reached its tolerance
    counts: dict = field(default_factory=dict)


class Spans:
    """The benchmark's own spans, (name, start_ns, end_ns) on the epoch clock
    that the profiler stamps device events with."""

    def __init__(self):
        self.items: list = []

    def now(self) -> int:
        return time.time_ns()

    def add(self, name: str, start_ns: int) -> int:
        end = time.time_ns()
        self.items.append((name, start_ns, end))
        return end


def sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def build_ddh(config: dict, a: np.ndarray, space, device, spans: Spans,
              partition: tuple | None = None) -> tuple[DDH, dict]:
    """The configuration's DDH on the nodal model ``a`` (the program's
    numbering), each step in a span; returns it and what building it
    counted.  Its subdomains are the configuration's square blocks of
    ``block_size`` DOFs on the ``nx`` x ``nx`` grid, or the system's
    ``partition``: ``(element_labels, n_domains)`` of the space's mesh."""
    c = config
    if partition is None:
        where = {"nx": c["nx"], "ny": c["nx"], "block_size": c["block_size"]}
    else:
        where = {"element_labels": partition[0], "n_domains": partition[1]}
    t0 = spans.now()
    ddh = DDH(c["omega"], a, space, wh_maxit=c["wh_maxit"], device=device, **where,
              **c.get("ddh_options", {}))
    t = spans.add("DDH()", t0)
    counts = {"ctor_s": (t - t0) / 1e9}
    if c["transfer"]:
        stats = ddh.prepare(cache_dir="", **c.get("prepare", {}))
        sync(device)
        t1 = spans.add("prepare", t)
        counts.update(prepare_s=(t1 - t) / 1e9, unique_domains=stats.get("transfer_nu"),
                      io_maps=ddh.io is not None)
        t = t1
    if "make_coarse" in c:
        ddh.make_coarse(**c["make_coarse"])
        sync(device)
        counts["coarse_s"] = (spans.add("make_coarse", t) - t) / 1e9
    return ddh, counts


def solver_options(config: dict, traffic: dict) -> tuple[tuple, dict]:
    """``(m, maxit, tol)`` and the other keyword options of ``DDH.solver``:
    the configuration's ``solver``, with the mix's ``solver`` over it."""
    solver = dict(config["solver"], **traffic.get("solver", {}))
    args = (solver.pop("m"), solver.pop("maxit"), solver.pop("tol"))
    return args, solver


def to_program(perm: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """A canonical [u; v] (..., 2 n) in the program's numbering, where
    ``perm[i]`` is the canonical id of the program's node i."""
    n = len(perm)
    return torch.cat([b[..., :n][..., perm], b[..., n:][..., perm]], dim=-1)


def to_canonical(perm: torch.Tensor, U: torch.Tensor) -> torch.Tensor:
    """A program-numbered [u; v] (..., 2 n) in the canonical numbering."""
    n = len(perm)
    out = U.new_zeros(U.shape)
    out[..., perm] = U[..., :n]
    out[..., n + perm] = U[..., n:]
    return out
