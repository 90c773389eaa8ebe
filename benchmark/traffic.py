"""The one traffic generator: a pool of requests from a mix's parameters and
the seed.

A mix file (``traffic/<mix>.json``) gives the request kind and its sizes:

* ``"request": "rhs"``: one new right-hand side per request;
* ``"request": "batch"``: ``batch`` right-hand sides solved together;
* ``"request": "model"``: a new wave-speed model (the configuration's model
  times 1 + ``bump_scale`` x a mean of smooth seeded bumps) and one
  right-hand side on it.

Every right-hand side is the collocated load of a sum of Gaussian point
sources of the configuration's width 1/omega.  The pool is the same list of
sizes for every seed: the counts of sources run through their range in equal
shares, and the sources sit at fixed sites (a Halton sequence over
[-extent, extent]^2), since how hard a right-hand side is depends on where
its sources are.  The seed moves each source within ``jitter`` of its site,
draws its amplitude and sign, draws the models' bumps, and orders the pool.
Requests are served round-robin from the pool in a closed loop.  Everything
is made on the device from the seed, at the nodes and with the lumped mass
of the cell's grid (``cell.grid()``, the protocol in ``spec.py``), in its
canonical numbering.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from .reference.grid import bumped_speed, gaussians


@dataclass
class Request:
    index: int  # position in the pool
    b: torch.Tensor  # (2 ndof,) or (batch, 2 ndof) float64 forcings, canonical numbering
    n_rhs: int
    a: torch.Tensor | None = None  # (ndof,) nodal wave-speed model of a "model" request
    model: dict | None = None  # its parameters, for the reference


def _counts(rng, lo: int, hi: int, n: int) -> np.ndarray:
    """n counts from lo..hi in equal shares, in a seeded order."""
    base = np.resize(np.arange(lo, hi + 1), n)
    return rng.permutation(base)


def halton(n: int) -> np.ndarray:
    """The first n points of the Halton sequence in bases 2 and 3, (n, 2) in
    [0, 1)^2."""
    out = np.zeros((n, 2))
    for j, base in enumerate((2, 3)):
        for i in range(n):
            f, k, x = 1.0, i + 1, 0.0
            while k:
                f /= base
                x += f * (k % base)
                k //= base
            out[i, j] = x
    return out


def make_pool(cell, seed: int, grid, device) -> list[Request]:
    traffic, config = cell.traffic, cell.config
    rng = np.random.default_rng(seed)
    kind, n = traffic["request"], int(traffic["pool"])
    omega = float(config["omega"])
    xy = torch.as_tensor(grid.coords(), device=device)
    m = torch.as_tensor(grid.lumped_mass(), device=device)
    ext = float(traffic["extent"])
    lo, hi = traffic["sources"]
    alo, ahi = traffic["amplitude"]
    per = int(traffic.get("batch", 1))
    counts = np.resize(np.arange(lo, hi + 1), n * per).reshape(n, per)
    first = np.concatenate([[0], np.cumsum(counts.reshape(-1))])
    sites = ext * (2.0 * halton(int(first[-1])) - 1.0)
    jit = float(traffic["jitter"])

    def rhs(k: int) -> torch.Tensor:
        site = sites[first[k]:first[k + 1]]
        c = np.clip(site + rng.uniform(-jit, jit, site.shape), -ext, ext)
        ns = len(site)
        amp = rng.uniform(alo, ahi, ns) * rng.choice([-1.0, 1.0], ns)
        bu = m * gaussians(xy, torch.as_tensor(c, device=device),
                           torch.as_tensor(amp, device=device), omega)
        return torch.cat([bu, torch.zeros_like(bu)])

    if kind == "model":
        base = cell.speed(xy)
        blo, bhi = traffic["bumps"]
        nbumps = _counts(rng, blo, bhi, n)
    pool = []
    for i in rng.permutation(n):
        b = torch.stack([rhs(i * per + j) for j in range(per)])
        req = Request(index=len(pool), b=b[0] if kind != "batch" else b, n_rhs=per)
        if kind == "model":
            nbk = int(nbumps[i])
            wlo, whi = traffic["bump_width"]
            req.model = {
                "centers": rng.uniform(-1.0, 1.0, (nbk, 2)),
                "amps": rng.uniform(-1.0, 1.0, nbk),
                "widths": rng.uniform(wlo, whi, nbk),
                "scale": float(traffic["bump_scale"]),
            }
            req.a = model_speed(req.model, xy, base)
        pool.append(req)
    return pool


def model_speed(model: dict, xy: torch.Tensor, base: torch.Tensor) -> torch.Tensor:
    """The nodal wave-speed model of a "model" request at points ``xy``: the
    configuration's model ``base`` there, bumped."""
    t = {k: torch.as_tensor(model[k], device=xy.device, dtype=xy.dtype)
         for k in ("centers", "amps", "widths")}
    return bumped_speed(base, xy, t["centers"], t["amps"], t["widths"], model["scale"])
