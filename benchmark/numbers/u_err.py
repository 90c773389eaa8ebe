"""u_err: for the compared requests, the relative distance
||U - U_ref|| / ||U_ref|| of each solution from the plain reference DDH solve
(``cell.reference``: ``reference/ddh.py`` unless the configuration names
another) of the same forcing and, for a "model" request, the same wave-speed
model, to the configuration's ``reference_tol``; the reading is the
largest."""

import sys

import torch


def reading(cell, grid, items, device) -> float:
    """``items`` are (request, canonical U) pairs."""
    c = cell.config
    xy = torch.as_tensor(grid.coords(), device=device)
    shared = None
    worst = 0.0
    for req, U in items:
        ref = shared if req.a is None else None
        if ref is None:
            a = cell.speed(xy) if req.a is None else req.a
            ref = cell.reference(grid, a.cpu().numpy(), device, torch.float64)
            if req.a is None:
                shared = ref
        b = req.b.reshape(-1, req.b.shape[-1])
        Uref = ref.solve(b, tol=c["reference_tol"])
        err = (U.reshape(Uref.shape) - Uref).norm(dim=1) / Uref.norm(dim=1)
        print(f"[bench] u_err of pool request {req.index}: {err.tolist()}", file=sys.stderr)
        worst = max(worst, float(err.max()))
    return worst
