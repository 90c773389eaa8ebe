"""residual: the true relative residual ||b - A U|| / ||b|| of each compared
request, A the coupled Helmholtz operator assembled in float64 by the plain
reference (``reference/helmholtz.py``); the reading is the largest."""

from benchmark.reference.helmholtz import ReferenceHelmholtz


def reading(cell, grid, items, device) -> float:
    ref = ReferenceHelmholtz(grid, cell.config["omega"], cell.speed, device)
    return max(ref.residual(U, req.b) for req, U in items)
