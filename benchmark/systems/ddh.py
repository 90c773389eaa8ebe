"""Configuration kind "ddh": the substructured DDH solve of upstream
``examples/DDH.cpp`` as ``examples/drivers.py::run_ddh`` runs it:
``DDH(...)``, ``prepare`` (with ``"transfer": true``), then
``ddh.solver(m, maxit, tol, **options)`` on one forcing or a block of them.

Traffic "rhs" and "batch" build the operator in set-up; "model" builds a new
one for every request, on the request's wave-speed model.
"""

from __future__ import annotations

import torch

from benchmark.system import Outcome, build_ddh, solver_options, sync, to_program
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis


class System:
    def __init__(self, cell, grid, device, spans):
        config, traffic = cell.config, cell.traffic
        self.cfg, self.kind, self.device, self.spans = config, traffic["request"], device, spans
        nx = config["nx"]
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        self.fem = H1Space(mesh, Basis(config["deg"] + 1))
        self.perm = torch.as_tensor(grid.match(self.fem.coords), device=device)
        self.solver_args, self.solver_kw = solver_options(config, traffic)
        self.ddh = None
        if self.kind != "model":
            xy = torch.as_tensor(grid.coords(), device=device)
            self.ddh = self.operator(cell.speed(xy))[0]
            self.solve = self.ddh.solver(*self.solver_args, **self.solver_kw)

    def operator(self, a_can: torch.Tensor):
        """The configuration's DDH on the canonical nodal model ``a_can``."""
        a = a_can[self.perm].cpu().numpy()
        return build_ddh(self.cfg, a, self.fem, self.device, self.spans)

    def serve(self, req) -> Outcome:
        counts = {}
        if self.kind == "model":
            ddh, counts = self.operator(req.a)
            solve = ddh.solver(*self.solver_args, **self.solver_kw)
        else:
            solve = self.solve
        b = to_program(self.perm, req.b)
        t = self.spans.now()
        out, U = solve(b)
        sync(self.device)
        self.spans.add("solve", t)
        K = req.n_rhs
        ok = bool(torch.as_tensor(out.success).all())
        counts.update(matvecs=out.num_matvec // K if self.kind == "batch" else out.num_matvec,
                      restarts=out.num_iter)
        if self.kind != "batch":  # the residual the solve stopped at, relative to its start
            counts["stop_res"] = float(out.res_norm[out.n_hist - 1] / out.res_norm[0])
        return Outcome(U=U, ok=ok, counts=counts)

    def warm_up(self, req) -> None:
        self.serve(req)
        self.spans.items.clear()

    def close(self) -> None:
        self.ddh = self.solve = None
