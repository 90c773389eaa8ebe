"""Configuration kind "helmholtz_ddh": the coupled system of upstream
``examples/Helmholtz.cpp``, solved per right-hand side by the port's public
hook ``models/inverse.py::ddh_solve_hook`` (FGMRES right-preconditioned by
one bounded float32 DDH solve) on ``apply_helmholtz``, with the grid
numbering of ``run_helmholtz_ddh``.  Traffic "rhs" only.
"""

from __future__ import annotations

import torch

from benchmark.system import Outcome, build_ddh, sync, to_program
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import (
    apply_helmholtz,
    make_helmholtz_op,
    project_coefficients,
)
from cuddhelmholtz_tpu_torch.models.inverse import ddh_solve_hook
from cuddhelmholtz_tpu_torch.ops.structured import GridH1Space
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace
from cuddhelmholtz_tpu_torch.utils.basis import Basis


class System:
    def __init__(self, cell, grid, device, spans, dtype=torch.float64):
        if cell.traffic["request"] != "rhs":
            raise ValueError("the composite solve serves one right-hand side per request")
        c, self.device, self.spans, self.dtype = cell.config, device, spans, dtype
        nx = c["nx"]
        mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
        fem = GridH1Space(mesh, Basis(c["deg"] + 1), nx, nx)
        fs = FaceSpace(fem, mesh.boundary_edges)
        self.perm = torch.as_tensor(grid.match(fem.coords), device=device)
        a2, af = project_coefficients(fem, fs, cell.speed)
        self.op = make_helmholtz_op(c["omega"], a2, af, fem, fs, dtype=dtype, device=device)
        xy = torch.as_tensor(grid.coords(), device=device)
        a = cell.speed(xy)[self.perm].cpu().numpy()
        self.ddh = build_ddh(c, a, fem, device, spans)[0]
        o, i = c["solver"], c["precond"]
        self.hook = ddh_solve_hook(self.ddh, m=o["m"], maxit=o["maxit"], tol=o["tol"],
                                   inner_m=i["m"], inner_maxit=i["maxit"])

    def matvec(self, U: torch.Tensor) -> torch.Tensor:
        return apply_helmholtz(self.op, U)

    def serve(self, req) -> Outcome:
        b = to_program(self.perm, req.b).to(self.dtype)
        calls = self.hook.precond.calls
        t = self.spans.now()
        U = self.hook(self.matvec, b)
        sync(self.device)
        self.spans.add("solve", t)
        res = self.hook.results[-1]
        return Outcome(U=U, ok=bool(res.success),
                       counts={"precond": self.hook.precond.calls - calls,
                               "matvecs": res.num_matvec, "restarts": res.num_iter})

    def warm_up(self, req, n_precond: int = 3) -> None:
        """A few applications of P and of the operator on the request's
        shapes; no whole 1e-6 solve."""
        v = to_program(self.perm, req.b).to(self.dtype)
        for _ in range(n_precond):
            self.hook.precond(v)
            self.matvec(v)
        sync(self.device)
        self.hook.precond.calls = 0
        self.spans.items.clear()

    def close(self) -> None:
        self.op = self.ddh = self.hook = None
