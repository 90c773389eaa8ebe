"""The plain references agree with the program where both are exact: the
DDH solve in float64 to a tight tolerance, and the coupled operator.  The
references import nothing of the program; these tests may."""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.ddh import ReferenceDDH
from benchmark.reference.grid import Grid, disc_speed, gaussians
from benchmark.reference.helmholtz import ReferenceHelmholtz
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import (
    apply_helmholtz,
    make_helmholtz_op,
    project_coefficients,
)
from cuddhelmholtz_tpu_torch.ops.structured import GridH1Space
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

NX = 8
OMEGA = 2 * math.pi * NX / 10


def test_reference_ddh_matches_the_program_in_float64():
    g = Grid(NX, 3)
    xy = torch.as_tensor(g.coords())
    a = disc_speed(xy).numpy()
    fu = gaussians(xy, torch.tensor([[0.3, -0.2], [-0.5, 0.4]], dtype=torch.float64),
                   torch.tensor([1.0, -0.7], dtype=torch.float64), OMEGA).numpy()
    fu = fu * g.lumped_mass()
    Uref = ReferenceDDH(g, OMEGA, a, 16, 5, "cpu").solve(
        torch.as_tensor(np.concatenate([fu, 0 * fu]))[None], tol=1e-11)[0].numpy()
    mesh = Mesh2D.uniform_rect(NX, -1.0, 1.0, NX, -1.0, 1.0)
    fem = H1Space(mesh, Basis(4))
    perm = g.match(fem.coords)
    ddh = DDH(OMEGA, a[perm], fem, nx=NX, ny=NX, device="cpu", dtype=torch.float64)
    ddh.prepare(cache_dir="", want_io=False)
    _, U = ddh.solver(60, 200, 1e-11)(torch.as_tensor(np.concatenate([fu[perm], 0 * fu[perm]])))
    n = len(perm)
    Uc = np.zeros(2 * n)
    Uc[perm], Uc[n + perm] = U[:n].numpy(), U[n:].numpy()
    assert np.linalg.norm(Uc - Uref) <= 1e-9 * np.linalg.norm(Uref)


def test_reference_operator_matches_the_program():
    g = Grid(NX, 3)
    ref = ReferenceHelmholtz(g, OMEGA, disc_speed, "cpu")
    mesh = Mesh2D.uniform_rect(NX, -1.0, 1.0, NX, -1.0, 1.0)
    for fem in (GridH1Space(mesh, Basis(4), NX, NX), H1Space(mesh, Basis(4))):
        fs = FaceSpace(fem, mesh.boundary_edges)
        a2, af = project_coefficients(fem, fs, disc_speed)
        op = make_helmholtz_op(OMEGA, a2, af, fem, fs, device="cpu")
        perm = torch.as_tensor(g.match(fem.coords))
        n = len(perm)
        U = torch.randn(2 * n, dtype=torch.float64, generator=torch.Generator().manual_seed(0))
        Uc = torch.zeros_like(U)
        Uc[perm], Uc[n + perm] = U[:n], U[n:]
        Yc = ref.apply(Uc)
        Y = apply_helmholtz(op, U)
        assert float((torch.cat([Yc[:n][perm], Yc[n:][perm]]) - Y).norm() / Y.norm()) < 1e-12
