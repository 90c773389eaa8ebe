"""The DDH's direct path against the plain reference, on the CPU.

The direct path is upstream's DDH as written: no ``prepare``, and every
``action``, ``rhs`` and ``postprocess`` runs one wave cycle.  The reference
is ``benchmark/reference/ddh.py``: a float64 transliteration of upstream
``DDH.cpp`` in plain torch, independent of the port, which probes the
transfer map of each subdomain and solves the same substructured system.

Each case is a seeded smooth model (the upstream disc times 1 + 0.1 x a mean
of 2-6 Gaussian bumps, as the benchmark's model traffic draws them) and a
seeded forcing of 1-4 Gaussian sources, at nx 8 and 16 with 16 x 16-DOF
subdomains (4 and 16 of them), degree 3.  omega = 2 pi nx keeps a period
at 80 leapfrog steps: at the benchmark's 2 pi nx / 10 it is 800, and one
float64 direct solve takes minutes on the CPU.  The waves are then shorter
than an element outside the disc: the tests hold the algebra of the two
solves to each other, not the discretisation to the physics.  Two
WaveHoltz iterations, so that the cycle's restart from the last iterate
runs (five take 3x the matvecs at 2.5x the cost each).

The counter ``ddh.action.direct`` counts each direct apply once (a solve's
count is its ``num_matvec``); ``test_torch_action_graph.py`` holds a
transfer-path apply to counting ``ddh.action.eager`` alone.
"""

import math

import numpy as np
import pytest
import torch

from benchmark.reference.ddh import ReferenceDDH
from benchmark.reference.grid import Grid, bumped_speed, disc_speed, gaussians
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils import spans
from cuddhelmholtz_tpu_torch.utils.basis import Basis

torch.set_num_threads(1)

DEG, BLOCK, WH_MAXIT = 3, 16, 2
COUNTERS = "ddh.action."
# Both solves stop at a relative residual of 1e-11 on the same lambda-system;
# what that leaves, through the system's conditioning at these sizes, and
# float64 round-off stay far below 1e-9 (2.1e-11 at most when written).
TOL_F64 = 1e-9
# The float32 solve stops at the configuration's 1e-4 relative residual
# (GMRES(20)); the lambda error that leaves is at most the system's
# condition number times 1e-4, and the solution inherits it through the
# postprocess: 2e-3 bounds it with room at these sizes (9.8e-5 at most when
# written).  The card's TF32 control, not this test, holds the precision.
TOL_F32 = 2e-3


def omega(nx: int) -> float:
    return 2 * math.pi * nx


def case(nx: int, seed: int):
    """The seed's canonical grid, nodal model and (2 ndof,) forcing."""
    g = Grid(nx, DEG)
    xy = torch.as_tensor(g.coords())
    rng = np.random.default_rng([nx, seed])
    nb = int(rng.integers(2, 7))
    a = bumped_speed(disc_speed(xy), xy, torch.as_tensor(rng.uniform(-1.0, 1.0, (nb, 2))),
                     torch.as_tensor(rng.uniform(-1.0, 1.0, nb)),
                     torch.as_tensor(rng.uniform(0.35, 0.7, nb)), 0.1)
    ns = int(rng.integers(1, 5))
    amps = rng.uniform(0.5, 1.5, ns) * rng.choice([-1.0, 1.0], ns)
    fu = torch.as_tensor(g.lumped_mass()) * gaussians(
        xy, torch.as_tensor(rng.uniform(-0.8, 0.8, (ns, 2))), torch.as_tensor(amps), omega(nx))
    return g, a.numpy(), torch.cat([fu, torch.zeros_like(fu)])


_REF: dict = {}


def reference(nx: int, seed: int):
    """(grid, model, forcing, the reference's canonical U to 1e-11), once a
    case."""
    if (nx, seed) not in _REF:
        g, a, b = case(nx, seed)
        ref = ReferenceDDH(g, omega(nx), a, BLOCK, WH_MAXIT, "cpu")
        _REF[nx, seed] = g, a, b, ref.solve(b[None], tol=1e-11)[0]
    return _REF[nx, seed]


def direct_ddh(g: Grid, a: np.ndarray, dtype=torch.float32):
    """The port's DDH on the direct path (no ``prepare``) and the numbering
    ``perm`` (the canonical id of each of its nodes)."""
    nx = g.nx
    fem = H1Space(Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0), Basis(DEG + 1))
    perm = torch.as_tensor(g.match(fem.coords))
    ddh = DDH(omega(nx), a[perm.numpy()], fem, nx=nx, ny=nx, wh_maxit=WH_MAXIT,
              block_size=BLOCK, device="cpu", dtype=dtype)
    assert not ddh.use_transfer
    return ddh, perm


def solve_canonical(ddh, perm, b, m: int, maxit: int, tol: float):
    """The port's solve of the canonical forcing ``b``: (result, canonical U)."""
    n = len(perm)
    out, U = ddh.solver(m, maxit, tol)(torch.cat([b[:n][perm], b[n:][perm]]))
    Uc = torch.zeros(2 * n, dtype=torch.float64)
    Uc[perm], Uc[n + perm] = U[:n].double(), U[n:].double()
    return out, Uc


def rel(U, Uref) -> float:
    return float((U - Uref).norm() / Uref.norm())


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("nx", [8, 16])
def test_float64_direct_solve_matches_the_reference(nx, seed):
    g, a, b, Uref = reference(nx, seed)
    ddh, perm = direct_ddh(g, a, torch.float64)
    out, U = solve_canonical(ddh, perm, b, 200, 5, 1e-11)
    assert bool(out.success)
    assert rel(U, Uref) <= TOL_F64


@pytest.mark.parametrize("nx", [8, 16])
def test_float32_direct_solve_to_1e_4_is_near_the_reference(nx):
    g, a, b, Uref = reference(nx, 0)
    ddh, perm = direct_ddh(g, a)
    out, U = solve_canonical(ddh, perm, b, 20, 100, 1e-4)
    assert bool(out.success)
    assert rel(U, Uref) <= TOL_F32


def test_each_direct_apply_is_counted_once():
    g, a, b = case(8, 3)
    ddh, perm = direct_ddh(g, a)
    spans.reset(COUNTERS)
    lam = torch.randn(3, ddh.size, generator=torch.Generator().manual_seed(0))
    ddh.action(lam[0])
    ddh.action(lam)  # a block of three is one apply
    assert spans.totals(COUNTERS) == {"direct": 2}
    spans.reset(COUNTERS)
    out, _ = solve_canonical(ddh, perm, b, 20, 100, 1e-4)
    assert spans.totals(COUNTERS) == {"direct": out.num_matvec}

