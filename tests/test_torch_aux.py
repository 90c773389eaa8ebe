"""The port's auxiliary pieces: solver checkpoints and ``DDH(rhs_split=)``.

* ``utils/checkpoint.py``: the resume of ``tests/test_gmres.py::
  test_checkpoint_resume`` in both packages (float64), each package reading
  the other's file: the resumed solve continues from the saved iterate.
* ``rhs_split``: the port's ``DDH.rhs`` in float64 equals the JAX package's
  to 1e-12 for "full" and "mass"; and the port holds the checks of
  ``tests/test_ddh.py::test_ddh_mass_split_is_more_consistent`` (the mass
  split's solution is nearer the lumped global solution, within 0.09) and
  ``test_ddh_two_domain_interface_exact`` (a 2-strip partition with the
  mass split leaves a lumped-system residual below 5e-3 away from the
  interface-boundary corners).  The port's solves run on the transfer
  path (the same operator, probed once) to keep the CPU time small; the
  lumped global reference is a dense direct solve.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.solvers.ddh import DDH as JDDH
from cuddhelmholtz_tpu.solvers.gmres import gmres as jgmres
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu.utils.checkpoint import (
    load_solver_state as jload_solver_state,
    save_solver_state as jsave_solver_state,
)
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
from cuddhelmholtz_tpu_torch.ops.mass import lumped_mass_diagonal
from cuddhelmholtz_tpu_torch.ops.stiffness import apply_stiffness, make_stiffness_op
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.solvers.gmres import gmres
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis
from cuddhelmholtz_tpu_torch.utils.checkpoint import load_solver_state, save_solver_state

torch.set_num_threads(1)
NX = 8
OMEGA = 2 * np.pi * NX / 10


def test_checkpoint_resume(tmp_path):
    """Save the iterate of a stopped solve, resume with x0 in both packages
    (each from the other's file): the resumed solves converge to x_true,
    start from the saved residual level and agree with each other."""
    n = 512
    rng = np.random.default_rng(9)
    x_true = rng.standard_normal(n)

    def jmatvec(v):
        return 2.0 * v - 0.4 * jnp.roll(v, 1) + 0.3 * jnp.roll(v, -1)

    def matvec(v):
        return 2.0 * v - 0.4 * torch.roll(v, 1) + 0.3 * torch.roll(v, -1)

    b = matvec(torch.as_tensor(x_true))
    partial = gmres(matvec, b, m=5, maxit=3, tol=1e-12)
    jpartial = jgmres(jmatvec, jnp.asarray(b.numpy()), m=5, maxit=3, tol=1e-12)
    assert not partial.success and not bool(jpartial.success)
    assert np.allclose(partial.x.numpy(), np.asarray(jpartial.x), rtol=0, atol=1e-12)

    path, jpath = str(tmp_path / "port" / "ckpt.npz"), str(tmp_path / "jax.npz")
    save_solver_state(path, partial.x, res_norm=partial.res_norm, omega=1.5, tag=7)
    jsave_solver_state(jpath, jpartial.x, res_norm=jpartial.res_norm, omega=1.5, tag=7)
    state, jstate = jload_solver_state(path), load_solver_state(jpath)
    for s in (state, jstate):
        assert float(s["omega"]) == 1.5 and int(s["tag"]) == 7
    assert np.array_equal(load_solver_state(path)["x"], partial.x.numpy())

    resumed = gmres(matvec, b, x0=torch.as_tensor(jstate["x"]), m=5, maxit=100, tol=1e-10)
    jresumed = jgmres(jmatvec, jnp.asarray(b.numpy()), x0=jnp.asarray(state["x"]), m=5,
                      maxit=100, tol=1e-10)
    assert resumed.success and bool(jresumed.success)
    assert (resumed.num_iter, resumed.num_matvec) == (int(jresumed.num_iter),
                                                      int(jresumed.num_matvec))
    err = float(np.linalg.norm(resumed.x.numpy() - x_true) / np.linalg.norm(x_true))
    assert err < 1e-8
    h0 = float(resumed.res_norm[0])
    hp = float(partial.res_norm[partial.n_hist - 1])
    assert abs(h0 - hp) < 1e-5 * max(1.0, hp)


def _port_space():
    mesh = Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    return mesh, H1Space(mesh, Basis(4))


def _gaussian(xy):
    r = (xy[..., 0] + 0.3) ** 2 + (xy[..., 1] - 0.2) ** 2
    return torch.exp(-r / (2 * 0.2**2))


def _lumped_parts(mesh, fem, a_nodal):
    """The lumped global discretisation of ``tests/test_ddh.py``: the
    GLL-collocated stiffness, the lumped a^2 mass and the boundary face
    mass, as dense float64 arrays."""
    n = fem.ndof
    stiff = make_stiffness_op(fem, quad=fem.basis.quadrature, device="cpu")
    S = np.stack([apply_stiffness(stiff, torch.eye(n, dtype=torch.float64)[i]).numpy()
                  for i in range(n)], axis=1)
    fs = FaceSpace(fem, mesh.boundary_edges)
    Hb = np.zeros(n)
    edge_meas = 0.5 * mesh.edge_lengths()
    qw = fem.basis.quadrature.w
    for i, e in enumerate(fs.faces):
        np.add.at(Hb, fs.proj[fs.face_dofs[i]], edge_meas[e] * qw)
    return S, lumped_mass_diagonal(fem), Hb, fs


def _lumped_solution(S, mlump, Hb, a_nodal, b):
    """Dense direct solve of the lumped coupled system."""
    m, H, w2 = np.diag(mlump * a_nodal**2), np.diag(Hb * a_nodal), OMEGA * OMEGA
    A = np.block([[S - w2 * m, -OMEGA * H], [-OMEGA * H, -(S - w2 * m)]])
    return np.linalg.solve(A, b)


@pytest.fixture(scope="module")
def setup():
    mesh, fem = _port_space()
    a_nodal = np.ones(fem.ndof)
    b = helmholtz_rhs(fem, _gaussian)
    S, mlump, Hb, fs = _lumped_parts(mesh, fem, a_nodal)
    return mesh, fem, a_nodal, b, (S, mlump, Hb, fs)


@pytest.mark.parametrize("split", ["full", "mass"])
def test_rhs_split_matches_jax(split):
    jmesh = JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    jfem = JH1Space(jmesh, JBasis(4))
    _, fem = _port_space()
    a = 1.0 + 0.3 * np.random.default_rng(0).random(fem.ndof)
    f = np.random.default_rng(1).standard_normal(2 * fem.ndof)
    kw = dict(nx=NX, ny=NX, block_size=8, rhs_split=split)
    want = np.asarray(JDDH(OMEGA, a, jfem, dtype=jnp.float64, **kw).rhs(jnp.asarray(f)))
    got = DDH(OMEGA, a, fem, device="cpu", dtype=torch.float64, **kw).rhs(torch.as_tensor(f))
    assert np.abs(got.numpy() - want).max() < 1e-12 * np.abs(want).max()


def _solve(ddh, b, tol, maxit):
    out = gmres(ddh.action, ddh.rhs(b), m=20, maxit=maxit, tol=tol)
    assert out.success
    return ddh.postprocess(out.x, b).numpy()


def test_mass_split_is_more_consistent(setup):
    """``test_ddh_mass_split_is_more_consistent``: the mass split roughly
    halves the interface defect against the lumped global solution."""
    mesh, fem, a_nodal, b, (S, mlump, Hb, _) = setup
    xd = _lumped_solution(S, mlump, Hb, a_nodal, b.numpy())
    rels = {}
    full = DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX, device="cpu")
    T_u = full.precompute_transfer()
    for split in ("full", "mass"):
        ddh = full if split == "full" else DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX,
                                               rhs_split="mass", device="cpu")
        ddh.set_transfer(T_u, full._T_groups)  # T does not depend on the split
        U = _solve(ddh, b, 1e-5, 40)
        rels[split] = np.linalg.norm(U - xd) / np.linalg.norm(xd)
    assert rels["mass"] < rels["full"]
    assert rels["mass"] < 0.09, rels


def test_two_domain_interface_exact(setup):
    """``test_ddh_two_domain_interface_exact``: two strips of 4 x 8
    elements, the mass split, wh_maxit 12: the lumped-system residual away
    from the interface-boundary corners is below 5e-3."""
    mesh, fem, a_nodal, b, (S, mlump, Hb, fs) = setup
    i = np.arange(NX)
    II, _ = np.meshgrid(i, i, indexing="ij")
    labels = (II // 4).T.reshape(-1)
    ddh = DDH(OMEGA, a_nodal, fem, element_labels=labels, wh_maxit=12, rhs_split="mass",
              device="cpu")
    ddh.precompute_transfer()
    U = _solve(ddh, b, 1e-6, 100)
    n = fem.ndof
    u, v = U[:n], U[n:]
    bn = b.numpy()
    ru = S @ u - OMEGA**2 * mlump * a_nodal**2 * u - OMEGA * Hb * a_nodal * v - bn[:n]
    gI = ddh._gI_np
    counts = np.zeros(n, int)
    for p in range(ddh.n_domains):
        counts[gI[p][gI[p] >= 0]] += 1
    bdry = np.zeros(n, bool)
    bdry[fs.proj] = True
    clean = ~((counts > 1) & bdry)
    assert np.linalg.norm(ru[clean]) / np.linalg.norm(bn[:n]) < 5e-3
