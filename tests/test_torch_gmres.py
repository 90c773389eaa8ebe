"""The port's GMRES(m) against the JAX package's, on the same inputs.

Two systems: the nonsymmetric Toeplitz oracle of ``tests/test_gmres.py`` and
the DDH lambda system (``test_ddh_oracle.py``'s history check, m=10,
maxit=4).  Restart and matvec counts must be equal (the counting rules are
part of the port); residual histories agree to rtol 2e-3 in float32 (as
``test_ddh_oracle.py`` compares them: Krylov vectors drift apart in
round-off) and in float64 to rtol 1e-6 plus 1e-13 of the initial residual
(a true residual b - A x carries round-off of order eps * ||b||).
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
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.solvers.gmres import gmres
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis


def toeplitz_np(x):
    """Nonsymmetric tridiagonal Toeplitz: diag -3, sub 1.0, super 1.5."""
    y = -3.0 * x
    y[1:] += 1.0 * x[:-1]
    y[:-1] += 1.5 * x[1:]
    return y


def toeplitz_jax(x):
    return -3.0 * x + jnp.pad(1.0 * x[:-1], (1, 0)) + jnp.pad(1.5 * x[1:], (0, 1))


def toeplitz_torch(x):
    y = -3.0 * x
    y[1:] += 1.0 * x[:-1]
    y[:-1] += 1.5 * x[1:]
    return y


def _same_run(got, want, rtol, atol_rel=0.0):
    assert got.success == bool(want.success)
    assert got.num_iter == int(want.num_iter)
    assert got.num_matvec == int(want.num_matvec)
    assert got.n_hist == int(want.n_hist)
    h, hw = got.res_norm.numpy(), np.asarray(want.res_norm)
    assert np.isnan(h[got.n_hist:]).all() and np.isfinite(h[: got.n_hist]).all()
    np.testing.assert_allclose(h[: got.n_hist], hw[: got.n_hist], rtol=rtol, atol=atol_rel * hw[0])


@pytest.mark.parametrize(
    "dtype,tol,m,rtol",
    [("float64", 1e-10, 5, 1e-6), ("float32", 1e-5, 5, 2e-3), ("float64", 1e-10, 10, 1e-6)],
)
def test_toeplitz_matches_jax(dtype, tol, m, rtol):
    n = 512
    b = toeplitz_np(np.random.default_rng(42).standard_normal(n)).astype(dtype)
    want = jgmres(toeplitz_jax, jnp.asarray(b), m=m, maxit=100, tol=tol)
    got = gmres(toeplitz_torch, torch.from_numpy(b), m=m, maxit=100, tol=tol)
    _same_run(got, want, rtol, 1e-13 if dtype == "float64" else 0.0)
    res = np.linalg.norm(toeplitz_np(got.x.numpy()) - b) / np.linalg.norm(b)
    assert res < tol * 1.01


def test_exact_in_one_restart_and_restart_budget():
    """Full GMRES(n) exits early inside the first restart; a tiny tol runs
    exactly maxit - 1 restarts."""
    n = 24
    rng = np.random.default_rng(3)
    A = rng.standard_normal((n, n)) + 4.0 * np.eye(n)
    x_true = rng.standard_normal(n)
    b = A @ x_true
    At = torch.from_numpy(A)
    out = gmres(lambda v: At @ v, torch.from_numpy(b), m=n, maxit=2, tol=1e-12)
    want = jgmres(lambda v: jnp.asarray(A) @ v, jnp.asarray(b), m=n, maxit=2, tol=1e-12)
    _same_run(out, want, 1e-6, 1e-13)
    assert np.linalg.norm(out.x.numpy() - x_true) < 1e-8
    bt = toeplitz_np(rng.standard_normal(64))
    out = gmres(toeplitz_torch, torch.from_numpy(bt), m=2, maxit=5, tol=1e-30)
    want = jgmres(toeplitz_jax, jnp.asarray(bt), m=2, maxit=5, tol=1e-30)
    _same_run(out, want, 1e-6, 1e-13)
    assert out.num_iter == 4 and out.num_matvec == 1 + 4 * 3 and not out.success


def test_zero_initial_residual():
    b = torch.zeros(50, dtype=torch.float64)
    b[0] = 1.0
    out = gmres(lambda v: 2.0 * v, b, b / 2.0, m=5, maxit=10, tol=1e-12)
    assert out.success and out.num_iter == 0 and out.num_matvec == 1


def test_lambda_system_matches_jax():
    nx, deg = 8, 3
    omega = 2 * np.pi * nx / 2.5  # nt = 200 (test_ddh_oracle.py)
    jfem = JH1Space(JMesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), JBasis(deg + 1))
    a_nodal = 1.0 + 0.3 * np.random.default_rng(0).random(jfem.ndof)
    jddh = JDDH(omega, a_nodal, jfem, nx=nx, ny=nx, block_size=8)
    fem = H1Space(Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), Basis(deg + 1))
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=8, device="cpu")

    def f(xy):
        r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
        return omega**2 * torch.exp(-(omega**2) * r)

    Y = ddh.rhs(helmholtz_rhs(fem, f))
    want = jgmres(jddh.action, jnp.asarray(Y.numpy()), m=10, maxit=4, tol=1e-6)
    got = gmres(ddh.action, Y, m=10, maxit=4, tol=1e-6)
    _same_run(got, want, 2e-3)
    assert got.num_matvec == 1 + 3 * 11
