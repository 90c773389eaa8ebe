"""The port's GMRES variants, FGMRES and the two GMRES-driven examples
against the JAX package, on the same inputs.

Solvers: ``gmres`` with a left preconditioner, with single-pass CGS
(``reorth=False``) and in the deferred least-squares mode, and ``fgmres`` in
its standard and deferred modes, with a fixed and with a varying (inner
GMRES) right preconditioner, on the nonsymmetric Toeplitz system of
``tests/test_gmres.py``.  In float64 the restart and matvec counts must be
equal and the residual histories agree to rtol 1e-10 plus 1e-13 of the
initial residual (a true residual carries round-off of order eps * ||b||).
``run_poisson(nx=8)`` and ``run_helmholtz(nx=12, m=200, maxit=15)`` (15 of
the 45 restarts it needs to converge) give the JAX package's counts and
solutions (the latter unconverged) within 1e-8 relative; their histories
agree to rtol 1e-3 (the Krylov vectors of GMRES(200) on the indefinite
Helmholtz system drift apart in round-off: 8e-5 at most over 45 restarts).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.examples import drivers as jdrivers
from cuddhelmholtz_tpu.solvers.gmres import fgmres as jfgmres
from cuddhelmholtz_tpu.solvers.gmres import gmres as jgmres
from cuddhelmholtz_tpu_torch.examples.drivers import run_helmholtz, run_poisson
from cuddhelmholtz_tpu_torch.solvers.gmres import fgmres, gmres

torch.set_num_threads(1)

N = 512
HIST_RTOL, HIST_ATOL, SOL_TOL = 1e-10, 1e-13, 1e-8
DRIVER_HIST_RTOL = 1e-3
D = 1.0 + np.random.default_rng(5).random(N)  # diagonal of the fixed preconditioner


def toeplitz_jax(x):
    return -3.0 * x + jnp.pad(1.0 * x[:-1], (1, 0)) + jnp.pad(1.5 * x[1:], (0, 1))


def toeplitz_torch(x):
    y = -3.0 * x
    y[1:] += 1.0 * x[:-1]
    y[:-1] += 1.5 * x[1:]
    return y


def tridiag_jax(x):
    """The preconditioners' nearby operator (same diagonal, one band)."""
    return -3.0 * x + jnp.pad(1.5 * x[1:], (0, 1))


def tridiag_torch(x):
    y = -3.0 * x
    y[:-1] += 1.5 * x[1:]
    return y


def _rhs():
    return np.random.default_rng(42).standard_normal(N)


def _same_run(got, want):
    assert got.success == bool(want.success)
    assert got.num_iter == int(want.num_iter)
    assert got.num_matvec == int(want.num_matvec)
    assert got.n_hist == int(want.n_hist)
    h, hw = got.res_norm.numpy(), np.asarray(want.res_norm)
    assert np.isnan(h[got.n_hist:]).all()
    np.testing.assert_allclose(h[: got.n_hist], hw[: got.n_hist], rtol=HIST_RTOL,
                               atol=HIST_ATOL * hw[0])


@pytest.mark.parametrize("opts", [
    {"precond": True},
    {"precond": True, "reorth": False},
    {"reorth": False},
    {"deferred": True},
    {"deferred": True, "reorth": False},
    {"deferred": True, "precond": True},
])
def test_gmres_variants_match_jax(opts):
    opts = dict(opts)
    kw = dict(m=6, maxit=60, tol=1e-10)
    jkw, tkw = dict(kw), dict(kw)
    if opts.pop("precond", False):
        jkw["precond"] = lambda x: x / jnp.asarray(D)
        tkw["precond"] = lambda x: x / torch.from_numpy(D)
    b = _rhs()
    want = jgmres(toeplitz_jax, jnp.asarray(b), **jkw, **opts)
    got = gmres(toeplitz_torch, torch.from_numpy(b), **tkw, **opts)
    _same_run(got, want)
    assert got.success
    res = np.linalg.norm(toeplitz_torch(got.x).numpy() - b) / np.linalg.norm(b)
    assert res < 1e-9


def _inner_jax(v):
    return jgmres(tridiag_jax, v, m=3, maxit=2, tol=0.0).x


def _inner_torch(v):
    return gmres(tridiag_torch, v, m=3, maxit=2, tol=0.0).x


@pytest.mark.parametrize("deferred", [False, True])
@pytest.mark.parametrize("varying", [False, True])
def test_fgmres_matches_jax(deferred, varying):
    """Flexible GMRES with a fixed diagonal or a varying inner-GMRES right
    preconditioner."""
    if varying:
        jP, tP = _inner_jax, _inner_torch
    else:
        jP = lambda x: x / jnp.asarray(D)  # noqa: E731
        tP = lambda x: x / torch.from_numpy(D)  # noqa: E731
    b = _rhs()
    kw = dict(m=5, maxit=40, tol=1e-10, deferred=deferred)
    want = jfgmres(toeplitz_jax, jnp.asarray(b), jP, **kw)
    got = fgmres(toeplitz_torch, torch.from_numpy(b), tP, **kw)
    _same_run(got, want)
    assert got.success
    np.testing.assert_allclose(got.x.numpy(), np.asarray(want.x), rtol=0,
                               atol=SOL_TOL * np.abs(np.asarray(want.x)).max())


def test_fgmres_deferred_overshoots_to_restart_boundary():
    """The deferred mode runs whole restarts: every restart adds m + 1
    matvecs, where the standard mode stops inside the last one."""
    b = torch.from_numpy(_rhs())
    P = lambda x: x / torch.from_numpy(D)  # noqa: E731
    std = fgmres(toeplitz_torch, b, P, m=7, maxit=40, tol=1e-10)
    dfr = fgmres(toeplitz_torch, b, P, m=7, maxit=40, tol=1e-10, deferred=True)
    assert std.success and dfr.success and std.num_iter == dfr.num_iter
    assert dfr.num_matvec == 1 + dfr.num_iter * (7 + 1)
    assert std.num_matvec < dfr.num_matvec


def _same_driver(got, want):
    assert (got.num_iter, got.num_matvec, got.success) == (
        int(want.num_iter), int(want.num_matvec), bool(want.success))
    np.testing.assert_allclose(got.res_norm, want.res_norm, rtol=DRIVER_HIST_RTOL)
    assert np.array_equal(got.coords, want.coords)
    err = np.linalg.norm(got.solution - want.solution) / np.linalg.norm(want.solution)
    assert err < SOL_TOL, err


def test_run_poisson_matches_jax(tmp_path):
    want = jdrivers.run_poisson(nx=8)
    got = run_poisson(nx=8, out_dir=str(tmp_path), device="cpu")
    _same_driver(got, want)
    assert np.array_equal(np.fromfile(tmp_path / "poisson.0000"), got.solution)


def test_run_helmholtz_matches_jax(tmp_path):
    # 15 of the 45 restarts GMRES(200) needs here: the counts, the
    # unconverged history and iterate must still agree
    want = jdrivers.run_helmholtz(nx=12, m=200, maxit=15)
    got = run_helmholtz(nx=12, m=200, maxit=15, out_dir=str(tmp_path), device="cpu")
    assert not got.success
    _same_driver(got, want)
    hist = np.atleast_2d(np.loadtxt(tmp_path / "h_12_3.txt"))
    np.testing.assert_allclose(hist[:, 0], got.res_norm, rtol=1e-9)
    # max_seconds switches to the host-loop gmres_host: the same restarts
    host = run_helmholtz(nx=4, max_seconds=60.0, device="cpu")
    plain = run_helmholtz(nx=4, device="cpu")
    assert (host.num_iter, host.num_matvec) == (plain.num_iter, plain.num_matvec)
    assert np.array_equal(host.res_norm, plain.res_norm)
    assert len(host.extra["times"]) == host.num_iter + 1
