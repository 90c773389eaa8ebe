"""The port's host-loop GMRES (``gmres_host``, ``ProgressBar``) and LGMRES
(``lgmres``) against its own ``gmres`` and the JAX package.

Operators: the nonsymmetric Toeplitz system of ``tests/test_gmres.py``
(diagonal -3, sub 1.0, super 1.5) and its indefinite shifted Laplacian, on
which restarted GMRES stagnates.  ``gmres_host`` runs ``gmres``'s restarts,
so against the port's ``gmres`` its counts, history and iterate are
bitwise equal; against JAX's ``gmres_host`` the counts are equal and the
history agrees to rtol 1e-12 plus 1e-14 of the initial residual (a true
residual carries round-off of order eps ||b||).  ``lgmres(k=0)`` is
``gmres`` bitwise.  Against JAX's ``lgmres`` on the stagnation fixture
(199 restarts of 12 matvecs) the counts are equal and the history agrees
to rtol 1e-10 plus 1e-13 of the initial residual: the two packages' CGS
sums round differently (JAX's loop orthogonalises against the zero-padded
basis), which moves late entries by 1e-9 of themselves and 4e-16 of the
initial residual.  The progress output is compared with JAX's byte for
byte.
"""

import time

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.examples import drivers as jdrivers
from cuddhelmholtz_tpu.solvers import gmres as jg
from cuddhelmholtz_tpu_torch.examples.drivers import run_helmholtz
from cuddhelmholtz_tpu_torch.solvers.gmres import ProgressBar, gmres, gmres_host, lgmres

torch.set_num_threads(1)

N = 400


def toeplitz_jax(x):
    return -3.0 * x + jnp.pad(1.0 * x[:-1], (1, 0)) + jnp.pad(1.5 * x[1:], (0, 1))


def toeplitz_torch(x):
    y = -3.0 * x
    y[1:] += 1.0 * x[:-1]
    y[:-1] += 1.5 * x[1:]
    return y


def shifted_laplacian_jax(x):
    y = (2.0 - 0.8) * x
    y = y.at[1:].add(-x[:-1])
    return y.at[:-1].add(-x[1:])


def shifted_laplacian_torch(x):
    y = (2.0 - 0.8) * x
    y[1:] -= x[:-1]
    y[:-1] -= x[1:]
    return y


def _hist(out) -> np.ndarray:
    return np.asarray(out.res_norm)[: int(out.n_hist)]


CASES = {
    # (seed, rhs kind, m, maxit, tol, left preconditioned)
    "converges": (11, "manufactured", 8, 60, 1e-10, False),
    "restart_budget": (13, "random", 2, 5, 1e-30, False),
    "zero_rhs": (0, "zero", 4, 8, 1e-10, False),
    "left_preconditioned": (14, "random", 6, 40, 1e-9, True),
}


def _case_rhs(seed, kind):
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros(64)
    if kind == "manufactured":
        return np.array(toeplitz_jax(jnp.asarray(rng.standard_normal(N))))
    return rng.standard_normal(N)


@pytest.mark.parametrize("case", list(CASES))
def test_gmres_host_matches_gmres_and_jax(case):
    seed, kind, m, maxit, tol, left = CASES[case]
    b = _case_rhs(seed, kind)
    d = 1.0 + np.random.default_rng(5).random(b.size)
    pt = (lambda v: v / torch.from_numpy(d)) if left else None
    pj = (lambda v: v / jnp.asarray(d)) if left else None
    kw = dict(m=m, maxit=maxit, tol=tol)
    out = gmres(toeplitz_torch, torch.from_numpy(b), precond=pt, **kw)
    host, times = gmres_host(toeplitz_torch, torch.from_numpy(b), precond=pt, **kw)
    assert (host.success, host.num_iter, host.num_matvec, host.n_hist) == (
        out.success, out.num_iter, out.num_matvec, out.n_hist)
    assert torch.equal(host.x, out.x)
    assert np.array_equal(_hist(host), _hist(out))
    assert len(times) == host.n_hist and times[0] == 0.0 and times == sorted(times)
    jhost, jtimes = jg.gmres_host(toeplitz_jax, jnp.asarray(b), precond=pj, **kw)
    assert (host.success, host.num_iter, host.num_matvec) == (
        bool(jhost.success), int(jhost.num_iter), int(jhost.num_matvec))
    np.testing.assert_allclose(_hist(host), _hist(jhost), rtol=1e-12,
                               atol=1e-14 * float(_hist(jhost)[0]))
    assert len(jtimes) == len(times)
    if kind == "zero":
        assert host.success and host.num_iter == 0 and not host.x.any()


def test_gmres_host_wall_clock_cutoff():
    """The clock is read after each restart: the solve stops at the first
    restart that ends past max_seconds, not before."""
    b = torch.from_numpy(np.random.default_rng(12).standard_normal(N))

    def slow(x):
        time.sleep(0.002)
        return toeplitz_torch(x)

    out, times = gmres_host(slow, b, m=2, maxit=10_000, tol=1e-30, max_seconds=0.05)
    assert not out.success and 0 < out.num_iter < 10_000 - 1
    assert times[-1] > 0.05 >= times[-2]
    assert len(times) == out.n_hist == out.num_iter + 1


def test_progress_output_matches_jax(capsys):
    """``ProgressBar`` and ``gmres_host``'s verbose output, byte for byte."""
    steps = [0.0, 0.01, 0.3, 0.3, 0.5, 1.2, -1.0]
    for bar_cls in (ProgressBar, jg.ProgressBar):
        bar = bar_cls()
        for f in steps:
            bar.update(f)
        bar.finish()
    drawn = capsys.readouterr().out
    assert drawn[: len(drawn) // 2] == drawn[len(drawn) // 2:]
    assert drawn.startswith("\r[" + "-" * 40 + "]   0.0%")

    b = np.array(toeplitz_jax(jnp.asarray(np.random.default_rng(11).standard_normal(N))))
    for verbose in (1, 2):
        gmres_host(toeplitz_torch, torch.from_numpy(b), m=8, maxit=60, tol=1e-10,
                   verbose=verbose)
        got = capsys.readouterr().out
        jg.gmres_host(toeplitz_jax, jnp.asarray(b), m=8, maxit=60, tol=1e-10, verbose=verbose)
        want = capsys.readouterr().out
        assert got == want and got.endswith("\n")
        if verbose == 2:
            assert got.splitlines()[0].startswith("iteration      1 / 60 || rel. res. = ")


def test_lgmres_k0_matches_gmres():
    b = torch.from_numpy(np.random.default_rng(21).standard_normal(N))
    out_g = gmres(toeplitz_torch, b, m=8, maxit=30, tol=1e-10)
    out_l = lgmres(toeplitz_torch, b, m=8, k=0, maxit=30, tol=1e-10)
    assert (out_l.num_iter, out_l.num_matvec, out_l.success) == (
        out_g.num_iter, out_g.num_matvec, out_g.success)
    assert np.array_equal(_hist(out_l), _hist(out_g)) and torch.equal(out_l.x, out_g.x)


def test_lgmres_matches_jax_and_breaks_stagnation():
    """LGMRES(8, 3) on the indefinite shifted Laplacian: JAX's counts and
    history, and far below GMRES(11) at no more matvecs."""
    rng = np.random.default_rng(22)
    x_true = rng.standard_normal(N)
    b = np.array(shifted_laplacian_jax(jnp.asarray(x_true)))
    out_l = lgmres(shifted_laplacian_torch, torch.from_numpy(b), m=8, k=3, maxit=200, tol=1e-8)
    jout = jg.lgmres(shifted_laplacian_jax, jnp.asarray(b), m=8, k=3, maxit=200, tol=1e-8)
    assert (out_l.num_iter, out_l.num_matvec, out_l.success) == (
        int(jout.num_iter), int(jout.num_matvec), bool(jout.success))
    h, jh = _hist(out_l), _hist(jout)
    np.testing.assert_allclose(h, jh, rtol=1e-10, atol=1e-13 * jh[0])
    out_g = gmres(shifted_laplacian_torch, torch.from_numpy(b), m=11, maxit=200, tol=1e-8)
    assert out_l.num_matvec <= out_g.num_matvec
    assert h[-1] < 1e-2 * _hist(out_g)[-1]
    assert np.linalg.norm(out_l.x.numpy() - x_true) / np.linalg.norm(x_true) < 1e-3


def test_run_helmholtz_host_loop_matches_jax(tmp_path):
    """``run_helmholtz(max_seconds=, verbose=)`` runs ``gmres_host``: the
    plain path's counts, history and solution bitwise, JAX's counts, and
    the per-restart times in the history file."""
    kw = dict(nx=6, m=40, maxit=6)
    plain = run_helmholtz(**kw, device="cpu")
    host = run_helmholtz(**kw, max_seconds=3600.0, verbose=2, out_dir=str(tmp_path),
                         device="cpu")
    assert (host.num_iter, host.num_matvec, host.success) == (
        plain.num_iter, plain.num_matvec, plain.success)
    assert np.array_equal(host.res_norm, plain.res_norm)
    assert np.array_equal(host.solution, plain.solution)
    times = host.extra["times"]
    assert len(times) == host.num_iter + 1 and plain.extra["times"] is None
    hist = np.loadtxt(tmp_path / "h_6_3.txt")
    np.testing.assert_allclose(hist[:, 1], times, rtol=1e-9)
    want = jdrivers.run_helmholtz(**kw, max_seconds=3600.0)
    assert (host.num_iter, host.num_matvec, host.success) == (
        want.num_iter, want.num_matvec, want.success)
    np.testing.assert_allclose(host.res_norm, want.res_norm, rtol=1e-9)
