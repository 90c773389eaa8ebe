"""The port's batched GMRES solvers against the JAX package, in float64.

``block_gmres`` (one shared block-Krylov space) on ``tests/test_gmres.py``'s
Toeplitz oracle with K = 4 manufactured right-hand sides, and on its
converged-lane case (rank-deficient residual blocks); ``gmres_lockstep``
(the counterpart of ``jax.vmap(gmres)``) on its three-lane case, against
solo port ``gmres`` and against ``jax.vmap(gmres)``.  Counts are equal;
histories agree to rtol 1e-8 plus 1e-13 of the initial residual (a true
residual b - A x carries round-off of order eps * ||b||, as
``test_torch_gmres.py`` allows) and solutions to 1e-10 relative.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.solvers.gmres import block_gmres as jblock_gmres
from cuddhelmholtz_tpu.solvers.gmres import gmres as jgmres
from cuddhelmholtz_tpu_torch.solvers.gmres import block_gmres, gmres, gmres_lockstep

torch.set_num_threads(1)


def toeplitz_jax(x):
    """Nonsymmetric tridiagonal Toeplitz: diag -3, sub 1.0, super 1.5."""
    return -3.0 * x + jnp.pad(1.0 * x[:-1], (1, 0)) + jnp.pad(1.5 * x[1:], (0, 1))


def toeplitz_torch(x):
    """The same operator on the last axis of a vector or a (K, n) block."""
    y = -3.0 * x
    y[..., 1:] += 1.0 * x[..., :-1]
    y[..., :-1] += 1.5 * x[..., 1:]
    return y


def _close_hist(got, want, r0):
    np.testing.assert_allclose(got, want, rtol=1e-8, atol=1e-13 * r0)


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same_block(got, want):
    assert got.num_iter == int(want.num_iter)
    assert got.num_matvec == int(want.num_matvec)
    assert got.n_hist == int(want.n_hist)
    assert got.success.tolist() == np.asarray(want.success).tolist()
    h, hw = got.res_norm.numpy(), np.asarray(want.res_norm)
    assert np.isnan(h[got.n_hist:]).all() and np.isfinite(h[: got.n_hist]).all()
    for k in range(h.shape[1]):
        _close_hist(h[: got.n_hist, k], hw[: got.n_hist, k], hw[0, k])
    assert _rel(got.x.numpy(), np.asarray(want.x)) < 1e-10


def test_block_gmres_matches_jax():
    n, K = 512, 4
    X = np.random.default_rng(7).standard_normal((K, n))
    B = np.array(jax.vmap(toeplitz_jax)(jnp.asarray(X)))
    want = jax.jit(lambda B: jblock_gmres(jax.vmap(toeplitz_jax), B, m=5, maxit=100,
                                          tol=1e-8))(jnp.asarray(B))
    got = block_gmres(toeplitz_torch, torch.from_numpy(B), m=5, maxit=100, tol=1e-8)
    assert bool(got.success.all())
    # K single-vector matvecs for r0, then K per block step and per restart
    assert got.num_matvec == K * (1 + 6 * got.num_iter)
    _same_block(got, want)
    R = B - toeplitz_torch(got.x).numpy()
    assert (np.linalg.norm(R, axis=1) / np.linalg.norm(B, axis=1)).max() < 1e-8 * 1.01


def test_block_gmres_survives_converged_lane():
    """Lane 0 converges at once and lanes 1, 2 are the same system, so the
    residual blocks are rank-deficient: the QR falls back to the polar
    factor, and every lane still converges with finite values."""
    n = 256
    b2 = np.array(toeplitz_jax(jnp.asarray(np.random.default_rng(5).standard_normal(n))))
    e0 = np.zeros(n)
    e0[0] = 1e3
    B = np.stack([e0, b2, b2])
    got = block_gmres(toeplitz_torch, torch.from_numpy(B), m=5, maxit=100, tol=1e-8)
    want = jblock_gmres(jax.vmap(toeplitz_jax), jnp.asarray(B), m=5, maxit=100, tol=1e-8)
    assert bool(got.success.all()) and torch.isfinite(got.x).all()
    R = B - toeplitz_torch(got.x).numpy()
    assert (np.linalg.norm(R, axis=1) / np.linalg.norm(B, axis=1)).max() < 1e-8 * 1.01
    assert (got.num_iter, got.num_matvec) == (int(want.num_iter), int(want.num_matvec))


def _three_lanes() -> np.ndarray:
    """``test_gmres.py``'s lanes of different difficulty (solo matvec counts
    56 / 38 / 46 at m = 7, tol 1e-10)."""
    n = 512
    rng = np.random.default_rng(11)
    e0 = np.zeros(n)
    e0[0] = 1.0
    return np.stack([
        toeplitz_torch(rng.standard_normal(n)),
        1e3 * toeplitz_torch(e0),
        toeplitz_torch(np.sin(np.linspace(0, np.pi, n))),
    ])


@pytest.mark.parametrize("opts", [{}, {"deferred": True}, {"reorth": False}],
                         ids=["standard", "deferred", "single_pass"])
def test_lockstep_matches_solo_gmres(opts):
    """Each lane of the lock-step solve is a solo ``gmres`` of that row:
    its counts, history and solution, while the lanes exit at different
    points."""
    bs = torch.from_numpy(_three_lanes())
    out = gmres_lockstep(toeplitz_torch, bs, m=7, maxit=100, tol=1e-10, **opts)
    assert bool(out.success.all())
    assert len(set(out.num_matvec.tolist())) > 1
    for k in range(bs.shape[0]):
        solo = gmres(toeplitz_torch, bs[k], m=7, maxit=100, tol=1e-10, **opts)
        nh = solo.n_hist
        assert (int(out.num_iter[k]), int(out.num_matvec[k]), int(out.n_hist[k])) == (
            solo.num_iter, solo.num_matvec, nh)
        h = out.res_norm[k].numpy()
        assert np.isnan(h[nh:]).all()
        _close_hist(h[:nh], solo.res_norm[:nh].numpy(), float(solo.res_norm[0]))
        assert _rel(out.x[k].numpy(), solo.x.numpy()) < 1e-10


def test_lockstep_matches_jax_vmap():
    bs = _three_lanes()
    solve = lambda b: jgmres(toeplitz_jax, b, m=7, maxit=100, tol=1e-10)  # noqa: E731
    want = jax.jit(jax.vmap(solve))(jnp.asarray(bs))
    out = gmres_lockstep(toeplitz_torch, torch.from_numpy(bs), m=7, maxit=100, tol=1e-10)
    assert out.num_matvec.tolist() == np.asarray(want.num_matvec).tolist() == [56, 38, 46]
    assert out.num_iter.tolist() == np.asarray(want.num_iter).tolist()
    assert out.n_hist.tolist() == np.asarray(want.n_hist).tolist()
    for k in range(3):
        nh = int(out.n_hist[k])
        hw = np.asarray(want.res_norm[k])
        _close_hist(out.res_norm[k, :nh].numpy(), hw[:nh], hw[0])
        assert _rel(out.x[k].numpy(), np.asarray(want.x[k])) < 1e-10
