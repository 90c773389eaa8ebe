"""The port's two-level coarse space (``solvers/coarse.py``) against the JAX
package.

The JAX package's ``coarse_setup``: nx 8, deg 3, the disc coefficient, the
default 16-DOF blocks (4 subdomains, nt 800).  The transfer stack comes
from JAX (``load_jax_maps``), so both packages assemble from identical T.
Spaces built in float64 agree to 1e-10 relative (the host assembly is the
same float64 algebra, summed in another order), and the port's assembly
equals a brute-force Z^T (I - U) Z through the transfer action in float64.
The sparse apply runs GMRES in both packages, so it agrees to 1e-8.  The
float32 two-level solves take JAX's restarts; ``run_ddh`` takes its
matvecs too, the solver on the fixture's forcing within JAX's own
round-off spread (see ``test_two_level_solver_matches_jax``).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.examples.drivers import run_ddh as jrun_ddh
from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.ops.functional import linear_functional as jlinear_functional
from cuddhelmholtz_tpu.ops.mass import apply_diag_inv_mass as japply_diag_inv_mass
from cuddhelmholtz_tpu.ops.mass import make_diag_inv_mass_op as jmake_diag_inv_mass_op
from cuddhelmholtz_tpu.solvers import coarse as jcoarse
from cuddhelmholtz_tpu.solvers import ddh as jddh_mod
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
from cuddhelmholtz_tpu_torch.solvers import coarse
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, ddh_action_transfer, load_jax_maps
from cuddhelmholtz_tpu_torch.solvers.gmres import gmres
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

torch.set_num_threads(1)

NX, DEG = 8, 3
OMEGA = 2 * np.pi * NX / 10
RIDGE = 1e-8


@pytest.fixture(autouse=True, scope="module")
def _no_setup_cache():
    """Neither package reads or writes a setup cache here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _alpha(xy):
    r = xy[..., 0] ** 2 + xy[..., 1] ** 2
    return jnp.where(r < 0.0625, 0.2, 1.0)


@pytest.fixture(scope="module")
def pair():
    """(JAX DDH, port DDH) of ``coarse_setup``, both holding JAX's T."""
    jfem = JH1Space(JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), JBasis(DEG + 1))
    a_nodal = np.asarray(japply_diag_inv_mass(jmake_diag_inv_mass_op(jfem),
                                              jlinear_functional(jfem, _alpha)))
    jddh = jddh_mod.DDH(OMEGA, a_nodal, jfem, nx=NX, ny=NX)
    jddh.precompute_transfer()
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    ddh = DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX, device="cpu")
    load_jax_maps(ddh, {"T_u": np.asarray(jddh._T_u), "groups": jddh._T_groups}, jddh.pad)
    return jddh, ddh


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("n,n_super", [(64, 8), (37, 4), (100, 16), (5, 1)])
def test_superdomain_labels_match_jax(n, n_super):
    pts = np.random.default_rng(n).standard_normal((n, 2))
    assert np.array_equal(coarse.superdomain_labels(pts, n_super),
                          jcoarse.superdomain_labels(pts, n_super))


@pytest.mark.parametrize("dps", [1, 4])
def test_dense_coarse_space_matches_jax(pair, dps):
    jddh, ddh = pair
    want = jcoarse.build_coarse_space(jddh, n_dir=2, domains_per_super=dps, ridge=RIDGE,
                                      dtype=jnp.float64)
    got = coarse.build_coarse_space(ddh, n_dir=2, domains_per_super=dps, ridge=RIDGE,
                                    dtype=torch.float64)
    assert np.array_equal(_np(got.sd), _np(want.sd))
    for name in ("V", "dscale", "Einv"):
        assert _rel(_np(getattr(got, name)), getattr(want, name)) <= 1e-10, name


@pytest.mark.parametrize("ortho", [False, True])
def test_sparse_coarse_space_matches_jax(pair, ortho):
    jddh, ddh = pair
    want = jcoarse.build_coarse_space_sparse(jddh, n_dir=2, domains_per_super=1, ridge=RIDGE,
                                             dtype=jnp.float64, ortho=ortho)
    got = coarse.build_coarse_space_sparse(ddh, n_dir=2, domains_per_super=1, ridge=RIDGE,
                                           dtype=torch.float64, ortho=ortho)
    assert np.array_equal(_np(got.nbr), _np(want.nbr))
    assert np.array_equal(_np(got.sd), _np(want.sd))
    for name in ("V", "dscale", "Eb", "Pinv"):
        assert _rel(_np(getattr(got, name)), getattr(want, name)) <= 1e-10, name


def _dense_Z(ddh, cs):
    """The coarse basis as a dense (2 n_lambda, nc) float64 matrix."""
    V, sd = _np(cs.V).astype(np.float64), _np(cs.sd)
    nS, nm = cs.members.shape[0], V.shape[2]
    Z = np.zeros((2 * ddh.n_lambda, 2 * nS * nm))
    for side in (0, 1):
        for s in range(nS):
            for j in range(nm):
                z = np.where((sd == s)[:, None], V[:, :, j], 0.0)
                Z[side * ddh.n_lambda:side * ddh.n_lambda + ddh.n_own,
                  (side * nS + s) * nm + j] = z.reshape(-1)
    return Z


def _sparse_dense_E(cs):
    """The dense normalised matrix of a block-sparse space, in the dense
    path's (side, superdomain, mode) order."""
    nbr = _np(cs.nbr)
    nS, K = nbr.shape
    nm = cs.V.shape[2]
    Eb = _np(cs.Eb).reshape(nS, 2, nm, K, 2, nm).transpose(0, 3, 1, 4, 2, 5)
    E = np.zeros((2 * nS * nm, 2 * nS * nm))
    for r in range(nS):
        for k in np.nonzero(nbr[r] >= 0)[0]:
            c = nbr[r, k]
            for t in (0, 1):
                for s in (0, 1):
                    E[(t * nS + r) * nm:(t * nS + r + 1) * nm,
                      (s * nS + c) * nm:(s * nS + c + 1) * nm] += Eb[r, k, t, s]
    return E


@pytest.mark.parametrize("kind", ["dense", "sparse", "sparse_ortho"])
def test_assembly_matches_brute_force(pair, kind):
    """The assembled E equals Z^T (I - U) Z with (I - U) applied column by
    column through ``ddh_action_transfer`` in float64 on the same T; with
    ortho the row factor must use the dual superdomain's transform."""
    _, ddh = pair
    if kind == "dense":
        cs = coarse.build_coarse_space(ddh, n_dir=2, domains_per_super=1, ridge=RIDGE,
                                       dtype=torch.float64)
        En = np.linalg.inv(_np(cs.Einv))
        d = 1.0 / _np(cs.dscale)
    else:
        cs = coarse.build_coarse_space_sparse(ddh, n_dir=2, domains_per_super=1, ridge=RIDGE,
                                              dtype=torch.float64, ortho=kind == "sparse_ortho")
        En = _sparse_dense_E(cs)
        d = 1.0 / _np(cs.dscale).reshape(-1)
    nc = En.shape[0]
    En[np.arange(nc), np.arange(nc)] -= RIDGE
    E_asm = En * d[:, None] * d[None, :]
    Z = _dense_Z(ddh, cs)
    T64 = torch.as_tensor(ddh._T_u[ddh._T_groups], dtype=torch.float64)
    AZ = ddh_action_transfer(ddh.params, T64, torch.as_tensor(Z.T), ddh.n_own).numpy().T
    E_brute = Z.T @ AZ
    assert _rel(E_asm, E_brute) <= 1e-10


@pytest.mark.parametrize("kind,tol", [("dense", 1e-10), ("sparse", 1e-8)])
def test_coarse_apply_matches_jax(pair, kind, tol):
    jddh, ddh = pair
    v = np.random.default_rng(5).standard_normal(2 * ddh.n_lambda)
    kw = dict(n_dir=2, domains_per_super=1, ridge=RIDGE)
    if kind == "dense":
        jcs = jcoarse.build_coarse_space(jddh, dtype=jnp.float64, **kw)
        cs = coarse.build_coarse_space(ddh, dtype=torch.float64, **kw)
    else:
        jcs = jcoarse.build_coarse_space_sparse(jddh, dtype=jnp.float64, **kw)
        cs = coarse.build_coarse_space_sparse(ddh, dtype=torch.float64, **kw)
    want = jcoarse.coarse_apply(jcs, jddh.params, jnp.asarray(v), jddh.n_own,
                                solve_m=20, solve_maxit=2, solve_tol=3e-2)
    got = coarse.coarse_apply(cs, ddh.params, torch.as_tensor(v), ddh.n_own,
                              solve_m=20, solve_maxit=2, solve_tol=3e-2)
    assert got.dtype == torch.float64 and got.shape == (2 * ddh.n_lambda,)
    assert _rel(got.numpy(), want) <= tol


def _forcing(fem):
    def f(xy):
        r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
        return torch.exp(-(OMEGA**2) * r)

    return helmholtz_rhs(fem, f, dtype=torch.float32)


@pytest.fixture(scope="module")
def one_level(pair):
    """The port's one-level solution of the fixture's problem."""
    _, ddh = pair
    b = _forcing(ddh.space)
    out = gmres(ddh.action, ddh.rhs(b), m=20, maxit=100, tol=1e-4)
    assert out.success
    return b, out


@pytest.mark.parametrize("mode", ["additive", "multiplicative"])
def test_two_level_solver_matches_jax(pair, one_level, mode):
    """``solver(coarse=mode)`` takes JAX's restarts and solves the one-level
    system (within 5e-3 of its solution).  The matvecs agree within 3: the
    last restart exits within a few steps of the tolerance, and a relative
    perturbation of b by 1e-7 (fp32 round-off) moves JAX's own count by up
    to 2 here (239-241 additive, 205-206 multiplicative; port 242 and 205).
    The residual histories agree to 1e-4 over the first three restarts and
    to 5 % after."""
    jddh, ddh = pair
    b, out0 = one_level
    ddh.make_coarse(n_dir=2, domains_per_super=1, ridge=RIDGE)
    jddh.make_coarse(n_dir=2, domains_per_super=1, ridge=RIDGE)
    out, U = ddh.solver(20, 100, 1e-4, coarse=mode)(b)
    jout, _ = jddh.solver(20, 100, 1e-4, coarse=mode)(jnp.asarray(b.numpy()))
    assert out.success and bool(jout.success)
    assert out.num_iter == int(jout.num_iter)
    assert abs(out.num_matvec - int(jout.num_matvec)) <= 3
    hist = out.res_norm[: out.n_hist].numpy()
    jhist = np.asarray(jout.res_norm)[: int(jout.n_hist)]
    np.testing.assert_allclose(hist[:4], jhist[:4], rtol=1e-4)
    np.testing.assert_allclose(hist, jhist, rtol=5e-2)
    assert _rel(out.x, out0.x) < 5e-3
    assert U.shape == (2 * ddh.g_ndof,) and torch.isfinite(U).all()


def test_run_ddh_two_level_matches_jax():
    """``run_ddh(transfer=True, coarse="multiplicative")`` at nx 8 on the CPU
    takes the JAX driver's restarts and matvecs."""
    kw = dict(nx=8, transfer=True, coarse="multiplicative", coarse_n_dir=2,
              coarse_domains_per_super=1)
    res = run_ddh(device="cpu", **kw)
    want = jrun_ddh(**kw)
    assert res.success and want.success
    assert (res.num_iter, res.num_matvec) == (want.num_iter, want.num_matvec)
    assert res.extra["coarse"] == "multiplicative" and res.extra["coarse_seconds"] >= 0.0
    assert res.extra["ddh"].coarse_space is not None


@pytest.mark.parametrize("case", ["before_make_coarse", "unknown_mode", "block", "vmapped"])
def test_coarse_solver_value_errors(pair, case):
    _, ddh = pair
    ddh.make_coarse(n_dir=2, domains_per_super=1, ridge=RIDGE)
    if case == "before_make_coarse":
        fresh = DDH(OMEGA, np.ones(ddh.g_ndof), ddh.space, nx=NX, ny=NX, device="cpu")
        with pytest.raises(ValueError, match="make_coarse"):
            fresh.solver(20, 100, 1e-4, coarse="additive")
    elif case == "unknown_mode":
        with pytest.raises(ValueError, match="coarse must be"):
            ddh.solver(20, 100, 1e-4, coarse="bogus")
    else:
        with pytest.raises(ValueError, match="does not compose with coarse"):
            ddh.solver(20, 100, 1e-4, coarse="additive", **{case: True})


def test_coarse_study_records(tmp_path, capsys):
    """``examples/coarse_study.py`` prints one JSON line per case with the
    JAX study's keys (``docs/run_coarse_study.py``) and the coarse size."""
    import json

    from cuddhelmholtz_tpu_torch.examples import coarse_study

    out = tmp_path / "study.jsonl"
    coarse_study.main(["--nx", "8", "--n-dir", "2", "--device", "cpu", "--out", str(out)])
    lines = capsys.readouterr().out.strip().splitlines()
    recs = [json.loads(line) for line in lines]
    assert recs == [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["case"] for r in recs] == ["one_level", "two_level_mult"]
    keys = {"case", "nx", "block", "restarts", "matvecs", "success", "warm_seconds",
            "compile_seconds", "final_rel_res", "n_lambda", "n_domains", "total_seconds"}
    for r in recs:
        assert keys <= r.keys() and r["success"] and r["n_domains"] == 4
    coarse = recs[1]["coarse"]
    assert (coarse["method"], coarse["n_dir"], coarse["dps"], coarse["nc"]) == (
        "iterative", 2, 1, 40)
    assert coarse["solve"] == [20, 2, 3e-2]
