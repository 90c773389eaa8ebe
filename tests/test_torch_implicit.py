"""The port's differentiable solves (``solvers/implicit.py``,
``models/inverse.py``) against the JAX package, case for case with
``tests/test_implicit.py``.

Both packages get the same numpy-seeded inputs; the port's Helmholtz
template is the JAX template's fields carried over
(``helmholtz_template_from_jax``), so both differentiate the same operator.
The FWI fixture (nx 4, deg 2, 162 unknowns) solves with GMRES(200), which
does not restart below 200 unknowns, in both packages.  Tolerances: the
coefficient update 1e-14 of the host collocation, the template operator
1e-12 of ``make_helmholtz_op``, gradients 1e-8 relative to JAX, central
differences as ``tests/test_implicit.py`` holds JAX, the FGMRES + DDH hook
(nx 8, deg 3, io maps in both packages) 1e-6 of the default path and of
JAX's hook run, the inversion's loss history 1e-8 relative to JAX's.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.models import helmholtz as jhelm
from cuddhelmholtz_tpu.models import inverse as jinv
from cuddhelmholtz_tpu.ops import face_mass as jfm
from cuddhelmholtz_tpu.ops import mass as jmass
from cuddhelmholtz_tpu.solvers.implicit import implicit_solve as jimplicit_solve
from cuddhelmholtz_tpu.spaces.h1 import FaceSpace as JFaceSpace
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch import implicit_solve
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import (
    apply_helmholtz,
    helmholtz_op_with_coeff,
    helmholtz_template_from_jax,
    make_helmholtz_op,
    make_helmholtz_template,
)
from cuddhelmholtz_tpu_torch.models.inverse import (
    ddh_solve_hook,
    invert_wavespeed,
    misfit,
    solve_helmholtz_diff,
)
from cuddhelmholtz_tpu_torch.ops.face_mass import face_mass_op_with_coeff, make_face_mass_op
from cuddhelmholtz_tpu_torch.ops.mass import make_mass_op, mass_op_with_coeff, variable_coeff_n_quad
from cuddhelmholtz_tpu_torch.solvers.gmres import gmres
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

torch.set_num_threads(1)

FULL = {"m": 200, "maxit": 3}  # GMRES(200): no restart below 200 unknowns


@pytest.fixture(autouse=True, scope="module")
def _no_setup_cache():
    """Neither package reads or writes a setup cache here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


def _spaces(nx, deg):
    jm = JMesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    jfem = JH1Space(jm, JBasis(deg + 1))
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))
    return jfem, JFaceSpace(jfem, jm.boundary_edges), fem, FaceSpace(fem, mesh.boundary_edges)


def _tmpl_arrays(jt) -> dict:
    arrays = {"ndof": jt.ndof, "face_proj": np.asarray(jt.face_proj)}
    for sub in ("stiffness", "mass_unit", "face_mass_unit"):
        arrays.update({f"{sub}.{k}": np.asarray(v)
                       for k, v in getattr(jt, sub)._asdict().items()})
    return arrays


def _rel(got, want) -> float:
    got = got.detach().numpy() if torch.is_tensor(got) else np.asarray(got)
    want = np.asarray(want)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _toeplitz_jax(d):
    def mv(x):
        lower = jnp.concatenate([jnp.zeros(1, x.dtype), x[:-1]])
        upper = jnp.concatenate([x[1:], jnp.zeros(1, x.dtype)])
        return d * x - 1.0 * lower + 0.5 * upper

    return mv


def _toeplitz_torch(x, d):
    """The nonsymmetric tridiagonal Toeplitz of ``tests/test_implicit.py``
    with the diagonal ``d`` as the operator's parameter."""
    y = d * x
    y = y - torch.cat([x.new_zeros(1), x[:-1]])
    return y + 0.5 * torch.cat([x[1:], x.new_zeros(1)])


def test_coeff_update_matches_host_collocation():
    jfem, jfs, fem, fs = _spaces(4, 2)
    a = 1.0 + 0.3 * np.random.default_rng(3).standard_normal(fem.ndof)
    nq = variable_coeff_n_quad(fem)
    upd = mass_op_with_coeff(make_mass_op(fem, n_quad=nq, device="cpu"), torch.from_numpy(a))
    ref = make_mass_op(fem, coeff=a, device="cpu")
    np.testing.assert_allclose(upd.wdetj.numpy(), ref.wdetj.numpy(), rtol=1e-14)
    jupd = jmass.mass_op_with_coeff(jmass.make_mass_op(jfem, n_quad=nq), jnp.asarray(a))
    np.testing.assert_allclose(upd.wdetj.numpy(), np.asarray(jupd.wdetj), rtol=1e-14)

    af = a[fs.proj]
    fupd = face_mass_op_with_coeff(make_face_mass_op(fs, n_quad=nq, device="cpu"),
                                  torch.from_numpy(af))
    fref = make_face_mass_op(fs, coeff=af, device="cpu")
    np.testing.assert_allclose(fupd.wds.numpy(), fref.wds.numpy(), rtol=1e-14)
    jfupd = jfm.face_mass_op_with_coeff(jfm.make_face_mass_op(jfs, n_quad=nq), jnp.asarray(af))
    np.testing.assert_allclose(fupd.wds.numpy(), np.asarray(jfupd.wds), rtol=1e-14)


def test_helmholtz_op_with_coeff_matches_make():
    jfem, jfs, fem, fs = _spaces(4, 2)
    rng = np.random.default_rng(4)
    a = 1.0 + 0.2 * rng.standard_normal(fem.ndof)
    omega = 3.1
    tmpl = make_helmholtz_template(fem, fs, device="cpu")
    # the JAX template carried over holds the port's own data
    jt = jhelm.make_helmholtz_template(jfem, jfs)
    carried = helmholtz_template_from_jax(_tmpl_arrays(jt), "cpu")
    assert torch.equal(tmpl.face_proj, carried.face_proj) and tmpl.ndof == carried.ndof
    for sub in ("stiffness", "mass_unit", "face_mass_unit"):
        for x, y in zip(getattr(tmpl, sub), getattr(carried, sub)):
            if torch.is_tensor(x):
                np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=1e-13, atol=1e-15)
            else:
                assert x == y
    op_t = helmholtz_op_with_coeff(tmpl, omega, torch.from_numpy(a * a),
                                   torch.from_numpy(a[fs.proj]))
    op_r = make_helmholtz_op(omega, a * a, a[fs.proj], fem, fs, kron=False, device="cpu")
    U = torch.from_numpy(rng.standard_normal(2 * fem.ndof))
    np.testing.assert_allclose(apply_helmholtz(op_t, U).numpy(), apply_helmholtz(op_r, U).numpy(),
                               rtol=1e-12, atol=1e-12)


def test_adjoint_gradient_wrt_rhs():
    """grad_b 0.5||x(b)||^2 = A^{-T} x for the nonsymmetric Toeplitz
    operator: the transposed matvec is the VJP of the matvec."""
    n = 40
    rng = np.random.default_rng(0)
    d = 2.5 + 0.1 * rng.standard_normal(n)
    b = rng.standard_normal(n)
    bt = torch.tensor(b, requires_grad=True)
    x = implicit_solve(_toeplitz_torch, bt, torch.from_numpy(d), m=20, maxit=50, tol=1e-12)
    (g,) = torch.autograd.grad(0.5 * torch.dot(x, x), bt)

    A = np.stack([_toeplitz_torch(torch.from_numpy(e), torch.from_numpy(d)).numpy()
                  for e in np.eye(n)], axis=1)
    g_ref = np.linalg.solve(A.T, np.linalg.solve(A, b))
    np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-8, atol=1e-10)
    mv = _toeplitz_jax(jnp.asarray(d))
    g_jax = jax.grad(lambda b: 0.5 * jnp.sum(
        jimplicit_solve(mv, b, m=20, maxit=50, tol=1e-12) ** 2))(jnp.asarray(b))
    np.testing.assert_allclose(g.numpy(), np.asarray(g_jax), rtol=1e-8, atol=1e-10)


def test_gradient_wrt_matvec_params():
    """The gradient reaches the operator's parameter (the diagonal)."""
    n = 30
    rng = np.random.default_rng(1)
    d0 = 3.0 + 0.1 * rng.standard_normal(n)
    b = rng.standard_normal(n)

    def loss(d):
        x = implicit_solve(_toeplitz_torch, torch.from_numpy(b), d, m=15, maxit=50, tol=1e-12)
        return torch.sum(x**3)

    dt = torch.tensor(d0, requires_grad=True)
    (g,) = torch.autograd.grad(loss(dt), dt)
    g = g.numpy()
    eps = 1e-6
    for i in [0, n // 2, n - 1]:
        dp, dm = d0.copy(), d0.copy()
        dp[i] += eps
        dm[i] -= eps
        fd = (float(loss(torch.from_numpy(dp))) - float(loss(torch.from_numpy(dm)))) / (2 * eps)
        assert abs(g[i] - fd) < 1e-5 * max(1.0, abs(fd))
    g_jax = jax.grad(lambda d: jnp.sum(jimplicit_solve(
        _toeplitz_jax(d), jnp.asarray(b), m=15, maxit=50, tol=1e-12) ** 3))(jnp.asarray(d0))
    assert _rel(g, g_jax) < 1e-8


@pytest.fixture(scope="module")
def fwi():
    """The FWI fixture of ``tests/test_implicit.py`` in both packages."""
    jfem, jfs, fem, fs = _spaces(4, 2)
    rng = np.random.default_rng(7)
    omega = 2.0
    jt = jhelm.make_helmholtz_template(jfem, jfs)
    tmpl = helmholtz_template_from_jax(_tmpl_arrays(jt), "cpu")
    b = rng.standard_normal(2 * fem.ndof) * 0.1
    xy = fem.coords
    a_true = 1.0 + 0.1 * np.cos(np.pi * xy[:, 0]) * np.cos(np.pi * xy[:, 1])
    obs = solve_helmholtz_diff(tmpl, omega, torch.from_numpy(a_true), torch.from_numpy(b),
                               tol=1e-12, **FULL)
    jobs = jinv.solve_helmholtz_diff(jt, omega, jnp.asarray(a_true), jnp.asarray(b), tol=1e-12,
                                     **FULL)
    assert _rel(obs, jobs) < 1e-10
    return dict(fem=fem, fs=fs, jfem=jfem, jfs=jfs, tmpl=tmpl, jt=jt, omega=omega, b=b,
                obs=obs, jobs=np.asarray(jobs))


def test_fwi_gradient_vs_jax_and_finite_differences(fwi):
    tmpl, omega, b, obs = fwi["tmpl"], fwi["omega"], torch.from_numpy(fwi["b"]), fwi["obs"]
    a0 = np.ones(fwi["fem"].ndof)

    def f(a):
        return misfit(tmpl, omega, a, b, obs, tol=1e-12, **FULL)

    a = torch.tensor(a0, requires_grad=True)
    val = f(a)
    (g,) = torch.autograd.grad(val, a)
    assert torch.isfinite(val) and float(val.detach()) > 0
    jf = lambda a: jinv.misfit(fwi["jt"], omega, a, jnp.asarray(fwi["b"]),  # noqa: E731
                               jnp.asarray(fwi["jobs"]), tol=1e-12, **FULL)
    jval, jg = jax.value_and_grad(jf)(jnp.asarray(a0))
    assert abs(float(val.detach()) - float(jval)) <= 1e-8 * abs(float(jval))
    assert _rel(g, jg) < 1e-8
    # a central difference along a random direction, as JAX's test holds JAX
    eps = 1e-6
    v = np.random.default_rng(0).standard_normal(a0.size)
    v /= np.linalg.norm(v)
    fd = (float(f(torch.from_numpy(a0 + eps * v))) - float(f(torch.from_numpy(a0 - eps * v)))) / (
        2 * eps)
    ad = float(g.numpy() @ v)
    assert abs(ad - fd) < 2e-5 * max(1.0, abs(fd)), (ad, fd)


def test_fwi_gradient_wrt_omega(fwi):
    """omega as a tensor keeps its gradient (a float omega would give 0)."""
    tmpl, b, obs = fwi["tmpl"], torch.from_numpy(fwi["b"]), fwi["obs"]
    a0 = torch.ones(fwi["fem"].ndof, dtype=torch.float64)

    def f(w):
        return misfit(tmpl, w, a0, b, obs, tol=1e-12, **FULL)

    w = torch.tensor(fwi["omega"], dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(f(w), w)
    eps = 1e-6
    fd = (float(f(fwi["omega"] + eps)) - float(f(fwi["omega"] - eps))) / (2 * eps)
    assert abs(float(g) - fd) < 1e-5 * max(1.0, abs(fd))
    g_jax = jax.grad(lambda w: jinv.misfit(
        fwi["jt"], w, jnp.ones(fwi["fem"].ndof), jnp.asarray(fwi["b"]), jnp.asarray(fwi["jobs"]),
        tol=1e-12, **FULL))(jnp.asarray(fwi["omega"]))
    assert abs(float(g) - float(g_jax)) <= 1e-8 * abs(float(g_jax))


def test_forward_solve_records_no_graph(fwi):
    """The Krylov iteration runs under no_grad: the solution's only graph
    node is the implicit solve, and neither solve sees grad mode."""
    seen = []

    def solve(mv, rhs):
        seen.append(torch.is_grad_enabled())
        return gmres(mv, rhs, tol=1e-12, **FULL).x

    a = torch.ones(fwi["fem"].ndof, dtype=torch.float64, requires_grad=True)
    U = solve_helmholtz_diff(fwi["tmpl"], fwi["omega"], a, torch.from_numpy(fwi["b"]),
                             solve=solve)
    assert seen == [False]
    assert U.requires_grad and type(U.grad_fn).__name__ == "_ImplicitSolveBackward"
    (g,) = torch.autograd.grad(0.5 * torch.dot(U, U), a)
    assert seen == [False, False] and torch.isfinite(g).all()


def test_invert_wavespeed_descends_as_jax(fwi):
    fem, fs = fwi["fem"], fwi["fs"]
    a, hist = invert_wavespeed(fem, fs, fwi["omega"], torch.from_numpy(fwi["b"]), fwi["obs"],
                               np.ones(fem.ndof), steps=5, step_size=0.5,
                               solve_kwargs={"tol": 1e-10, **FULL}, device="cpu")
    hist = hist.numpy()
    assert hist[-1] < hist[0] * 0.9 and torch.isfinite(a).all()
    ja, jhist = jinv.invert_wavespeed(fwi["jfem"], fwi["jfs"], fwi["omega"],
                                      jnp.asarray(fwi["b"]), jnp.asarray(fwi["jobs"]),
                                      np.ones(fem.ndof), steps=5, step_size=0.5,
                                      solve_kwargs={"tol": 1e-10, **FULL})
    np.testing.assert_allclose(hist, np.asarray(jhist), rtol=1e-8)
    assert _rel(a, ja) < 1e-8


def test_ddh_solve_hook_matches_default_path_and_jax():
    """The FGMRES + DDH hook (DDH frozen at a slightly wrong coefficient)
    gives the default path's solution and adjoint gradient, and JAX's hook
    run's: a preconditioner changes the iteration path, not the answer.
    Both DDHs run 2 WaveHoltz iterations (a cheaper P, as in
    ``tests/test_torch_composite.py``); the default path is GMRES(1300),
    which does not restart on these 1,250 unknowns."""
    from cuddhelmholtz_tpu.ops.functional import linear_functional as jlinear_functional
    from cuddhelmholtz_tpu.solvers.ddh import DDH as JDDH
    from cuddhelmholtz_tpu_torch.ops.functional import linear_functional
    from cuddhelmholtz_tpu_torch.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
    from cuddhelmholtz_tpu_torch.solvers.ddh import DDH

    nx, deg, wh_maxit = 8, 3, 2
    omega = 2 * np.pi * nx / 10
    jfem, jfs, fem, fs = _spaces(nx, deg)
    jt = jhelm.make_helmholtz_template(jfem, jfs)
    tmpl = helmholtz_template_from_jax(_tmpl_arrays(jt), "cpu")
    b = np.random.default_rng(11).standard_normal(2 * fem.ndof) * 0.1
    bt = torch.from_numpy(b)

    def u_and_grad(obs, **kw):
        """(U, gradient of the misfit 0.5 ||U - obs||^2 at a = 1; obs None
        means 0.9 U), on one forward and one adjoint solve."""
        a = torch.ones(fem.ndof, dtype=torch.float64, requires_grad=True)
        U = solve_helmholtz_diff(tmpl, omega, a, bt, **kw)
        r = U - (0.9 * U.detach() if obs is None else obs)
        return U.detach(), torch.autograd.grad(0.5 * torch.dot(r, r), a)[0]

    U_ref, g_ref = u_and_grad(None, tol=1e-11, m=1300, maxit=2)
    obs = 0.9 * U_ref

    a_frozen = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"),
                                   linear_functional(fem, lambda xy: 1.05 + 0 * xy[..., 0])).numpy()
    ddh = DDH(omega, a_frozen, fem, nx=nx, ny=nx, wh_maxit=wh_maxit, device="cpu")
    ddh.prepare(want_io=True)
    hook = ddh_solve_hook(ddh, m=30, maxit=50, tol=1e-11)
    U, g = u_and_grad(obs, solve=hook)
    assert float((U - U_ref).abs().max()) < 1e-6
    assert float((g - g_ref).abs().max()) < 1e-6
    # the forward and the adjoint solve, each converged through P
    assert len(hook.results) == 2 and all(r.success for r in hook.results)
    assert hook.precond.calls == sum(r.num_matvec - 1 - r.num_iter for r in hook.results)

    ja_frozen = np.asarray(jmass.apply_diag_inv_mass(
        jmass.make_diag_inv_mass_op(jfem), jlinear_functional(jfem, lambda xy: 1.05)))
    np.testing.assert_allclose(a_frozen, ja_frozen, rtol=1e-14)
    jddh = JDDH(omega, ja_frozen, jfem, nx=nx, ny=nx, wh_maxit=wh_maxit)
    jddh.prepare(want_io=True, cache_dir="")
    jhook = jinv.ddh_solve_hook(jddh, m=30, maxit=50, tol=1e-11)

    def jloss(a):
        U = jinv.solve_helmholtz_diff(jt, omega, a, jnp.asarray(b), solve=jhook)
        r = U - jnp.asarray(obs.numpy())
        return 0.5 * jnp.vdot(r, r), U

    (_, jU), jg = jax.value_and_grad(jloss, has_aux=True)(jnp.ones(fem.ndof))
    assert np.abs(U.numpy() - np.asarray(jU)).max() < 1e-6
    assert np.abs(g.numpy() - np.asarray(jg)).max() < 1e-6
