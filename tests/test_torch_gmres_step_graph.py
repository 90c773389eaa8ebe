"""The standard GMRES restart's per-step bookkeeping replayed as CUDA graphs
(``solvers/gmres.py::_StepGraphs``).

On a CUDA device each Arnoldi/Givens step of ``_restart``, everything
between the matvec and the exit read (``_arnoldi_givens``), replays one
graph per (step index, n, m, dtype, device, reorth); on the CPU, where the
residual or the matvec's output needs grad, and in a nested solve of a key
already held, the same function runs eagerly.

On the CPU: every solver counts one ``gmres.step.eager`` per step (block and
lock steps included), no ``gmres.step.graphed`` and keeps no graph state;
and the step function gives the JAX package's counts and histories in
float64 for the plain, flexible and LGMRES (``vin``) restarts, with CGS2 and
with single-pass CGS (rtol 1e-10 plus 1e-13 of the initial residual, as
``test_torch_fgmres.py``).

The tests marked ``cuda`` hold the graphed restart to the eager one bit for
bit (``x``, the history, the counts) on a λ-system of the DDH at nx 16 and
on the composite's float64 FGMRES at nx 16; check that a first solve
captures at most m graphs a key and a second none; that a nested solve of a
held key runs eagerly and leaves the outer result as it was; that an input
that needs grad runs eagerly and leaves the cached state without grad; and
that a new ``DDH`` per model captures nothing and keeps no memory.  They skip where there is no
GPU.  On a machine without JAX run
``python -m pytest --noconftest tests/test_torch_gmres_step_graph.py -m cuda``.
"""

import gc
from collections import OrderedDict

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu_torch.solvers import gmres as gmres_mod
from cuddhelmholtz_tpu_torch.solvers.gmres import (
    block_gmres,
    fgmres,
    gmres,
    gmres_lockstep,
    lgmres,
)
from cuddhelmholtz_tpu_torch.utils import spans

torch.set_num_threads(1)

N = 256
STEP = "gmres.step."
HIST_RTOL, HIST_ATOL = 1e-10, 1e-13


def _steps(out) -> int:
    """Arnoldi steps of a solve: its matvecs less r0's and each restart's
    true residual."""
    return out.num_matvec - 1 - out.num_iter


def toeplitz(x):
    """The nonsymmetric Toeplitz operator of ``tests/test_gmres.py`` (a
    numpy or torch vector, or rows of a block)."""
    y = -3.0 * x
    y[..., 1:] += 1.0 * x[..., :-1]
    y[..., :-1] += 1.5 * x[..., 1:]
    return y


def _rhs(n: int = N, seed: int = 42) -> np.ndarray:
    return np.random.default_rng(seed).standard_normal(n)


D = 1.0 + np.random.default_rng(5).random(N)  # a fixed right preconditioner's diagonal


# ------------------------------------------------------------------ on the CPU


@pytest.mark.parametrize("solver", ["gmres", "fgmres", "lgmres"])
def test_cpu_solve_stays_eager(solver, monkeypatch):
    monkeypatch.setattr(gmres_mod, "_WORKSPACES", OrderedDict())
    b = torch.from_numpy(_rhs())
    spans.reset(STEP)
    if solver == "gmres":
        out = gmres(toeplitz, b, m=6, maxit=40, tol=1e-10)
    elif solver == "fgmres":
        out = fgmres(toeplitz, b, lambda v: v / torch.from_numpy(D), m=6, maxit=40, tol=1e-10)
    else:
        out = lgmres(toeplitz, b, m=6, k=2, maxit=40, tol=1e-10)
    assert out.success and _steps(out) > 6
    assert spans.totals(STEP) == {"eager": _steps(out)}
    assert gmres_mod._WORKSPACES == OrderedDict()


@pytest.mark.parametrize("solver", ["deferred", "block", "lockstep"])
def test_other_loops_count_each_step_eager(solver):
    b = torch.from_numpy(_rhs())
    B = torch.from_numpy(np.stack([_rhs(seed=s) for s in (1, 2, 3)]))
    spans.reset(STEP)
    if solver == "deferred":
        out = gmres(toeplitz, b, m=6, maxit=5, tol=0.0, deferred=True)
        want = 6 * out.num_iter
    elif solver == "block":
        out = block_gmres(toeplitz, B, m=4, maxit=3, tol=0.0)
        want = 4 * out.num_iter  # one block step each
    else:
        out = gmres_lockstep(toeplitz, B, m=4, maxit=3, tol=0.0)
        want = 4 * int(out.num_iter.max())  # one lock step each, all lanes
    assert want > 0
    assert spans.totals(STEP) == {"eager": want}


def test_workspace_is_for_cuda_tensors_only(monkeypatch):
    monkeypatch.setattr(gmres_mod, "_WORKSPACES", OrderedDict())
    r = torch.ones(8, dtype=torch.float64)
    assert gmres_mod._workspace(r, 4, True) is None
    assert gmres_mod._workspace(r.requires_grad_(), 4, True) is None
    assert gmres_mod._WORKSPACES == OrderedDict()


def _close(got, want) -> None:
    assert got.success == bool(want.success)
    assert (got.num_iter, got.num_matvec, got.n_hist) == (
        int(want.num_iter), int(want.num_matvec), int(want.n_hist))
    h, hw = got.res_norm.numpy(), np.asarray(want.res_norm)
    assert np.isnan(h[got.n_hist:]).all()
    np.testing.assert_allclose(h[: got.n_hist], hw[: got.n_hist], rtol=HIST_RTOL,
                               atol=HIST_ATOL * hw[0])


@pytest.mark.parametrize("reorth", [True, False], ids=["cgs2", "cgs"])
@pytest.mark.parametrize("variant", ["plain", "flexible", "vin"])
def test_step_function_matches_jax(variant, reorth):
    """The restart on ``_arnoldi_givens`` gives JAX's counts and history in
    float64: ``gmres`` (plain), ``fgmres`` (flexible: the step applies A to
    the stored direction) and ``lgmres`` (``vin``: augmented directions)."""
    import jax.numpy as jnp

    from cuddhelmholtz_tpu.solvers import gmres as jg

    def toeplitz_jax(x):
        return -3.0 * x + jnp.pad(1.0 * x[:-1], (1, 0)) + jnp.pad(1.5 * x[1:], (0, 1))

    b = _rhs()
    kw = dict(maxit=60, tol=1e-10, reorth=reorth)
    spans.reset(STEP)
    if variant == "plain":
        got = gmres(toeplitz, torch.from_numpy(b), m=6, **kw)
        want = jg.gmres(toeplitz_jax, jnp.asarray(b), m=6, **kw)
    elif variant == "flexible":
        got = fgmres(toeplitz, torch.from_numpy(b), lambda v: v / torch.from_numpy(D), m=5, **kw)
        want = jg.fgmres(toeplitz_jax, jnp.asarray(b), lambda v: v / jnp.asarray(D), m=5, **kw)
    else:
        got = lgmres(toeplitz, torch.from_numpy(b), m=5, k=2, **kw)
        want = jg.lgmres(toeplitz_jax, jnp.asarray(b), m=5, k=2, **kw)
    _close(got, want)
    assert got.success
    assert spans.totals(STEP) == {"eager": _steps(got)}


# ------------------------------------------------------------------ on the GPU


@pytest.fixture
def cuda(monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    # every test starts from an empty cache of step graphs
    monkeypatch.setattr(gmres_mod, "_WORKSPACES", OrderedDict())
    return torch.device("cuda")


def _eager(monkeypatch):
    """From here on every restart runs eagerly."""
    monkeypatch.setattr(gmres_mod, "_workspace", lambda r, m, reorth: None)


def _same(got, want) -> None:
    assert (got.success, got.num_iter, got.num_matvec, got.n_hist) == (
        want.success, want.num_iter, want.num_matvec, want.n_hist)
    assert torch.equal(got.x, want.x)
    assert torch.equal(got.res_norm[: got.n_hist], want.res_norm[: want.n_hist])


def _ddh(device, nx: int = 16, rough: bool = False):
    """A prepared transfer DDH (degree 3, 8 x 8-DOF subdomains): a uniform
    medium, or a seeded rough one."""
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
    from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    fem = H1Space(Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), Basis(4))
    a = (1.0 + 0.3 * np.random.default_rng(nx).random(fem.ndof)) if rough else np.ones(fem.ndof)
    ddh = DDH(2 * np.pi * nx / 2.5, a, fem, nx=nx, ny=nx, block_size=8, device=device)
    ddh.prepare(cache_dir="")
    return ddh


def _forcing(ddh, seed: int = 5) -> torch.Tensor:
    g = np.random.default_rng(seed).standard_normal(2 * ddh.g_ndof)
    return torch.from_numpy(g).to(ddh.gmask.device)


def _matrix(cuda, n: int = N, dtype=torch.float64) -> torch.Tensor:
    """A seeded nonsymmetric, well-conditioned dense matrix on the card."""
    g = torch.Generator().manual_seed(3)
    A = 3.0 * torch.eye(n, dtype=dtype) + torch.randn(n, n, generator=g, dtype=dtype) / n ** 0.5
    return A.to(cuda)


@pytest.mark.cuda
def test_lambda_solve_is_the_eager_solve_bitwise(cuda, monkeypatch):
    ddh = _ddh(cuda)
    g = _forcing(ddh)
    spans.reset(STEP)
    out, U = ddh.solver(20, 20, 1e-4)(g)
    counts = spans.totals(STEP)
    assert out.success and counts["graphed"] == _steps(out) and "eager" not in counts
    assert 0 < counts["captures"] <= 20
    _eager(monkeypatch)
    ref, U_ref = ddh.solver(20, 20, 1e-4)(g)
    _same(out, ref)
    assert torch.equal(U, U_ref)


@pytest.mark.cuda
@pytest.mark.parametrize("reorth", [True, False], ids=["cgs2", "cgs"])
def test_fgmres_is_the_eager_fgmres_bitwise(cuda, monkeypatch, reorth):
    """A float64 flexible solve right-preconditioned by a float32 inner
    GMRES, as the composite's: two keys, both graphed."""
    A = _matrix(cuda)
    A32 = A.to(torch.float32)
    b = torch.from_numpy(_rhs()).to(cuda)

    def P(v):
        return gmres(lambda u: A32 @ u, v.to(torch.float32), m=4, maxit=2, tol=0.0).x.to(v.dtype)

    spans.reset(STEP)
    out = fgmres(lambda v: A @ v, b, P, m=6, maxit=30, tol=1e-10, reorth=reorth)
    counts = spans.totals(STEP)
    assert out.success and "eager" not in counts
    assert counts["captures"] <= 6 + 4
    _eager(monkeypatch)
    _same(out, fgmres(lambda v: A @ v, b, P, m=6, maxit=30, tol=1e-10, reorth=reorth))


@pytest.mark.cuda
def test_composite_solve_is_the_eager_solve_bitwise(cuda, monkeypatch):
    """The composite's standard float64 FGMRES(20), P one bounded float32
    DDH solve (``run_helmholtz_ddh(refine=False)``), at nx 16."""
    from cuddhelmholtz_tpu_torch.examples.drivers import run_helmholtz_ddh

    monkeypatch.setenv("CUDDH_CACHE_DIR", "")
    kw = dict(nx=16, refine=False, measure_warm=False, device=cuda)
    spans.reset(STEP)
    got = run_helmholtz_ddh(**kw)
    counts = spans.totals(STEP)
    # the coefficients' mass projections solve on the CPU, eagerly
    assert got.success and counts["graphed"] > 0
    _eager(monkeypatch)
    want = run_helmholtz_ddh(**kw)
    assert (got.num_iter, got.num_matvec) == (want.num_iter, want.num_matvec)
    assert np.array_equal(got.solution, want.solution)
    assert np.array_equal(got.res_norm, want.res_norm, equal_nan=True)


@pytest.mark.cuda
def test_captures_once_per_step_and_key(cuda):
    A = _matrix(cuda)
    b = torch.from_numpy(_rhs()).to(cuda)
    spans.reset(STEP)
    first = gmres(lambda v: A @ v, b, m=8, maxit=20, tol=1e-10)
    assert 0 < spans.total(STEP + "captures") <= 8
    spans.reset(STEP)
    second = gmres(lambda v: A @ v, b, m=8, maxit=20, tol=1e-10)
    assert spans.totals(STEP) == {"graphed": _steps(second)}
    _same(first, second)
    (ws,) = gmres_mod._WORKSPACES.values()
    assert not ws.busy and sum(g is not None for g in ws.graphs) <= 8


@pytest.mark.cuda
def test_nested_solve_of_a_held_key_runs_eagerly(cuda):
    A = _matrix(cuda)
    b = torch.from_numpy(_rhs()).to(cuda)
    plain = gmres(lambda v: A @ v, b, m=8, maxit=20, tol=1e-10)
    nested = []  # (held: the outer restart holds the key's state, result)

    def mv(v):  # a solve of the same key inside every matvec
        held = any(ws.busy for ws in gmres_mod._WORKSPACES.values())
        nested.append((held, gmres(lambda u: A @ u, v.clone(), m=8, maxit=2, tol=0.0)))
        return A @ v

    spans.reset(STEP)
    out = gmres(mv, b, m=8, maxit=20, tol=1e-10)
    counts = spans.totals(STEP)
    _same(out, plain)
    held = sum(_steps(o) for h, o in nested if h)
    free = sum(_steps(o) for h, o in nested if not h)  # r0's and each true residual's
    assert held > 0 and free > 0
    assert counts["eager"] == held and counts["graphed"] == _steps(out) + free
    assert len(gmres_mod._WORKSPACES) == 1


@pytest.mark.cuda
def test_an_input_that_needs_grad_runs_eagerly(cuda, monkeypatch):
    """An input that needs grad, or a right preconditioner whose output does
    on a residual that does not, runs the restart eagerly from its first
    step, as the eager path would, and leaves the cached state without
    grad."""
    A = _matrix(cuda)
    b = torch.from_numpy(_rhs()).to(cuda)
    s = torch.ones((), dtype=A.dtype, device=cuda, requires_grad=True)
    gmres(lambda v: A @ v, b, m=8, maxit=20, tol=1e-10)  # the key's state exists

    def solves():
        return (gmres(lambda v: A @ v, b.clone().requires_grad_(), m=8, maxit=20, tol=1e-10),
                fgmres(lambda v: A @ v, b, lambda v: s * v, m=8, maxit=20, tol=1e-10))

    spans.reset(STEP)
    got = solves()
    assert spans.totals(STEP) == {"eager": sum(_steps(o) for o in got)}
    assert all(o.x.requires_grad for o in got)
    (ws,) = gmres_mod._WORKSPACES.values()
    assert not any(t.requires_grad for t in (*ws.state(), ws.w))
    _eager(monkeypatch)
    for o, ref in zip(got, solves()):
        _same(o, ref)


@pytest.mark.cuda
def test_a_new_operator_per_model_captures_nothing_and_keeps_no_memory(cuda):
    """One operator and one solve per model, as an inversion or the model
    stream runs them: the λ key's step graphs serve every model, and what
    the process holds does not grow with the number of models."""
    def one_model(k):
        ddh = _ddh(cuda, rough=bool(k % 2))
        ddh.solver(20, 5, 1e-4)(_forcing(ddh, seed=k))
        torch.cuda.synchronize()

    for k in range(2):  # both media: what stays with the process is made here
        one_model(k)
    gc.collect()
    held = torch.cuda.memory_allocated()
    spans.reset(STEP)
    for k in range(2, 6):
        one_model(k)
    gc.collect()
    counts = spans.totals(STEP)
    assert counts["graphed"] > 0 and "captures" not in counts and "eager" not in counts
    assert torch.cuda.memory_allocated() - held < 1 << 20
