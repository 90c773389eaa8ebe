"""The composite 1e-6 solve (``run_helmholtz_ddh``) against the JAX package.

``run_helmholtz_ddh(nx=8, m=10, maxit=30, inner_maxit=2, wh_maxit=2)`` runs
in both packages with the DDH io maps precomputed (the JAX package's
``CUDDH_IO_MAPS=1``; the port always builds them on the transfer path), so
each preconditioner application runs no wave cycle on the CPU.  The refinement steps, outer
restarts and matvecs must be equal, and both solutions within 1e-5 relative
of a dense direct solve of the same fp64 operator.  The port's stagnation
contract (an unreachable tol=1e-16), its ``refine=False`` branch and the
dispatch of the four new configurations by ``run_config`` are checked on the
port alone.
"""

import dataclasses

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu_torch import config
from cuddhelmholtz_tpu_torch.examples import drivers
from cuddhelmholtz_tpu_torch.examples.drivers import (
    point_sources,
    run_config,
    run_helmholtz_ddh,
    wave_speed_coeff,
)
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import (
    apply_helmholtz,
    helmholtz_rhs,
    make_helmholtz_op,
    project_coefficients,
)
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _no_setup_cache():
    """``prepare`` here neither reads nor writes a setup cache (in either
    package)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


NX = 8
SMALL = dict(nx=NX, m=10, maxit=30, inner_maxit=2)
DIRECT_TOL = 1e-5


@pytest.fixture(scope="module")
def direct_solution():
    """Dense direct solve of the fp64 coupled operator at nx=8 (H1
    numbering), with the drivers' medium and forcing."""
    mesh = Mesh2D.uniform_rect(NX, -1.0, 1.0, NX, -1.0, 1.0)
    fem = H1Space(mesh, Basis(4))
    fs = FaceSpace(fem, mesh.boundary_edges)
    omega = 2 * np.pi * NX / 10
    a2, af = project_coefficients(fem, fs, wave_speed_coeff)
    op = make_helmholtz_op(omega, a2, af, fem, fs, device="cpu")
    n2 = 2 * fem.ndof
    eye = torch.eye(n2, dtype=torch.float64)
    A = torch.stack([apply_helmholtz(op, eye[i]) for i in range(n2)], dim=1).numpy()
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega)).numpy()
    return np.linalg.solve(A, b)


def _rel(x, ref):
    return float(np.linalg.norm(x - ref) / np.linalg.norm(ref))


def test_composite_matches_jax(direct_solution, monkeypatch):
    from cuddhelmholtz_tpu.examples.drivers import run_helmholtz_ddh as jrun

    monkeypatch.setenv("CUDDH_IO_MAPS", "1")
    want = jrun(**SMALL, wh_maxit=2, measure_warm=False)
    got = run_helmholtz_ddh(**SMALL, wh_maxit=2, measure_warm=False,
                            device="cpu")
    assert got.extra["precompute"]["io_nu"] == 4 and got.extra["ddh"].io is not None
    assert got.extra["refine"] is True and got.success and bool(want.success)
    assert got.extra["refine_steps"] == want.extra["refine_steps"]
    assert (got.num_iter, got.num_matvec) == (int(want.num_iter), int(want.num_matvec))
    assert len(got.res_norm) == got.extra["refine_steps"] + 1
    assert got.res_norm[-1] / got.res_norm[0] < 1e-6
    assert len(got.extra["inner_histories"]) == got.extra["refine_steps"]
    assert got.extra["n_precond"] == got.num_iter * 10
    assert np.array_equal(got.coords, want.coords)
    assert _rel(got.solution, direct_solution) < DIRECT_TOL
    assert _rel(np.asarray(want.solution), direct_solution) < DIRECT_TOL


def test_stagnation_contract():
    """An unreachable tolerance trips the refinement's stagnation guard: the
    record says so (success false, stagnated true) with one true fp64
    residual per refinement step, stalled near the fp64 floor."""
    res = run_helmholtz_ddh(**SMALL, wh_maxit=1, tol=1e-16,
                            measure_warm=False, device="cpu")
    assert not res.success
    assert res.extra["stagnated"] is True
    assert 2 <= res.extra["refine_steps"] <= 6
    assert len(res.res_norm) == res.extra["refine_steps"] + 1
    assert len(res.extra["inner_histories"]) == res.extra["refine_steps"]
    assert res.res_norm[-1] >= 0.9 * res.res_norm[-2]
    assert res.res_norm[-1] / res.res_norm[0] < 1e-4


def test_refine_false_runs_one_fgmres(direct_solution):
    """``refine=False``: one standard FGMRES on the fp64 operator, run twice
    on the same b (``measure_warm``) with the same counts."""
    res = run_helmholtz_ddh(**SMALL, wh_maxit=1, refine=False, device="cpu")
    assert res.success and res.extra["refine"] is False
    assert res.extra["warm_seconds"] > 0
    first = res.extra["first_run"]
    assert (first["num_iter"], first["num_matvec"]) == (res.num_iter, res.num_matvec)
    np.testing.assert_array_equal(first["res_norm"], res.res_norm)
    assert len(res.res_norm) == res.num_iter + 1
    assert res.res_norm[-1] / res.res_norm[0] <= 1e-6
    assert res.extra["n_precond"] == res.num_matvec - 1 - res.num_iter
    assert _rel(res.solution, direct_solution) < DIRECT_TOL


def test_run_config_dispatches_new_kinds(monkeypatch):
    """Each new configuration reaches its driver with the config's fields."""
    calls = {}

    def recorder(name):
        def run(**kw):
            calls[name] = kw
            return name
        return run

    for name in ("run_poisson", "run_helmholtz", "run_helmholtz_ddh"):
        monkeypatch.setattr(drivers, name, recorder(name))
    assert run_config(config.POISSON_STRUCTURED, device="cpu") == "run_poisson"
    assert calls["run_poisson"] == dict(nx=15, deg=3, m=20, maxit=20, tol=1e-6, device="cpu")
    assert run_config(config.HELMHOLTZ_UNPRECONDITIONED, maxit=10) == "run_helmholtz"
    kw = calls["run_helmholtz"]
    assert (kw["nx"], kw["m"], kw["maxit"], kw["tol"], kw["dtype"], kw["mesh"]) == (
        128, 200, 10, 1e-6, torch.float32, None)
    assert kw["device"] == "cuda"
    assert run_config(config.HELMHOLTZ_DDH_1E6, measure_warm=False) == "run_helmholtz_ddh"
    kw = calls["run_helmholtz_ddh"]
    assert (kw["nx"], kw["m"], kw["maxit"], kw["tol"], kw["wh_maxit"], kw["transfer"],
            kw["mesh"], kw["measure_warm"]) == (128, 20, 100, 1e-6, 5, True, None, False)
    run_config(config.HELMHOLTZ_DDH_UNSTRUCTURED_1E6, device="cpu")
    kw = calls["run_helmholtz_ddh"]
    assert (kw["nx"], kw["n_domains"], kw["mesh"].n_elem, kw["tol"]) == (8, 8, 119, 1e-6)
    with pytest.raises(ValueError, match="unknown config kind"):
        run_config(dataclasses.replace(config.DDH_STRUCTURED, kind="nope"), device="cpu")


def compare_with_jax(nx: int) -> dict:
    """``run_helmholtz_ddh(nx=nx)`` at the default budgets in both packages
    on the CPU, the JAX package under x64 with its io maps precomputed in
    fp32 (``CUDDH_IO_MAPS=1``): refinement steps, outer restarts, matvecs
    and the outer (true fp64 residual) and inner FGMRES histories of each."""
    import os

    os.environ["CUDDH_IO_MAPS"] = "1"
    from cuddhelmholtz_tpu.examples.drivers import run_helmholtz_ddh as jrun

    out = {}
    for name, run in (("jax", lambda: jrun(nx=nx, measure_warm=False)),
                      ("port", lambda: run_helmholtz_ddh(nx=nx, measure_warm=False,
                                                         device="cpu"))):
        r = run()
        out[name] = {
            "refine_steps": int(r.extra["refine_steps"]), "restarts": int(r.num_iter),
            "matvecs": int(r.num_matvec), "success": bool(r.success),
            "outer": [float(x) for x in np.asarray(r.res_norm)],
            "inner_tols": [float(t) for t in r.extra["inner_tols"]],
            "inner": [[float(x) for x in h] for h in r.extra["inner_histories"]],
        }
    return out


if __name__ == "__main__":
    # python tests/test_torch_composite.py NX [NX ...]: one JSON line per nx
    import json
    import os
    import sys

    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ["CUDDH_X64"] = "1"
    for arg in sys.argv[1:]:
        print(json.dumps({"nx": int(arg), **compare_with_jax(int(arg))}), flush=True)
