"""The named-config surface of the port: ``config.BASELINE_CONFIGS``, the
drivers CLI (``examples/drivers.py::main``) and the port bench
(``cuddhelmholtz_tpu_torch/bench.py``), against the JAX package on the CPU.

The bench runs at nx 16 (16 subdomains, nt 800) without its config rows; its
headline counts must equal a direct ``DDH.solver`` call with the same GMRES
options on the same inputs.  A failing config row is recorded and makes the
bench exit non-zero.
"""

import dataclasses
import json

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu import config as jconfig
from cuddhelmholtz_tpu.examples.drivers import main as jmain
from cuddhelmholtz_tpu_torch import bench, config
from cuddhelmholtz_tpu_torch.examples import drivers
from cuddhelmholtz_tpu_torch.examples.drivers import main, point_sources, wave_speed_coeff
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
from cuddhelmholtz_tpu_torch.ops.functional import linear_functional
from cuddhelmholtz_tpu_torch.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _no_setup_cache():
    """``prepare`` here neither reads nor writes a setup cache (in either
    package)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


# fields the port leaves out: no driver of either package reads them (the
# split is DDH(rhs_split=), held to JAX in test_torch_aux.py)
LEFT_OUT = {"rhs_split": "full"}


def test_baseline_configs_match_jax():
    got, want = config.BASELINE_CONFIGS, jconfig.BASELINE_CONFIGS
    assert [c.name for c in got] == [c.name for c in want]
    assert len(got) == 9
    for g, w in zip(got, want):
        gd, wd = dataclasses.asdict(g), dataclasses.asdict(w)
        assert set(wd) - set(gd) == set(LEFT_OUT)
        assert {k: wd[k] for k in LEFT_OUT} == LEFT_OUT
        assert gd == {k: wd[k] for k in gd}, g.name
    hf, ms = config.DDH_HIGH_FREQUENCY, config.DDH_MULTI_SOURCE_8
    assert (hf.nx, hf.omega) == (256, 2 * np.pi * 25.6)
    assert (ms.kind, ms.n_sources, ms.gmres) == ("ddh_multi", 8, config.GmresConfig(40, 100, 1e-4))


def test_run_config_dispatches_ddh_kinds(monkeypatch):
    """``ddh_multi`` reaches ``run_ddh_multi_source`` and ``measure_warm``
    reaches every DDH driver, as in the JAX package."""
    calls = {}

    def recorder(name):
        def run(**kw):
            calls[name] = kw
            return name
        return run

    for name in ("run_ddh", "run_ddh_multi_source"):
        monkeypatch.setattr(drivers, name, recorder(name))
    assert drivers.run_config(config.DDH_MULTI_SOURCE_8, measure_warm=True) == (
        "run_ddh_multi_source")
    kw = calls["run_ddh_multi_source"]
    assert (kw["nx"], kw["m"], kw["maxit"], kw["tol"], kw["n_sources"], kw["transfer"],
            kw["measure_warm"], kw["device"]) == (128, 40, 100, 1e-4, 8, True, True, "cuda")
    drivers.run_config(config.DDH_HIGH_FREQUENCY, measure_warm=True, device="cpu")
    kw = calls["run_ddh"]
    assert (kw["nx"], kw["block_size"], kw["measure_warm"], kw["device"]) == (256, 16, True, "cpu")


def test_cli_record_matches_jax(capsys):
    assert jmain(["poisson_structured", "nx=8"]) == 0
    want = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert main(["poisson_structured", "nx=8"], device="cpu") == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    got = json.loads(lines[0])
    assert set(got) == set(want)
    for k in ("config", "success", "iters", "matvecs"):
        assert got[k] == want[k], k
    assert got["final_rel_res"] == pytest.approx(want["final_rel_res"], rel=1e-6)
    assert main(["no_such_config"], device="cpu") == 1


def test_bench_headline_matches_a_direct_solve(monkeypatch):
    # the scaling key's records come from spawned ranks, checked in
    # test_torch_multiprocess.py; here only that the bench asks for them
    from cuddhelmholtz_tpu_torch.examples import scaling

    asked = []
    monkeypatch.setattr(scaling, "capture_scaling",
                        lambda **kw: asked.append(kw) or {"backend": "gloo", "devices": [1]})
    nx = 16
    rec = bench.run_bench(device="cpu", nx=nx, skip_configs=True)
    assert set(rec) == {"metric", "value", "unit", "vs_baseline", "solve_seconds",
                        "wave_cycle_executed_nnz_s", "extras"}
    ex = rec["extras"]
    assert {"solve_seconds", "setup_seconds", "gmres_restarts", "gmres_matvecs",
            "wave_cycle_executed_nnz_s", "wave_cycle_ms_per_apply", "wave_cycle_dense_tflops",
            "precompute", "baseline_configs", "scaling", "device"} <= set(ex)
    assert ex["baseline_configs"] == {} and ex["device"]["name_power_limit"] is None
    assert asked == [{"device": "cpu"}] and ex["scaling"]["backend"] == "gloo"
    assert rec["value"] > 0 and ex["wave_cycle_ms_per_apply"] > 0

    omega = 2 * np.pi * nx / 10
    fem = H1Space(Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0), Basis(4))
    a = apply_diag_inv_mass(make_diag_inv_mass_op(fem, dtype=torch.float32, device="cpu"),
                            linear_functional(fem, wave_speed_coeff, dtype=torch.float32))
    ddh = DDH(omega, a.numpy().astype(np.float64), fem, nx=nx, ny=nx, device="cpu")
    ddh.prepare(want_io=False)
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega), dtype=torch.float32)
    out, _ = ddh.solver(20, 100, 1e-4, gmres_opts={"deferred": True, "reorth": False})(
        b * (1.0 + bench.PERTURB))
    assert out.success
    assert (ex["gmres_restarts"], ex["gmres_matvecs"]) == (out.num_iter, out.num_matvec)
    # deferred mode: every restart runs all 20 steps plus its true residual
    assert out.num_matvec == 1 + 21 * out.num_iter


def test_bench_records_failures_and_exits_nonzero(monkeypatch, capsys):
    def fail(cfg, **kw):
        raise RuntimeError(f"{cfg.name} refused")

    monkeypatch.setattr(bench, "run_config", fail)
    rows = bench._config_rows("cpu", 1.0)
    assert list(rows) == [
        "ddh_unstructured_square", "ddh_structured", "ddh_high_frequency", "ddh_512_block32",
        "helmholtz_unpreconditioned", "ddh_multi_source_8", "poisson_structured",
        "helmholtz_ddh_1e6", "helmholtz_ddh_unstructured_1e6"]
    assert all("refused" in row["error"] for row in rows.values())
    monkeypatch.setattr(bench, "run_bench", lambda **kw: {"extras": {"baseline_configs": rows}})
    assert bench.main() == 1
    assert json.loads(capsys.readouterr().out)["extras"]["baseline_configs"] == rows


def test_run_ddh_warm_and_out_dir(tmp_path):
    """``run_ddh(measure_warm=, out_dir=)``: a second timed solve, and the
    coordinates, solution and history in the reference's formats."""
    res = drivers.run_ddh(nx=8, block_size=8, transfer=True, tol=1e-2, measure_warm=True,
                          out_dir=str(tmp_path), device="cpu")
    assert res.success and res.extra["warm_seconds"] > 0
    nd = res.extra["ndof"]
    assert np.array_equal(np.fromfile(tmp_path / "xy.0000").reshape(nd, 2), res.coords)
    np.testing.assert_array_equal(np.fromfile(tmp_path / "ddh.0000"), res.solution)
    hist = np.atleast_2d(np.loadtxt(tmp_path / "ddh_8_3.txt"))
    np.testing.assert_allclose(hist[:, 0], res.res_norm, rtol=1e-9)
