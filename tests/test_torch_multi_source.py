"""Multi-source DDH (``run_ddh_multi_source``) against the JAX package.

Every batched apply folds the K sources into the subdomain row axis; it
must equal K single-source applies (direct and transfer/io paths, a rough
medium at nx 8, block 8, omega raised so nt = 200, as
``test_torch_transfer.py``).  The driver runs in both packages at nx 16,
deg 1 (4 subdomains, nt 200), K = 2 and 3 ring sources, tol 1e-3, on the
direct path with ``method="vmap"`` (lock-step GMRES) and ``"block"`` (block
GMRES), and once on the transfer/io path with the JAX package's maps
carried over by ``load_jax_maps``: restarts and per-source matvecs equal,
solutions within 1e-3 relative (the DDH runs in float32, as
``test_torch_transfer.py`` compares it).  deg 1 keeps the CPU cost down:
at deg 3 the CFL step count is 800, four times deg 1's.
"""

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.examples.drivers import run_ddh_multi_source as jrun
from cuddhelmholtz_tpu_torch.examples import drivers
from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh_multi_source
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.solvers import ddh as ddh_mod
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


SMALL = dict(nx=16, deg=1, tol=1e-3)
RUNS = {}  # (K, method, transfer) -> (JAX result, port result)


def _run(K: int, method: str, transfer: bool = False, **port_kw):
    key = (K, method, transfer)
    if key not in RUNS:
        kw = dict(SMALL, n_sources=K, method=method, transfer=transfer)
        RUNS[key] = (jrun(**kw), run_ddh_multi_source(**kw, **port_kw, device="cpu"))
    return RUNS[key]


def _rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _same(want, got, K):
    assert got.success and bool(want.success)
    assert got.extra["per_source_restarts"] == list(want.extra["per_source_restarts"])
    assert got.extra["per_source_matvecs"] == list(want.extra["per_source_matvecs"])
    assert got.solution.shape == np.asarray(want.solution).shape == (K, 2 * got.extra["ndof"])
    assert _rel(got.solution, want.solution) < 1e-3
    for h, hw in zip(got.extra["histories"], want.extra["histories"]):
        np.testing.assert_allclose(h, np.asarray(hw), rtol=2e-3)


@pytest.mark.parametrize("method", ["vmap", "block"])
@pytest.mark.parametrize("K", [2, 3])
def test_direct_path_matches_jax(K, method):
    want, got = _run(K, method)
    _same(want, got, K)
    assert got.extra["method"] == method and got.extra["n_sources"] == K


@pytest.mark.parametrize("K", [2, 3])
def test_block_needs_no_more_restarts_than_vmap(K):
    """The shared block space takes no more restarts than the slowest lane
    of the lock-step solve, for one block matvec per step."""
    _, vm = _run(K, "vmap")
    _, bl = _run(K, "block")
    assert bl.num_iter <= max(vm.extra["per_source_restarts"])
    # block: one restart count, 1 + (m + 1) per restart for each source
    assert bl.extra["per_source_matvecs"] == [1 + 21 * bl.num_iter] * K


def test_transfer_path_with_jax_maps(monkeypatch, tmp_path):
    """Block GMRES on the rolled transfer path and the io maps, on the JAX
    package's own maps (probed under ``CUDDH_IO_MAPS=1``)."""
    monkeypatch.setenv("CUDDH_IO_MAPS", "1")
    monkeypatch.setenv("CUDDH_CACHE_DIR", str(tmp_path))
    kw = dict(SMALL, n_sources=2, method="block", transfer=True)
    want = jrun(**kw)
    jddh = want.extra["ddh"]
    maps = {"T_u": jddh._T_u, "groups": jddh._T_groups}
    maps.update({k: np.asarray(getattr(jddh.io, k)) for k in ("Pu", "Pv", "R", "Pul", "Pvl")})

    def prepare(self, want_io=True):
        ddh_mod.load_jax_maps(self, maps, jax_pad=jddh.pad)
        return {}

    monkeypatch.setattr(ddh_mod.DDH, "prepare", prepare)
    got = run_ddh_multi_source(**kw, device="cpu")
    ddh = got.extra["ddh"]
    assert ddh.use_transfer and ddh.route is not None and ddh.io is not None
    _same(want, got, 2)


def test_out_dir_artifacts(tmp_path):
    """The coordinates, each source's solution and history, in the
    reference's formats."""
    got = run_ddh_multi_source(**SMALL, n_sources=2, method="block", transfer=False,
                               out_dir=str(tmp_path), device="cpu")
    nd = got.extra["ndof"]
    # raw float64 in Fortran order (``numpy.fromfile``)
    assert np.array_equal(np.fromfile(tmp_path / "xy.0000").reshape(nd, 2), got.coords)
    for k in range(2):
        np.testing.assert_array_equal(np.fromfile(tmp_path / f"ddh_src{k:02d}.0000"),
                                      got.solution[k])
        hist = np.loadtxt(tmp_path / f"ddh_src{k:02d}_16_1.txt")
        np.testing.assert_allclose(hist[:, 0], got.extra["histories"][k], rtol=1e-9)
        assert np.isnan(hist[:, 1]).all()


def test_refusals():
    # shard_sources without a process group: one shard, the replicated solve
    one = run_ddh_multi_source(**SMALL, shard_sources=True, device="cpu")
    ref = run_ddh_multi_source(**SMALL, device="cpu")
    assert one.extra["n_shard"] == 1
    assert np.array_equal(one.solution, ref.solution)
    assert one.extra["per_source_matvecs"] == ref.extra["per_source_matvecs"]
    with pytest.raises(ValueError, match="method"):
        run_ddh_multi_source(**SMALL, method="loop", device="cpu")
    fem = H1Space(Mesh2D.uniform_rect(8, -1, 1, 8, -1, 1), Basis(4))
    ddh = ddh_mod.DDH(2 * np.pi * 8 / 2.5, np.ones(fem.ndof), fem, nx=8, ny=8, block_size=8,
                      device="cpu")
    with pytest.raises(ValueError, match="coarse"):
        ddh.solver(20, 10, 1e-4, block=True, coarse="additive")
    assert drivers.run_config.__doc__


@pytest.fixture(scope="module")
def rough_ddh():
    """nx 8, block 8, a rough medium (every subdomain distinct), nt 200,
    with its transfer and io maps probed on the CPU."""
    fem = H1Space(Mesh2D.uniform_rect(8, -1, 1, 8, -1, 1), Basis(4))
    a = 1.0 + 0.3 * np.random.default_rng(0).random(fem.ndof)
    ddh = ddh_mod.DDH(2 * np.pi * 8 / 2.5, a, fem, nx=8, ny=8, block_size=8, device="cpu")
    return ddh


@pytest.mark.parametrize("path", ["direct", "rolled", "scatter"])
def test_batched_apply_is_per_source(rough_ddh, path):
    """action, rhs and postprocess of a (3, n) block equal three single
    applies, row for row."""
    ddh = rough_ddh
    if path == "direct":
        ddh.use_transfer = False
    else:
        if ddh.io is None:
            ddh.prepare(want_io=True)
        ddh.use_transfer = True
    route = ddh.route
    if path == "scatter":
        ddh.route = None
    try:
        rng = np.random.default_rng(9)
        lam = torch.from_numpy(rng.standard_normal((3, ddh.size)).astype(np.float32))
        f = torch.from_numpy(rng.standard_normal((3, 2 * ddh.g_ndof)))
        got = {"action": ddh.action(lam), "rhs": ddh.rhs(f), "post": ddh.postprocess(lam, f)}
        for k in range(3):
            want = {"action": ddh.action(lam[k]), "rhs": ddh.rhs(f[k]),
                    "post": ddh.postprocess(lam[k], f[k])}
            for name, w in want.items():
                assert got[name].shape[1:] == w.shape
                assert _rel(got[name][k], w) < 1e-6, (path, name, k)
    finally:
        ddh.route = route
