"""The port at pads whose stiffness exceeds a block's shared memory, against
the JAX package.

Two configurations stand in, at CPU size, for the paths that need the
streamed kernel on the card:

  * structured, 32-DOF blocks (as ``ddh_512_block32``): nx=16 gives 4
    subdomains of 625 DOFs, port pad 632 (JAX pad 640), shared S;
  * the unstructured square refined once (as ``large_unstructured``, which
    refines it three times) and bisected into 16 domains: pad 312 (JAX 384),
    one S per domain, grouped probes.

On the CPU the wrapper runs the plain cycle at any pad, so the CPU tests hold
the port's arithmetic, precompute and solve to the JAX package's.  Each
configuration runs one WaveHoltz iteration at a frequency whose CFL-limited
step count is small (nt = 100 and 27): the leapfrog is unstable at a cut
``nt_override`` (nt = 200 at the structured case's natural frequency gives
inf), and the natural nt (800, 1,300) costs minutes of CPU time.
Tolerances: the cycle 2e-4 relative to the max (as
``test_torch_wave_cycle.py``); the apply 2e-4 relative (as
``test_torch_ddh.py``); solves the same restart and matvec counts, histories
to rtol 2e-3 and solutions to 1e-3 (as ``test_torch_transfer.py``).

The tests marked ``cuda`` hold the streamed kernel, forced, to the plain cycle
in both layouts and to the resident kernel at pad 176; they skip where there
is no GPU.  On a machine without JAX run
``python -m pytest --noconftest tests/test_torch_large_pad.py -m cuda``.
"""

import json

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu_torch.examples.drivers import (
    DriverResult,
    point_sources,
    run_ddh,
    wave_speed_coeff,
)
from cuddhelmholtz_tpu_torch.config import DDH_512_BLOCK32
from cuddhelmholtz_tpu_torch.examples import large_unstructured
from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.mesh.refine import jittered_grid, refine_quad_mesh
from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
from cuddhelmholtz_tpu_torch.ops.functional import linear_functional
from cuddhelmholtz_tpu_torch.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, ddh_params_from_jax
from cuddhelmholtz_tpu_torch.spaces.ensemble import coordinate_bisection_labels
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

# Small shapes: torch's intra-op thread pool costs more than it saves here,
# and beside other busy test processes it slows these tests a hundredfold.
torch.set_num_threads(1)


@pytest.fixture(autouse=True, scope="module")
def _no_setup_cache():
    """``prepare`` here neither reads nor writes a setup cache (in either
    package)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


NX, BLOCK = 16, 32
OMEGA = 2 * np.pi * 12.8  # nt = 100 at nx = 16
L1_DOMAINS, L1_OMEGA_SCALE = 16, 48.0  # nt = 27 on the once-refined mesh
CYCLE_TOL, APPLY_TOL = 2e-4, 2e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _medium(fem, omega):
    """a(x) interpolated at the nodes and the two-source forcing, as
    ``run_ddh`` builds them (host float64)."""
    a_nodal = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"),
                                  linear_functional(fem, wave_speed_coeff))
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega))
    return a_nodal.numpy(), b


def _structured_ddh(device, omega=OMEGA, block=BLOCK, wh_maxit=1):
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(4))
    a_nodal, b = _medium(fem, omega)
    ddh = DDH(omega, a_nodal, fem, nx=NX, ny=NX, block_size=block, wh_maxit=wh_maxit,
              device=device)
    return ddh, a_nodal, b


def _l1_mesh():
    mesh = refine_quad_mesh(load_unstructured_square(), 1)
    return mesh, L1_OMEGA_SCALE * 2 * np.pi / (5 * large_unstructured.median_h(mesh))


@pytest.fixture(scope="module")
def pair632():
    """(JAX DDH, port DDH, a_nodal, b): nx=16, 32-DOF blocks, direct path."""
    jddh_mod = pytest.importorskip("cuddhelmholtz_tpu.solvers.ddh")
    from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
    from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
    from cuddhelmholtz_tpu.utils.basis import Basis as JBasis

    ddh, a_nodal, b = _structured_ddh("cpu")
    jfem = JH1Space(JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), JBasis(4))
    jddh = jddh_mod.DDH(OMEGA, a_nodal, jfem, nx=NX, ny=NX, block_size=BLOCK, wh_maxit=1)
    assert (ddh.n_domains, ddh.pad, jddh.pad, ddh.nt) == (4, 632, 640, 100)
    assert ddh.shared_S and jddh.shared_S
    return jddh, ddh, a_nodal, b


def test_plain_cycle_at_pad_632_matches_xla_scan(pair632):
    import jax.numpy as jnp
    from cuddhelmholtz_tpu.solvers.ddh import _wave_cycle_xla

    jddh, ddh, _, _ = pair632
    arrays = {k: np.asarray(v) for k, v in jddh.params._asdict().items()}
    port = ddh_params_from_jax(arrays, ddh.pad, "cpu")
    rng = np.random.default_rng(0)
    F = (rng.standard_normal(arrays["gmask"].shape) * arrays["gmask"]).astype(np.float32)
    G = (rng.standard_normal(arrays["gmask"].shape) * arrays["gmask"]).astype(np.float32)
    u_x, v_x = _wave_cycle_xla(jddh.params, jnp.asarray(F), jnp.asarray(G), 1,
                               precision="highest")
    u, v = wc.wave_cycle_plain(port, torch.from_numpy(F[:, :632]),
                               torch.from_numpy(G[:, :632]), 1)
    assert np.abs(np.asarray(u_x)[:, 632:]).max() == 0  # the cut slots are padding
    assert _rel_max(u, np.asarray(u_x)[:, :632]) < CYCLE_TOL
    assert _rel_max(v, np.asarray(v_x)[:, :632]) < CYCLE_TOL
    # the port's own setup gives the same cycle data as the JAX package's
    assert _rel_max(ddh.S, port.S) < 1e-6 and torch.equal(ddh.gI, port.gI)


def test_sparse_plain_cycle_at_pad_632_matches_xla_scan(pair632):
    """The plain cycle through the sparse form of the pad-632 S equals the
    dense plain cycle and the JAX scan in float64 (the sums differ only in
    order: 1e-12)."""
    import jax.numpy as jnp
    from cuddhelmholtz_tpu.solvers.ddh import _wave_cycle_xla

    jddh, ddh, _, _ = pair632
    arrays = {k: np.asarray(v) for k, v in jddh.params._asdict().items()}
    fields = ("S", "Ha", "inv_mi", "tables")
    port = ddh_params_from_jax(arrays, ddh.pad, "cpu")
    port = port._replace(**{k: getattr(port, k).double() for k in fields})
    rng = np.random.default_rng(1)
    F = rng.standard_normal(arrays["gmask"].shape) * arrays["gmask"]
    G = rng.standard_normal(arrays["gmask"].shape) * arrays["gmask"]
    form = wc.sparse_form(port.S)
    assert int(form.ptr[0, -1]) == int((port.S != 0).sum()) <= form.stride
    Ft, Gt = torch.from_numpy(F[:, :632]), torch.from_numpy(G[:, :632])
    u, v = wc.wave_cycle_plain(port, Ft, Gt, 1, sparse=form)
    u0, v0 = wc.wave_cycle_plain(port, Ft, Gt, 1)
    assert _rel_max(u, u0) < 1e-12 and _rel_max(v, v0) < 1e-12
    jp = jddh.params._replace(**{k: jnp.asarray(arrays[k], jnp.float64) for k in fields})
    u_x, v_x = _wave_cycle_xla(jp, jnp.asarray(F), jnp.asarray(G), 1, precision="highest")
    assert _rel_max(u, np.asarray(u_x)[:, :632]) < 1e-12
    assert _rel_max(v, np.asarray(v_x)[:, :632]) < 1e-12


@pytest.mark.parametrize("op", ["action", "rhs", "postprocess"])
def test_apply_at_pad_632_matches_jax(pair632, op):
    import jax.numpy as jnp

    jddh, ddh, _, b = pair632
    rng = np.random.default_rng(1)
    lam = rng.standard_normal(ddh.size).astype(np.float32)
    if op == "action":
        got, want = ddh.action(torch.from_numpy(lam)), jddh.action(jnp.asarray(lam))
    elif op == "rhs":
        got, want = ddh.rhs(b), jddh.rhs(jnp.asarray(b.numpy()))
    else:
        got = ddh.postprocess(torch.from_numpy(lam), b)
        want = jddh.postprocess(jnp.asarray(lam), jnp.asarray(b.numpy()))
    assert _rel(got, np.asarray(want)) < APPLY_TOL


def _jax_solve(jddh, b, tol):
    import jax.numpy as jnp

    jddh.prepare(cache_dir="", want_io=False)
    out, U = jddh.solver(20, 100, tol)(jnp.asarray(b.numpy()))
    n = int(out.n_hist)
    return int(out.num_iter), int(out.num_matvec), np.asarray(out.res_norm)[:n], np.asarray(U)


def test_run_ddh_transfer_at_pad_632_matches_jax(pair632):
    """``run_ddh(nx=16, block_size=32, transfer=True)`` to 1e-2 against the
    JAX DDH's transfer-path solve on the same medium and forcing."""
    jddh_mod = pytest.importorskip("cuddhelmholtz_tpu.solvers.ddh")
    jddh, _, a_nodal, b = pair632
    jddh = jddh_mod.DDH(OMEGA, a_nodal, jddh.space, nx=NX, ny=NX, block_size=BLOCK, wh_maxit=1)
    want = _jax_solve(jddh, b, 1e-2)
    got = run_ddh(nx=NX, block_size=BLOCK, transfer=True, tol=1e-2, wh_maxit=1, omega=OMEGA,
                  device="cpu")
    assert got.success and got.extra["ddh"].pad == 632
    assert got.extra["precompute"]["transfer_layout"] == "shared"
    assert (got.num_iter, got.num_matvec) == want[:2]
    np.testing.assert_allclose(got.res_norm, want[2], rtol=2e-3)
    assert _rel(got.solution, want[3]) < 1e-3


def test_config_matches_jax():
    from cuddhelmholtz_tpu.config import BASELINE_CONFIGS

    cfg = DDH_512_BLOCK32
    jcfg = next(c for c in BASELINE_CONFIGS if c.name == cfg.name)
    for name in ("kind", "nx", "deg", "mesh", "wh_maxit", "transfer", "block_size"):
        assert getattr(cfg, name) == getattr(jcfg, name), name
    assert (cfg.gmres.m, cfg.gmres.maxit, cfg.gmres.tol) == (
        jcfg.gmres.m, jcfg.gmres.maxit, jcfg.gmres.tol)
    assert cfg.omega == jcfg.omega


@pytest.mark.parametrize("levels", [1, 2])
def test_refine_matches_jax(levels):
    from cuddhelmholtz_tpu.mesh.io import load_unstructured_square as jload
    from cuddhelmholtz_tpu.mesh.refine import refine_quad_mesh as jrefine

    m, jm = refine_quad_mesh(load_unstructured_square(), levels), jrefine(jload(), levels)
    assert m.n_elem == 119 * 4**levels
    for name in ("vertices", "elem_vertices", "edge_elements", "interior_edges"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name), err_msg=name)


def test_jittered_grid_matches_jax():
    from cuddhelmholtz_tpu.mesh.refine import jittered_grid as jjittered

    m, jm = jittered_grid(9, 7, amount=0.25, seed=1), jjittered(9, 7, amount=0.25, seed=1)
    np.testing.assert_array_equal(m.vertices, jm.vertices)
    np.testing.assert_array_equal(m.elem_vertices, jm.elem_vertices)


def test_refined_unstructured_solve_matches_jax():
    """The ``large_unstructured`` pipeline (``solve_case``: bisection, then
    ``run_ddh(transfer=True)``) on the once-refined mesh with 16 domains and
    one WaveHoltz iteration: grouped probes of per-domain S, the domain
    groups and the solve to 1e-2 against the JAX DDH's."""
    jddh_mod = pytest.importorskip("cuddhelmholtz_tpu.solvers.ddh")
    from cuddhelmholtz_tpu.mesh.io import load_unstructured_square as jload
    from cuddhelmholtz_tpu.mesh.refine import refine_quad_mesh as jrefine
    from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
    from cuddhelmholtz_tpu.utils.basis import Basis as JBasis

    mesh, omega = _l1_mesh()
    labels, _ = coordinate_bisection_labels(mesh, L1_DOMAINS)
    a_nodal, b = _medium(H1Space(mesh, Basis(4)), omega)
    jddh = jddh_mod.DDH(omega, a_nodal, JH1Space(jrefine(jload(), 1), JBasis(4)),
                        element_labels=labels, wh_maxit=1)
    want = _jax_solve(jddh, b, 1e-2)

    got = run_ddh(tol=1e-2, mesh=mesh, element_labels=labels, omega=omega, wh_maxit=1,
                  transfer=True, device="cpu")
    ddh = got.extra["ddh"]
    assert (ddh.pad, jddh.pad, ddh.nt, ddh.shared_S) == (312, 384, 27, False)
    assert got.extra["precompute"]["transfer_layout"] == "grouped"
    _, inv, nu = ddh._domain_groups()
    _, jinv, jnu = jddh._domain_groups()
    assert nu == jnu == L1_DOMAINS and np.array_equal(inv, jinv)
    assert got.success and (got.num_iter, got.num_matvec) == want[:2]
    np.testing.assert_allclose(got.res_norm, want[2], rtol=2e-3)
    assert _rel(got.solution, want[3]) < 1e-3


# ------------------------------------------------------------ on the GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _masked(rng, mask, dev):
    return torch.from_numpy((rng.standard_normal(mask.shape) * mask).astype(np.float32)).to(dev)


def _check(u, v, u0, v0, pad_mask):
    assert _rel_max(u.cpu(), u0.cpu()) < CYCLE_TOL and _rel_max(v.cpu(), v0.cpu()) < CYCLE_TOL
    assert float(u0.abs().max()) > 0
    assert (u[pad_mask] == 0).all() and (v[pad_mask] == 0).all()


@pytest.mark.cuda
def test_streamed_shared_matches_plain(cuda):
    """Layout (a) at pad 632, where of the dense kernels only the streamed
    one fits: 4 subdomains tiled to 20 rows (the last block half full)."""
    ddh, _, _ = _structured_ddh(cuda, wh_maxit=2)
    p = ddh.params
    p = p._replace(Ha=p.Ha.repeat(5, 1), inv_mi=p.inv_mi.repeat(5, 1))
    mask = ddh.gmask.repeat(5, 1)
    rng = np.random.default_rng(2)
    F, G = _masked(rng, mask.cpu().numpy(), cuda), _masked(rng, mask.cpu().numpy(), cuda)
    before = wc.launch_counts()
    u, v = wc.wave_cycle(p, F, G, 2, kernel=wc.k1_kernel(p.S, variant="streamed"))
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, "streamed_shared": before["streamed_shared"] + 1}
    _check(u, v, *wc.wave_cycle_plain(p, F, G, 2), mask == 0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 16, None])
def test_streamed_grouped_matches_plain(cuda, c):
    """Layout (b) at pad 312 (runs of c rows against each domain's S) and,
    with c None, the per-row layout (c) tiled onto it."""
    mesh, omega = _l1_mesh()
    labels, _ = coordinate_bisection_labels(mesh, L1_DOMAINS)
    fem = H1Space(mesh, Basis(4))
    ddh = DDH(omega, _medium(fem, omega)[0], fem, element_labels=labels, wh_maxit=2,
              device=cuda)
    p, mask = ddh.params, ddh.gmask
    if c is not None:
        p = p._replace(Ha=p.Ha.repeat_interleave(c, 0), inv_mi=p.inv_mi.repeat_interleave(c, 0))
        mask = mask.repeat_interleave(c, 0)
    rng = np.random.default_rng(3)
    F, G = _masked(rng, mask.cpu().numpy(), cuda), _masked(rng, mask.cpu().numpy(), cuda)
    before = wc.launch_counts()
    u, v = wc.wave_cycle(p, F, G, 2, c, kernel=wc.k1_kernel(p.S, variant="streamed"))
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, "streamed_grouped": before["streamed_grouped"] + 1}
    _check(u, v, *wc.wave_cycle_plain(p, F, G, 2, c), mask == 0)


@pytest.mark.cuda
def test_streamed_matches_resident_at_pad_176(cuda):
    """Both kernels at the flagship's pad (16-DOF blocks), on the same rows."""
    ddh, _, _ = _structured_ddh(cuda, omega=2 * np.pi * NX / 10, block=16, wh_maxit=1)
    assert ddh.pad == 176
    rng = np.random.default_rng(4)
    m = ddh.gmask.cpu().numpy()
    F, G = _masked(rng, m, cuda), _masked(rng, m, cuda)
    before = wc.launch_counts()
    u_r, v_r = wc.wave_cycle(ddh.params, F, G, 1, kernel=wc.k1_kernel(ddh.S, variant="resident"))
    u_s, v_s = wc.wave_cycle(ddh.params, F, G, 1, kernel=wc.k1_kernel(ddh.S, variant="streamed"))
    torch.cuda.synchronize()
    assert wc.launch_counts() == {
        **before, "shared": before["shared"] + 1,
        "streamed_shared": before["streamed_shared"] + 1,
    }
    _check(u_s, v_s, u_r, v_r, ddh.gmask == 0)
    _check(u_s, v_s, *wc.wave_cycle_plain(ddh.params, F, G, 1), ddh.gmask == 0)


@pytest.mark.parametrize("flag", [["--coarse", "additive"]])
def test_large_unstructured_refuses_unported_options(flag, tmp_path):
    """``--coarse`` is ported now: ``--levels 1 --domains 4 --deg 1 --coarse
    additive`` runs the two-level lambda-solve and its record has a
    ``coarse`` entry (the iterative space, 4 directions, 4 subdomains per
    superdomain: one superdomain of 2 x 9 modes)."""
    out = tmp_path / "rec.jsonl"
    large_unstructured.main(["--levels", "1", "--domains", "4", "--deg", "1", *flag,
                             "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["success"] and rec["case"] == "unstructured_L1_coarse_addi"
    coarse = rec["coarse"]
    assert (coarse["mode"], coarse["n_dir"], coarse["dps"], coarse["nc"]) == (
        "additive", 4, 4, 18)
    assert coarse["build_seconds"] >= 0.0 and rec["ctor_seconds"] >= 0.0


def test_large_unstructured_composite_solves(tmp_path):
    """``--levels 1 --domains 4 --composite`` runs the lambda-solve and the
    coupled 1e-6 solve on the same partition and writes a ``composite``
    record that succeeds, with a true fp64 relative residual <= 1e-6.  At
    ``--deg 1`` (pad 144, nt 321) both take ~20 s on the CPU; at the default
    degree 3 (pad 1,144) the probes alone take minutes there."""
    out = tmp_path / "rec.jsonl"
    large_unstructured.main(["--levels", "1", "--domains", "4", "--deg", "1", "--composite",
                             "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["success"] and (rec["n_domains"], rec["pad"]) == (4, 144)
    comp = rec["composite"]
    assert comp["success"] and comp["final_rel_res"] <= 1e-6
    assert comp["refine_steps"] <= 6 and comp["iters"] <= 100


def test_large_unstructured_composite_record(tmp_path, monkeypatch):
    """The plumbing of ``--composite``: the arguments it hands
    ``run_helmholtz_ddh`` and the record it builds from the result, with a
    recorder in place of the solve (the real solve runs in
    ``test_large_unstructured_composite_solves``)."""
    seen = {}

    def fake(**kw):
        seen.update(kw)
        return DriverResult(
            solution=np.zeros(2), coords=np.zeros((1, 2)), res_norm=np.array([1.0, 1e-7]),
            num_iter=3, num_matvec=70, seconds=0.1, success=True,
            extra={"warm_seconds": 0.05, "refine_steps": 2})

    monkeypatch.setattr(large_unstructured, "run_helmholtz_ddh", fake)
    out = tmp_path / "rec.jsonl"
    large_unstructured.main(["--levels", "1", "--domains", "16", "--omega-scale", "48",
                             "--composite", "--device", "cpu", "--out", str(out)])
    rec = json.loads(out.read_text().splitlines()[0])
    assert rec["success"] and rec["n_domains"] == 16
    assert rec["composite"] == {"success": True, "iters": 3, "matvecs": 70,
                                "warm_seconds": 0.05, "refine_steps": 2,
                                "final_rel_res": 1e-7}
    assert (seen["n_domains"], seen["tol"], seen["device"]) == (16, 1e-6, "cpu")
    assert seen["omega"] == pytest.approx(rec["omega"])
