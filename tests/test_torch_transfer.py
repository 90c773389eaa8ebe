"""The port's transfer/io DDH path against the JAX package.

Structured nx=8, block 8 (16 subdomains of 49 DOFs, pf = 24), omega =
2 pi nx / 2.5 so nt = 200, as ``tests/test_ddh.py``.  Two media: a rough
random one (every subdomain distinct) and a uniform one (a handful of
subdomain types, so the majority split of the transfer matmul and of the io
maps runs).  Host tables (groups, route) must equal the JAX package's
exactly; float32 results agree to 2e-5 relative (the tolerance of
``test_ddh.py``'s transfer-vs-direct checks: one batched product against
maps probed through the same cycle).  ``run_ddh(transfer=True)`` must give
JAX's restart and matvec counts, histories to rtol 2e-3 and solutions to 1e-3
(as ``test_torch_ddh.py``).
"""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.examples.drivers import run_ddh as jrun_ddh
from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.solvers import ddh as jddh_mod
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.solvers import ddh as ddh_mod
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils import spans
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


NX, DEG, BLOCK = 8, 3, 8
OMEGA = 2 * np.pi * NX / 2.5  # nt = 200
TOL = 2e-5


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _rel_max(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


def _pair(medium: str):
    """(JAX DDH, port DDH) with the transfer maps precomputed in both."""
    jfem = JH1Space(JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), JBasis(DEG + 1))
    if medium == "rough":
        a_nodal = 1.0 + 0.3 * np.random.default_rng(0).random(jfem.ndof)
    else:
        a_nodal = np.ones(jfem.ndof)
    jddh = jddh_mod.DDH(OMEGA, a_nodal, jfem, nx=NX, ny=NX, block_size=BLOCK)
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    ddh = ddh_mod.DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX, block_size=BLOCK, device="cpu")
    jddh.precompute_transfer()
    ddh.precompute_transfer()
    return jddh, ddh


@pytest.fixture(scope="module", params=["rough", "uniform"])
def pair(request):
    return _pair(request.param)


@pytest.fixture(scope="module")
def rough():
    return _pair("rough")


def test_domain_groups_match_jax(pair):
    jddh, ddh = pair
    _, jinv, jnu = jddh._domain_groups()
    uidx, inv, nu = ddh._domain_groups()
    assert nu == jnu and np.array_equal(inv, jinv)
    assert np.array_equal(uidx, jddh._domain_groups()[0])


def test_transfer_matrices_match_jax(pair):
    jddh, ddh = pair
    assert ddh._T_u.shape == jddh._T_u.shape == (ddh._domain_groups()[2], 48, 48)
    assert _rel_max(ddh._T_u, jddh._T_u) < TOL
    assert ddh.transfer_stats["transfer_layout"] == "shared"


def test_route_matches_jax(pair):
    jddh, ddh = pair
    r, jr = ddh.route, jddh.route
    assert r is not None and jr is not None
    assert r.offs == jddh.route_offs
    assert torch.equal(r.perms, torch.tensor(jddh.route_perms))
    assert np.array_equal(r.masks.float().numpy(), np.asarray(jr.masks, np.float32))
    assert np.array_equal(r.irr_src.numpy(), np.asarray(jr.irr_src))
    assert np.array_equal(r.irr_tgt.numpy(), np.asarray(jr.irr_tgt))
    for name in ("A", "A0", "A_spec", "spec_idx"):
        assert (getattr(r, name) is None) == (getattr(jr, name) is None), name
    if r.A0 is not None:
        assert _rel_max(r.A0, np.asarray(jr.A0)) < TOL
    if r.spec_idx is not None:
        assert np.array_equal(r.spec_idx.numpy(), np.asarray(jr.spec_idx))


def test_scatter_indices_are_unique(pair):
    """Every set or add the transfer path makes at a list of indices (route
    remainder, majority corrections, dual-trace writes) has distinct
    indices, so their order on a GPU does not matter."""
    _, ddh = pair
    r = ddh.route
    for idx in (r.irr_tgt, r.spec_idx, ddh.B1[ddh.B1 >= 0]):
        if idx is not None:
            assert idx.numel() == torch.unique(idx).numel()


def test_transfer_actions_match(pair):
    """Rolled and scatter exchanges against the port's direct action and
    the JAX rolled action on the same lambda."""
    jddh, ddh = pair
    lam = torch.from_numpy(np.random.default_rng(1).standard_normal(ddh.size).astype(np.float32))
    rolled = ddh.action(lam)
    scatter = ddh_mod.ddh_action_transfer(ddh.params, ddh.T, lam, ddh.n_own)
    direct = ddh_mod.ddh_action(ddh.params, lam, n_own=ddh.n_own)
    want = np.asarray(jddh.action(jnp.asarray(lam.numpy())))
    assert _rel(rolled, direct) < TOL and _rel(scatter, direct) < TOL
    assert _rel(rolled, want) < TOL


@pytest.mark.parametrize("op", ["rhs", "postprocess"])
def test_io_path_matches_wave_path(rough, op):
    _, ddh = rough
    if ddh.io is None:
        ddh.precompute_io_maps()
    assert ddh.io_stats["io_ncols"] == 2 * ddh.pad + 48
    rng = np.random.default_rng(2)
    f = torch.from_numpy(rng.standard_normal(2 * ddh.g_ndof))
    lam = torch.from_numpy(rng.standard_normal(ddh.size).astype(np.float32))
    if op == "rhs":
        got = ddh.rhs(f)
        want = ddh_mod.ddh_rhs(ddh.params, f, ddh.g_ndof, ddh.n_lambda)
    else:
        got = ddh.postprocess(lam, f)
        want = ddh_mod.ddh_postprocess(ddh.params, lam, f, ddh.g_ndof, n_own=ddh.n_own)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("layout", ["shared", "grouped"])
def test_probe_chunks_agree(monkeypatch, layout):
    """Probe columns split into several chunks (a tiny state bound) give the
    transfer matrices of one chunk; grouped chunks are rounded to runs of
    8 rows and zero-padded."""
    rng = np.random.default_rng(3)
    mesh = Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    if layout == "grouped":  # jitter the interior vertices: one S per domain
        verts = mesh.vertices.copy()
        inner = (np.abs(np.abs(verts) - 1) > 1e-12).all(axis=1)
        verts[inner] += 0.15 * (2.0 / NX) * rng.uniform(-1, 1, (inner.sum(), 2))
        mesh = Mesh2D.from_vertices(verts, mesh.elem_vertices)
    fem = H1Space(mesh, Basis(DEG + 1))
    ddh = ddh_mod.DDH(OMEGA, 1.0 + 0.2 * rng.random(fem.ndof), fem, nx=NX, ny=NX,
                      block_size=BLOCK, wh_maxit=1, device="cpu")
    one = ddh.precompute_transfer().copy()
    assert ddh.transfer_stats["transfer_layout"] == layout
    nu = ddh._domain_groups()[2]
    monkeypatch.setattr(ddh_mod, "PROBE_STATE_ELEMS", 10 * nu * ddh.pad)
    with spans.recording() as rec:
        many = ddh.precompute_transfer()
    assert ddh.transfer_stats["transfer_chunk_cols"] == (8 if layout == "grouped" else 10)
    assert sum(1 for sp in rec.spans if sp[0] == "ddh.probe") > 4
    assert np.abs(many - one).max() <= 1e-6 * np.abs(one).max()


def test_io_maps_refuse_max_bytes():
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    ddh = ddh_mod.DDH(OMEGA, np.ones(fem.ndof), fem, nx=NX, ny=NX, block_size=BLOCK,
                      device="cpu")
    assert ddh.precompute_io_maps(max_bytes=1 << 10) is None and ddh.io is None


@pytest.mark.parametrize("inv", [
    [0] * 9 + [1, 2, 1, 3, 2, 0, 1],  # majority group 0: shared product + specials
    [0, 1, 2, 3] * 3,  # 4 nu > ndom: per-domain gather
    [0, 1, 2, 3] * 4,  # 4 nu <= ndom, no majority: one-hot combine
], ids=["majority", "gather", "onehot"])
def test_group_apply_branches(inv):
    inv = np.asarray(inv)
    nu, ndom = inv.max() + 1, inv.size
    rng = np.random.default_rng(4)
    M = torch.from_numpy(rng.standard_normal((nu, 5, 7)).astype(np.float32))
    x = torch.from_numpy(rng.standard_normal((ndom, 7)).astype(np.float32))
    onehot = torch.from_numpy((inv[None, :] == np.arange(nu)[:, None]).astype(np.float32))
    maj, spec = ddh_mod._iomaps_split(inv, "cpu")
    assert (spec is not None) == (inv.tolist().count(0) >= ndom / 2)
    got = ddh_mod._group_apply(M, x, onehot, maj, spec)
    want = torch.stack([M[inv[d]] @ x[d] for d in range(ndom)])
    assert torch.allclose(got, want, rtol=1e-6, atol=1e-6)


def test_jax_maps_carried_over(rough):
    """The JAX package's own maps, installed in the port's DDH: the port's
    exchange and io apply must reproduce JAX's on identical maps."""
    jddh, _ = rough
    if jddh.io is None:
        jddh.precompute_io_maps()
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    ddh = ddh_mod.DDH(OMEGA, 1.0 + 0.3 * np.random.default_rng(0).random(fem.ndof), fem,
                      nx=NX, ny=NX, block_size=BLOCK, device="cpu")
    maps = {"T_u": jddh._T_u, "groups": jddh._T_groups}
    maps.update({k: np.asarray(getattr(jddh.io, k)) for k in ("Pu", "Pv", "R", "Pul", "Pvl")})
    ddh_mod.load_jax_maps(ddh, maps, jax_pad=jddh.pad)
    assert ddh.io.Pu.shape == (16, ddh.pad, 2 * ddh.pad) and ddh.route is not None
    rng = np.random.default_rng(5)
    lam = rng.standard_normal(ddh.size).astype(np.float32)
    f = rng.standard_normal(2 * ddh.g_ndof)
    jp, jio = jddh.params, jddh.io
    want = {
        "action": jddh.action(jnp.asarray(lam)),
        "rhs": jddh_mod.ddh_rhs_io(jp, jio, jnp.asarray(f), jddh.g_ndof, jddh.n_lambda),
        "post": jddh_mod.ddh_postprocess_io(jp, jio, jnp.asarray(lam), jnp.asarray(f),
                                            jddh.g_ndof, jddh.n_own),
    }
    lam_t, f_t = torch.from_numpy(lam), torch.from_numpy(f)
    got = {"action": ddh.action(lam_t), "rhs": ddh.rhs(f_t), "post": ddh.postprocess(lam_t, f_t)}
    for k in want:
        assert _rel(got[k], np.asarray(want[k])) < 1e-6, k


def test_run_ddh_transfer_matches_jax(monkeypatch, tmp_path):
    """nx=8, nt=800, tol=1e-2: two restarts on the rolled transfer path."""
    monkeypatch.setenv("CUDDH_CACHE_DIR", str(tmp_path))
    kw = dict(nx=8, deg=3, block_size=8, transfer=True, tol=1e-2)
    want = jrun_ddh(**kw)
    got = run_ddh(**kw, device="cpu")
    assert got.success and want.success
    assert got.extra["ddh"].route is not None and got.extra["precompute"]["transfer_nu"] > 0
    assert (got.num_iter, got.num_matvec) == (want.num_iter, want.num_matvec)
    np.testing.assert_allclose(got.res_norm, want.res_norm, rtol=2e-3)
    assert _rel(got.solution, want.solution) < 1e-3


def test_device_defaults_to_the_card(monkeypatch):
    """Entry points run on the card unless asked for the CPU; without a
    CUDA device they raise instead of falling back."""
    assert inspect.signature(run_ddh).parameters["device"].default == "cuda"
    assert inspect.signature(ddh_mod.DDH).parameters["device"].default == "cuda"
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        run_ddh(nx=8, block_size=8)
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ddh_mod.DDH(OMEGA, np.ones(fem.ndof), fem, nx=NX, ny=NX, block_size=BLOCK)
