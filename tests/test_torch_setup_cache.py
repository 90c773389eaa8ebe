"""The port's DDH setup disk cache and the window-patch io path.

Cache: structured nx 8, block 8 (16 subdomains of 49 DOFs, pad 56, pf 24),
omega = 2 pi nx / 2.5 (nt 200), a uniform medium (a handful of subdomain
types), on the CPU.  A hit restores the transfer stack, the io maps and the
coarse space bitwise and runs no probe; the key changes with omega and
differs from the JAX package's; ``cache_dir=""`` writes nothing; an entry
that does not read is a miss and is deleted.

Patch io: the ``GridH1Space`` DDH of the same size, whose subdomains are
7 x 7 windows at stride 6.  Seeded random io maps in float64 go through
the patch path, the gather path and the JAX package's
``ddh_rhs_io_patch``/``ddh_postprocess_io_patch`` called eagerly under x64
on the same maps (zero-padded to the JAX pad): they agree to 1e-12.
"""

import os
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.ops.structured import GridH1Space as JGridH1Space
from cuddhelmholtz_tpu.solvers import ddh as jddh_mod
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.ops.structured import GridH1Space
from cuddhelmholtz_tpu_torch.solvers import ddh as ddh_mod
from cuddhelmholtz_tpu_torch.solvers.coarse import coarse_arrays
from cuddhelmholtz_tpu_torch.solvers.ddh import (
    DDH,
    IOMaps,
    _build_patch_io,
    _iomaps_split,
    ddh_postprocess_io,
    ddh_postprocess_io_patch,
    ddh_rhs_io,
    ddh_rhs_io_patch,
)
from cuddhelmholtz_tpu_torch.spaces.ensemble import coordinate_bisection_labels
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

torch.set_num_threads(1)

NX, DEG, BLOCK = 8, 3, 8
OMEGA = 2 * np.pi * NX / 2.5  # nt = 200
_FLOAT_FIELDS = ("S", "gmask", "F_weight", "Ha", "inv_mi", "m_gmi", "Hf", "a2wf", "tables")


@pytest.fixture(autouse=True, scope="module")
def _no_default_cache():
    """Only the directories a test names hold a cache here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def _fem(grid: bool = False):
    mesh = Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    return GridH1Space(mesh, Basis(DEG + 1), NX, NX) if grid else H1Space(mesh, Basis(DEG + 1))


def _ddh(omega: float = OMEGA, grid: bool = False) -> DDH:
    fem = _fem(grid)
    return DDH(omega, np.ones(fem.ndof), fem, nx=NX, ny=NX, block_size=BLOCK, device="cpu")


def _b(ddh) -> torch.Tensor:
    return torch.as_tensor(np.random.default_rng(1).standard_normal(2 * ddh.g_ndof),
                           dtype=torch.float32)


def _no_probes(monkeypatch):
    def fail(*a, **k):
        raise AssertionError("a probe ran")

    monkeypatch.setattr(ddh_mod.DDH, "_probe", fail)


@pytest.fixture(scope="module")
def cached(tmp_path_factory):
    """A cache directory holding one entry (transfer, io maps, iterative
    coarse space) and the operator that wrote it."""
    root = tmp_path_factory.mktemp("cache")
    ddh = _ddh()
    stats = ddh.prepare(cache_dir=str(root), want_io=True)
    assert stats["cache_hit"] is False and stats["cache_dir"] == str(root)
    ddh.make_coarse(n_dir=2, domains_per_super=2, method="iterative", solve_m=20,
                    solve_maxit=2, solve_tol=3e-2)
    return root, ddh


def test_round_trip_is_a_hit_without_probes(cached, monkeypatch):
    root, ddh1 = cached
    files = os.listdir(root)
    assert files == [f"ddh_{ddh1.setup_cache_key()}.npz"]
    _no_probes(monkeypatch)
    ddh2 = _ddh()
    stats = ddh2.prepare(cache_dir=str(root))
    assert stats["cache_hit"] is True and stats["load_seconds"] >= 0.0
    assert "transfer_seconds" not in stats and ddh2.transfer_stats == {}
    assert np.array_equal(ddh2._T_u, ddh1._T_u) and ddh2._T_u.dtype == np.float32
    assert np.array_equal(ddh2._T_groups, ddh1._T_groups)
    assert ddh2.route.offs == ddh1.route.offs and torch.equal(ddh2.route.A0, ddh1.route.A0)
    for name in ("Pu", "Pv", "R", "Pul", "Pvl", "onehot"):
        assert torch.equal(getattr(ddh2.io, name), getattr(ddh1.io, name)), name
    got, want = coarse_arrays(ddh2.coarse_space), coarse_arrays(ddh1.coarse_space)
    assert got.keys() == want.keys() == {"V", "sd", "dscale", "nbr", "Eb", "Pinv"}
    for k in want:
        assert np.array_equal(got[k], want[k]), k
    assert torch.equal(ddh2.coarse_space.members, ddh1.coarse_space.members)
    assert ddh2._coarse_meta == ddh1._coarse_meta
    # the coarse solve's (m, maxit, tol) are make_coarse's arguments, not
    # cached: the matching call returns the loaded space and sets them
    cs = ddh2.coarse_space
    assert ddh2.make_coarse(n_dir=2, domains_per_super=2, method="iterative", solve_m=20,
                            solve_maxit=2, solve_tol=3e-2) is cs
    b = _b(ddh1)
    for coarse in (None, "multiplicative"):
        out1, U1 = ddh1.solver(20, 100, 1e-4, coarse=coarse)(b)
        out2, U2 = ddh2.solver(20, 100, 1e-4, coarse=coarse)(b)
        assert out1.success and (out1.num_iter, out1.num_matvec) == (out2.num_iter,
                                                                     out2.num_matvec)
        assert np.array_equal(out1.res_norm.numpy(), out2.res_norm.numpy(), equal_nan=True)
        assert torch.equal(out1.x, out2.x) and torch.equal(U1, U2)


def test_matching_make_coarse_returns_the_cached_space(cached, monkeypatch):
    root, _ = cached
    _no_probes(monkeypatch)
    ddh = _ddh()
    ddh.prepare(cache_dir=str(root))
    cs = ddh.coarse_space
    assert cs is not None
    same = ddh.make_coarse(n_dir=2, domains_per_super=2, method="iterative", solve_m=20,
                           solve_maxit=2, solve_tol=3e-2)
    assert same is cs and ddh.coarse_solve == (20, 2, 3e-2)
    other = ddh.make_coarse(n_dir=2, domains_per_super=1, method="iterative")
    assert other is not cs and other.members.shape[0] == 16


def test_key_changes_with_omega_and_differs_from_jax():
    ddh = _ddh()
    assert _ddh().setup_cache_key() == ddh.setup_cache_key()
    assert _ddh(omega=1.01 * OMEGA).setup_cache_key() != ddh.setup_cache_key()
    jfem = JH1Space(JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), JBasis(DEG + 1))
    jddh = jddh_mod.DDH(OMEGA, np.ones(jfem.ndof), jfem, nx=NX, ny=NX, block_size=BLOCK)
    assert jddh.setup_cache_key() != ddh.setup_cache_key()


def test_empty_cache_dir_writes_nothing(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDDH_CACHE_DIR", str(tmp_path / "env"))
    ddh = _ddh()
    stats = ddh.prepare(cache_dir="", want_io=False)
    assert stats["cache_dir"] is None and stats["cache_hit"] is False
    ddh.make_coarse(n_dir=2, domains_per_super=4)
    assert os.listdir(tmp_path) == []


def test_env_var_names_the_directory(tmp_path, monkeypatch):
    monkeypatch.setenv("CUDDH_CACHE_DIR", str(tmp_path))
    ddh = _ddh()
    assert ddh.prepare(want_io=False)["cache_dir"] == str(tmp_path)
    assert os.listdir(tmp_path) == [f"ddh_{ddh.setup_cache_key()}.npz"]
    assert ddh_mod.DEFAULT_CACHE_DIR.endswith(".ddh_cache_torch")


def test_truncated_file_is_a_miss_and_deleted(tmp_path):
    ddh = _ddh()
    ddh.prepare(cache_dir=str(tmp_path), want_io=False)
    path = tmp_path / f"ddh_{ddh.setup_cache_key()}.npz"
    data = path.read_bytes()
    path.write_bytes(data[: len(data) // 2])
    again = _ddh()
    assert again.try_load_precomputed(str(tmp_path)) is False
    assert not path.exists() and again._T_u is None
    stats = again.prepare(cache_dir=str(tmp_path), want_io=False)
    assert stats["cache_hit"] is False and path.exists()
    assert np.array_equal(again._T_u, ddh._T_u)


def test_hit_without_io_maps_computes_and_saves_them(tmp_path):
    ddh = _ddh()
    ddh.prepare(cache_dir=str(tmp_path), want_io=False)
    path = tmp_path / f"ddh_{ddh.setup_cache_key()}.npz"
    with np.load(path) as z:
        assert "Pu" not in z.files
    again = _ddh()
    stats = again.prepare(cache_dir=str(tmp_path), want_io=True)
    assert stats["cache_hit"] is True and stats["io_seconds"] >= 0.0
    assert again.io is not None and "transfer_seconds" not in stats
    with np.load(path) as z:
        assert np.array_equal(z["Pu"], again.io.Pu.numpy())


# ------------------------------------------------------------------ patch io


def _random_io(ddh, dtype=torch.float64) -> IOMaps:
    """Seeded random io maps of the operator's shapes (nu of its groups)."""
    _, inv, nu = ddh._domain_groups()
    pad, pf = ddh.pad, ddh._fslot_np.shape[1]
    rng = np.random.default_rng(7)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape), dtype=dtype)

    maj, spec = _iomaps_split(inv, "cpu")
    return IOMaps(Pu=t(nu, pad, 2 * pad), Pv=t(nu, pad, 2 * pad), R=t(nu, 2 * pf, 2 * pad),
                  Pul=t(nu, pad, 2 * pf), Pvl=t(nu, pad, 2 * pf),
                  onehot=torch.as_tensor(inv[None, :] == np.arange(nu)[:, None], dtype=dtype),
                  maj=maj, spec_idx=spec)


def _params64(ddh):
    p = ddh.params
    return p._replace(**{f: getattr(p, f).double() for f in _FLOAT_FIELDS})


@pytest.fixture(scope="module")
def grid_ddh():
    return _ddh(grid=True)


def _inputs(ddh, K=None):
    rng = np.random.default_rng(3)
    shape = () if K is None else (K,)
    f = torch.as_tensor(rng.standard_normal((*shape, 2 * ddh.g_ndof)))
    lam = torch.as_tensor(rng.standard_normal((*shape, ddh.size)))
    return f, lam


def test_patch_io_builds_on_the_grid_numbering_only(grid_ddh):
    ddh = grid_ddh
    ddh.set_io_maps(*(_random_io(ddh, torch.float32)[:5]), ddh._domain_groups()[1])
    ddh.use_transfer = True
    pio, pshape = ddh.patch_io()
    assert pio is not None and pshape == (25, 25, 7, 6)
    assert ddh.io_path == "patch"
    assert pio.Rw.shape == (ddh._domain_groups()[2], 48, 98) and pio.w_F.shape == (16, 98)
    f, lam = _inputs(ddh)
    f32, lam32 = f.float(), lam.float()
    assert torch.equal(ddh.rhs(f32), ddh_rhs_io_patch(ddh.params, ddh.io, pio, f32,
                                                      ddh.g_ndof, ddh.n_lambda, pshape))
    assert torch.equal(ddh.postprocess(lam32, f32), ddh_postprocess_io_patch(
        ddh.params, ddh.io, pio, lam32, f32, ddh.g_ndof, ddh.n_own, pshape))

    ref = _ddh()  # the reference (H1Space) numbering of the same mesh
    ref.set_io_maps(*(_random_io(ref, torch.float32)[:5]), ref._domain_groups()[1])
    ref.use_transfer = True
    assert ref.patch_io() == (None, None) and ref.io_path == "gather"

    mesh = load_unstructured_square()
    labels, _ = coordinate_bisection_labels(mesh, 8)
    ufem = H1Space(mesh, Basis(DEG + 1))
    uddh = DDH(OMEGA, np.ones(ufem.ndof), ufem, element_labels=labels, device="cpu")
    uddh.set_io_maps(*(_random_io(uddh, torch.float32)[:5]), uddh._domain_groups()[1])
    assert uddh.patch_io() == (None, None)


@pytest.mark.parametrize("K", [None, 2])
def test_patch_io_matches_gather(grid_ddh, K):
    ddh = grid_ddh
    p, io = _params64(ddh), _random_io(ddh)
    pio, pshape = _build_patch_io(ddh.space, p, io)
    assert pio.Mw.dtype == torch.float64
    f, lam = _inputs(ddh, K)
    want = ddh_rhs_io(p, io, f, ddh.g_ndof, ddh.n_lambda)
    got = ddh_rhs_io_patch(p, io, pio, f, ddh.g_ndof, ddh.n_lambda, pshape)
    assert got.shape == want.shape and _rel(got, want) <= 1e-12
    want = ddh_postprocess_io(p, io, lam, f, ddh.g_ndof, ddh.n_own)
    got = ddh_postprocess_io_patch(p, io, pio, lam, f, ddh.g_ndof, ddh.n_own, pshape)
    assert got.shape == want.shape and _rel(got, want) <= 1e-12


def _jax_pad(M, pad, jpad, rows: bool, fg_cols: bool):
    """A port map with its slot axes zero-padded from ``pad`` to ``jpad``."""
    M = np.asarray(M)
    if rows:
        M = np.pad(M, ((0, 0), (0, jpad - pad), (0, 0)))
    if fg_cols:
        z = ((0, 0), (0, 0), (0, jpad - pad))
        M = np.concatenate([np.pad(M[..., :pad], z), np.pad(M[..., pad:], z)], axis=-1)
    return jnp.asarray(M)


def test_patch_io_matches_jax_called_eagerly(grid_ddh):
    ddh = grid_ddh
    jfem = JGridH1Space(JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), JBasis(DEG + 1), NX, NX)
    jddh = jddh_mod.DDH(OMEGA, np.ones(jfem.ndof), jfem, nx=NX, ny=NX, block_size=BLOCK)
    jp = jddh.params
    jp = jp._replace(**{f: jnp.asarray(np.asarray(getattr(jp, f)), jnp.float64)
                        for f in ("gmask", "F_weight", "m_gmi", "Hf", "a2wf")})
    p, io = _params64(ddh), _random_io(ddh)
    pad, jpad = ddh.pad, jddh.pad
    _, inv, _ = ddh._domain_groups()
    group, maj, spec = jddh_mod._iomaps_split(inv)
    jio = jddh_mod.IOMaps(
        Pu=_jax_pad(io.Pu, pad, jpad, True, True), Pv=_jax_pad(io.Pv, pad, jpad, True, True),
        R=_jax_pad(io.R, pad, jpad, False, True), Pul=_jax_pad(io.Pul, pad, jpad, True, False),
        Pvl=_jax_pad(io.Pvl, pad, jpad, True, False), onehot=jnp.asarray(io.onehot.numpy()),
        group=group, maj=maj, spec_idx=spec)
    jpio, jshape = jddh_mod._build_patch_io(jfem, jp, jio)
    pio, pshape = _build_patch_io(ddh.space, p, io)
    assert jpio is not None and pshape == jshape
    f, lam = _inputs(ddh)
    want = jddh_mod.ddh_rhs_io_patch(jp, jio, jpio, jnp.asarray(f.numpy()), ddh.g_ndof,
                                     ddh.n_lambda, jshape)
    got = ddh_rhs_io_patch(p, io, pio, f, ddh.g_ndof, ddh.n_lambda, pshape)
    assert _rel(got, want) <= 1e-12
    want = jddh_mod.ddh_postprocess_io_patch(jp, jio, jpio, jnp.asarray(lam.numpy()),
                                             jnp.asarray(f.numpy()), ddh.g_ndof, ddh.n_own,
                                             jshape)
    got = ddh_postprocess_io_patch(p, io, pio, lam, f, ddh.g_ndof, ddh.n_own, pshape)
    assert _rel(got, want) <= 1e-12


def _window_case(s: int, h: int = 7, n: int = 3):
    """A hand-built row-major grid tiled by n x n windows of h x h DOFs at
    stride s, with random io maps."""
    W = s * (n - 1) + h
    ys, xs = np.meshgrid(np.arange(W), np.arange(W), indexing="ij")
    space = SimpleNamespace(coords=np.stack([xs.reshape(-1), ys.reshape(-1)], 1).astype(float))
    by, bx = np.meshgrid(np.arange(n), np.arange(n), indexing="ij")
    base = (by.reshape(-1) * s) * W + bx.reshape(-1) * s
    dr, dc = np.meshgrid(np.arange(h), np.arange(h), indexing="ij")
    gI = base[:, None] + (dr * W + dc).reshape(-1)[None]
    ones = torch.ones(gI.shape, dtype=torch.float64)
    params = SimpleNamespace(gI=torch.as_tensor(gI), F_weight=ones, m_gmi=ones)
    nwin, ndom = h * h, n * n
    rng = np.random.default_rng(0)

    def t(*shape):
        return torch.as_tensor(rng.standard_normal(shape))

    io = IOMaps(Pu=t(1, nwin, 2 * nwin), Pv=t(1, nwin, 2 * nwin), R=t(1, 4, 2 * nwin),
                Pul=t(1, nwin, 4), Pvl=t(1, nwin, 4), onehot=torch.ones(1, ndom,
                                                                        dtype=torch.float64))
    return space, params, io


def test_patch_io_refuses_windows_wider_than_twice_the_stride():
    """h <= 2 s: 7-DOF windows at stride 3 overlap three deep and are
    refused; at stride 4 they build."""
    assert _build_patch_io(*_window_case(s=3)) == (None, None)
    pio, pshape = _build_patch_io(*_window_case(s=4))
    assert pio is not None and pshape == (15, 15, 7, 4)
