"""Setup parity of the PyTorch port against the JAX package.

Quadrature, basis, mesh, H1 and ensemble tables and the DDH setup (B-tables,
own-slot layout, subdomain operators) go through both packages from the same
inputs.  The host setup is NumPy float64 in both, so index tables must agree
bitwise and float tables to round-off; the DDH device tables are float32 in
both and are compared at 1e-6 relative on real slots (the port pads a
subdomain to a multiple of 8, the JAX package to 128).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.solvers.ddh import DDH as JDDH
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu.utils.quadrature import QuadratureRule as JQuad
from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh, run_ddh_multi_source
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, ddh_params_from_jax
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis
from cuddhelmholtz_tpu_torch.utils.quadrature import QuadratureRule

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


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, DEG, BLOCK = 8, 3, 8
OMEGA = 2 * np.pi * NX / 2.5  # nt = 200 at the CFL-limited dt (test_ddh_oracle.py)


def _jax_fields(params) -> dict:
    return {name: np.asarray(getattr(params, name)) for name in params._fields}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


@pytest.fixture(scope="module")
def pair():
    """(JAX DDH, port DDH) on the same mesh and a rough random medium."""
    jmesh = JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    jfem = JH1Space(jmesh, JBasis(DEG + 1))
    a_nodal = 1.0 + 0.3 * np.random.default_rng(0).random(jfem.ndof)
    jddh = JDDH(OMEGA, a_nodal, jfem, nx=NX, ny=NX, block_size=BLOCK)
    mesh = Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    fem = H1Space(mesh, Basis(DEG + 1))
    ddh = DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX, block_size=BLOCK, device="cpu")
    return jddh, ddh


@pytest.mark.parametrize("n", [2, 3, 4, 5, 8, 12])
@pytest.mark.parametrize("kind", ["lobatto", "legendre"])
def test_quadrature_and_basis_match(n, kind):
    if kind == "lobatto":
        q, jq = QuadratureRule(n), JQuad(n)
        np.testing.assert_allclose(Basis(n).derivative_matrix, JBasis(n).derivative_matrix,
                                   rtol=0, atol=1e-14)
        np.testing.assert_allclose(Basis(n).mass_matrix, JBasis(n).mass_matrix,
                                   rtol=0, atol=1e-14)
    else:
        q, jq = QuadratureRule(n, "legendre"), JQuad(n, "legendre")
    np.testing.assert_allclose(q.x, jq.x, rtol=0, atol=1e-14)
    np.testing.assert_allclose(q.w, jq.w, rtol=0, atol=1e-14)


def test_mesh_tables_match():
    m, jm = Mesh2D.uniform_rect(5, -1, 1, 3, 0, 2), JMesh2D.uniform_rect(5, -1, 1, 3, 0, 2)
    for name in ("vertices", "elem_vertices", "edge_vertices", "edge_elements",
                 "edge_sides", "edge_delta", "edge_type", "interior_edges", "boundary_edges"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name), err_msg=name)
    q = QuadratureRule(4)
    em, jem = m.element_metrics(q), jm.element_metrics(JQuad(4))
    for name in ("jacobians", "measures", "coords"):
        np.testing.assert_allclose(getattr(em, name), getattr(jem, name), rtol=0, atol=1e-14)
    np.testing.assert_allclose(m.edge_lengths(), jm.edge_lengths(), rtol=0, atol=1e-14)
    assert abs(m.min_h() - jm.min_h()) < 1e-14


def test_h1_and_ensemble_tables_match(pair):
    jddh, ddh = pair
    assert ddh.space.ndof == jddh.space.ndof
    np.testing.assert_array_equal(ddh.space.dofs, jddh.space.dofs)
    np.testing.assert_allclose(ddh.space.coords, jddh.space.coords, rtol=0, atol=1e-14)
    e, je = ddh.efem, jddh.efem
    for name in ("elems", "n_elems", "faces", "face_side", "sizes", "fsizes", "gI", "fI",
                 "pI", "local_dofs", "cmap"):
        np.testing.assert_array_equal(getattr(e, name), getattr(je, name), err_msg=name)


def test_ddh_tables_match(pair):
    jddh, ddh = pair
    jp, p = _jax_fields(jddh.params), ddh.params
    assert (ddh.nt, ddh.n_own, ddh.n_lost, ddh.n_lambda) == (
        jddh.nt, jddh.n_own, jddh.n_lost, jddh.n_lambda)
    assert ddh.nt == 200 and abs(ddh.dt - jddh.dt) < 1e-14 and ddh.shared_S == jddh.shared_S
    np.testing.assert_array_equal(ddh.lambda_newid, jddh.lambda_newid)
    for name in ("fslot", "B0", "B1"):
        np.testing.assert_array_equal(_np(getattr(p, name)), jp[name], err_msg=name)
    mx = ddh.efem.mx_ndof
    assert ddh.pad == 56 and jddh.pad == 128  # 49 real DOFs per subdomain
    np.testing.assert_array_equal(_np(p.gI)[:, :mx], jp["gI"][:, :mx])
    assert (_np(p.gI)[:, mx:] == -1).all()
    real = {"S": (_np(p.S)[:mx, :mx], jp["S"][:mx, :mx]),
            "Ha": (_np(p.Ha)[:, :mx], jp["Ha"][:, :mx]),
            "inv_mi": (_np(p.inv_mi)[:, :mx], jp["inv_mi"][:, :mx]),
            "m_gmi": (_np(p.m_gmi)[:, :mx], jp["m_gmi"][:, :mx]),
            "Hf": (_np(p.Hf), jp["Hf"]), "a2wf": (_np(p.a2wf), jp["a2wf"]),
            "tables": (_np(p.tables), jp["tables"])}
    for name, (got, want) in real.items():
        scale = max(np.abs(want).max(), 1e-30)
        assert np.abs(got - want).max() <= 1e-6 * scale, name
    assert p.K0 == float(jp["K0"]) and p.dt == float(jp["dt"]) and p.omega == float(jp["omega"])
    # padding slots stay exactly zero in every coefficient the cycle reads
    for name in ("Ha", "inv_mi", "gmask", "F_weight"):
        assert (_np(getattr(p, name))[:, mx:] == 0).all(), name


def test_stiffness_is_symmetric(pair):
    """The port computes P @ S, the JAX scan S P: they agree because S = S^T."""
    jddh, ddh = pair
    S = _np(ddh.params.S)
    assert np.abs(S - S.T).max() <= 1e-6 * np.abs(S).max()


def test_params_from_jax_round_trip(pair):
    jddh, ddh = pair
    arrays = _jax_fields(jddh.params)
    got = ddh_params_from_jax(arrays, ddh.pad, "cpu")
    want = ddh.params
    for name in want._fields:
        a, b = getattr(got, name), getattr(want, name)
        if isinstance(b, torch.Tensor):
            assert a.dtype == b.dtype and a.shape == b.shape, name
            assert torch.allclose(a, b, rtol=1e-6, atol=1e-6 * float(b.abs().max())), name
        else:
            assert a == b, name
    # widening and cutting back is the identity; cutting real slots raises
    wide = ddh_params_from_jax(arrays, 136, "cpu")
    back = ddh_params_from_jax(
        {k: (_np(v) if isinstance(v, torch.Tensor) else v) for k, v in wide._asdict().items()},
        ddh.pad, "cpu")
    for name in got._fields:
        a, b = getattr(back, name), getattr(got, name)
        assert torch.equal(a, b) if isinstance(b, torch.Tensor) else a == b, name
    with pytest.raises(ValueError):
        ddh_params_from_jax(arrays, 48, "cpu")


def test_run_ddh_unported_options_raise():
    """The transfer path, the multi-source kind and the coarse space are
    ported now (they run); a coarse correction without the transfer path
    is a ``ValueError`` as in the JAX package, and the multi-device source
    sharding still raises, naming the ROADMAP queue."""
    res = run_ddh(nx=8, block_size=8, transfer=True, tol=1e-2, device="cpu")
    assert res.success and res.extra["ddh"].use_transfer
    with pytest.raises(ValueError, match="requires transfer=True"):
        run_ddh(nx=8, coarse="additive", device="cpu")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        run_ddh_multi_source(nx=8, shard_sources=True, device="cpu")


def test_port_imports_no_jax():
    mods = ("examples.drivers", "examples.large_unstructured", "examples.coarse_study",
            "config", "mesh.io", "mesh.refine", "spaces.ensemble", "solvers.ddh",
            "solvers.coarse", "ops.cuda.wave_cycle", "ops.stiffness", "ops.kron",
            "ops.structured", "models.poisson", "solvers.gmres", "bench")
    code = ("import sys; " + "; ".join(f"import cuddhelmholtz_tpu_torch.{m}" for m in mods)
            + "; assert 'jax' not in sys.modules; assert 'cuddhelmholtz_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], cwd=REPO, check=True, timeout=120)
