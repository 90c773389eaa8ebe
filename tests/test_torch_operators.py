"""The port's global operators against the JAX package, on the same inputs.

Three spaces go through both packages: ``H1Space`` on a 6x5 ``uniform_rect``
mesh, ``H1Space`` on the unstructured square (119 quads, full size) and
``GridH1Space`` on an 8x8 grid.  Tolerances, relative to the largest entry
of the reference:
  * tables (face space, stiffness/mass/face-mass data, kron factors, lumped
    inverses, functionals) 1e-14: the host setup is NumPy float64 in both;
  * float64 applies 1e-12: the same sums in another order;
  * ``project_coefficients`` 1e-10: GMRES(5) mass solves to 1e-12;
  * the fp32 permuted kron matvec against the generic fp32 operator 1e-4
    (as ``tests/test_drivers.py::test_permuted_kron_matvec32_matches_generic``).
DDH on a ``GridH1Space`` builds the same tables and dedup groups as the JAX
package's DDH on the same space.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.mesh.io import load_unstructured_square as jload_square
from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.ops import face_mass as jfm
from cuddhelmholtz_tpu.ops import functional as jfun
from cuddhelmholtz_tpu.ops import kron as jkron
from cuddhelmholtz_tpu.ops import mass as jmass
from cuddhelmholtz_tpu.ops import stiffness as jstiff
from cuddhelmholtz_tpu.ops import structured as jstruct
from cuddhelmholtz_tpu.models import helmholtz as jhelm
from cuddhelmholtz_tpu.spaces.h1 import FaceSpace as JFaceSpace
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu.utils.quadrature import QuadratureRule as JQuad
from cuddhelmholtz_tpu_torch.examples.drivers import _make_matvec32, wave_speed_coeff
from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import (
    apply_helmholtz,
    helmholtz_op_from_jax,
    make_helmholtz_op,
    make_helmholtz_template,
    project_coefficients,
)
from cuddhelmholtz_tpu_torch.models.poisson import make_poisson_op
from cuddhelmholtz_tpu_torch.ops import face_mass as fm
from cuddhelmholtz_tpu_torch.ops import functional as fun
from cuddhelmholtz_tpu_torch.ops import kron
from cuddhelmholtz_tpu_torch.ops import mass
from cuddhelmholtz_tpu_torch.ops import stiffness as stiff
from cuddhelmholtz_tpu_torch.ops import structured as struct
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis
from cuddhelmholtz_tpu_torch.utils.quadrature import QuadratureRule

torch.set_num_threads(1)

DEG = 3
TABLE_TOL, APPLY_TOL, PROJ_TOL = 1e-14, 1e-12, 1e-10
SPACES = ("rect", "square", "grid")
CPU = "cpu"  # the operator builders default to the card


def _close(got, want, tol):
    got = got.cpu().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    want = np.asarray(want)
    assert got.shape == want.shape
    scale = max(float(np.abs(want).max()), 1e-300)
    err = float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max()) / scale
    assert err <= tol, err


def _coeff(xy):
    """A smooth positive coefficient, the same in both packages."""
    return 1.0 + 0.3 * xy[..., 0] ** 2 + 0.2 * xy[..., 1]


def _build(kind):
    nb = DEG + 1
    if kind == "square":
        jmesh, mesh = jload_square(), load_unstructured_square()
        return JH1Space(jmesh, JBasis(nb)), H1Space(mesh, Basis(nb))
    if kind == "rect":
        jmesh = JMesh2D.uniform_rect(6, -1.0, 1.0, 5, -1.0, 0.5)
        mesh = Mesh2D.uniform_rect(6, -1.0, 1.0, 5, -1.0, 0.5)
        return JH1Space(jmesh, JBasis(nb)), H1Space(mesh, Basis(nb))
    jmesh = JMesh2D.uniform_rect(8, -1.0, 1.0, 8, -1.0, 1.0)
    mesh = Mesh2D.uniform_rect(8, -1.0, 1.0, 8, -1.0, 1.0)
    return (jstruct.GridH1Space(jmesh, JBasis(nb), 8, 8),
            struct.GridH1Space(mesh, Basis(nb), 8, 8))


@pytest.fixture(scope="module", params=SPACES)
def spaces(request):
    """(kind, JAX space, JAX face space, port space, port face space, a2, af)
    with nodal coefficients made from a seed."""
    jsp, sp = _build(request.param)
    jfs = JFaceSpace(jsp, jsp.mesh.boundary_edges)
    fs = FaceSpace(sp, sp.mesh.boundary_edges)
    rng = np.random.default_rng(7)
    a2 = 1.0 + 0.5 * rng.random(sp.ndof)
    af = 1.0 + 0.5 * rng.random(fs.fdof)
    return request.param, jsp, jfs, sp, fs, a2, af


def test_spaces_and_mesh_queries_match_jax(spaces):
    kind, jsp, jfs, sp, fs, _, _ = spaces
    assert sp.ndof == jsp.ndof and np.array_equal(sp.dofs, np.asarray(jsp.dofs))
    assert np.array_equal(sp.coords, jsp.coords)
    for name in ("faces", "face_dofs", "proj"):
        assert np.array_equal(getattr(fs, name), np.asarray(getattr(jfs, name))), name
    assert (fs.fdof, fs.size, fs.n_faces) == (jfs.fdof, jfs.size, jfs.n_faces)
    m, jm = sp.mesh, jsp.mesh
    assert (m.n_vertices, m.n_edges, m.max_element_order) == (
        jm.n_vertices, jm.n_edges, jm.max_element_order)
    assert m.max_h() == jm.max_h()
    for q in (QuadratureRule(5, QuadratureRule.GaussLegendre), sp.basis.quadrature):
        jq = JQuad(q.n, q.kind)
        got, want = m.edge_metrics(q, fs.faces), jm.edge_metrics(jq, jfs.faces)
        for name in ("measures", "coords", "normals"):
            _close(getattr(got, name), getattr(want, name), TABLE_TOL)
    # restrict / prolong / orth
    x = np.random.default_rng(1).standard_normal(sp.ndof)
    xt = torch.from_numpy(x)
    _close(fs.restrict(xt), jfs.restrict(jnp.asarray(x)), 0.0)
    xf = x[: fs.fdof]
    _close(fs.prolong(torch.from_numpy(xf), xt), jfs.prolong(jnp.asarray(xf), jnp.asarray(x)), 0.0)
    _close(fs.orth(xt), jfs.orth(jnp.asarray(x)), 0.0)


def test_operator_tables_match_jax(spaces):
    kind, jsp, jfs, sp, fs, a2, af = spaces
    so, jso = stiff.make_stiffness_op(sp, device=CPU), jstiff.make_stiffness_op(jsp)
    for name in ("P", "D", "A", "B", "C"):
        _close(getattr(so, name), getattr(jso, name), TABLE_TOL)
    assert np.array_equal(so.dofs.numpy(), np.asarray(jso.dofs))
    for coeff, nq in ((None, None), (a2, None), (None, mass.variable_coeff_n_quad(sp))):
        mo = mass.make_mass_op(sp, coeff, n_quad=nq, device=CPU)
        jmo = jmass.make_mass_op(jsp, coeff, n_quad=nq)
        _close(mo.P, jmo.P, TABLE_TOL)
        _close(mo.wdetj, jmo.wdetj, TABLE_TOL)
    assert mass.variable_coeff_n_quad(sp) == jmass.variable_coeff_n_quad(jsp)
    for coeff in (None, af):
        fo, jfo = fm.make_face_mass_op(fs, coeff, device=CPU), jfm.make_face_mass_op(jfs, coeff)
        _close(fo.P, jfo.P, TABLE_TOL)
        _close(fo.wds, jfo.wds, TABLE_TOL)
        assert np.array_equal(fo.fdofs.numpy(), np.asarray(jfo.fdofs))
        _close(fm.make_diag_inv_face_mass_op(fs, coeff, device=CPU).p,
               jfm.make_diag_inv_face_mass_op(jfs, coeff).p, TABLE_TOL)
    _close(mass.make_diag_inv_mass_op(sp, a2, device=CPU).p,
           jmass.make_diag_inv_mass_op(jsp, a2).p, TABLE_TOL)


def test_assembly_table_sums_like_segment_sum():
    """The deterministic assembly equals a sequential scatter-add; negative
    ids are padding and add nowhere."""
    rng = np.random.default_rng(3)
    ids = rng.integers(-5, 50, size=(40, 4, 4))
    ids[0, 0, 0] = 49  # the largest target is present
    vals = rng.standard_normal(ids.shape)
    want = np.zeros(50)
    keep = ids.reshape(-1) >= 0
    np.add.at(want, ids.reshape(-1)[keep], vals.reshape(-1)[keep])
    table = torch.as_tensor(mass.assembly_table(ids, 50))
    _close(mass.assemble(table, torch.from_numpy(vals)), want, 1e-15)


def test_functionals_match_jax(spaces):
    kind, jsp, jfs, sp, fs, _, _ = spaces
    quad = QuadratureRule(2 * sp.n_basis, QuadratureRule.GaussLegendre)
    jquad = JQuad(quad.n, quad.kind)
    for q, jq in ((None, None), (quad, jquad)):
        _close(fun.linear_functional(sp, _coeff, q), jfun.linear_functional(jsp, _coeff, jq),
               TABLE_TOL)
        _close(fun.face_linear_functional(fs, _coeff, q),
               jfun.face_linear_functional(jfs, _coeff, jq), TABLE_TOL)


def test_generic_applies_match_jax(spaces):
    kind, jsp, jfs, sp, fs, a2, af = spaces
    rng = np.random.default_rng(11)
    x = rng.standard_normal(sp.ndof)
    xf = rng.standard_normal(fs.fdof)
    xt, jx = torch.from_numpy(x), jnp.asarray(x)
    _close(stiff.apply_stiffness(stiff.make_stiffness_op(sp, device=CPU), xt),
           jstiff.apply_stiffness(jstiff.make_stiffness_op(jsp), jx), APPLY_TOL)
    _close(mass.apply_mass(mass.make_mass_op(sp, a2, device=CPU), xt),
           jmass.apply_mass(jmass.make_mass_op(jsp, a2), jx), APPLY_TOL)
    _close(fm.apply_face_mass(fm.make_face_mass_op(fs, af, device=CPU), torch.from_numpy(xf)),
           jfm.apply_face_mass(jfm.make_face_mass_op(jfs, af), jnp.asarray(xf)), APPLY_TOL)


def test_structured_and_kron_applies_match_jax():
    _, jsp, jfs, sp, fs, a2, af = _grid_case()
    nx, ny = sp.grid
    nb = sp.n_basis
    x = np.random.default_rng(5).standard_normal(sp.ndof)
    xt, jx = torch.from_numpy(x), jnp.asarray(x)
    xe = struct.grid_gather(xt, nx, ny, nb)
    _close(xe, jstruct.grid_gather(jx, nx, ny, nb), 0.0)
    _close(xe, xt[torch.as_tensor(sp.dofs, dtype=torch.int64)], 0.0)
    _close(struct.grid_scatter(xe, nx, ny, nb), jstruct.grid_scatter(jnp.asarray(xe.numpy()),
                                                                      nx, ny, nb), APPLY_TOL)
    so, mo = stiff.make_stiffness_op(sp, device=CPU), mass.make_mass_op(sp, a2, device=CPU)
    jso, jmo = jstiff.make_stiffness_op(jsp), jmass.make_mass_op(jsp, a2)
    ks = kron.make_kron_stiffness_op(sp, device=CPU)
    km = kron.make_kron_mass_op(sp, a2, device=CPU)
    jks, jkm = jkron.make_kron_stiffness_op(jsp), jkron.make_kron_mass_op(jsp, a2)
    for name in ks._fields:
        _close(getattr(ks, name), getattr(jks, name), TABLE_TOL)
    for name in km._fields:
        _close(getattr(km, name), getattr(jkm, name), TABLE_TOL)
    y_s = jstiff.apply_stiffness(jso, jx)
    y_m = jmass.apply_mass(jmo, jx)
    _close(struct.apply_stiffness_structured(so, (nx, ny), xt),
           jstruct.apply_stiffness_structured(jso, (nx, ny), jx), APPLY_TOL)
    _close(struct.apply_mass_structured(mo, (nx, ny), xt),
           jstruct.apply_mass_structured(jmo, (nx, ny), jx), APPLY_TOL)
    _close(kron.apply_stiffness_kron(ks, xt),
           jkron.apply_stiffness_kron(jks, jx, precision="highest"), APPLY_TOL)
    _close(kron.apply_mass_kron(km, xt), jkron.apply_mass_kron(jkm, jx, precision="highest"),
           APPLY_TOL)
    # every path computes the generic operator
    _close(kron.apply_stiffness_kron(ks, xt), y_s, APPLY_TOL)
    _close(kron.apply_mass_kron(km, xt), y_m, APPLY_TOL)


def test_grid_space_rejects_permuted_elements():
    mesh = Mesh2D.uniform_rect(4, -1.0, 1.0, 3, -1.0, 1.0)
    with pytest.raises(ValueError, match="row-major"):
        struct.GridH1Space(mesh, Basis(DEG + 1), 3, 4)
    permuted = Mesh2D(mesh.vertices, mesh.elem_vertices[::-1].copy())
    with pytest.raises(ValueError, match="row-major"):
        struct.GridH1Space(permuted, Basis(DEG + 1), 4, 3)


def _grid_case():
    jsp, sp = _build("grid")
    jfs = JFaceSpace(jsp, jsp.mesh.boundary_edges)
    fs = FaceSpace(sp, sp.mesh.boundary_edges)
    rng = np.random.default_rng(7)
    return ("grid", jsp, jfs, sp, fs, 1.0 + 0.5 * rng.random(sp.ndof),
            1.0 + 0.5 * rng.random(fs.fdof))


@pytest.mark.parametrize("path", ["generic", "structured", "kron"])
def test_apply_helmholtz_matches_jax(path):
    _, jsp, jfs, sp, fs, a2, af = _grid_case()
    omega = 2 * np.pi * 0.8
    use_kron = path == "kron"
    op = make_helmholtz_op(omega, a2, af, sp, fs, kron=use_kron, device=CPU)
    jop = jhelm.make_helmholtz_op(omega, a2, af, jsp, jfs, kron=use_kron)
    grid = sp.grid if path == "structured" else None
    U = np.random.default_rng(2).standard_normal(2 * sp.ndof)
    got = apply_helmholtz(op, torch.from_numpy(U), grid=grid)
    want = jhelm.apply_helmholtz(jop, jnp.asarray(U), grid=grid, kron_precision="highest")
    _close(got, want, APPLY_TOL)


def _jax_op_arrays(jop) -> dict:
    arrays = {"omega": jop.omega, "ndof": jop.ndof, "face_proj": np.asarray(jop.face_proj)}
    for sub in ("stiffness", "mass", "face_mass", "kron_stiffness", "kron_mass"):
        op = getattr(jop, sub)
        if op is not None:
            arrays.update({f"{sub}.{k}": np.asarray(v) for k, v in op._asdict().items()})
    return arrays


@pytest.mark.parametrize("use_kron", [False, True])
def test_helmholtz_op_from_jax(use_kron):
    """The JAX op's fields, carried over, give the JAX op's action."""
    _, jsp, jfs, sp, fs, a2, af = _grid_case()
    jop = jhelm.make_helmholtz_op(3.0, a2, af, jsp, jfs, kron=use_kron)
    op = helmholtz_op_from_jax(_jax_op_arrays(jop), "cpu")
    assert (op.kron_stiffness is not None) == use_kron and (op.stiffness is None) == use_kron
    U = np.random.default_rng(4).standard_normal(2 * sp.ndof)
    _close(apply_helmholtz(op, torch.from_numpy(U)),
           jhelm.apply_helmholtz(jop, jnp.asarray(U), kron_precision="highest"), APPLY_TOL)
    # and the port's own make_helmholtz_op makes the same data
    own = make_helmholtz_op(3.0, a2, af, sp, fs, kron=use_kron, device=CPU)
    _close(apply_helmholtz(own, torch.from_numpy(U)), apply_helmholtz(op, torch.from_numpy(U)),
           APPLY_TOL)


def test_project_coefficients_matches_jax():
    """On the unstructured square (the target configuration's space)."""
    jsp, sp = _build("square")
    jfs = JFaceSpace(jsp, jsp.mesh.boundary_edges)
    fs = FaceSpace(sp, sp.mesh.boundary_edges)
    a2, af = project_coefficients(sp, fs, wave_speed_coeff)

    def jcoeff(xy):
        r = xy[..., 0] ** 2 + xy[..., 1] ** 2
        return jnp.where(r < 0.0625, 0.2, 1.0)

    ja2, jaf = jhelm.project_coefficients(jsp, jfs, jcoeff)
    _close(a2, ja2, PROJ_TOL)
    _close(af, jaf, PROJ_TOL)


def test_permuted_kron_matvec32_matches_generic():
    """The refinement's structured fast path (kron operator on the grid
    numbering + permutation gathers) computes the generic fp32 operator."""
    nx = 12
    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    fem = H1Space(mesh, Basis(DEG + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)
    a2, af = project_coefficients(fem, fs, wave_speed_coeff)
    op = make_helmholtz_op(omega, a2.astype(np.float32), af.astype(np.float32), fem, fs,
                           dtype=torch.float32, device=CPU)
    mv_fast = _make_matvec32(omega, a2, af, fem, fs, mesh, nx, device="cpu")
    U = torch.from_numpy(np.random.default_rng(0).standard_normal(2 * fem.ndof).astype(np.float32))
    y0 = apply_helmholtz(op, U).numpy()
    y1 = mv_fast(U).numpy()
    assert np.linalg.norm(y1 - y0) / np.linalg.norm(y0) < 1e-4


@pytest.mark.parametrize("nx", [8, 16])
def test_ddh_on_grid_space_matches_jax(nx):
    """DDH built on the grid numbering: lambda numbering, own-slot layout,
    dedup groups and nu as the JAX package's DDH on the same space."""
    from cuddhelmholtz_tpu.solvers.ddh import DDH as JDDH

    nb = DEG + 1
    jsp = jstruct.GridH1Space(JMesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), JBasis(nb), nx, nx)
    sp = struct.GridH1Space(Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), Basis(nb), nx, nx)
    a_nodal = 1.0 + 0.3 * np.random.default_rng(0).random(sp.ndof)
    omega = 2 * np.pi * nx / 10
    jddh = JDDH(omega, a_nodal, jsp, nx=nx, ny=nx, block_size=8)
    ddh = DDH(omega, a_nodal, sp, nx=nx, ny=nx, block_size=8, device="cpu")
    assert (ddh.n_lambda, ddh.n_own, ddh.size, ddh.nt) == (
        jddh.n_lambda, jddh.n_own, jddh.size, jddh.nt)
    jp = jddh.params
    for name in ("B0", "B1", "fslot"):
        got = getattr(ddh, name).numpy()
        assert np.array_equal(got, np.asarray(getattr(jp, name))[:, : got.shape[1]]), name
    gI = np.asarray(jp.gI)
    assert np.array_equal(ddh.gI.numpy(), gI[:, : ddh.pad])
    assert (gI[:, ddh.pad:] == -1).all()
    ju, jg, jnu = jddh._domain_groups()
    u, g, nu = ddh._domain_groups()
    assert nu == jnu and np.array_equal(g, np.asarray(jg)) and np.array_equal(u, np.asarray(ju))


# the public operator builders, each called on the grid case with **kw
BUILDERS = {
    "make_stiffness_op": lambda sp, fs, a2, af, **kw: stiff.make_stiffness_op(sp, **kw),
    "make_mass_op": lambda sp, fs, a2, af, **kw: mass.make_mass_op(sp, a2, **kw),
    "make_diag_inv_mass_op": lambda sp, fs, a2, af, **kw: mass.make_diag_inv_mass_op(sp, **kw),
    "make_kron_stiffness_op": lambda sp, fs, a2, af, **kw: kron.make_kron_stiffness_op(sp, **kw),
    "make_kron_mass_op": lambda sp, fs, a2, af, **kw: kron.make_kron_mass_op(sp, a2, **kw),
    "make_face_mass_op": lambda sp, fs, a2, af, **kw: fm.make_face_mass_op(fs, af, **kw),
    "make_diag_inv_face_mass_op":
        lambda sp, fs, a2, af, **kw: fm.make_diag_inv_face_mass_op(fs, **kw),
    "make_helmholtz_op":
        lambda sp, fs, a2, af, **kw: make_helmholtz_op(3.0, a2, af, sp, fs, **kw),
    "make_helmholtz_template":
        lambda sp, fs, a2, af, **kw: make_helmholtz_template(sp, fs, **kw),
    "make_poisson_op": lambda sp, fs, a2, af, **kw: make_poisson_op(sp, fs, **kw),
}


def _tensors(op):
    """Every tensor of a builder's (nested) NamedTuple."""
    for x in op:
        if isinstance(x, torch.Tensor):
            yield x
        elif isinstance(x, tuple):
            yield from _tensors(x)


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_builder_defaults_to_the_card(name, monkeypatch):
    """Without ``device`` a builder runs on the card, so without one it
    raises (naming ``device='cpu'``) and falls back to nothing; with
    ``device="cpu"`` it builds on the CPU."""
    _, _, _, sp, fs, a2, af = _grid_case()
    build = BUILDERS[name]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        build(sp, fs, a2, af)
    tensors = list(_tensors(build(sp, fs, a2, af, device=CPU)))
    assert tensors and all(t.device.type == "cpu" for t in tensors)
