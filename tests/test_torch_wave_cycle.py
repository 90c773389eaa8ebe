"""The port's WaveHoltz cycle against the JAX package's.

The plain PyTorch cycle (``wave_cycle_plain``, what the wrapper runs on CPU
tensors) is held to ``_wave_cycle_xla(precision="highest")`` and to the
Pallas kernel in interpret mode, on the same numpy-seeded, masked (F, G).
Tolerance: max error over max magnitude < 2e-4, the bound the JAX package
holds its own Pallas kernel to (``test_pallas_wave_cycle.py``); both sides
run float32 state through 5 x nt x 2 leapfrog steps, where round-off in the
stiffness products grows with the step count.

The tests marked ``cuda`` build and launch the Hopper kernels (by default
the sparse one) and skip where there is no GPU.  They need no JAX: on a machine without it run
``python -m pytest --noconftest tests/test_torch_wave_cycle.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, ddh_params_from_jax
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

# Small shapes: torch's intra-op thread pool costs more than it saves here,
# and beside other busy test processes it slows these tests a hundredfold.
torch.set_num_threads(1)

NX, DEG, BLOCK = 8, 3, 8
OMEGA = 2 * np.pi * NX / 2.5  # nt = 200 at the CFL-limited dt
TOL = 2e-4


def _rel_max(got, want) -> float:
    got, want = np.asarray(got), np.asarray(want)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _forcing(gmask: np.ndarray, seed: int):
    rng = np.random.default_rng(seed)
    F = (rng.standard_normal(gmask.shape) * gmask).astype(np.float32)
    G = (rng.standard_normal(gmask.shape) * gmask).astype(np.float32)
    return F, G


def _jax_case(nt_override=None, jitter=False):
    """JAX DDH params, masked random (F, G) as numpy, and the port's params
    carried over with ``ddh_params_from_jax`` (port pad 56 for 49 DOFs)."""
    jddh_mod = pytest.importorskip("cuddhelmholtz_tpu.solvers.ddh")
    from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
    from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
    from cuddhelmholtz_tpu.utils.basis import Basis as JBasis

    rng = np.random.default_rng(3)
    mesh = JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    if jitter:
        # every subdomain assembles a different stiffness: per-domain S
        verts = mesh.vertices.copy()
        inner = (np.abs(np.abs(verts[:, 0]) - 1) > 1e-12) & (np.abs(np.abs(verts[:, 1]) - 1) > 1e-12)
        verts[inner] += 0.15 * (2.0 / NX) * rng.uniform(-1, 1, (inner.sum(), 2))
        mesh = JMesh2D.from_vertices(verts, mesh.elem_vertices)
    fem = JH1Space(mesh, JBasis(DEG + 1))
    a_nodal = 1.0 + 0.2 * rng.random(fem.ndof)
    jddh = jddh_mod.DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX, block_size=BLOCK,
                        nt_override=nt_override)
    assert jddh.shared_S != jitter
    arrays = {k: np.asarray(v) for k, v in jddh.params._asdict().items()}
    F, G = _forcing(arrays["gmask"], seed=4)
    pad = 56
    port = ddh_params_from_jax(arrays, pad, "cpu")
    return jddh_mod, jddh.params, F, G, port, pad


@pytest.fixture(scope="module")
def shared_case():
    return _jax_case()


def test_plain_matches_xla_scan(shared_case):
    jddh_mod, jparams, F, G, port, pad = shared_case
    import jax.numpy as jnp

    u_x, v_x = jddh_mod._wave_cycle_xla(jparams, jnp.asarray(F), jnp.asarray(G), 5,
                                        precision="highest")
    u, v = wc.wave_cycle_plain(port, torch.from_numpy(F[:, :pad]), torch.from_numpy(G[:, :pad]))
    assert np.abs(np.asarray(u_x)[:, pad:]).max() == 0  # the cut slots are padding
    assert _rel_max(u, np.asarray(u_x)[:, :pad]) < TOL
    assert _rel_max(v, np.asarray(v_x)[:, :pad]) < TOL


def test_plain_matches_pallas_interpret():
    jddh_mod, jparams, F, G, port, pad = _jax_case(nt_override=60)
    import jax.numpy as jnp
    from cuddhelmholtz_tpu.ops.pallas.wave_cycle import wave_cycle_pallas

    u_p, v_p = wave_cycle_pallas(jparams, jnp.asarray(F), jnp.asarray(G), wh_maxit=5,
                                 precision="high", interpret=True)
    u, v = wc.wave_cycle_plain(port, torch.from_numpy(F[:, :pad]), torch.from_numpy(G[:, :pad]))
    assert _rel_max(u, np.asarray(u_p)[:, :pad]) < TOL
    assert _rel_max(v, np.asarray(v_p)[:, :pad]) < TOL


def test_plain_per_domain_matches_xla_scan():
    """Per-domain (ndom, pad, pad) stiffness (layout (c)) in the plain
    cycle."""
    jddh_mod, jparams, F, G, port, pad = _jax_case(nt_override=60, jitter=True)
    import jax.numpy as jnp

    assert port.S.dim() == 3
    S = port.S.numpy()
    assert np.abs(S - S.transpose(0, 2, 1)).max() <= 1e-6 * np.abs(S).max()
    u_x, v_x = jddh_mod._wave_cycle_xla(jparams, jnp.asarray(F), jnp.asarray(G), 5,
                                        precision="highest")
    u, v = wc.wave_cycle_plain(port, torch.from_numpy(F[:, :pad]), torch.from_numpy(G[:, :pad]))
    assert _rel_max(u, np.asarray(u_x)[:, :pad]) < TOL
    assert _rel_max(v, np.asarray(v_x)[:, :pad]) < TOL


def test_wrapper_runs_plain_on_cpu_without_counting(shared_case):
    _, _, F, G, port, pad = shared_case
    Ft, Gt = torch.from_numpy(F[:, :pad]), torch.from_numpy(G[:, :pad])
    before = wc.launch_counts()
    u, v = wc.wave_cycle(port, Ft, Gt, wh_maxit=1)
    u0, v0 = wc.wave_cycle_plain(port, Ft, Gt, wh_maxit=1)
    assert torch.equal(u, u0) and torch.equal(v, v0)
    assert wc.launch_counts() == before


def _grouped_case(device, c=8, nt_override=30):
    """A per-domain-S DDH and layout-(b) operands: each domain's S, Ha and
    inv_mi repeated over a run of ``c`` rows, masked random (F, G)."""
    ddh = _port_ddh(device, jitter=True, nt_override=nt_override)
    p = ddh.params
    gp = p._replace(Ha=p.Ha.repeat_interleave(c, 0), inv_mi=p.inv_mi.repeat_interleave(c, 0))
    gmask = ddh.gmask.repeat_interleave(c, 0)
    F, G = _forcing(gmask.cpu().numpy(), seed=6)
    return ddh, gp, torch.from_numpy(F).to(device), torch.from_numpy(G).to(device), gmask


def test_plain_grouped_matches_per_row():
    """Layout (b) in the plain cycle: rows in runs sharing one S equal the
    per-row cycle on the same stack expanded to one S per row."""
    ddh, gp, F, G, _ = _grouped_case("cpu", c=3)
    u, v = wc.wave_cycle(gp, F, G, s_group_size=3)
    rows = gp._replace(S=gp.S.repeat_interleave(3, 0))
    u0, v0 = wc.wave_cycle_plain(rows, F, G)
    assert _rel_max(u, u0) < 1e-6 and _rel_max(v, v0) < 1e-6
    with pytest.raises(ValueError, match="s_group_size"):
        wc.wave_cycle_plain(gp, F, G, s_group_size=5)


@pytest.mark.parametrize("pad,fits", [(56, True), (176, True), (216, True), (256, False)])
def test_shared_memory_admission(pad, fits):
    """H100 opt-in limit: 232,448 B per block.  With a sparse form of S the
    sparse kernel runs at every pad here.  Without one, up to the flagship
    pad (176) and beyond the dense S fits beside the row state and the
    resident kernel runs; at the JAX package's pad of 256 it does not, and
    the streamed kernel takes the cycle."""
    limit = 232448
    assert wc.kernel_variant(pad, limit, stride=pad * 30) == "sparse"
    assert wc.kernel_variant(pad, limit) == ("resident" if fits else "streamed")
    assert wc.kernel_variant(pad, limit, pad * 30, variant="streamed") == "streamed"
    assert (wc.shared_memory_bytes(pad) <= limit) == fits


def _f64(params):
    """Float64 copies of the cycle operands (exact: they hold float32 values)."""
    return params._replace(**{k: getattr(params, k).double() for k in ("S", "Ha", "inv_mi", "tables")})


def _jax_f64(jparams):
    import jax.numpy as jnp

    return jparams._replace(**{
        k: jnp.asarray(np.asarray(getattr(jparams, k)), jnp.float64)
        for k in ("S", "Ha", "inv_mi", "tables")
    })


SPARSE_TOL = 1e-12  # float64: the sparse and dense sums differ only in order


def test_sparse_plain_matches_dense_and_xla_scan(shared_case):
    """Layout (a): the plain cycle through the sparse form equals the dense
    plain cycle and the JAX scan in float64."""
    jddh_mod, jparams, F, G, port, pad = shared_case
    import jax.numpy as jnp

    p64 = _f64(port)
    F64, G64 = torch.from_numpy(F[:, :pad]).double(), torch.from_numpy(G[:, :pad]).double()
    form = wc.sparse_form(p64.S)
    assert form.ptr.shape == (1, pad + 1) and form.val.dtype == torch.float64
    u, v = wc.wave_cycle_plain(p64, F64, G64, sparse=form)
    u0, v0 = wc.wave_cycle_plain(p64, F64, G64)
    assert _rel_max(u, u0) < SPARSE_TOL and _rel_max(v, v0) < SPARSE_TOL
    u_x, v_x = jddh_mod._wave_cycle_xla(_jax_f64(jparams), jnp.asarray(F, jnp.float64),
                                        jnp.asarray(G, jnp.float64), 5, precision="highest")
    assert _rel_max(u, np.asarray(u_x)[:, :pad]) < SPARSE_TOL
    assert _rel_max(v, np.asarray(v_x)[:, :pad]) < SPARSE_TOL


def test_sparse_plain_per_domain_matches_xla_scan():
    """Layouts (b) and (c) on a per-domain stack: the plain cycle through
    the sparse form equals the dense plain cycle and the JAX scan in
    float64.  (A stack with ragged nnz:
    ``test_torch_sparse_cycle.py``.)"""
    jddh_mod, jparams, F, G, port, pad = _jax_case(nt_override=60, jitter=True)
    import jax.numpy as jnp

    p64 = _f64(port)
    form = wc.sparse_form(p64.S)
    nnz = (p64.S != 0).sum((1, 2))
    assert form.ptr.shape == (port.S.shape[0], pad + 1) and form.stride >= int(nnz.max())
    F64, G64 = torch.from_numpy(F[:, :pad]).double(), torch.from_numpy(G[:, :pad]).double()
    u, v = wc.wave_cycle_plain(p64, F64, G64, sparse=form)  # (c): one group per row
    u0, v0 = wc.wave_cycle_plain(p64, F64, G64)
    assert _rel_max(u, u0) < SPARSE_TOL and _rel_max(v, v0) < SPARSE_TOL
    u_x, v_x = jddh_mod._wave_cycle_xla(_jax_f64(jparams), jnp.asarray(F, jnp.float64),
                                        jnp.asarray(G, jnp.float64), 5, precision="highest")
    assert _rel_max(u, np.asarray(u_x)[:, :pad]) < SPARSE_TOL
    assert _rel_max(v, np.asarray(v_x)[:, :pad]) < SPARSE_TOL

    c = 3  # (b): runs of c rows against each domain's S
    gp = p64._replace(Ha=p64.Ha.repeat_interleave(c, 0), inv_mi=p64.inv_mi.repeat_interleave(c, 0))
    Fb, Gb = F64.repeat_interleave(c, 0), G64.repeat_interleave(c, 0)
    ub, vb = wc.wave_cycle_plain(gp, Fb, Gb, 2, s_group_size=c, sparse=form)
    ub0, vb0 = wc.wave_cycle_plain(gp, Fb, Gb, 2, s_group_size=c)
    assert _rel_max(ub, ub0) < SPARSE_TOL and _rel_max(vb, vb0) < SPARSE_TOL
    # the JAX scan on the same runs, each row given its run's S
    jp = _jax_f64(jparams)
    jp = jp._replace(**{k: jnp.repeat(getattr(jp, k), c, axis=0) for k in ("S", "Ha", "inv_mi")})
    u_x, v_x = jddh_mod._wave_cycle_xla(jp, jnp.asarray(np.repeat(F, c, 0), jnp.float64),
                                        jnp.asarray(np.repeat(G, c, 0), jnp.float64), 2,
                                        precision="highest")
    assert _rel_max(ub, np.asarray(u_x)[:, :pad]) < SPARSE_TOL
    assert _rel_max(vb, np.asarray(v_x)[:, :pad]) < SPARSE_TOL
    with pytest.raises(ValueError, match="sparse form of 1 groups"):
        wc.wave_cycle_plain(gp, Fb, Gb, 1, s_group_size=c, sparse=form.take(torch.tensor([0])))


# ------------------------------------------------------------ on the GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _port_ddh(device, jitter=False, nt_override=None):
    rng = np.random.default_rng(3)
    mesh = Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    if jitter:
        verts = mesh.vertices.copy()
        inner = (np.abs(np.abs(verts[:, 0]) - 1) > 1e-12) & (np.abs(np.abs(verts[:, 1]) - 1) > 1e-12)
        verts[inner] += 0.15 * (2.0 / NX) * rng.uniform(-1, 1, (inner.sum(), 2))
        mesh = Mesh2D.from_vertices(verts, mesh.elem_vertices)
    fem = H1Space(mesh, Basis(DEG + 1))
    a_nodal = 1.0 + 0.2 * rng.random(fem.ndof)
    return DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX, block_size=BLOCK, nt_override=nt_override,
               device=device)


@pytest.mark.cuda
def test_kernel_matches_plain(cuda):
    ddh = _port_ddh(cuda)
    F, G = _forcing(ddh.gmask.cpu().numpy(), seed=5)
    Ft, Gt = torch.from_numpy(F).to(cuda), torch.from_numpy(G).to(cuda)
    before = wc.launch_counts()
    u, v = wc.wave_cycle(ddh.params, Ft, Gt)
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, "sparse_shared": before["sparse_shared"] + 1}
    u0, v0 = wc.wave_cycle_plain(ddh.params, Ft, Gt)
    assert _rel_max(u.cpu(), u0.cpu()) < TOL
    assert _rel_max(v.cpu(), v0.cpu()) < TOL
    # padded slots stay exactly zero
    pad_mask = ddh.gmask == 0
    assert (u[pad_mask] == 0).all() and (v[pad_mask] == 0).all()


@pytest.mark.cuda
def test_kernel_per_row_stiffness_matches_plain(cuda):
    """Layout (c): one S per row, in one launch of the sparse kernel's
    per-row instance over the ndom rows (no replicas)."""
    ddh = _port_ddh(cuda, jitter=True, nt_override=60)
    assert ddh.params.S.dim() == 3 and ddh.params.S.shape[0] == ddh.n_domains
    F, G = _forcing(ddh.gmask.cpu().numpy(), seed=7)
    Ft, Gt = torch.from_numpy(F).to(cuda), torch.from_numpy(G).to(cuda)
    before = wc.launch_counts()
    u, v = wc.wave_cycle(ddh.params, Ft, Gt)
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, "sparse_per_row": before["sparse_per_row"] + 1}
    u0, v0 = wc.wave_cycle_plain(ddh.params, Ft, Gt)
    assert _rel_max(u.cpu(), u0.cpu()) < TOL and _rel_max(v.cpu(), v0.cpu()) < TOL
    pad_mask = ddh.gmask == 0
    assert (u[pad_mask] == 0).all() and (v[pad_mask] == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 24])
def test_kernel_grouped_matches_plain(cuda, c):
    """Layout (b): runs of c rows against one S each."""
    _, gp, F, G, gmask = _grouped_case(cuda, c=c, nt_override=60)
    before = wc.launch_counts()
    u, v = wc.wave_cycle(gp, F, G, s_group_size=c)
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, "sparse_grouped": before["sparse_grouped"] + 1}
    u0, v0 = wc.wave_cycle_plain(gp, F, G, s_group_size=c)
    assert _rel_max(u.cpu(), u0.cpu()) < TOL and _rel_max(v.cpu(), v0.cpu()) < TOL
    assert (u[gmask == 0] == 0).all() and (v[gmask == 0] == 0).all()


@pytest.mark.cuda
def test_kernel_refuses_bad_groups_and_large_pad(cuda):
    """Bad runs still raise; at a pad whose dense S exceeds a block's shared
    memory the sparse kernel runs by default, the streamed one when forced,
    and a forced resident kernel raises."""
    _, gp, F, G, _ = _grouped_case(cuda, c=12, nt_override=10)
    with pytest.raises(ValueError, match="multiple of 8"):
        wc.wave_cycle(gp, F, G, s_group_size=12)
    with pytest.raises(ValueError, match="s_group_size"):
        wc.wave_cycle(gp, F, G, s_group_size=8)
    big = 256  # S alone is 256 KB: more than a block's shared memory
    z = torch.zeros((8, big), device=cuda)
    p = gp._replace(S=torch.zeros((1, big, big), device=cuda), Ha=z, inv_mi=z)
    before = wc.launch_counts()
    u, v = wc.wave_cycle(p, z, z, s_group_size=8)
    us, vs = wc.wave_cycle(p, z, z, s_group_size=8,
                           kernel=wc.k1_kernel(p.S, variant="streamed"))
    torch.cuda.synchronize()
    assert wc.launch_counts() == {
        **before, "sparse_grouped": before["sparse_grouped"] + 1,
        "streamed_grouped": before["streamed_grouped"] + 1,
    }
    assert (u == 0).all() and (v == 0).all() and (us == 0).all() and (vs == 0).all()
    with pytest.raises(ValueError, match="no kernel resident"):
        wc.wave_cycle(p, z, z, s_group_size=8, kernel=wc.k1_kernel(p.S, variant="resident"))
