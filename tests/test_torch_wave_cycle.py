"""The port's WaveHoltz cycle against the JAX package's.

The plain PyTorch cycle (``wave_cycle_plain``, what the wrapper runs on CPU
tensors) is held to ``_wave_cycle_xla(precision="highest")`` and to the
Pallas kernel in interpret mode, on the same numpy-seeded, masked (F, G).
Tolerance: max error over max magnitude < 2e-4, the bound the JAX package
holds its own Pallas kernel to (``test_pallas_wave_cycle.py``); both sides
run float32 state through 5 x nt x 2 leapfrog steps, where round-off in the
stiffness products grows with the step count.

The tests marked ``cuda`` build and launch the Hopper kernel and skip where
there is no GPU.  They need no JAX: on a machine without it run
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
    """Per-domain (ndom, pad, pad) stiffness: the plain cycle serves it on
    the CPU (the CUDA kernel covers the shared layout only)."""
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
    before = wc.wave_cycle.launches
    u, v = wc.wave_cycle(port, Ft, Gt, wh_maxit=1)
    u0, v0 = wc.wave_cycle_plain(port, Ft, Gt, wh_maxit=1)
    assert torch.equal(u, u0) and torch.equal(v, v0)
    assert wc.wave_cycle.launches == before


@pytest.mark.parametrize("pad,fits", [(56, True), (176, True), (216, True), (256, False)])
def test_shared_memory_admission(pad, fits):
    """H100 opt-in limit: 232,448 B per block.  The flagship pad (176) fits;
    the JAX package's pad of 256 does not."""
    if fits:
        wc.check_shared_memory(pad, 232448)
    else:
        with pytest.raises(ValueError, match="shared memory"):
            wc.check_shared_memory(pad, 232448)


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
    before = wc.wave_cycle.launches
    u, v = wc.wave_cycle(ddh.params, Ft, Gt)
    torch.cuda.synchronize()
    assert wc.wave_cycle.launches == before + 1
    u0, v0 = wc.wave_cycle_plain(ddh.params, Ft, Gt)
    assert _rel_max(u.cpu(), u0.cpu()) < TOL
    assert _rel_max(v.cpu(), v0.cpu()) < TOL
    # padded slots stay exactly zero
    pad_mask = ddh.gmask == 0
    assert (u[pad_mask] == 0).all() and (v[pad_mask] == 0).all()


@pytest.mark.cuda
def test_kernel_refuses_per_domain_stiffness(cuda):
    ddh = _port_ddh(cuda, jitter=True, nt_override=10)
    assert ddh.params.S.dim() == 3
    F = torch.zeros_like(ddh.gmask)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        wc.wave_cycle(ddh.params, F, F)
