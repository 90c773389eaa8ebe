"""The port's DDH apply and its whole direct-path solve against the JAX package.

``action``, ``rhs`` and ``postprocess`` of the port's DDH (built by the port's
own setup) are held to the JAX ``DDH`` and to the NumPy transliteration of
the reference kernel (``tests/ddh_oracle.py``) on numpy-seeded inputs.
Tolerance 2e-4 relative (2-norm), as ``test_ddh_oracle.py`` holds the JAX
package: float32 state through 5 x nt x 2 leapfrog steps.

``run_ddh`` at nx=8 then runs in both packages with the same arguments.  The
restart and matvec counts must be equal; histories agree to rtol 2e-3 (as
``test_ddh_oracle.py`` compares lambda-GMRES histories: float32 Krylov
vectors drift apart in round-off over the restarts) and the solutions to 1e-3
relative.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.examples.drivers import run_ddh as jrun_ddh
from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.solvers.ddh import DDH as JDDH
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis
from ddh_oracle import DDHOracle

# Small shapes: torch's intra-op thread pool costs more than it saves here,
# and beside other busy test processes it slows these tests a hundredfold.
torch.set_num_threads(1)

NX, DEG, BLOCK = 8, 3, 8
OMEGA = 2 * np.pi * NX / 2.5  # nt = 200 (test_ddh_oracle.py)
TOL = 2e-4


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def trio():
    """(JAX DDH, port DDH, oracle) from the same mesh and medium, plus the
    forcing b (numpy float64, [f; 0])."""
    jmesh = JMesh2D.uniform_rect(NX, -1, 1, NX, -1, 1)
    jfem = JH1Space(jmesh, JBasis(DEG + 1))
    a_nodal = 1.0 + 0.3 * np.random.default_rng(0).random(jfem.ndof)
    jddh = JDDH(OMEGA, a_nodal, jfem, nx=NX, ny=NX, block_size=BLOCK)
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    ddh = DDH(OMEGA, a_nodal, fem, nx=NX, ny=NX, block_size=BLOCK, device="cpu")
    oracle = DDHOracle(OMEGA, a_nodal, jfem, jddh.efem)

    def f(xy):
        r = (xy[..., 0] + 0.5) ** 2 + xy[..., 1] ** 2
        return OMEGA**2 * torch.exp(-(OMEGA**2) * r)

    b = helmholtz_rhs(fem, f).numpy()
    return jddh, ddh, oracle, b


def _oracle_maps(ddh, oracle):
    newid, n_ref, n = ddh.lambda_newid, oracle.n_lambda, ddh.n_lambda

    def to_port(l_ref):
        z = np.zeros(2 * n, dtype=np.float32)
        z[newid] = l_ref[:n_ref]
        z[n + newid] = l_ref[n_ref:]
        return z

    def from_port(l):
        return np.concatenate([l[newid], l[n + newid]])

    return to_port, from_port


def test_dual_trace_ids_are_unique(trio):
    """The transmission update scatters with ``index_put`` (no defined order
    for repeated indices on a GPU): the valid B1 ids must be distinct."""
    _, ddh, _, _ = trio
    B1 = ddh.params.B1
    valid = B1[B1 >= 0]
    assert valid.numel() == torch.unique(valid).numel() > 0


@pytest.mark.parametrize("op", ["action", "rhs", "postprocess"])
def test_apply_matches_jax(trio, op):
    jddh, ddh, _, b = trio
    lam = np.random.default_rng(1).standard_normal(ddh.size).astype(np.float32)
    if op == "action":
        want = jddh.action(jnp.asarray(lam))
        got = ddh(torch.from_numpy(lam))
    elif op == "rhs":
        want = jddh.rhs(jnp.asarray(b))
        got = ddh.rhs(torch.from_numpy(b))
    else:
        want = jddh.postprocess(jnp.asarray(lam), jnp.asarray(b))
        got = ddh.postprocess(torch.from_numpy(lam), torch.from_numpy(b))
    assert got.dtype == torch.float32 and got.shape == tuple(want.shape)
    assert _rel(got, want) < TOL


@pytest.mark.parametrize("op", ["action", "rhs", "postprocess"])
def test_apply_matches_reference_oracle(trio, op):
    _, ddh, oracle, b = trio
    to_port, from_port = _oracle_maps(ddh, oracle)
    l_ref = np.random.default_rng(2).standard_normal(2 * oracle.n_lambda).astype(np.float32)
    if op == "action":
        want = oracle.action(l_ref)
        got = from_port(ddh.action(torch.from_numpy(to_port(l_ref))).numpy())
    elif op == "rhs":
        want = oracle.rhs(b)
        got = from_port(ddh.rhs(torch.from_numpy(b)).numpy())
    else:
        want = oracle.postprocess(l_ref, b)
        got = ddh.postprocess(torch.from_numpy(to_port(l_ref)), torch.from_numpy(b)).numpy()
    assert _rel(got, want) < TOL


def test_irregular_partition_matches_reference_oracle():
    """Uneven strips through ``element_labels``: per-domain stiffness and
    ragged face counts, on the port's own setup (no JAX objects)."""
    i, _ = np.meshgrid(np.arange(NX), np.arange(NX), indexing="ij")
    labels = np.minimum(i // 3, 2).T.reshape(-1)
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    rng = np.random.default_rng(3)
    a_nodal = 1.0 + 0.3 * rng.random(fem.ndof)
    ddh = DDH(OMEGA, a_nodal, fem, element_labels=labels, device="cpu")
    assert ddh.n_domains == 3 and ddh.params.S.dim() == 3
    oracle = DDHOracle(OMEGA, a_nodal, fem, ddh.efem)
    to_port, from_port = _oracle_maps(ddh, oracle)
    l_ref = rng.standard_normal(2 * oracle.n_lambda).astype(np.float32)
    got = from_port(ddh.action(torch.from_numpy(to_port(l_ref))).numpy())
    assert _rel(got, oracle.action(l_ref)) < TOL


def test_run_ddh_matches_jax():
    """The slice end to end at nx=8 (16 subdomains, nt=800): tol=1e-2 keeps
    the run to two restarts and exercises the early Arnoldi exit."""
    kw = dict(nx=8, deg=3, block_size=8, tol=1e-2)
    want = jrun_ddh(**kw)
    got = run_ddh(**kw, device="cpu")
    assert got.success and want.success
    assert (got.num_iter, got.num_matvec) == (want.num_iter, want.num_matvec)
    np.testing.assert_allclose(got.res_norm, want.res_norm, rtol=2e-3)
    assert got.solution.shape == want.solution.shape and np.isfinite(got.solution).all()
    assert _rel(got.solution, want.solution) < 1e-3
