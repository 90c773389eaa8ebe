"""The port's unstructured-square DDH against the JAX package.

The mesh is the repository's ``meshes/unstructured_square`` (140 vertices,
119 quads), partitioned by coordinate bisection.  Loading and bisection are
host NumPy and must agree exactly.  With 4 domains every subdomain has its
own stiffness, so the transfer probes run the grouped layout (b); the probe
transfer matrices agree with JAX's to 2e-5 relative (as
``test_torch_transfer.py``), and ``run_config(ddh_unstructured_square)``
gives JAX's restart and matvec counts, histories to rtol 2e-3 and solutions
to 1e-3 (as ``test_torch_ddh.py``).
"""

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.config import BASELINE_CONFIGS
from cuddhelmholtz_tpu.examples.drivers import run_config as jrun_config
from cuddhelmholtz_tpu.mesh.io import load_unstructured_square as jload
from cuddhelmholtz_tpu.solvers.ddh import DDH as JDDH
from cuddhelmholtz_tpu.spaces.ensemble import coordinate_bisection_labels as jbisect
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch.config import DDH_UNSTRUCTURED_SQUARE
from cuddhelmholtz_tpu_torch.examples.drivers import run_config
from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
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


OMEGA = DDH_UNSTRUCTURED_SQUARE.omega
JCFG = next(c for c in BASELINE_CONFIGS if c.name == "ddh_unstructured_square")


def _rel(a, b) -> float:
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


@pytest.fixture(scope="module")
def pair4():
    """(JAX DDH, port DDH) on 4 bisection domains, one WaveHoltz iteration
    per cycle (nt = 1,717 is the CFL limit), a rough medium; transfer maps
    precomputed in both."""
    labels, _ = coordinate_bisection_labels(load_unstructured_square(), 4)
    a_fem = JH1Space(jload(), JBasis(4))
    a_nodal = 1.0 + 0.3 * np.random.default_rng(0).random(a_fem.ndof)
    jddh = JDDH(OMEGA, a_nodal, a_fem, element_labels=labels, wh_maxit=1)
    ddh = DDH(OMEGA, a_nodal, H1Space(load_unstructured_square(), Basis(4)),
              element_labels=labels, wh_maxit=1, device="cpu")
    jddh.precompute_transfer()
    ddh.precompute_transfer()
    return jddh, ddh


def test_config_matches_jax():
    for name in ("nx", "deg", "mesh", "n_domains", "wh_maxit", "transfer"):
        assert getattr(DDH_UNSTRUCTURED_SQUARE, name) == getattr(JCFG, name), name
    g, jg = DDH_UNSTRUCTURED_SQUARE.gmres, JCFG.gmres
    assert (g.m, g.maxit, g.tol) == (jg.m, jg.maxit, jg.tol)
    assert DDH_UNSTRUCTURED_SQUARE.name == JCFG.name and DDH_UNSTRUCTURED_SQUARE.kind == "ddh"


def test_mesh_loads_like_jax():
    m, jm = load_unstructured_square(), jload()
    assert (m.n_elem, m.vertices.shape[0]) == (119, 140)
    for name in ("vertices", "elem_vertices", "edge_elements", "interior_edges"):
        np.testing.assert_array_equal(getattr(m, name), getattr(jm, name), err_msg=name)


@pytest.mark.parametrize("n_target", [4, 8])
@pytest.mark.parametrize("cut_sweep", [0, 7])
def test_bisection_matches_jax(n_target, cut_sweep):
    labels, n = coordinate_bisection_labels(load_unstructured_square(), n_target, cut_sweep)
    jlabels, jn = jbisect(jload(), n_target, cut_sweep)
    assert n == jn == n_target
    np.testing.assert_array_equal(labels, jlabels)


def test_grouped_plain_cycle_equals_per_row(pair4):
    """The probe layout (b) (rows in runs of 8 per matrix) in the plain
    cycle equals the per-row einsum cycle on the same rows, to 2e-5 of the
    max: the batched and per-row products sum in different orders over
    1,717 x 2 steps."""
    _, ddh = pair4
    p = ddh.params
    assert p.S.dim() == 3 and p.S.shape[0] == 4
    c = 8
    gp = p._replace(Ha=p.Ha.repeat_interleave(c, 0), inv_mi=p.inv_mi.repeat_interleave(c, 0))
    gmask = ddh.gmask.repeat_interleave(c, 0).numpy()
    rng = np.random.default_rng(1)
    F = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32))
    G = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32))
    u, v = wc.wave_cycle_plain(gp, F, G, wh_maxit=1, s_group_size=c)
    rows = gp._replace(S=p.S.repeat_interleave(c, 0))
    u0, v0 = wc.wave_cycle_plain(rows, F, G, wh_maxit=1)
    assert torch.isfinite(u0).all() and float(u0.abs().max()) > 0
    assert torch.allclose(u, u0, rtol=0, atol=2e-5 * float(u0.abs().max()))
    assert torch.allclose(v, v0, rtol=0, atol=2e-5 * float(v0.abs().max()))


def test_transfer_matches_jax(pair4):
    jddh, ddh = pair4
    _, jinv, jnu = jddh._domain_groups()
    _, inv, nu = ddh._domain_groups()
    assert nu == jnu == 4 and np.array_equal(inv, jinv)
    assert ddh.transfer_stats["transfer_layout"] == "grouped"
    assert ddh.transfer_stats["transfer_rows"] == 4 * ddh.transfer_stats["transfer_ncols"]
    T, jT = ddh._T_u, jddh._T_u
    assert T.shape == jT.shape
    assert np.abs(T - jT).max() < 2e-5 * np.abs(jT).max()
    # the exchange of this partition agrees with the direct action
    lam = torch.from_numpy(np.random.default_rng(2).standard_normal(ddh.size).astype(np.float32))
    ddh.use_transfer = False
    direct = ddh.action(lam)
    ddh.use_transfer = True
    assert _rel(ddh.action(lam), direct) < 2e-5


def test_run_config_matches_jax(monkeypatch, tmp_path):
    """The configuration end to end at 4 domains, one WaveHoltz iteration
    per apply and three restarts at most."""
    monkeypatch.setenv("CUDDH_CACHE_DIR", str(tmp_path))
    kw = dict(n_domains=4, wh_maxit=1, maxit=3)
    want = jrun_config(JCFG, **kw)
    got = run_config(DDH_UNSTRUCTURED_SQUARE, **kw, device="cpu")
    assert got.extra["precompute"]["transfer_layout"] == "grouped"
    assert (got.num_iter, got.num_matvec) == (want.num_iter, want.num_matvec)
    np.testing.assert_allclose(got.res_norm, want.res_norm, rtol=2e-3)
    assert _rel(got.solution, want.solution) < 1e-3
