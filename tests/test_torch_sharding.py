"""The port's multi-device layer (``parallel/sharding.py``) against the JAX package's.

The port runs SPMD, one process per device: each case spawns n gloo ranks on
the CPU (``spawn_cpu_processes`` running ``test_torch_parallel_worker.py``, one
start-up for every check of that n), while this process computes the JAX
package's sharded results on ``device_mesh(n)`` over the conftest's 8
virtual CPU devices.  n = 3 pads the 16 subdomains to 18 rows.

Tolerances: float64 (the element-sharded stiffness, mass and Helmholtz
matvecs; ``ShardedDDH``'s direct action, rhs and postprocess, the DDH built
in float64 in both packages) within 1e-12 relative to the max; the float32
lambda paths (the transfer action, the rolled-halo action, a GMRES step:
the JAX package probes its transfer matrices in float32 only) within 1e-5
relative, the GMRES step with the JAX sharded solve's restart and matvec
counts exactly.  Every rank must hold the same bits, and the port's
sharded results equal its own single-process ones (``ShardedDDH`` with no
process group, computed here) bitwise on the DDH paths (every lambda entry
has one writer), which in turn are the port's ``DDH``.
"""

import os
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.models.helmholtz import (
    apply_helmholtz as japply_helmholtz,
    make_helmholtz_op as jmake_helmholtz_op,
    project_coefficients,
)
from cuddhelmholtz_tpu.ops.mass import make_mass_op as jmake_mass_op
from cuddhelmholtz_tpu.ops.stiffness import make_stiffness_op as jmake_stiffness_op
from cuddhelmholtz_tpu.parallel.sharding import (
    ShardedDDH as JShardedDDH,
    device_mesh as jdevice_mesh,
    shard_mass_op as jshard_mass_op,
    shard_stiffness_op as jshard_stiffness_op,
    sharded_helmholtz_matvec as jsharded_helmholtz_matvec,
    sharded_mass_apply as jsharded_mass_apply,
    sharded_stiffness_apply as jsharded_stiffness_apply,
)
from cuddhelmholtz_tpu.solvers.ddh import DDH as JDDH
from cuddhelmholtz_tpu.solvers.gmres import gmres as jgmres
from cuddhelmholtz_tpu.spaces.h1 import FaceSpace as JFaceSpace, H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.parallel import spawn_cpu_processes
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis
from test_torch_parallel_worker import ddh_paths

WORKER = os.path.join(os.path.dirname(__file__), "test_torch_parallel_worker.py")
SIZES = (2, 3)
SPAWN_TIMEOUT = 240.0  # seconds for every rank of one spawn, start-up included
OMEGA_D = 2 * np.pi * 8 / 2.5  # nt 200 at nx 8 (test_torch_ddh.py)


def _space(nx, nb):
    mesh = JMesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    return mesh, JH1Space(mesh, JBasis(nb))


def _port_space(nx, nb=4):
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    return mesh, H1Space(mesh, Basis(nb))


def make_inputs(path: str) -> dict:
    """The numpy-seeded inputs of every check, written to ``path``."""
    rng = np.random.default_rng(0)
    _, f10 = _space(10, 5)
    _, f10m = _space(10, 4)
    m8, f8 = _space(8, 4)
    fs = JFaceSpace(f8, m8.boundary_edges)

    def coeff(xy):
        r = xy[..., 0] ** 2 + xy[..., 1] ** 2
        return jnp.where(r < 0.0625, 0.2, 1.0)

    a2, af = project_coefficients(f8, fs, coeff)
    ddh = JDDH(OMEGA_D, np.ones(f8.ndof), f8, nx=8, ny=8, block_size=8, wh_maxit=1)
    _, f16 = _space(16, 4)
    ddh16 = JDDH(2 * np.pi * 1.6, np.ones(f16.ndof), f16, nx=16, ny=16, block_size=8,
                 wh_maxit=1)
    inp = {
        "x_stiff": rng.standard_normal(f10.ndof),
        "a_mass": 1.0 + 0.5 * rng.random(f10m.ndof),
        "x_mass": rng.standard_normal(f10m.ndof),
        "omega_h": 2 * np.pi * 8 / 10,
        "a2": np.asarray(a2),
        "af": np.asarray(af),
        "U": rng.standard_normal(2 * f8.ndof),
        "omega_d": OMEGA_D,
        "a_nodal": 1.0 + 0.3 * rng.random(f8.ndof),
        "lam": rng.standard_normal(ddh.size),
        "f": rng.standard_normal(2 * f8.ndof),
        "lam16": rng.standard_normal(ddh16.size),
    }
    np.savez(path, **inp)
    return inp


def jax_results(inp: dict, mesh, axis="shard", elem_mesh=None) -> dict:
    """The JAX package's sharded results on ``mesh`` (mesh axis or axes
    ``axis``) for the worker's checks; the element-sharded operators, which
    take one axis in the JAX package, on ``elem_mesh`` (default ``mesh``)."""
    out = {}
    emesh = mesh if elem_mesh is None else elem_mesh
    eaxis = emesh.axis_names[0]
    _, fem = _space(10, 5)
    op = jmake_stiffness_op(fem)
    out["stiffness"] = np.asarray(jsharded_stiffness_apply(op, emesh, eaxis)(
        jshard_stiffness_op(op, emesh, eaxis), jnp.asarray(inp["x_stiff"])))
    _, fem = _space(10, 4)
    op = jmake_mass_op(fem, coeff=inp["a_mass"])
    out["mass"] = np.asarray(jsharded_mass_apply(op, emesh, eaxis)(
        jshard_mass_op(op, emesh, eaxis), jnp.asarray(inp["x_mass"])))
    m8, fem = _space(8, 4)
    fs = JFaceSpace(fem, m8.boundary_edges)
    hop = jmake_helmholtz_op(float(inp["omega_h"]), inp["a2"], inp["af"], fem, fs)
    matvec = jsharded_helmholtz_matvec(hop, emesh, eaxis)
    out["helmholtz"] = np.asarray(matvec(jnp.asarray(inp["U"])))
    out["helmholtz_single"] = np.asarray(japply_helmholtz(hop, jnp.asarray(inp["U"])))

    lam, f = jnp.asarray(inp["lam"]), jnp.asarray(inp["f"])
    ddh = JDDH(OMEGA_D, inp["a_nodal"], fem, nx=8, ny=8, block_size=8, wh_maxit=1,
               dtype=jnp.float64)
    sddh = JShardedDDH(ddh, mesh, axis)
    out["action"] = np.asarray(sddh.action(lam))
    out["rhs"] = np.asarray(sddh.rhs(f))
    out["post"] = np.asarray(sddh.postprocess(lam, f))

    ddh32 = JDDH(OMEGA_D, inp["a_nodal"], fem, nx=8, ny=8, block_size=8, wh_maxit=1)
    ddh32.precompute_transfer()
    route, ddh32.route = ddh32.route, None
    out["transfer"] = np.asarray(JShardedDDH(ddh32, mesh, axis).action(
        jnp.asarray(inp["lam"], jnp.float32)))
    ddh32.use_transfer, ddh32.route = False, route
    _, f16 = _space(16, 4)
    ddh16 = JDDH(2 * np.pi * 1.6, np.ones(f16.ndof), f16, nx=16, ny=16, block_size=8,
                 wh_maxit=1)
    ddh16.precompute_transfer()
    s16 = JShardedDDH(ddh16, mesh, axis)
    out["rolled_engaged"] = s16._roll_data is not None
    out["rolled"] = np.asarray(s16.action(jnp.asarray(inp["lam16"], jnp.float32)))

    s32 = JShardedDDH(ddh32, mesh, axis)
    f32 = jnp.asarray(inp["f"], jnp.float32)
    res = jgmres(s32.action, s32.rhs(f32), m=5, maxit=5, tol=1e-6)
    out["gmres_counts"] = np.array([int(res.num_iter), int(res.num_matvec)])
    out["gmres_hist"] = np.asarray(res.res_norm)[: int(res.n_hist)]
    out["gmres_x"] = np.asarray(res.x)
    return out


def spawn(n_procs: int, per_proc: int, mode: str, in_npz: str, prefix: str) -> list[dict]:
    """Run the worker in n_procs * per_proc gloo ranks; each rank's results."""
    runs = spawn_cpu_processes(WORKER, n_procs, per_proc, mode, in_npz, prefix,
                               timeout=SPAWN_TIMEOUT)
    for rank, (rc, text) in enumerate(runs):
        assert rc == 0, f"rank {rank} exited {rc}:\n{text[-3000:]}"
    return [dict(np.load(f"{prefix}.{r}.npz")) for r in range(len(runs))]


def rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def check_against_jax(ranks: list[dict], want: dict, single: dict | None) -> None:
    """The assertions shared by every mesh: ranks bitwise equal, the port
    against JAX at the stated tolerances, and against the port's own
    single-process results where given."""
    got = ranks[0]
    for other in ranks[1:]:
        for k in got:
            assert np.array_equal(got[k], other[k]), f"ranks disagree on {k}"
    for k in ("stiffness", "mass", "helmholtz"):
        assert rel(got[k], want[k]) < 1e-12, k
    assert rel(got["helmholtz"], want["helmholtz_single"]) < 1e-12
    for k in ("action", "rhs", "post"):
        assert rel(got[k], want[k]) < 1e-12, k
    for k in ("transfer", "rolled"):
        assert rel(got[k], want[k]) < 1e-5, k
    # the port's rolled exchange runs on any mesh whose ranks hold every
    # route offset (JAX's on a 1-axis mesh only; on 2 axes it scatters)
    assert bool(got["rolled_engaged"])
    assert np.array_equal(got["action"], got["action_again"])
    assert np.array_equal(got["gmres_counts"], want["gmres_counts"])
    assert rel(got["gmres_hist"], want["gmres_hist"]) < 1e-5
    assert rel(got["gmres_x"], want["gmres_x"]) < 1e-5
    if single is not None:
        for k in ("action", "rhs", "transfer", "rolled", "gmres_x"):
            assert np.array_equal(got[k], single[k]), k
        assert rel(got["post"], single["post"]) < 1e-12


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(inputs, {n: rank results}, {n: JAX results}, single-process results):
    the spawns of every n start together and run while JAX computes."""
    tmp = tmp_path_factory.mktemp("sharding")
    in_npz = str(tmp / "inputs.npz")
    inp = make_inputs(in_npz)
    got, errors = {}, []

    def run(n):
        try:
            got[n] = spawn(n, 1, "shard", in_npz, str(tmp / f"out{n}"))
        except BaseException as e:  # reported by the test that reads it
            errors.append(e)

    want = {}

    def run_jax(n):
        try:
            want[n] = jax_results(inp, jdevice_mesh(n))
        except BaseException as e:
            errors.append(e)

    threads = [threading.Thread(target=run, args=(n,)) for n in SIZES]
    threads += [threading.Thread(target=run_jax, args=(n,)) for n in SIZES]
    for th in threads:
        th.start()
    single = {}  # ShardedDDH at world 1: this process, no process group
    ddh_paths(inp, None, single)
    for th in threads:
        th.join(SPAWN_TIMEOUT + 30)
        assert not th.is_alive()
    if errors:
        raise errors[0]
    return inp, got, want, single


@pytest.mark.parametrize("n", SIZES)
def test_sharded_operators_and_ddh_match_jax(runs, n):
    _, got, want, single = runs
    check_against_jax(got[n], want[n], single)
    assert want[n]["rolled_engaged"]


def test_world_one_is_the_unsharded_port(runs):
    """Without a process group ShardedDDH is the port's DDH: the direct
    action, rhs and postprocess and the scattered transfer action bitwise,
    the rolled action (the halo a local copy; one product over the full
    transfer stack where DDH splits off its majority matrix) to float32
    round-off."""
    inp, _, _, single = runs
    assert not torch.distributed.is_initialized()
    _, fem = _port_space(8)
    lam, f = torch.as_tensor(inp["lam"]), torch.as_tensor(inp["f"])
    kw = dict(nx=8, ny=8, block_size=8, wh_maxit=1, device="cpu")
    ddh = DDH(OMEGA_D, inp["a_nodal"], fem, dtype=torch.float64, **kw)
    assert np.array_equal(single["action"], ddh.action(lam).numpy())
    assert np.array_equal(single["rhs"], ddh.rhs(f).numpy())
    assert np.array_equal(single["post"], ddh.postprocess(lam, f).numpy())
    ddh32 = DDH(OMEGA_D, inp["a_nodal"], fem, **kw)
    ddh32.precompute_transfer()
    ddh32.route = None
    assert np.array_equal(single["transfer"], ddh32.action(lam.float()).numpy())
    _, fem16 = _port_space(16)
    ddh16 = DDH(2 * np.pi * 1.6, np.ones(fem16.ndof), fem16, nx=16, ny=16, block_size=8,
                wh_maxit=1, device="cpu")
    ddh16.precompute_transfer()
    want = ddh16.action(torch.as_tensor(inp["lam16"]).float()).numpy()
    assert rel(single["rolled"], want) < 1e-6


def test_row_padding_at_three_ranks(runs):
    """16 subdomains over 3 ranks pad to 18 rows (6 per rank), and the
    results still equal the 2-rank ones."""
    _, got, _, _ = runs
    for k in ("action", "rhs", "transfer", "rolled"):
        assert np.array_equal(got[3][0][k], got[2][0][k]), k
    assert jax.device_count() >= 3
