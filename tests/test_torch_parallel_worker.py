"""One gloo rank of the port's multi-process tests (``test_torch_sharding.py``,
``test_torch_multiprocess.py``).

Started by ``cuddhelmholtz_tpu_torch.parallel.spawn_cpu_processes`` as
``test_torch_parallel_worker.py RANK WORLD DEVS_PER_PROC MODE IN_NPZ OUT_PREFIX``.
It joins the process group (``initialize_from_env`` on the CPU), builds the
mesh of MODE (``shard``: ``device_mesh()``; ``hybrid``: the 2-axis ``("dcn",
"ici")`` ``hybrid_device_mesh()``), runs every sharded operator on the
numpy-seeded inputs of IN_NPZ and writes its results to OUT_PREFIX.RANK.npz.
The test compares them with the JAX package's sharded results and with the
port's single-process ones, and the ranks' files with each other.  MODE
``sources`` runs ``run_ddh_multi_source(shard_sources=True)`` instead.

It holds no test itself (pytest collects nothing here); the name keeps it
with the port's tests.
"""

import os
import sys

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D  # noqa: E402
from cuddhelmholtz_tpu_torch.models.helmholtz import make_helmholtz_op  # noqa: E402
from cuddhelmholtz_tpu_torch.ops.mass import make_mass_op  # noqa: E402
from cuddhelmholtz_tpu_torch.ops.stiffness import make_stiffness_op  # noqa: E402
from cuddhelmholtz_tpu_torch.parallel import (  # noqa: E402
    ShardedDDH,
    device_mesh,
    hybrid_device_mesh,
    initialize_from_env,
    shard_mass_op,
    shard_stiffness_op,
    sharded_helmholtz_matvec,
    sharded_mass_apply,
    sharded_stiffness_apply,
)
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH  # noqa: E402
from cuddhelmholtz_tpu_torch.solvers.gmres import gmres  # noqa: E402
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space  # noqa: E402
from cuddhelmholtz_tpu_torch.utils.basis import Basis  # noqa: E402


def t(a):
    return torch.as_tensor(np.asarray(a))


def space(nx, nb):
    mesh = Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1)
    return mesh, H1Space(mesh, Basis(nb))


def operators(inp, mesh, out):
    """Element-sharded stiffness, mass and coupled Helmholtz matvecs (fp64)."""
    _, fem = space(10, 5)
    op = make_stiffness_op(fem, device="cpu")
    out["stiffness"] = sharded_stiffness_apply(op, mesh)(shard_stiffness_op(op, mesh),
                                                         t(inp["x_stiff"])).numpy()
    _, fem = space(10, 4)
    op = make_mass_op(fem, coeff=inp["a_mass"], device="cpu")
    out["mass"] = sharded_mass_apply(op, mesh)(shard_mass_op(op, mesh), t(inp["x_mass"])).numpy()
    m8, fem = space(8, 4)
    fs = FaceSpace(fem, m8.boundary_edges)
    hop = make_helmholtz_op(float(inp["omega_h"]), inp["a2"], inp["af"], fem, fs, kron=False,
                          device="cpu")
    matvec = sharded_helmholtz_matvec(hop, mesh)
    out["helmholtz"] = matvec(t(inp["U"])).numpy()


def ddh_paths(inp, mesh, out):
    """ShardedDDH: in float64 the direct action, rhs and postprocess at 16
    domains; in float32 the transfer action without a route at 16 domains,
    the rolled action at 64 and a GMRES step on the direct path."""
    nx, omega = 8, float(inp["omega_d"])
    _, fem = space(nx, 4)
    ddh = DDH(omega, inp["a_nodal"], fem, nx=nx, ny=nx, block_size=8, wh_maxit=1,
              device="cpu", dtype=torch.float64)
    sddh = ShardedDDH(ddh, mesh)
    lam, f = t(inp["lam"]), t(inp["f"])
    out["action"] = sddh.action(lam).numpy()
    out["rhs"] = sddh.rhs(f).numpy()
    out["post"] = sddh.postprocess(lam, f).numpy()
    out["action_again"] = sddh.action(lam).numpy()

    ddh32 = DDH(omega, inp["a_nodal"], fem, nx=nx, ny=nx, block_size=8, wh_maxit=1,
                device="cpu")
    s32 = ShardedDDH(ddh32, mesh)
    f32, lam32 = t(inp["f"]).float(), lam.float()
    ddh32.precompute_transfer()
    route, ddh32.route = ddh32.route, None  # the scattered transfer exchange
    out["transfer"] = ShardedDDH(ddh32, mesh).action(lam32).numpy()
    ddh32.use_transfer, ddh32.route = False, route

    _, fem16 = space(16, 4)
    ddh16 = DDH(2 * np.pi * 16 / 10, np.ones(fem16.ndof), fem16, nx=16, ny=16, block_size=8,
                wh_maxit=1, device="cpu")
    ddh16.precompute_transfer()
    sddh16 = ShardedDDH(ddh16, mesh)
    out["rolled_engaged"] = np.array(sddh16._roll is not None)
    out["rolled"] = sddh16.action(t(inp["lam16"]).float()).numpy()

    res = gmres(s32.action, s32.rhs(f32), m=5, maxit=5, tol=1e-6)
    out["gmres_counts"] = np.array([res.num_iter, res.num_matvec])
    out["gmres_hist"] = res.res_norm[: res.n_hist].numpy()
    out["gmres_x"] = res.x.numpy()


def sources(inp, out):
    from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh_multi_source

    res = run_ddh_multi_source(nx=8, deg=1, n_sources=4, tol=1e-3, transfer=False,
                               method="vmap", shard_sources=True, device="cpu")
    out["solution"] = res.solution
    out["restarts"] = np.array(res.extra["per_source_restarts"])
    out["matvecs"] = np.array(res.extra["per_source_matvecs"])
    out["n_shard"] = np.array(res.extra["n_shard"])


def main():
    rank, world, per_proc = (int(a) for a in sys.argv[1:4])
    mode, in_npz, prefix = sys.argv[4:7]
    torch.set_num_threads(1)
    assert initialize_from_env(device="cpu")
    assert (torch.distributed.get_world_size(), torch.distributed.get_rank()) == (world, rank)
    inp = dict(np.load(in_npz))
    out = {}
    if mode == "sources":
        sources(inp, out)
    else:
        if mode == "hybrid":
            mesh = hybrid_device_mesh()
            assert mesh.mesh_dim_names == ("dcn", "ici")
            assert tuple(mesh.mesh.shape) == (world // per_proc, per_proc)
        else:
            mesh = device_mesh()
        operators(inp, mesh, out)
        ddh_paths(inp, mesh, out)
    np.savez(f"{prefix}.{rank}.npz", **out)
    torch.distributed.destroy_process_group()
    print(f"rank {rank}: OK", flush=True)


if __name__ == "__main__":
    main()
