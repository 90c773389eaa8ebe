"""One rank of the scaling harness: times the sharded DDH (or Helmholtz) matvec.

Counterpart of ``cuddhelmholtz_tpu/examples/scaling_mp_worker.py``.  Started
by ``examples/scaling.py`` through ``parallel.spawn_processes`` (one process
per rank, NCCL on cards, gloo on the CPU) as

    scaling_mp_worker.py RANK WORLD PER_PROC DEVICE MODE NX DEG REPS TRANSFER

Every rank joins the process group, builds the same problem at ``NX``
(``MODE`` ``ddh``: the flagship's DDH with 16-DOF subdomains, its transfer
matrices when ``TRANSFER`` is 1, wrapped in ``ShardedDDH`` on the 2-axis
("dcn", "ici") mesh; ``global``: the element-sharded coupled Helmholtz
matvec), times ``REPS`` matvecs after one warm-up, and rank 0 prints one
``SCALING_MP {json}`` line with the record (backend, world size, device,
seconds per matvec, stencil-equivalent nnz/s, the wave-cycle kernel
launches of this rank).
"""

import json
import os
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))))

from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D  # noqa: E402
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc  # noqa: E402
from cuddhelmholtz_tpu_torch.parallel import (  # noqa: E402
    ShardedDDH,
    hybrid_device_mesh,
    initialize_from_env,
    sharded_helmholtz_matvec,
)
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, _sync  # noqa: E402
from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space  # noqa: E402
from cuddhelmholtz_tpu_torch.utils import spans  # noqa: E402
from cuddhelmholtz_tpu_torch.utils.basis import Basis  # noqa: E402


def main() -> int:
    rank, world, per_proc = (int(a) for a in sys.argv[1:4])
    device, mode = sys.argv[4], sys.argv[5]
    nx, deg, reps, transfer = (int(a) for a in sys.argv[6:10])
    assert initialize_from_env(device=device)
    dev = torch.device("cuda", torch.cuda.current_device()) if device == "cuda" else \
        torch.device("cpu")
    if dev.type == "cpu":
        torch.set_num_threads(1)
    mesh = hybrid_device_mesh(per_proc)
    nb = deg + 1
    omega = 2 * np.pi * nx / 10
    m2d = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(m2d, Basis(nb))
    rec = {"mode": mode, "backend": torch.distributed.get_backend(), "devices": world,
           "processes": world // per_proc, "device": str(dev), "nx": nx, "ndof": fem.ndof}
    if dev.type == "cuda":
        rec["device_name"] = torch.cuda.get_device_name(dev)
    if mode == "ddh":
        ddh = DDH(omega, np.ones(fem.ndof), fem, nx=nx, ny=nx, device=dev)
        if transfer:
            ddh.precompute_transfer()
        op = ShardedDDH(ddh, mesh)
        x = torch.zeros(op.size, device=dev)
        matvec = op.action
        nnz = ddh.wh_maxit * ddh.nt * 2 * int(ddh.efem.sizes.astype(np.int64).sum()) * (
            2 * nb - 1) ** 2
        rec.update(n_domains=ddh.n_domains, transfer=bool(transfer),
                   rolled=op._roll is not None)
    else:
        from cuddhelmholtz_tpu_torch.models.helmholtz import make_helmholtz_op

        fs = FaceSpace(fem, m2d.boundary_edges)
        hop = make_helmholtz_op(omega, np.ones(fem.ndof), np.ones(fs.fdof), fem, fs,
                                dtype=torch.float32, kron=False, device=dev)
        matvec = sharded_helmholtz_matvec(hop, mesh)
        x = torch.zeros(2 * fem.ndof, device=dev)
        nnz = 4 * fem.ndof * (2 * nb - 1) ** 2  # 2 stiffness + 2 mass applies
    x[0] = 1.0
    spans.reset(wc.LAUNCHES)
    matvec(x)  # warm-up
    _sync(dev)
    t0 = time.perf_counter()
    for _ in range(reps):
        y = matvec(x)
    _sync(dev)
    dt = (time.perf_counter() - t0) / reps
    rec.update(matvec_seconds=dt, nnz_per_s=nnz / dt, nnz_per_s_per_device=nnz / dt / world,
               finite=bool(torch.isfinite(y).all()),
               launches={k: v for k, v in wc.launch_counts().items() if v})
    if rank == 0:
        print("SCALING_MP " + json.dumps(rec), flush=True)
    torch.distributed.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
