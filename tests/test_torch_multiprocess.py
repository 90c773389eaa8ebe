"""The port's multi-process path: gloo ranks on a 2-axis ("dcn", "ici") mesh.

Counterpart of ``tests/test_multiprocess.py`` (+ ``mp_worker.py``): 2
simulated hosts x 2 ranks each (``spawn_cpu_processes(worker, 2, 2)``, one
process per rank, ``initialize_from_env`` from the ``CUDDH_*`` variables,
``hybrid_device_mesh()``) run every check of ``test_torch_sharding.py``,
held to the JAX package's ``ShardedDDH`` on the same (2, 2) ("dcn", "ici")
mesh of the conftest's virtual CPU devices, at the same tolerances.  Then
``run_ddh_multi_source(shard_sources=True)`` over 2 ranks must equal the
replicated solve, source by source, as ``tests/test_multichip.py::
test_source_axis_data_parallel`` checks the JAX package: the same restart
and matvec counts and solutions within 1e-5 relative.  The weak-scaling
harness (``examples/scaling.py``, the bench's ``scaling`` key) runs its
direct-path rows at 1 and 2 gloo ranks, and ``examples/sharded_solve.py``
(the sharded flagship solve of ``chip_smoke.py`` phase 29) at nx 8 on 2
ranks takes the unsharded solve's 9 restarts / 185 matvecs (JAX's
``run_ddh(nx=8, block_size=8)`` counts), bitwise on repeat.  A spawn whose
ranks outlive its timeout kills them all.
"""

import json
import threading
import time

import jax
import numpy as np
import pytest
from jax.sharding import Mesh

from cuddhelmholtz_tpu.parallel.sharding import device_mesh as jdevice_mesh
from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh_multi_source
from cuddhelmholtz_tpu_torch.examples import sharded_solve
from cuddhelmholtz_tpu_torch.examples.scaling import scaling
from cuddhelmholtz_tpu_torch.parallel import spawn_cpu_processes
from test_torch_sharding import SPAWN_TIMEOUT, check_against_jax, jax_results, make_inputs, spawn


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The hybrid-mesh ranks, the JAX results on the (2, 2) mesh, the
    source-sharded ranks and the replicated port solve, all started
    together."""
    tmp = tmp_path_factory.mktemp("multiprocess")
    in_npz = str(tmp / "inputs.npz")
    inp = make_inputs(in_npz)
    out, errors = {}, []

    def job(name, fn):
        def run():
            try:
                out[name] = fn()
            except BaseException as e:  # reported by the test that reads it
                errors.append(e)
        return threading.Thread(target=run)

    hybrid = Mesh(np.array(jax.devices()[:4]).reshape(2, 2), ("dcn", "ici"))
    threads = [
        job("hybrid", lambda: spawn(2, 2, "hybrid", in_npz, str(tmp / "hybrid"))),
        job("sources", lambda: spawn(2, 1, "sources", in_npz, str(tmp / "sources"))),
        job("jax", lambda: jax_results(inp, hybrid, ("dcn", "ici"), elem_mesh=jdevice_mesh(4))),
        job("replicated", lambda: run_ddh_multi_source(
            nx=8, deg=1, n_sources=4, tol=1e-3, transfer=False, method="vmap", device="cpu")),
        job("scaling", lambda: scaling(base_nx=8, reps=1, device="cpu", cpu_ranks=2)),
        job("sharded_solve", lambda: spawn_cpu_processes(
            sharded_solve.__file__, 1, 2, "--nx", "8", "--block-size", "8", "--device", "cpu",
            timeout=SPAWN_TIMEOUT)),
    ]
    for th in threads:
        th.start()
    for th in threads:
        th.join(SPAWN_TIMEOUT + 30)
        assert not th.is_alive()
    if errors:
        raise errors[0]
    return out


def test_sharded_ddh_on_a_dcn_ici_mesh(runs):
    assert len(runs["hybrid"]) == 4
    check_against_jax(runs["hybrid"], runs["jax"], None)


def test_shard_sources_equals_the_replicated_solve(runs):
    ref = runs["replicated"]
    for got in runs["sources"]:  # every rank gathers every source
        assert int(got["n_shard"]) == 2
        assert got["restarts"].tolist() == ref.extra["per_source_restarts"]
        assert got["matvecs"].tolist() == ref.extra["per_source_matvecs"]
        d = np.linalg.norm(got["solution"] - ref.solution) / np.linalg.norm(ref.solution)
        assert d < 1e-5, d


def test_scaling_records_name_backend_and_world(runs):
    recs = runs["scaling"]
    assert [r["devices"] for r in recs] == [1, 2]
    assert [r["nx"] for r in recs] == [8, 12]  # weak: nx 8 sqrt(2), in 4-element blocks
    for r in recs:
        assert r["backend"] == "gloo" and r["device"] == "cpu" and r["finite"]
        assert r["matvec_seconds"] > 0 and r["mode"] == "ddh" and not r["transfer"]
    assert recs[0]["efficiency_vs_1dev"] == 1.0


def test_sharded_solve_example(runs):
    outs = runs["sharded_solve"]
    for rank, (rc, text) in enumerate(outs):
        assert rc == 0, f"rank {rank}: {text[-3000:]}"
    rec = json.loads(outs[0][1].strip().splitlines()[-1])
    assert (rec["backend"], rec["world"], rec["rows_per_rank"]) == ("gloo", 2, 8)
    assert rec["rel_action"] == rec["rel_rhs"] == 0.0 and rec["rel_postprocess"] < 1e-6
    assert rec["rolled"] and rec["success"] and rec["bitwise"]
    assert (rec["restarts"], rec["matvecs"]) == (9, 185)
    assert rec["plain_residual"] <= 1.2e-4
    # every rank's record; on CPU tensors the wrapper runs the plain cycle
    assert rec["launches_direct"] == rec["launches_solves"] == [{}, {}]


def test_spawn_timeout_kills_every_rank(tmp_path):
    """A rank that outlives the spawn's timeout is killed, every one of
    them, and the call returns."""
    worker = tmp_path / "sleeper.py"
    worker.write_text("import time\ntime.sleep(120)\n")
    t0 = time.monotonic()
    outs = spawn_cpu_processes(str(worker), 1, 2, timeout=2.0)
    assert time.monotonic() - t0 < 60
    assert [rc < 0 for rc, _ in outs] == [True, True]
