"""The port's study drivers (``examples/sweep.py``,
``examples/partition_study.py``) against the JAX package's, on the CPU.

The sweep at nx 8 on the transfer path and the jittered-mesh structured
partition case at nx 8 must give JAX's records' restarts and matvecs,
with the same mesh, labels and record keys; the sweep's final relative
residual agrees to 1 % (the DDH's fp32 Krylov round-off).

``python tests/test_torch_studies.py [nx ...]`` (default 32) is the recheck
of the transfer-path sweep count (ROADMAP queue 3): the JAX package on the
CPU and the port on the CPU, one JSON line per size with both records'
restarts and matvecs.  Minutes per size; not part of the test suite.
"""

import json
import sys

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu.examples import partition_study as jps
from cuddhelmholtz_tpu.examples import sweep as jsweep
from cuddhelmholtz_tpu_torch.examples import partition_study as ps
from cuddhelmholtz_tpu_torch.examples import sweep

torch.set_num_threads(1)

COUNTS = ("iters", "matvecs", "success", "nx", "ndof", "n_domains", "nt")


@pytest.fixture(autouse=True, scope="module")
def _no_setup_cache():
    """Neither package reads or writes a setup cache here."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


def test_sweep_matches_jax():
    (got,) = sweep.sweep((8,), transfer=True, device="cpu")
    (want,) = jsweep.sweep((8,), transfer=True)
    assert set(got) == set(want)
    assert {k: got[k] for k in COUNTS} == {k: want[k] for k in COUNTS}
    assert got["success"] and got["omega"] == pytest.approx(want["omega"], rel=1e-15)
    # the last restart's residual carries the fp32 Krylov round-off (0.2 % here)
    assert got["final_rel_res"] == pytest.approx(want["final_rel_res"], rel=1e-2)
    json.dumps(got)


def test_partition_case_matches_jax():
    mesh, jmesh = ps.jittered_rect(8), jps.jittered_rect(8)
    np.testing.assert_array_equal(mesh.vertices, jmesh.vertices)
    labels, ndom = ps.structured_labels(8, 8, 4, 4)
    got = ps.measure("jitter8_structured4", mesh, labels, nx=8, device="cpu")
    want = jps.measure("jitter8_structured4", jmesh, labels, nx=8)
    assert set(got) == set(want) and ndom == got["n_domains"] == 4
    keys = ("n_elem", "n_domains", "n_shared", "n_lambda", "max_dom_elems", "min_dom_elems",
            "restarts", "matvecs", "success")
    assert {k: got[k] for k in keys} == {k: want[k] for k in keys}
    assert got["success"]


def recheck(nxs) -> None:
    """One JSON line per nx: the transfer-path sweep record's counts in the
    JAX package and in the port, both on the CPU."""
    import os

    os.environ["CUDDH_CACHE_DIR"] = ""
    for nx in nxs:
        (want,) = jsweep.sweep((nx,), transfer=True)
        (got,) = sweep.sweep((nx,), transfer=True, device="cpu")
        print(json.dumps({"nx": nx, "jax": [want["iters"], want["matvecs"]],
                          "port": [got["iters"], got["matvecs"]],
                          "jax_rel": want["final_rel_res"], "port_rel": got["final_rel_res"]}),
              flush=True)


if __name__ == "__main__":
    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    recheck([int(a) for a in sys.argv[1:]] or [32])
