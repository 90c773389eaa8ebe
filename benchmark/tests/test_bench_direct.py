"""CPU tests of the direct-path cell ``ddh_structured_matrix_free.rhs_stream``
(upstream's DDH as written: one wave cycle, K1, in every matvec, rhs and
postprocess, no ``prepare``) and its six per-layer readers.

The cell cut to nx 8 runs on the CPU, is correct against the plain
reference and reports ``setup_s`` and ``rhs_per_s``; the run writes no file
of the benchmark.  Each of its seven readers gets a synthetic trace and
recording, and reads nothing where its trace or counter is absent: an
untraced run, a program without the recorder, and the parent of the
direct-apply counter, which counts no ``ddh.action.direct``."""

from __future__ import annotations

import sys

import pytest

from benchmark import spec
from benchmark.run import Run, run_cell
from benchmark.tests.conftest import small_cell
from benchmark.trace import DeviceTrace
from cuddhelmholtz_tpu_torch.utils import spans

CELL = "ddh_structured_matrix_free.rhs_stream"
MS = 1_000_000
NAMES = ("matvecs_per_request.direct", "k1_ms_per_launch.direct", "k1_bound_pct.direct",
         "k1_window_pct.direct", "device_idle_pct.direct", "direct_apply_pct.direct",
         "graphed_step_pct.direct")
# the readers of the trace and of the apply counter; the graphed-step share,
# a counter of the Krylov step, has its own tests (test_bench_graphed_step.py)
TRACED = NAMES[1:6]
K1_FLOP = 67e12 * 0.0005  # a tenth of the bound's work for 5 ms of K1: 10 %


def test_the_cell_is_the_direct_path_of_the_upstream_example():
    cell = spec.load_cell(CELL)
    base = spec.load_cell("ddh_structured.rhs_stream")
    assert cell.config["transfer"] is False and "prepare" not in cell.config
    same = {k: v for k, v in base.config.items()
            if k not in ("name", "source", "transfer", "prepare", "deployment")}
    assert {k: cell.config[k] for k in same} == same
    assert cell.traffic == base.traffic and cell.chips == 1
    assert [m["name"] for m in cell.per_layer] == list(NAMES)
    # no p90: over the window's ~20 requests it is the second slowest, which
    # the seed's hardest sources set (2.8-3.4 s on an H100)
    assert {m["name"] for m in cell.end_to_end} == {"setup_s", "rhs_per_s"}


def test_the_small_cell_is_correct_and_writes_no_benchmark_file():
    files = {p: p.read_bytes() for p in spec.HERE.rglob("*")
             if p.is_file() and "__pycache__" not in p.parts}
    cell = small_cell(CELL)
    spans.reset("ddh.action.")
    res = run_cell(cell, 2**31 + 41, 0.2, False, device="cpu")
    assert res["correct"] is True and res["failed"] == 0, res["check"]
    assert set(res["metrics"]) == {"setup_s", "rhs_per_s"}
    # every apply of the warm-up and the window took the direct path
    assert spans.total("ddh.action.direct") > 0
    assert spans.totals("ddh.action.") == {"direct": spans.total("ddh.action.direct")}
    assert {p: p.read_bytes() for p in files} == files


def traced_run(monkeypatch, counts) -> Run:
    """Two requests whose solves launch K1 four times in all (5 ms of K1
    device time) in a 10 ms traced window, with the program's ``counts``
    in its recording."""
    rec = spans.Recording()
    rec.spans += [("ddh.solve", 0, 9 * MS, None, 0), ("ddh.action", 1 * MS, 3 * MS, 0, 0)]
    rec.counts.update(counts)
    monkeypatch.setattr(spans, "_rec", rec)
    ops = [("void wave_cycle_sparse_kernel<4>(...)", 0, 1 * MS),
           ("void wave_cycle_sparse_kernel<4>(...)", 2 * MS, 4 * MS),
           ("elementwise", 4 * MS, 5 * MS),
           ("void wave_cycle_mma_kernel<8>(...)", 6 * MS, 8 * MS)]
    reqs = [{"latency_s": 0.004, "n_rhs": 1, "ok": True, "matvecs": 3},
            {"latency_s": 0.005, "n_rhs": 1, "ok": True, "matvecs": 4}]
    return Run(setup_s=1.0, window_s=0.01, requests=reqs,
               trace=DeviceTrace(ops, 0, 10 * MS))


DIRECT = {"ddh.action.direct": 7, "k1.launches.sparse_shared": 3, "k1.launches.mma_shared": 1,
          "k1.flop": K1_FLOP, "k1.rows": 4096, "gmres.host_syncs": 9,
          "gmres.step.graphed": 6, "gmres.step.eager": 2}


def test_each_reader_on_a_synthetic_trace_and_recording(monkeypatch):
    run = traced_run(monkeypatch, DIRECT)
    read = {n: spec.metric_reader(n)(run) for n in NAMES}
    assert read["matvecs_per_request.direct"] == pytest.approx(3.5)
    assert read["k1_ms_per_launch.direct"] == pytest.approx(5.0 / 4)
    assert read["k1_bound_pct.direct"] == pytest.approx(10.0)
    assert read["k1_window_pct.direct"] == pytest.approx(50.0)
    assert read["device_idle_pct.direct"] == pytest.approx(100 * (1 - 6 / 10))
    assert read["direct_apply_pct.direct"] == pytest.approx(100.0)
    assert read["graphed_step_pct.direct"] == pytest.approx(75.0)


@pytest.mark.parametrize("graphed, eager, want", [(0, 0, 100.0), (3, 0, 70.0), (1, 2, 70.0)])
def test_the_share_of_direct_applies(monkeypatch, graphed, eager, want):
    counts = dict(DIRECT, **{"ddh.action.graphed": graphed, "ddh.action.eager": eager})
    run = traced_run(monkeypatch, counts)
    assert spec.metric_reader("direct_apply_pct.direct")(run) == pytest.approx(want)


def test_the_parent_without_the_direct_counter_reads_no_share(monkeypatch):
    parent = {k: v for k, v in DIRECT.items() if k != "ddh.action.direct"}
    run = traced_run(monkeypatch, parent)
    assert spec.metric_reader("direct_apply_pct.direct")(run) is None
    # the K1 and device readers read the parent as they read the change
    assert spec.metric_reader("k1_ms_per_launch.direct")(run) == pytest.approx(5.0 / 4)


@pytest.mark.parametrize("name", TRACED)
def test_nothing_to_read_gives_none(monkeypatch, name):
    read = spec.metric_reader(name)
    run = traced_run(monkeypatch, DIRECT)
    # an untraced run
    assert read(Run(setup_s=1.0, window_s=1.0, requests=run.requests)) is None
    # a window in which no K1 kernel ran and the program counted nothing
    empty = traced_run(monkeypatch, {"gmres.host_syncs": 9})
    empty.trace = DeviceTrace([("elementwise", 0, MS)], 0, 10 * MS)
    assert read(empty) is None or name == "device_idle_pct.direct"
    # a program without the recorder
    monkeypatch.setitem(sys.modules, "cuddhelmholtz_tpu_torch.utils.spans", None)
    monkeypatch.delattr("cuddhelmholtz_tpu_torch.utils.spans", raising=False)
    if name in ("k1_window_pct.direct", "device_idle_pct.direct"):
        assert read(run) is not None  # these read the device trace alone
    else:
        assert read(run) is None
