"""CPU tests of ``program_spans.py`` and the per-layer metrics that read the
program's own spans and counters: the idle split on synthetic device
intervals and nested spans, each reader on a synthetic ``Run``, and nothing
read where the program has no recorder."""

from __future__ import annotations

import sys

import pytest

from benchmark import program_spans, spec, stats
from benchmark.run import Run
from benchmark.trace import DeviceTrace
from cuddhelmholtz_tpu_torch.utils import spans

MS = 1_000_000
NEW = ("host_syncs_per_matvec.lambda", "step_ms.lambda", "apply_idle_pct.lambda",
       "krylov_idle_pct.lambda", "host_syncs_per_precond.composite", "precond_ms.composite",
       "apply_idle_pct.composite", "krylov_idle_pct.composite", "prepare_idle_ms.setup",
       "k1_tflops.setup")


def read(name, run):
    return spec.metric_reader(name)(run)


def recorded(monkeypatch, items, counts=None) -> spans.Recording:
    """A recording of the spans ``items`` (name, start_ms, end_ms, parent)
    installed as the program's last one."""
    rec = spans.Recording()
    roots = []
    for name, s, e, parent in items:
        roots.append(len(roots) if parent is None else roots[parent])
        rec.spans.append((name, s * MS, e * MS, parent, roots[-1]))
    rec.counts.update(counts or {})
    monkeypatch.setattr(spans, "_rec", rec)
    return rec


def lambda_run(monkeypatch) -> Run:
    """One request: a solve whose Krylov loop holds one step (an apply and
    a sync in it), then the postprocess; four device operations."""
    recorded(monkeypatch, [
        ("ddh.solve", 0, 900, None),
        ("gmres.solve", 100, 800, 0),
        ("gmres.step", 100, 400, 1),
        ("ddh.action", 120, 300, 2),
        ("gmres.sync", 350, 390, 2),
        ("ddh.postprocess", 800, 880, 0),
    ], {"gmres.host_syncs": 10})
    ops = [("a", 0, 50 * MS), ("b", 150 * MS, 200 * MS), ("c", 300 * MS, 360 * MS),
           ("d", 820 * MS, 850 * MS)]
    reqs = [{"latency_s": 0.4, "n_rhs": 1, "ok": True, "matvecs": 4},
            {"latency_s": 0.5, "n_rhs": 1, "ok": True, "matvecs": 5}]
    return Run(setup_s=1.0, window_s=1.0, requests=reqs, trace=DeviceTrace(ops, 0, 1000 * MS))


def test_the_idle_split_adds_up_to_the_device_idle_share(monkeypatch):
    run = lambda_run(monkeypatch)
    # gaps 50-150 (middle 100: the step), 200-300 (the apply), 360-820 (the
    # solve's loop after the step), 850-1000 (no span)
    split = program_spans.idle_split(run)
    assert split == {"gmres.step": pytest.approx(0.1), "ddh.action": pytest.approx(0.1),
                     "gmres.solve": pytest.approx(0.46), program_spans.OUTSIDE: pytest.approx(0.15)}
    assert 100 * sum(split.values()) / run.trace.window_s == pytest.approx(
        stats.device_idle_pct(run))
    assert program_spans.idle_under_s(run, "gmres.solve") == pytest.approx(0.66)
    assert program_spans.idle_under_s(run, "ddh.solve") == pytest.approx(0.66)
    assert program_spans.self_ns(spans.last().spans)[1] == 400 * MS


def test_the_lambda_readers(monkeypatch):
    run = lambda_run(monkeypatch)
    assert read("host_syncs_per_matvec.lambda", run) == pytest.approx(10 / 9)
    assert read("step_ms.lambda", run) == pytest.approx(300.0)
    assert read("apply_idle_pct.lambda", run) == pytest.approx(10.0)
    assert read("krylov_idle_pct.lambda", run) == pytest.approx(56.0)


def test_the_composite_readers(monkeypatch):
    """An outer FGMRES step whose P holds an inner solve with one apply."""
    recorded(monkeypatch, [
        ("gmres.solve", 0, 1000, None),
        ("gmres.step", 0, 600, 0),
        ("ddh.precond", 0, 500, 1),
        ("ddh.rhs", 0, 50, 2),
        ("gmres.solve", 50, 450, 2),
        ("gmres.step", 50, 400, 4),
        ("ddh.action", 60, 250, 5),
        ("helmholtz.apply", 500, 550, 1),
        ("ddh.precond", 600, 900, 0),
    ], {"gmres.host_syncs": 90})
    ops = [("a", 0, 10 * MS), ("b", 100 * MS, 120 * MS), ("c", 300 * MS, 320 * MS),
           ("d", 520 * MS, 530 * MS)]
    reqs = [{"latency_s": 1.0, "n_rhs": 1, "ok": True, "precond": 2, "matvecs": 3}]
    run = Run(setup_s=1.0, window_s=1.0, requests=reqs, trace=DeviceTrace(ops, 0, 1000 * MS))
    # gaps: 10-100 (middle 55: the inner step), 120-300 (the apply), 320-520
    # (middle 420: the inner solve), 530-1000 (middle 765: the second P)
    assert read("host_syncs_per_precond.composite", run) == pytest.approx(45.0)
    assert read("precond_ms.composite", run) == pytest.approx(400.0)
    assert read("apply_idle_pct.composite", run) == pytest.approx(18.0)
    assert read("krylov_idle_pct.composite", run) == pytest.approx(29.0)
    assert program_spans.idle_split(run)["ddh.precond"] == pytest.approx(0.47)


def test_the_setup_readers(monkeypatch):
    """Two problems: each a constructor, a prepare with a probe (K1 on the
    device) and its io maps, and a solve."""
    items, ops = [], []
    for k in range(2):
        t = 1000 * k
        n = len(items)
        items += [("ddh.init", t, t + 100, None), ("ddh.prepare", t + 100, t + 700, None),
                  ("ddh.probe", t + 150, t + 400, n + 1), ("ddh.io_maps", t + 500, t + 600, n + 1),
                  ("ddh.solve", t + 700, t + 950, None)]
        ops += [("ctor", t * MS, (t + 100) * MS),
                ("void wave_cycle_sparse_kernel<4>(...)", (t + 200) * MS, (t + 450) * MS),
                ("gemm", (t + 720) * MS, (t + 900) * MS)]
    recorded(monkeypatch, items, {"k1.flop": 5 * 10**12})
    reqs = [{"latency_s": 1.0, "n_rhs": 1, "ok": True, "ctor_s": 0.1, "prepare_s": 0.6}] * 2
    run = Run(setup_s=1.0, window_s=2.0, requests=reqs, trace=DeviceTrace(ops, 0, 2000 * MS))
    # a problem's gaps under prepare: 100-200 (middle 150: the probe),
    # 450-720 (middle 585: the io maps)
    assert read("prepare_idle_ms.setup", run) == pytest.approx(370.0)
    assert read("k1_tflops.setup", run) == pytest.approx(5.0 / 0.5)


def test_no_recorder_or_no_trace_reads_nothing(monkeypatch):
    run = lambda_run(monkeypatch)
    untraced = Run(setup_s=1.0, window_s=1.0, requests=run.requests)
    for name in NEW:
        assert read(name, untraced) is None, name
    # a program without the recorder (the parent of the change that added it)
    monkeypatch.setitem(sys.modules, "cuddhelmholtz_tpu_torch.utils.spans", None)
    monkeypatch.delattr("cuddhelmholtz_tpu_torch.utils.spans", raising=False)
    for name in NEW:
        assert read(name, run) is None, name
    assert program_spans.idle_split(run) is None
