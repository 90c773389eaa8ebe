"""CPU tests of the benchmark harness: files found by name, the metric
arithmetic on synthetic logs and traces, the contract of ``BENCHMARK.json``,
the last line's schema and the import rule."""

from __future__ import annotations

import ast
import json
import math
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from benchmark import spec, stats
from benchmark.run import Run, run_cell
from benchmark.trace import DeviceTrace

BENCH = spec.HERE
ROOT = spec.ROOT
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def bench_json() -> dict:
    return spec.load_json(ROOT / "BENCHMARK.json")


def test_every_file_is_found_by_name():
    b = bench_json()
    for w in b["workloads"]:
        cell = spec.load_cell(w["name"])
        assert cell.config["name"] == w["config"]
        assert cell.traffic["request"] in ("rhs", "batch", "model")
        assert callable(cell.system()) and cell.check
        assert cell.sample == "all" or cell.sample >= 1
        for name, limit in cell.check.items():
            assert callable(cell.number(name)) and limit > 0
        xy = torch.zeros(3, 2, dtype=torch.float64)
        assert cell.speed(xy).shape == (3,)
        for m in cell.end_to_end + cell.per_layer:
            assert callable(spec.metric_reader(m["name"]))
    assert {p.stem for p in (BENCH / "cells").glob("*.json")} == {
        w["name"] for w in b["workloads"]}
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
        assert spec.load_json(ROOT / c["file"])["name"] == c["name"]


def test_benchmark_json_keeps_the_contract():
    b = bench_json()
    assert set(b) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end",
                      "per_layer"}
    assert b["paths"] == ["benchmark"] and 1 <= b["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer") for x in b[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in b["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    e2e = {m["name"]: m for m in b["end_to_end"]}
    assert e2e["setup_s"]["bound"] <= 0.25
    for m in b["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in e2e
        assert all(w in e2e[m["moves"]].get("workloads", [w]) for w in m["workloads"])
    for w in b["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] == 1
        assert len(w["why"]) <= 200
        cell = spec.load_cell(w["name"])
        assert "setup_s" in [m["name"] for m in cell.end_to_end] and len(cell.end_to_end) >= 2
        assert cell.per_layer
    runs = 2 + 14 * 24
    assert runs * (b["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200


def test_a_new_metric_traffic_and_config_are_files_and_entries(tmp_path):
    """A later cell, configuration, speed model and per-layer metric: new
    files in a copy of the benchmark and new entries, no edit to a file that
    is there.  The configuration takes the DDH's direct path
    (``"transfer": false``) on a new wave-speed model, and its cell runs."""
    base = tmp_path / "benchmark"
    shutil.copytree(BENCH, base, ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: p.read_bytes() for p in base.rglob("*") if p.is_file()}
    (base / "metrics" / "throwaway_ms.lambda.py").write_text(
        "def read(run):\n    return 1e3 * run.window_s / len(run.requests)\n")
    (base / "speeds" / "layered.py").write_text(
        "import torch\n\n\ndef speed(xy):\n"
        "    return torch.where(xy[..., 1] < 0.0, xy.new_tensor(0.7), xy.new_tensor(1.0))\n")
    cfg = spec.load_json(base / "configs" / "ddh_structured.json")
    cfg.update(name="ddh_matrix_free_layered", transfer=False, speed="layered", nx=8,
               omega=2 * math.pi * 0.8)
    (base / "configs" / "ddh_matrix_free_layered.json").write_text(json.dumps(cfg))
    traffic = spec.load_json(base / "traffic" / "rhs_stream.json")
    traffic.update(sources=[4, 4], pool=2)
    (base / "traffic" / "rhs_four.json").write_text(json.dumps(traffic))
    name = "ddh_matrix_free_layered.rhs_four"
    (base / "cells" / f"{name}.json").write_text(json.dumps({"check": {"u_err": 5e-3},
                                                             "sample": 1}))
    b = bench_json()
    b["workloads"].append({"name": name, "config": "ddh_matrix_free_layered",
                           "traffic": "rhs_four", "chips": 1, "why": "x"})
    for m in b["end_to_end"]:
        if "ddh_structured.rhs_stream" in m.get("workloads", []):
            m["workloads"].append(name)
    b["per_layer"].append({"name": "throwaway_ms.lambda", "unit": "ms", "better": "lower",
                           "source": "host_clock", "layer": "DDH apply and P (solvers/ddh.py)",
                           "moves": "rhs_per_s", "workloads": [name]})
    cell = spec.load_cell(name, bench=b, base=base)
    assert cell.config["transfer"] is False and cell.traffic["sources"] == [4, 4]
    assert [m["name"] for m in cell.per_layer] == ["throwaway_ms.lambda"]
    run = Run(setup_s=1.0, window_s=2.0, requests=[{"latency_s": 1.0}] * 4)
    assert cell.reader("throwaway_ms.lambda")(run) == 500.0
    res = run_cell(cell, 2**31 + 29, 0.2, False, device="cpu")
    assert res["correct"] is True, res["check"]
    assert set(res["metrics"]) == {"setup_s", "rhs_per_s", "solve_ms_p90"}
    assert all(p.read_bytes() == data for p, data in before.items())


def test_percentile_matches_the_inclusive_quantiles():
    xs = [0.31, 0.52, 0.28, 0.47, 0.33, 0.9, 0.41, 0.36, 0.29, 0.6, 0.44]
    assert stats.percentile(xs, 90) == pytest.approx(
        statistics.quantiles(xs, n=10, method="inclusive")[8])
    assert stats.percentile([2.0], 90) == 2.0
    assert stats.percentile([1.0, 2.0], 50) == 1.5


def test_interval_union_gaps_and_idle_share():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.union_length(iv) == 3.0
    assert stats.merged(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.gaps(iv, -1.0, 5.0) == [(-1.0, 0.0), (2.0, 3.0), (4.0, 5.0)]
    assert stats.idle_pct(2.5, 10.0) == 75.0


def synthetic_run(trace=None) -> Run:
    reqs = [
        {"latency_s": 0.4, "n_rhs": 1, "ok": True, "matvecs": 380, "precond": 200,
         "ctor_s": 0.8, "prepare_s": 2.0},
        {"latency_s": 0.5, "n_rhs": 1, "ok": True, "matvecs": 400, "precond": 220,
         "ctor_s": 1.0, "prepare_s": 3.0},
        {"latency_s": 0.6, "n_rhs": 1, "ok": False, "matvecs": 420, "precond": 180,
         "ctor_s": 1.2, "prepare_s": 4.0},
    ]
    return Run(setup_s=9.5, window_s=1.5, requests=reqs, trace=trace)


def read(name, run):
    return spec.metric_reader(name)(run)


def test_end_to_end_readers_on_a_synthetic_log():
    run = synthetic_run()
    assert read("setup_s", run) == 9.5
    assert read("rhs_per_s", run) == pytest.approx(2 / 1.5)
    assert read("solve_ms_p90", run) == pytest.approx(580.0)
    assert read("composite_s_per_rhs", run) == pytest.approx(0.75)
    assert read("problems_per_s", run) == pytest.approx(2 / 1.5)


def test_per_layer_readers_on_a_synthetic_log_and_trace():
    ms = 1_000_000
    ops = [("void wave_cycle_sparse_kernel<4>(...)", 0, 250 * ms),
           ("ampere_sgemm", 200 * ms, 400 * ms),
           ("wave_cycle_mma_kernel", 600 * ms, 900 * ms),
           ("elementwise", 1400 * ms, 1600 * ms)]
    tr = DeviceTrace(ops, 0, 1500 * ms)
    run = synthetic_run(tr)
    assert read("matvecs_per_request.lambda", run) == pytest.approx(400.0)
    assert read("precond_per_rhs.composite", run) == pytest.approx(200.0)
    assert read("ms_per_matvec.lambda", run) == pytest.approx(1e3 * 1.5 / 1200)
    assert read("ms_per_precond.composite", run) == pytest.approx(1e3 * 1.5 / 600)
    assert read("ctor_ms.setup", run) == pytest.approx(1000.0)
    assert read("prepare_ms.setup", run) == pytest.approx(3000.0)
    assert read("k1_device_ms.setup", run) == pytest.approx(550.0 / 3)
    assert tr.busy_s == pytest.approx(0.8)
    for n in ("lambda", "composite", "setup"):
        assert read(f"device_idle_pct.{n}", run) == pytest.approx(100 * (1 - 0.8 / 1.5))
    assert tr.top_ops(2)[0] == ["wave_cycle_mma_kernel", 0.3]
    spans = [("request", 0, 1500 * ms), ("prepare", 350 * ms, 650 * ms)]
    assert tr.idle_gaps(spans) == [["request", pytest.approx(0.5)],
                                   ["prepare", pytest.approx(0.2)]]
    untraced = synthetic_run()
    for n in ("k1_device_ms.setup", "device_idle_pct.lambda"):
        assert read(n, untraced) is None


def imports_of(path: Path) -> set[str]:
    tree = ast.parse(path.read_text())
    out = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            out |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            out.add(node.module)
    return out


def test_nothing_in_the_benchmark_imports_jax_or_the_jax_package():
    assert spec.forbidden_modules(["cuddhelmholtz_tpu_torch", "cuddhelmholtz_tpu_torch.x",
                                   "jaxtyping", "numpy"]) == []
    assert spec.forbidden_modules(["cuddhelmholtz_tpu.solvers", "jax.numpy", "jaxlib",
                                   "flax.linen"]) == ["cuddhelmholtz_tpu.solvers", "flax.linen",
                                                      "jax.numpy", "jaxlib"]
    for path in BENCH.rglob("*.py"):
        if "tests" in path.parts:
            continue
        bad = spec.forbidden_modules(imports_of(path))
        assert not bad, f"{path} imports {bad}"
    # the modules a run loads, in a fresh interpreter
    code = ("import sys, benchmark.run, benchmark.check, benchmark.system, benchmark.control\n"
            "from benchmark import spec\n"
            "for p in spec.HERE.glob('cells/*.json'):\n"
            "    c = spec.load_cell(p.stem)\n"
            "    c.system(), [c.number(n) for n in c.check], c.speed\n"
            "print(spec.forbidden_modules())")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_the_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").rglob("*.py"):
        mods = imports_of(path)
        assert not any(m.split(".")[0].startswith("cuddhelmholtz") for m in mods), path


def test_without_a_card_the_run_prints_nothing_and_fails():
    out = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload",
                          "ddh_structured.rhs_stream", "--seed", "3", "--seconds", "1"],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={"CUDA_VISIBLE_DEVICES": "", "PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and out.stdout == ""


def test_the_last_line_schema(small_cell_result):
    res, cell = small_cell_result
    assert list(res)[-1] == "check"
    assert set(res) == {"correct", "attempted", "failed", "metrics", "device", "check"}
    assert res["correct"] is True and res["failed"] == 0 and res["attempted"] >= 1
    assert set(res["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    assert set(res["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in res["metrics"].values():
        assert set(m) == {"value", "unit"} and m["value"] > 0 and math.isfinite(m["value"])
    for c in res["check"].values():
        assert set(c) == {"value", "limit"} and c["value"] <= c["limit"]
    json.dumps(res)
