"""CPU tests of the readers of the graphed share of the Krylov step
(``graphed_step_pct.lambda``, ``.composite`` and ``.direct``) on a synthetic
``Run``: the share of the program counters, and nothing read from a program
that counts neither (one without the graphed step), from an untraced run or
from a program without the recorder."""

from __future__ import annotations

import sys

import pytest

from benchmark import spec
from benchmark.run import Run
from benchmark.trace import DeviceTrace
from cuddhelmholtz_tpu_torch.utils import spans

MS = 1_000_000
NAMES = ("graphed_step_pct.lambda", "graphed_step_pct.composite", "graphed_step_pct.direct")


def traced_run(monkeypatch, counts) -> Run:
    """One request whose solve holds one Krylov step, with the program's
    ``counts`` in its recording."""
    rec = spans.Recording()
    rec.spans += [("gmres.solve", 0, 900 * MS, None, 0), ("gmres.step", 100 * MS, 300 * MS, 0, 0)]
    rec.counts.update(counts)
    monkeypatch.setattr(spans, "_rec", rec)
    reqs = [{"latency_s": 0.9, "n_rhs": 1, "ok": True, "matvecs": 4, "precond": 1}]
    return Run(setup_s=1.0, window_s=1.0, requests=reqs,
               trace=DeviceTrace([("a", 0, 50 * MS)], 0, 1000 * MS))


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("graphed, eager, want", [(366, 0, 100.0), (300, 100, 75.0),
                                                  (0, 320, 0.0)])
def test_the_share_of_graphed_steps(monkeypatch, name, graphed, eager, want):
    counts = {k: v for k, v in (("gmres.step.graphed", graphed), ("gmres.step.eager", eager))
              if v}
    run = traced_run(monkeypatch, {"gmres.host_syncs": 5, "gmres.step.captures": 20, **counts})
    assert spec.metric_reader(name)(run) == pytest.approx(want)


@pytest.mark.parametrize("name", NAMES)
def test_nothing_to_read_gives_none(monkeypatch, name):
    read = spec.metric_reader(name)
    # a program that counts neither: the parent of the graphed step
    run = traced_run(monkeypatch, {"gmres.host_syncs": 5, "ddh.action.graphed": 4})
    assert read(run) is None
    assert read(Run(setup_s=1.0, window_s=1.0, requests=run.requests)) is None
    monkeypatch.setitem(sys.modules, "cuddhelmholtz_tpu_torch.utils.spans", None)
    monkeypatch.delattr("cuddhelmholtz_tpu_torch.utils.spans", raising=False)
    assert read(run) is None
