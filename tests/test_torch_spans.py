"""The port's span recorder and counters (``utils/spans.py``) on the CPU: off
by default, nested spans with parent and root, the host syncs the Krylov
loops count, the K1 work counters, and the one clock that the program's
spans, the benchmark's spans and the profiler's events share."""

from __future__ import annotations

import time
from collections import Counter

import numpy as np
import pytest
import torch

from benchmark.program_spans import innermost, self_ns
from benchmark.system import Spans
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
from cuddhelmholtz_tpu_torch.solvers import gmres as gmres_mod
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, DDHPreconditioner
from cuddhelmholtz_tpu_torch.solvers.gmres import block_gmres, fgmres, gmres
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils import spans
from cuddhelmholtz_tpu_torch.utils.basis import Basis

NX, DEG, BLOCK = 8, 3, 8
OMEGA = 2 * np.pi * NX / 2.5  # nt = 200


@pytest.fixture(autouse=True, scope="module")
def _no_setup_cache():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("CUDDH_CACHE_DIR", "")
        yield


def _system(n: int = 20, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    A = 3.0 * torch.eye(n, dtype=torch.float64) + 0.3 * torch.randn(
        n, n, dtype=torch.float64, generator=g)
    return A, torch.randn(n, dtype=torch.float64, generator=g)


def _ddh(wh_maxit: int = 1) -> DDH:
    fem = H1Space(Mesh2D.uniform_rect(NX, -1, 1, NX, -1, 1), Basis(DEG + 1))
    return DDH(OMEGA, np.ones(fem.ndof), fem, nx=NX, ny=NX, block_size=BLOCK,
               wh_maxit=wh_maxit, device="cpu")


def test_off_records_nothing_and_returns_the_shared_no_op():
    A, b = _system()
    before = spans.last()
    n_before = len(before.spans) if before is not None else 0
    syncs = spans.total("gmres.host_syncs")
    assert spans.span("gmres.step") is spans._NOOP
    with spans.span("anything") as s:
        assert s is spans._NOOP
    gmres(lambda v: A @ v, b, m=5, maxit=3, tol=0.0)
    assert spans.last() is before
    assert (len(before.spans) if before is not None else 0) == n_before
    # the totals are always kept
    assert spans.total("gmres.host_syncs") - syncs == 14


def test_nesting_gives_parent_root_and_self_time():
    with spans.recording() as rec:
        with spans.span("a"):
            with spans.span("b"):
                time.sleep(0.002)
            with spans.span("c"):
                with spans.span("d"):
                    time.sleep(0.002)
            time.sleep(0.002)
        with spans.span("e"):
            spans.count("n", 3)
    assert [s[0] for s in rec.spans] == ["a", "b", "c", "d", "e"]
    assert [(s[3], s[4]) for s in rec.spans] == [(None, 0), (0, 0), (0, 0), (2, 0), (None, 4)]
    assert rec.counts == {"n": 3} and rec.dropped == 0
    dur = [e - s for _, s, e, _, _ in rec.spans]
    own = self_ns(rec.spans)
    assert own == [dur[0] - dur[1] - dur[2], dur[1], dur[2] - dur[3], dur[3], dur[4]]
    assert own[0] >= 2_000_000 and all(x >= 0 for x in own)
    # the innermost span around points inside b, d, a alone and after e
    a, b_, c, d, e = rec.spans
    pts = [b_[1] + 1, d[1] + 1, c[2] + 1, e[2] + 10**9]
    assert innermost(rec.spans, pts) == [1, 3, 0, None]


def test_a_new_recording_clears_the_last_and_the_cap_drops(monkeypatch):
    with spans.recording() as first:
        with spans.span("x"):
            pass
    monkeypatch.setattr(spans, "CAP", 3)
    with spans.recording() as rec:
        for _ in range(5):
            with spans.span("y"):
                pass
    assert spans.last() is rec and rec is not first
    assert len(rec.spans) == 3 and rec.dropped == 2


def test_gmres_counts_two_m_plus_maxit_plus_one_host_syncs():
    """tol 0, m = 5, maxit = 3: 2 restarts of 5 steps (one exit test a
    step), 3 restart-loop tests and the final success read."""
    A, b = _system()
    with spans.recording() as rec:
        out = gmres(lambda v: A @ v, b, m=5, maxit=3, tol=0.0)
    assert out.num_iter == 2 and out.num_matvec == 13
    assert rec.counts["gmres.host_syncs"] == 2 * 5 + 3 + 1
    names = Counter(s[0] for s in rec.spans)
    assert names == {"gmres.solve": 1, "gmres.step": 10, "gmres.sync": 14}
    # every step and sync lies under the one solve
    assert {s[4] for s in rec.spans} == {0}


def test_fgmres_counts_its_steps_and_each_inner_solve():
    A, b = _system()

    def P(v):
        return gmres(lambda u: A @ u, v, m=3, maxit=2, tol=0.0).x

    with spans.recording() as rec:
        out = fgmres(lambda v: A @ v, b, P, m=4, maxit=2, tol=0.0)
    inner = 3 + 2 + 1  # one restart of 3 steps, 2 loop tests, the final read
    assert out.num_iter == 1
    assert rec.counts["gmres.host_syncs"] == 4 + 2 + 1 + 4 * inner
    assert Counter(s[0] for s in rec.spans)["gmres.solve"] == 5


def test_ddh_preconditioner_counts_44_host_syncs_per_application():
    """P's inner GMRES(20) runs 3 restart-loop tests and 2 restarts of 20
    steps (tol 0), then reads its success: 44 host reads, whatever the
    path of the apply."""
    ddh = _ddh()
    P = DDHPreconditioner(ddh, inner_m=20, inner_maxit=3)
    assert ddh.size > 20
    v = torch.randn(2 * ddh.g_ndof, dtype=torch.float64,
                    generator=torch.Generator().manual_seed(1))
    with spans.recording() as rec:
        P(v)
        P(v)
    assert P.calls == 2 and rec.counts["gmres.host_syncs"] == 2 * 44
    names = Counter(s[0] for s in rec.spans)
    assert names["ddh.precond"] == 2 and names["gmres.step"] == 80
    assert names["ddh.action"] == 2 * (1 + 40 + 2)
    assert names["ddh.rhs"] == names["ddh.postprocess"] == 2
    roots = {s[4] for s in rec.spans}
    assert [rec.spans[r][0] for r in sorted(roots)] == ["ddh.precond", "ddh.precond"]


def test_block_gmres_counts_one_sync_per_block_qr_and_restart_test(monkeypatch):
    A, _ = _system()
    B = torch.randn(3, A.shape[0], dtype=torch.float64, generator=torch.Generator().manual_seed(2))
    qr = Counter()
    block_qr = gmres_mod._block_qr

    def counted(Z, eps):
        qr["n"] += 1
        return block_qr(Z, eps)

    monkeypatch.setattr(gmres_mod, "_block_qr", counted)
    with spans.recording() as rec:
        out = block_gmres(lambda V: V @ A.T, B, m=4, maxit=3, tol=0.0)
    assert out.num_iter == 2 and qr["n"] == 2 * (1 + 4)
    assert rec.counts["gmres.host_syncs"] == qr["n"] + out.num_iter + 1
    assert Counter(s[0] for s in rec.spans)["gmres.step"] == 2 * 4


def _stack(S: torch.Tensor, n: int) -> torch.Tensor:
    """n copies of S, copy g with its first g columns zeroed: distinct nnz."""
    out = S.repeat(n, 1, 1)
    for g in range(n):
        out[g, :, :g] = 0.0
    return out


@pytest.mark.parametrize("layout", ["shared", "grouped", "per_row"])
def test_k1_work_counters_on_the_plain_cycle(layout):
    """k1.rows and k1.flop = 2 * 2 * wh_maxit * nt * sum over the rows of
    nnz(S of the row's group), on the CPU path, with no launch counted."""
    ddh = _ddh(wh_maxit=2)
    p = ddh.params
    ndom, pad = p.Ha.shape
    nt = p.tables.shape[0]
    s_group_size = None
    if layout == "grouped":
        groups, s_group_size = 2, ndom // 2
        p = p._replace(S=_stack(p.S, groups))
        per_row = [int((p.S[d // s_group_size] != 0).sum()) for d in range(ndom)]
    elif layout == "per_row":
        p = p._replace(S=_stack(p.S, ndom))
        per_row = [int((p.S[d] != 0).sum()) for d in range(ndom)]
    else:
        per_row = [int((p.S != 0).sum())] * ndom
    g = torch.Generator().manual_seed(3)
    F = torch.randn(ndom, pad, generator=g)
    G = torch.randn(ndom, pad, generator=g)
    launched = wc.launch_counts()
    with spans.recording() as rec:
        wc.wave_cycle(p, F, G, 2, s_group_size)
        wc.wave_cycle(p, F, G, 2, s_group_size)
    assert rec.counts["k1.rows"] == 2 * ndom
    assert rec.counts["k1.flop"] == 2 * (2 * 2 * 2 * nt * sum(per_row))
    assert wc.launch_counts() == launched and set(launched) == set(wc.ROUTE_KEYS)


def test_program_and_benchmark_spans_interleave_on_one_clock():
    bench = Spans()
    A, b = _system()
    with spans.recording() as rec:
        t0 = bench.now()
        with spans.span("first"):
            pass
        t1 = bench.add("between", t0)
        gmres(lambda v: A @ v, b, m=3, maxit=2, tol=0.0)
        bench.add("after", t1)
    first, solve = rec.spans[0], rec.spans[1]
    (_, b0, b1), (_, a0, a1) = bench.items
    assert b0 <= first[1] <= first[2] <= b1 <= a0 <= solve[1] <= solve[2] <= a1
    assert solve[0] == "gmres.solve"


def test_a_profiler_window_records_and_its_events_share_the_clock():
    """Under ``torch.profiler`` the spans record with no ``recording()``
    block; the profiler's own event of a matmul lies inside a span around
    it; after the window the recording stays and no new one starts."""
    A, b = _system(n=256)
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    prof.start()
    try:
        with spans.span("mm"):
            A @ A
        gmres(lambda v: A @ v, b, m=3, maxit=2, tol=0.0)
    finally:
        prof.stop()
    rec = spans.last()
    assert spans.span("after") is spans._NOOP and spans.last() is rec
    assert [s[0] for s in rec.spans[:2]] == ["mm", "gmres.solve"]
    assert rec.counts["gmres.host_syncs"] == 3 + 2 + 1
    _, s0, s1, _, _ = rec.spans[0]
    mm = [e for e in prof.profiler.kineto_results.events() if e.name() == "aten::mm"]
    assert mm and any(s0 <= e.start_ns() and e.start_ns() + e.duration_ns() <= s1 for e in mm)
