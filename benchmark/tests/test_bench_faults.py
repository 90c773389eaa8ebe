"""A run with the timed path broken underneath must come out not correct.

Each test skips the harness's look for a card (``run_cell`` on the CPU, at a
cut size) and drives the rest of a run: set-up, the window, and the
comparison with the plain reference.  The faults are the ones these cells
can have: a solve that returns its state unchanged, half of a batch left
out with the mean of the rest in its place, and an answer altered where it
is produced.  (No cell spans chips, so none can leave out an exchange
between them.)
"""

from __future__ import annotations

import pytest
import torch

import cuddhelmholtz_tpu_torch.models.inverse as inverse
import cuddhelmholtz_tpu_torch.solvers.ddh as ddh_mod
from benchmark.run import run_cell
from benchmark.tests.conftest import small_cell

SEED = 2**31 + 23


def run(name: str) -> dict:
    return run_cell(small_cell(name), SEED, 0.5, False, device="cpu")


def unchanged(solve):
    """The Krylov solve's result with x left at its start, zero."""
    def wrapped(*args, **kw):
        out = solve(*args, **kw)
        return out._replace(x=torch.zeros_like(out.x))
    return wrapped


def altered(fn, factor=1.05):
    def wrapped(*args, **kw):
        return fn(*args, **kw) * factor
    return wrapped


@pytest.mark.parametrize("name", ["ddh_structured.rhs_stream", "ddh_structured.model_stream",
                                  "helmholtz_ddh_1e6.rhs_stream",
                                  "ddh_structured.source_batch"])
def test_a_sound_run_is_correct(name):
    res = run(name)
    assert res["correct"] is True, res["check"]


@pytest.mark.parametrize("name", ["ddh_structured.rhs_stream", "ddh_structured.source_batch",
                                  "helmholtz_ddh_1e6.rhs_stream"])
def test_a_solve_that_returns_its_state_unchanged(name, monkeypatch):
    monkeypatch.setattr(ddh_mod, "gmres", unchanged(ddh_mod.gmres))
    monkeypatch.setattr(ddh_mod, "block_gmres", unchanged(ddh_mod.block_gmres))
    monkeypatch.setattr(inverse, "fgmres", unchanged(inverse.fgmres))
    assert run(name)["correct"] is False


def test_half_of_the_batch_left_out(monkeypatch):
    real = ddh_mod.block_gmres

    def half(matvec, b, **kw):
        out = real(matvec, b[: b.shape[0] // 2], **kw)
        rest = out.x.mean(dim=0, keepdim=True).expand(b.shape[0] - out.x.shape[0], -1)
        return out._replace(x=torch.cat([out.x, rest]),
                            success=torch.ones(b.shape[0], dtype=torch.bool))

    monkeypatch.setattr(ddh_mod, "block_gmres", half)
    assert run("ddh_structured.source_batch")["correct"] is False


@pytest.mark.parametrize("name", ["ddh_structured.rhs_stream", "ddh_structured.model_stream",
                                  "ddh_structured.source_batch"])
def test_an_answer_altered_where_it_is_produced(name, monkeypatch):
    monkeypatch.setattr(ddh_mod.DDH, "postprocess", altered(ddh_mod.DDH.postprocess))
    assert run(name)["correct"] is False


def test_a_composite_answer_altered_where_it_is_produced(monkeypatch):
    real = inverse.fgmres

    def wrapped(*args, **kw):
        out = real(*args, **kw)
        return out._replace(x=out.x * 1.05)

    monkeypatch.setattr(inverse, "fgmres", wrapped)
    assert run("helmholtz_ddh_1e6.rhs_stream")["correct"] is False
