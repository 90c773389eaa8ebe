"""Registers the ``cuda`` marker of the tests that need the card (the same
marker as the repository's own tests); they decide inside the test."""


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips inside the test without one")


import math  # noqa: E402

import pytest  # noqa: E402


def small_cell(name: str, nx: int = 8):
    """The cell ``name`` cut to ``nx`` x ``nx`` quads (at omega = 2 pi nx / 10,
    as the configuration scales it), a pool of two requests and one compared
    request: a run that the CPU finishes in seconds."""
    from benchmark import spec

    cell = spec.load_cell(name)
    cell.config.update(nx=nx, omega=2 * math.pi * nx / 10)
    cell.traffic.update(pool=2)
    if cell.sample != "all":
        cell.sample = 1
    return cell


@pytest.fixture(autouse=True)
def _no_setup_cache(monkeypatch):
    """No run of these tests reads or writes the program's set-up cache."""
    monkeypatch.setenv("CUDDH_CACHE_DIR", "")


@pytest.fixture(scope="session")
def small_cell_result():
    from benchmark.run import run_cell

    cell = small_cell("ddh_structured.rhs_stream")
    return run_cell(cell, 2**31 + 11, 0.5, False, device="cpu"), cell
