"""On the card, at each cell's own size: the program as the benchmark runs it
comes out correct, and its control (``control.py``: the plain reference in
TF32 in the program's place for the float32 DDH solve, the program's own
float32 path for the float64 coupled solve) does not.

    python3 -m pytest benchmark/tests/test_bench_control.py -m cuda
"""

from __future__ import annotations

import pytest
import torch

from benchmark import spec
from benchmark.control import reference_control
from benchmark.run import run_cell

CELLS = [w["name"] for w in spec.load_json(spec.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_the_control_fails_and_the_program_passes(name):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = spec.load_cell(name)
    assert run_cell(cell, 3_000_000_101, 2.0, False)["correct"] is True
    if cell.config["kind"] == "ddh":
        ctl = reference_control(cell, 3_000_000_102)
    else:
        ctl = run_cell(cell, 3_000_000_102, 2.0, False, control=True)
    assert ctl["correct"] is False
