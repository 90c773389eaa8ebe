"""CPU tests of the canonical discretisation and the DDH reference that a
configuration names (``"grid"``, ``"reference"``), and of the partition that
a system may hand ``build_ddh``.

The structured cells draw the same requests and build the same reference
through the cell as on ``Grid(nx, deg)`` directly.  The quad-mesh grid
(``grids/quad_mesh.py``) gives the structured grid's nodes and mass on a
uniform mesh file; on ``meshes/unstructured_square``, refined, its mass sums
to the square's area, a source of width 1/omega integrates to its amplitude,
and its nodes are the program's, one to one.  It loads nothing of the
program or of JAX."""

from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys

import numpy as np
import pytest
import torch

from benchmark import spec
from benchmark.reference.grid import Grid, gaussians
from benchmark.tests.conftest import small_cell
from benchmark.traffic import make_pool

SQUARE = {"mesh": "meshes/unstructured_square", "deg": 3}
# each configuration and each traffic mix at least once
CELLS = ("ddh_structured.model_stream", "ddh_structured.source_batch",
         "helmholtz_ddh_1e6.rhs_stream", "ddh_structured_matrix_free.rhs_stream")


def quad_mesh(**config):
    return spec.load_module(spec.HERE, "grids", "quad_mesh").grid(dict(SQUARE, **config))


@pytest.mark.parametrize("name", CELLS)
def test_a_structured_cell_draws_the_requests_of_its_grid(name):
    cell = spec.load_cell(name)
    c = cell.config
    assert "grid" not in c and cell.grid() == Grid(c["nx"], c["deg"])
    assert cell.grid() is cell.grid()
    seed = 2**31 + 97
    pool = make_pool(cell, seed, cell.grid(), "cpu")
    want = make_pool(cell, seed, Grid(c["nx"], c["deg"]), "cpu")
    assert len(pool) == len(want) == cell.traffic["pool"]
    for got, ref in zip(pool, want):
        assert (got.index, got.n_rhs) == (ref.index, ref.n_rhs)
        assert torch.equal(got.b, ref.b)
        if ref.a is None:
            assert got.a is None and got.model is None and ref.model is None
        else:
            assert torch.equal(got.a, ref.a) and got.model.keys() == ref.model.keys()
            assert all(np.array_equal(got.model[k], ref.model[k]) for k in ref.model)


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_the_cell_builds_the_reference_ddh_of_its_configuration(monkeypatch, dtype):
    cell = small_cell("ddh_structured.rhs_stream")
    c, grid = cell.config, cell.grid()
    a = cell.speed(torch.as_tensor(grid.coords())).numpy()
    mod = spec.load_module(spec.HERE, "reference", "ddh")
    monkeypatch.setattr(mod, "ReferenceDDH", lambda *args: args)
    assert cell.reference(grid, a, "cpu", dtype) == (
        grid, c["omega"], a, c["block_size"], c["wh_maxit"], "cpu", dtype)


def write_mesh(path, vertices, elements):
    path.mkdir()
    np.savetxt(path / "coordinates.txt", vertices, fmt="%.17e")
    np.savetxt(path / "elements.txt", elements, fmt="%d")
    (path / "info.txt").write_text(f"{len(vertices)} {len(elements)}\n")


def test_a_uniform_mesh_file_is_the_structured_grid(tmp_path):
    n = 4
    x = np.linspace(-1.0, 1.0, n + 1)
    X, Y = np.meshgrid(x, x, indexing="xy")
    i, j = np.meshgrid(np.arange(n), np.arange(n), indexing="xy")
    v0 = (j * (n + 1) + i).reshape(-1)
    write_mesh(tmp_path / "uniform", np.stack([X.reshape(-1), Y.reshape(-1)], axis=1),
               np.stack([v0, v0 + 1, v0 + n + 2, v0 + n + 1], axis=1))
    g = quad_mesh(mesh=str(tmp_path / "uniform"), levels=0)
    ref = Grid(n, 3)
    perm = g.match(ref.coords())
    assert g.ndof == ref.ndof and sorted(perm) == list(range(ref.ndof))
    assert np.abs(g.coords()[perm] - ref.coords()).max() <= 1e-12
    assert np.abs(g.lumped_mass()[perm] - ref.lumped_mass()).max() <= 1e-12
    # the file's elements run x fastest, as the grid's do, each [eta, xi]
    assert np.array_equal(g.element_nodes(), perm[ref.element_nodes()])
    # one level of refinement is the structured grid of twice the elements
    g2 = quad_mesh(mesh=str(tmp_path / "uniform"), levels=1)
    perm2 = g2.match(Grid(2 * n, 3).coords())
    assert np.abs(g2.lumped_mass()[perm2] - Grid(2 * n, 3).lumped_mass()).max() <= 1e-12


def test_match_refuses_a_point_off_the_nodes_and_a_node_twice():
    g = quad_mesh(levels=0)
    xy = g.coords()
    with pytest.raises(ValueError, match="does not lie"):
        g.match(xy[:3] + np.array([0.0, 2e-9]))
    with pytest.raises(ValueError, match="two program nodes"):
        g.match(np.concatenate([xy[:3], xy[1:2] + 1e-12]))


@pytest.mark.parametrize("levels", [0, 1, 2, 3])
def test_the_refined_square_holds_the_programs_nodes_one_to_one(levels):
    from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
    from cuddhelmholtz_tpu_torch.mesh.refine import refine_quad_mesh
    from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    g = quad_mesh(levels=levels)
    assert abs(g.lumped_mass().sum() - 4.0) <= 1e-12 and (g.lumped_mass() > 0).all()
    mesh = refine_quad_mesh(load_unstructured_square(), levels)
    # the same elements in the same order
    assert np.array_equal(g.corners, mesh.vertices[mesh.elem_vertices])
    fem = H1Space(mesh, Basis(4))
    gid = g.match(np.asarray(fem.coords))
    assert fem.ndof == g.ndof == len(np.unique(gid))
    # the canonical numbering runs over the nodes in (y, x) order
    xy = g.coords()
    assert (np.diff(xy[:, 1]) >= -1e-9).all()


def median_h(corners: np.ndarray) -> float:
    """The square root of the median element area."""
    x, y = corners[..., 0], corners[..., 1]
    area = 0.5 * np.abs((x * np.roll(y, -1, axis=1) - np.roll(x, -1, axis=1) * y).sum(axis=1))
    return float(np.sqrt(np.median(area)))


@pytest.mark.parametrize("levels", [2, 3])
def test_a_source_integrates_to_its_amplitude_under_the_lumped_mass(levels):
    g = quad_mesh(levels=levels)
    omega = 2 * math.pi / (5 * median_h(g.corners))
    xy = torch.as_tensor(g.coords())
    m = torch.as_tensor(g.lumped_mass())
    for c, amp in (([0.13, -0.21], 1.3), ([-0.52, 0.47], -0.8)):
        f = gaussians(xy, torch.tensor([c], dtype=torch.float64),
                      torch.tensor([amp], dtype=torch.float64), omega)
        assert float((m * f).sum()) == pytest.approx(amp, rel=0.01)


@pytest.mark.parametrize("key, name", [("grid", "hexagonal"), ("reference", "nowhere")])
def test_a_configuration_names_its_grid_and_reference(tmp_path, key, name):
    base = tmp_path / "benchmark"
    shutil.copytree(spec.HERE, base, ignore=shutil.ignore_patterns("__pycache__"))
    cell = spec.load_cell("ddh_structured.rhs_stream", base=base)
    assert key not in cell.config and spec.DEFAULT == {"grid": "structured", "reference": "ddh"}
    assert cell.grid() == Grid(cell.config["nx"], cell.config["deg"])
    cfg = spec.load_json(base / "configs" / "ddh_structured.json")
    (base / "configs" / "ddh_structured.json").write_text(json.dumps({**cfg, key: name}))
    with pytest.raises(ValueError, match=name):
        spec.load_cell("ddh_structured.rhs_stream", base=base)


def test_the_quad_mesh_grid_loads_nothing_of_the_program_or_jax():
    code = ("import sys\n"
            "from benchmark import spec\n"
            "for name in ('quad_mesh', 'structured'):\n"
            "    spec.load_module(spec.HERE, 'grids', name)\n"
            "g = spec.load_module(spec.HERE, 'grids', 'quad_mesh').grid(\n"
            "    {'mesh': 'meshes/unstructured_square', 'levels': 1, 'deg': 3})\n"
            "g.match(g.coords())\n"
            "bad = spec.FORBIDDEN | {'cuddhelmholtz_tpu_torch'}\n"
            "print(sorted(n for n in sys.modules if n.split('.', 1)[0] in bad))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "[]"


def test_build_ddh_takes_the_systems_partition():
    """The structured blocks handed over as a partition build the DDH that
    the configuration's ``nx`` and ``block_size`` build."""
    from benchmark.system import Spans, build_ddh
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.spaces.ensemble import structured_labels
    from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    cell = small_cell("ddh_structured_matrix_free.rhs_stream")
    c = cell.config
    fem = H1Space(Mesh2D.uniform_rect(c["nx"], -1.0, 1.0, c["nx"], -1.0, 1.0), Basis(4))
    a = cell.speed(torch.as_tensor(fem.coords)).numpy()
    epd = c["block_size"] // (c["deg"] + 1)
    blocks = structured_labels(c["nx"], c["nx"], epd, epd)
    ddh, counts = build_ddh(c, a, fem, "cpu", Spans())
    part, _ = build_ddh(c, a, fem, "cpu", Spans(), partition=blocks)
    assert part.n_domains == ddh.n_domains == blocks[1] and set(counts) == {"ctor_s"}
    lam = torch.randn(ddh.size, generator=torch.Generator().manual_seed(5))
    assert torch.equal(part.action(lam.to(ddh.gmask.dtype)), ddh.action(lam.to(ddh.gmask.dtype)))
