"""The port's native topology builds (``cuddhelmholtz_tpu_torch/native``).

The C++ edge build and CG numbering, the port's NumPy paths
(``CUDDH_NATIVE=0``) and the JAX package must give the same tables exactly,
on the structured grid, the 119-element unstructured square, its twice
refined mesh and a jittered grid.  The library builds on first use into a
build directory; concurrent first uses must all get a working library, and a
compiler that fails must raise.
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from cuddhelmholtz_tpu.mesh.io import load_unstructured_square as jload_square
from cuddhelmholtz_tpu.mesh.mesh2d import Mesh2D as JMesh2D
from cuddhelmholtz_tpu.mesh.refine import jittered_grid as jjittered_grid
from cuddhelmholtz_tpu.mesh.refine import refine_quad_mesh as jrefine
from cuddhelmholtz_tpu.spaces.h1 import H1Space as JH1Space
from cuddhelmholtz_tpu.utils.basis import Basis as JBasis
from cuddhelmholtz_tpu_torch import native
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MESHES = {
    "structured": lambda: JMesh2D.uniform_rect(7, -1, 1, 5, 0, 2),
    "unstructured": jload_square,
    "unstructured_L2": lambda: jrefine(jload_square(), 2),
    "jittered": lambda: jjittered_grid(9, 7, amount=0.25, seed=3),
}
EDGE_TABLES = ("edge_vertices", "edge_elements", "edge_sides", "edge_delta", "edge_type",
               "boundary_edges", "interior_edges")


def _port_mesh_and_space(jmesh, nb, monkeypatch, native_on: bool):
    monkeypatch.setenv("CUDDH_NATIVE", "1" if native_on else "0")
    mesh = Mesh2D(jmesh.vertices, jmesh.elem_vertices)
    return mesh, H1Space(mesh, Basis(nb))


@pytest.mark.parametrize("nb", [2, 4, 6])
@pytest.mark.parametrize("kind", list(MESHES))
def test_native_numpy_and_jax_agree(kind, nb, monkeypatch):
    jmesh = MESHES[kind]()
    jfem = JH1Space(jmesh, JBasis(nb))
    nat_mesh, nat = _port_mesh_and_space(jmesh, nb, monkeypatch, True)
    np_mesh, npy = _port_mesh_and_space(jmesh, nb, monkeypatch, False)
    for name in EDGE_TABLES:
        want = getattr(jmesh, name)
        assert np.array_equal(getattr(nat_mesh, name), want), name
        assert np.array_equal(getattr(np_mesh, name), want), name
    for fem in (nat, npy):
        assert fem.ndof == jfem.ndof
        assert np.array_equal(fem.dofs, jfem.dofs)
        assert np.array_equal(fem.coords, jfem.coords)


def test_native_off_takes_the_numpy_path(monkeypatch):
    """With CUDDH_NATIVE=0 neither build touches the library; with it on,
    both do."""
    calls = []
    monkeypatch.setattr(native, "library", lambda *a: calls.append(a) or pytest.fail("loaded"))
    monkeypatch.setenv("CUDDH_NATIVE", "0")
    assert native.build_edges(np.zeros((1, 4), np.int32), 4) is None
    H1Space(Mesh2D.uniform_rect(3, -1, 1, 3, -1, 1), Basis(3))
    assert calls == []
    monkeypatch.setenv("CUDDH_NATIVE", "1")
    with pytest.raises(pytest.fail.Exception):
        Mesh2D.uniform_rect(3, -1, 1, 3, -1, 1)
    assert len(calls) == 1


LOADER = """
import sys
sys.path.insert(0, {repo!r})
from cuddhelmholtz_tpu_torch import native
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
native.BUILD_DIR = {build!r}  # every use below builds and loads there
m = Mesh2D.uniform_rect(4, -1, 1, 4, -1, 1)
print(native.library()._name, len(m.edge_vertices))
"""


def test_concurrent_first_use_builds_once(tmp_path):
    """Four processes load from an empty build directory at once: every one
    gets a working library, one library file is built and no temporary file
    is left behind."""
    build = tmp_path / "build"
    code = LOADER.format(repo=REPO, build=str(build))
    procs = [subprocess.Popen([sys.executable, "-c", code], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for _ in range(4)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=180)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out
        assert out.strip().endswith(" 40"), out  # 4x4 quads have 40 edges
    files = sorted(os.listdir(build))
    assert [f for f in files if f.endswith(".so")] == [os.path.basename(
        outs[0].split()[0])]
    assert not [f for f in files if f.endswith(".tmp")], files


@pytest.mark.parametrize("cxx", ["false", "/nonexistent/c++"])
def test_broken_compiler_raises(cxx, tmp_path, monkeypatch):
    """A compiler that fails or cannot run raises an error that names it;
    nothing falls back to NumPy silently."""
    monkeypatch.setenv("CXX", cxx)
    with pytest.raises(RuntimeError, match="native:") as e:
        native.build(tmp_path)
    assert cxx in str(e.value)
    assert not list(tmp_path.iterdir()) or all(
        f.name == "topology.lock" for f in tmp_path.iterdir())
