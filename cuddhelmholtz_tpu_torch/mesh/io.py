"""Mesh loading.

Counterpart of ``load_mesh_dir``, ``load_unstructured_square`` and
``to_file`` in ``cuddhelmholtz_tpu/mesh/io.py``: the same repository-root
``meshes/`` data files, read with NumPy, and the raw float64 output dumps.
"""

from __future__ import annotations

import os
from pathlib import Path

import numpy as np

from .mesh2d import Mesh2D

MESH_DIR = Path(__file__).resolve().parents[2] / "meshes"


def load_mesh_dir(path) -> Mesh2D:
    """Load a mesh from a directory with info.txt/coordinates.txt/elements.txt.

    info.txt holds ``n_pts n_elem``; coordinates.txt has n_pts rows of
    ``x y``; elements.txt has n_elem rows of 4 vertex indices (CCW).
    """
    path = Path(path)
    n_pts, n_elem = (int(t) for t in (path / "info.txt").read_text().split()[:2])
    coords = np.loadtxt(path / "coordinates.txt", dtype=np.float64).reshape(n_pts, 2)
    elems = np.loadtxt(path / "elements.txt", dtype=np.int64).reshape(n_elem, 4)
    return Mesh2D(coords, elems)


def load_unstructured_square() -> Mesh2D:
    """The 140-vertex / 119-element unstructured quad mesh of [-1, 1]^2."""
    return load_mesh_dir(MESH_DIR / "unstructured_square")


def to_file(path: str, array) -> None:
    """Dump a float64 array as raw binary in Fortran order (the reference's
    output format, readable with ``numpy.fromfile``)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    np.asarray(array, dtype=np.float64).ravel(order="F").tofile(path)
