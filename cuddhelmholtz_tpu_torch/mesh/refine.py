"""Uniform quad-mesh refinement (each element -> 4 children) and jittered grids.

Counterpart of ``cuddhelmholtz_tpu/mesh/refine.py`` (host NumPy, copied:
importing the JAX module would import jax).  Refinement keeps the irregular
topology of a small fixture such as ``meshes/unstructured_square`` (its
non-grid vertex valences) while multiplying the element count by 4 per
level; the jittered grid is grid topology with irregular geometry, the
matched control case.  Both produce the JAX package's vertex and element
tables exactly.
"""

from __future__ import annotations

import numpy as np

from .mesh2d import Mesh2D


def refine_quad_mesh(mesh: Mesh2D, levels: int = 1) -> Mesh2D:
    """Refine ``levels`` times; the element count grows by 4^levels.

    Children are conforming (shared edge midpoints are deduplicated by
    vertex-pair key) and keep the parent's counter-clockwise orientation.
    """
    for _ in range(levels):
        mesh = _refine_once(mesh)
    return mesh


def _refine_once(mesh: Mesh2D) -> Mesh2D:
    v = mesh.vertices
    ev = mesh.elem_vertices  # (nel, 4) CCW
    nel, nv = ev.shape[0], v.shape[0]

    # one midpoint per edge, keyed by its sorted vertex pair (edge e runs
    # from corner e to corner e+1)
    pairs = np.stack([ev, np.roll(ev, -1, axis=1)], axis=2).reshape(-1, 2)
    key = np.sort(pairs, axis=1)
    uniq, inv = np.unique(key, axis=0, return_inverse=True)
    mid = 0.5 * (v[uniq[:, 0]] + v[uniq[:, 1]])
    em = (nv + np.arange(uniq.shape[0]))[inv.reshape(-1)].reshape(nel, 4)

    cen = v[ev].mean(axis=1)
    cen_id = nv + uniq.shape[0] + np.arange(nel)

    # child at corner c: [corner, next-edge midpoint, centroid, previous-edge
    # midpoint], counter-clockwise when the parent is
    children = np.stack(
        [np.stack([ev[:, c], em[:, c], cen_id, em[:, (c - 1) % 4]], axis=1) for c in range(4)],
        axis=1,
    ).reshape(-1, 4)
    return Mesh2D(np.concatenate([v, mid, cen]), children)


def jittered_grid(nx: int, ny: int, amount: float = 0.25, seed: int = 0) -> Mesh2D:
    """A ``uniform_rect`` grid of [-1, 1]^2 whose interior vertices are moved
    by up to ``amount`` times the cell size, uniformly at random from
    ``seed``."""
    xs = np.linspace(-1.0, 1.0, nx + 1)
    ys = np.linspace(-1.0, 1.0, ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="xy")
    rng = np.random.default_rng(seed)
    hx, hy = 2.0 / nx, 2.0 / ny
    jx = rng.uniform(-amount, amount, X.shape) * hx
    jy = rng.uniform(-amount, amount, Y.shape) * hy
    for j in (jx, jy):  # boundary vertices stay put
        j[:, 0] = j[:, -1] = 0.0
        j[0, :] = j[-1, :] = 0.0
    verts = np.stack([(X + jx).reshape(-1), (Y + jy).reshape(-1)], axis=1)
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="xy")
    v0 = (j * (nx + 1) + i).reshape(-1)
    elem = np.stack([v0, v0 + 1, v0 + nx + 2, v0 + nx + 1], axis=1)
    return Mesh2D(verts, elem)
