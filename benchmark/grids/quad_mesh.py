"""The canonical discretisation of a deployment on a quad-mesh file.

A configuration with ``"grid": "quad_mesh"`` names a mesh directory
(``"mesh"``, relative to the checkout's root, such as
``meshes/unstructured_square``) that holds ``coordinates.txt`` (one ``x y``
row a vertex) and ``elements.txt`` (four vertex ids a quad,
counter-clockwise), how many times to refine it (``"levels"``) and the
degree (``"deg"``).

Each refinement splits every quad into four at its four edge midpoints and
the mean of its four corners; the children of a quad follow its corners, the
child at corner c being (corner c, the midpoint of edge c -> c+1, the mean,
the midpoint of edge c-1 -> c).  The degree-``deg`` Gauss-Lobatto-Legendre
(GLL) nodes are mapped bilinearly onto each element, corners 0..3 at
(-1, -1), (1, -1), (1, 1), (-1, 1) of the reference square.  The nodes that
elements share are merged by their coordinates, to within 1e-9, and
numbered in lexicographic (y, x) order: the canonical numbering, which
depends on the geometry alone.  Plain NumPy: nothing here imports the
program under test.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from benchmark.reference.grid import gll, lagrange

ROOT = Path(__file__).resolve().parents[2]  # the checkout's root
TOL = 1e-9  # nodes closer than this, coordinate by coordinate, are one
NEAR = [(dx, dy) for dx in (-1, 0, 1) for dy in (-1, 0, 1)]


def refine(corners: np.ndarray, levels: int) -> np.ndarray:
    """The (nel 4^levels, 4, 2) corners of the elements after ``levels``
    refinements of the elements with corners ``corners`` (nel, 4, 2)."""
    for _ in range(levels):
        mid = 0.5 * (corners + np.roll(corners, -1, axis=1))  # mid[:, c]: edge c -> c+1
        cen = corners.mean(axis=1)
        corners = np.stack(
            [np.stack([corners[:, c], mid[:, c], cen, mid[:, (c - 1) % 4]], axis=1)
             for c in range(4)], axis=1).reshape(-1, 4, 2)
    return corners


class QuadMesh:
    """Node coordinates, element tables and lumped mass of the GLL
    discretisation of degree ``deg`` on the quads ``corners`` (nel, 4, 2)."""

    def __init__(self, corners: np.ndarray, deg: int):
        self.corners = np.asarray(corners, dtype=np.float64)
        self.deg, self.nb = int(deg), int(deg) + 1
        xi, w = gll(self.nb)
        P, dP = lagrange(np.array([-1.0, 1.0]), xi)  # the linear shape functions
        # [j (eta), i (xi), k (corner)]: corner k sits at (s_k, t_k) of (-1, 1)^2
        s, t = [0, 1, 1, 0], [0, 0, 1, 1]
        N = P[None, :, s] * P[:, None, t]
        Nx = dP[None, :, s] * P[:, None, t]
        Ny = P[None, :, s] * dP[:, None, t]
        pts = np.einsum("jik,ekd->ejid", N, self.corners)
        jx = np.einsum("jik,ekd->ejid", Nx, self.corners)
        jy = np.einsum("jik,ekd->ejid", Ny, self.corners)
        det = jx[..., 0] * jy[..., 1] - jy[..., 0] * jx[..., 1]

        nel = len(self.corners)
        node = self._merge(pts.reshape(-1, 2))
        self.ndof = int(node.max()) + 1
        self._elem = node.reshape(nel, self.nb, self.nb)
        first = np.unique(node, return_index=True)[1]
        self._coords = pts.reshape(-1, 2)[first]
        self._mass = np.bincount(node, weights=(np.outer(w, w) * np.abs(det)).reshape(-1),
                                 minlength=self.ndof)

    @classmethod
    def from_dir(cls, path, levels: int, deg: int) -> "QuadMesh":
        """The mesh in directory ``path``, refined ``levels`` times."""
        path = Path(path)
        v = np.loadtxt(path / "coordinates.txt", dtype=np.float64).reshape(-1, 2)
        e = np.loadtxt(path / "elements.txt", dtype=np.int64).reshape(-1, 4)
        return cls(refine(v[e], int(levels)), deg)

    def coords(self) -> np.ndarray:
        """(ndof, 2) node coordinates in the canonical numbering."""
        return self._coords

    def element_nodes(self) -> np.ndarray:
        """(nel, nb, nb) canonical node ids of each element, [e, eta, xi]."""
        return self._elem

    def lumped_mass(self) -> np.ndarray:
        """The GLL-collocated (lumped) mass diagonal (ndof,):
        sum_e w_i w_j |det J_e(xi_i, xi_j)|."""
        return self._mass

    # -- nodes by their cells of side TOL: one node's copies lie in one
    #    cell or in neighbouring ones, and distinct nodes far apart

    def _keys(self, cell: np.ndarray) -> np.ndarray:
        c = np.clip(cell - self._lo, 0, self._span - 1)
        return c[:, 0] * self._span[1] + c[:, 1]

    def _merge(self, pts: np.ndarray) -> np.ndarray:
        """The node id of each of the points ``pts`` (n, 2); sets the table
        of the cells that the points occupy and the node of each."""
        cell = np.floor(pts / TOL).astype(np.int64)
        self._lo = cell.min(axis=0) - 1
        self._span = cell.max(axis=0) - self._lo + 2
        if float(self._span[0]) * float(self._span[1]) >= 2.0 ** 62:
            raise ValueError("the mesh is too large to key its nodes at 1e-9")
        self._cells, inv = np.unique(self._keys(cell), return_inverse=True)
        # each occupied cell's node is the least occupied cell around it
        rep, near = self._cells.copy(), []
        for dx, dy in NEAR:
            k = self._cells + dx * self._span[1] + dy
            at = np.minimum(np.searchsorted(self._cells, k), len(self._cells) - 1)
            hit = self._cells[at] == k
            near.append((at, hit))
            rep = np.where(hit, np.minimum(rep, k), rep)
        for at, hit in near:
            if (rep[at[hit]] != rep[hit]).any():
                raise ValueError("two distinct nodes lie within 2e-9 of each other")
        reps, of = np.unique(rep, return_inverse=True)
        rank = np.empty(len(reps), dtype=np.int64)
        rank[np.lexsort((reps // self._span[1], reps % self._span[1]))] = np.arange(len(reps))
        self._cell_node = rank[of]
        return self._cell_node[inv]

    def match(self, coords: np.ndarray) -> np.ndarray:
        """Canonical id of each of ``coords`` (n, 2), matched to a node
        within 1e-9; raises where a point is not a node, or two points are
        the same node."""
        coords = np.asarray(coords, dtype=np.float64)
        key = self._keys(np.floor(coords / TOL).astype(np.int64))
        gid = np.full(len(coords), -1, dtype=np.int64)
        for dx, dy in NEAR:
            k = key + dx * self._span[1] + dy
            at = np.minimum(np.searchsorted(self._cells, k), len(self._cells) - 1)
            hit = (self._cells[at] == k) & (gid < 0)
            gid[hit] = self._cell_node[at[hit]]
        if (gid < 0).any() or np.abs(self._coords[gid] - coords).max() > TOL:
            raise ValueError("a program node does not lie on the reference grid")
        if len(np.unique(gid)) != len(gid):
            raise ValueError("two program nodes match one reference node")
        return gid


def grid(config: dict) -> QuadMesh:
    return QuadMesh.from_dir(ROOT / config["mesh"], config["levels"], config["deg"])
