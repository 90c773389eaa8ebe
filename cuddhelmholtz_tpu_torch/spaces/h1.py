"""Continuous-Galerkin global DOF numbering (host-side NumPy).

Counterpart of ``H1Space`` in ``cuddhelmholtz_tpu/spaces/h1.py``: the same
first-occurrence numbering over the flat (i fastest, then j, then element)
traversal, so ``dofs`` agrees bitwise with the JAX package.  The numbering
runs the native C++ build (``native.h1_numbering``) unless
``CUDDH_NATIVE=0``, else NumPy.  ``FaceSpace`` is
the trace space on a face list (the absorbing or Dirichlet boundary).
"""

from __future__ import annotations

import numpy as np
import torch

from ..mesh.mesh2d import Mesh2D
from ..utils.basis import Basis
from ..utils.debug import check_index_table


def first_occurrence_unique(arr: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Unique values in order of first occurrence, plus the inverse map
    (``vals[inv] == arr``)."""
    uniq, first_idx, inv = np.unique(arr, return_index=True, return_inverse=True)
    order = np.argsort(first_idx, kind="stable")
    rank = np.empty(len(order), dtype=np.int64)
    rank[order] = np.arange(len(order))
    return uniq[order], rank[inv]


def side_to_volume(i: np.ndarray, side: np.ndarray, nb: int) -> tuple[np.ndarray, np.ndarray]:
    """Map index i along side ``side`` of a quad to tensor indices (ix, iy).

    Sides: 0 bottom (iy=0), 1 right (ix=nb-1), 2 top (iy=nb-1), 3 left (ix=0);
    i runs in the side's canonical direction.
    """
    i = np.asarray(i)
    side = np.asarray(side)
    ix = np.where((side == 0) | (side == 2), i, np.where(side == 1, nb - 1, 0))
    iy = np.where((side == 1) | (side == 3), i, np.where(side == 2, nb - 1, 0))
    return ix, iy


_CORNER_IX = np.array([0, 1, 1, 0])  # local corner -> (ix, iy) in {0, nb-1}
_CORNER_IY = np.array([0, 0, 1, 1])


class H1Space:
    """Global continuous DOF numbering on tensor-product GLL nodes.

    Attributes: ``dofs`` (nel, nb, nb) int32 ([el, iy, ix] -> global DOF),
    ``ndof``, ``coords`` (ndof, 2) float64 nodal coordinates.
    """

    def __init__(self, mesh: Mesh2D, basis: Basis):
        self.mesh = mesh
        self.basis = basis
        nb = basis.n
        nel = mesh.n_elem
        N = nel * nb * nb

        from .. import native

        built = native.h1_numbering(
            mesh.elem_vertices, mesh.n_vertices, mesh.edge_vertices, mesh.edge_elements,
            mesh.edge_sides, mesh.edge_delta, nb,
        )
        if built is not None:
            self.dofs, self.ndof = built
            self._set_coords()
            return

        # primary[v] = flat volume index of the DOF v is identified with
        primary = np.arange(N, dtype=np.int64)

        def vol(el, ix, iy):
            return (np.asarray(el, dtype=np.int64) * nb + iy) * nb + ix

        # shared edge-interior DOFs
        if nb > 2 and len(mesh.interior_edges):
            e = mesh.interior_edges
            el0 = mesh.edge_elements[e, 0]
            s0 = mesh.edge_sides[e, 0]
            el1 = mesh.edge_elements[e, 1]
            s1 = mesh.edge_sides[e, 1]
            delta = mesh.edge_delta[e]
            i = np.arange(1, nb - 1)
            II = np.broadcast_to(i, (len(e), nb - 2))
            JJ = np.where(delta[:, None] < 0, nb - 1 - II, II)
            ix0, iy0 = side_to_volume(II, s0[:, None], nb)
            ix1, iy1 = side_to_volume(JJ, s1[:, None], nb)
            primary[vol(el1[:, None], ix1, iy1).ravel()] = vol(el0[:, None], ix0, iy0).ravel()

        # shared corner DOFs: per mesh vertex, all (element, corner)
        # incidences in element-major order; the first is primary
        flat_nodes = mesh.elem_vertices.ravel()
        order = np.argsort(flat_nodes, kind="stable")
        nodes_sorted = flat_nodes[order]
        is_first = np.ones(len(order), dtype=bool)
        is_first[1:] = nodes_sorted[1:] != nodes_sorted[:-1]
        group = np.cumsum(is_first) - 1
        first_pair = order[is_first][group]

        def pair_to_vol(p):
            el = p // 4
            c = p % 4
            return vol(el, _CORNER_IX[c] * (nb - 1), _CORNER_IY[c] * (nb - 1))

        dup = ~is_first
        primary[pair_to_vol(order[dup])] = pair_to_vol(first_pair[dup])

        unmasked = primary == np.arange(N)
        ids = np.cumsum(unmasked) - 1
        self.ndof = int(unmasked.sum())
        self.dofs = ids[primary].reshape(nel, nb, nb).astype(np.int32)
        self._set_coords()

    def _set_coords(self):
        check_index_table("H1Space.dofs", self.dofs, self.ndof, allow_pad=False)
        X = self.mesh.physical_coordinates(self.basis.nodes, self.basis.nodes)
        coords = np.zeros((self.ndof, 2), dtype=np.float64)
        coords[self.dofs.transpose(0, 2, 1).reshape(-1)] = X.reshape(-1, 2)
        self.coords = coords

    @property
    def n_basis(self) -> int:
        return self.basis.n

    @property
    def size(self) -> int:
        return self.ndof

    def __repr__(self) -> str:
        return f"H1Space(ndof={self.ndof}, nel={self.mesh.n_elem}, nb={self.basis.n})"


class FaceSpace:
    """Trace space spanned by H1 basis functions supported on a face list.

    Attributes: ``faces`` (nf,) int32 edge ids; ``face_dofs`` (nf, nb) int32,
    [f, i] -> face-space DOF; ``proj`` (fdof,) int32, face-space DOF -> global
    H1 DOF (first-occurrence order); ``fdof``.
    """

    def __init__(self, space: H1Space, faces: np.ndarray):
        self.h1 = space
        faces = np.asarray(faces, dtype=np.int32)
        self.faces = faces
        mesh = space.mesh
        nb = space.n_basis
        el0 = mesh.edge_elements[faces, 0]
        s0 = mesh.edge_sides[faces, 0]
        ix, iy = side_to_volume(np.broadcast_to(np.arange(nb), (len(faces), nb)), s0[:, None], nb)
        gdofs = space.dofs[el0[:, None], iy, ix]  # (nf, nb)
        proj, inv = first_occurrence_unique(gdofs.ravel())
        self.proj = proj.astype(np.int32)
        self.face_dofs = inv.reshape(len(faces), nb).astype(np.int32)
        self.fdof = len(proj)

        check_index_table("FaceSpace.proj", self.proj, space.ndof, allow_pad=False)
        check_index_table("FaceSpace.face_dofs", self.face_dofs, self.fdof, allow_pad=False)

    @property
    def size(self) -> int:
        return self.fdof

    @property
    def n_faces(self) -> int:
        return len(self.faces)

    def _proj(self, x: torch.Tensor) -> torch.Tensor:
        return torch.as_tensor(self.proj, dtype=torch.int64, device=x.device)

    def restrict(self, x: torch.Tensor) -> torch.Tensor:
        """Gather a global vector to the face space: y[i] = x[proj[i]]."""
        return x[..., self._proj(x)]

    def prolong(self, xf: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
        """y with the face-space vector added at its global DOFs (a new
        tensor; ``proj`` is unique, so the add order does not matter)."""
        y = y.clone()
        y[..., self._proj(y)] += xf
        return y

    def orth(self, x: torch.Tensor) -> torch.Tensor:
        """x with its face DOFs zeroed (a new tensor)."""
        x = x.clone()
        x[..., self._proj(x)] = 0.0
        return x
