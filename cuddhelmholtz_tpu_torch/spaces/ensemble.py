"""Ensemble (subdomain) function spaces for domain decomposition.

Counterpart of ``EnsembleSpace`` in ``cuddhelmholtz_tpu/spaces/ensemble.py``
(host-side NumPy): partition the mesh by per-element labels and build, per
subdomain and padded with -1,

  * element lists and local DOF numberings (``local_dofs``/``sizes``),
  * subspace -> global DOF maps (``gI``),
  * interface + boundary face lists and face-space numberings (``fI``/``pI``),
  * the connectivity map ``cmap`` pairing shared interface face DOFs.

Every numbering is one batched first-occurrence pass over a domain-major
traversal, as in the JAX package, so the tables agree bitwise.
``structured_labels`` and ``coordinate_bisection_labels`` make the element
labels of a partition.
"""

from __future__ import annotations

import warnings

import numpy as np

from ..utils.debug import check_index_table, debug_enabled
from .h1 import H1Space, first_occurrence_unique, side_to_volume


def _grouped_positions(group: np.ndarray, n_groups: int):
    """Rank of each entry within its group (stable), counts per group, and
    group start offsets (n_groups + 1)."""
    counts = np.bincount(group, minlength=n_groups)
    offsets = np.zeros(n_groups + 1, dtype=np.int64)
    np.cumsum(counts, out=offsets[1:])
    order = np.argsort(group, kind="stable")
    pos = np.empty(len(group), dtype=np.int64)
    pos[order] = np.arange(len(group)) - offsets[group[order]]
    return pos, counts.astype(np.int64), offsets


class EnsembleSpace:
    def __init__(self, space: H1Space, n_domains: int, element_labels: np.ndarray):
        labels = np.asarray(element_labels, dtype=np.int64).reshape(-1)
        mesh = space.mesh
        nb = space.n_basis
        nel = mesh.n_elem
        if labels.shape[0] != nel:
            raise ValueError("element_labels must have one entry per element")
        if labels.min() < 0 or labels.max() >= n_domains:
            raise ValueError("element labels out of range")

        self.space = space
        self.n_domains = n_domains
        self.n_basis = nb

        # CUDDH_DEBUG: audit the input numbering before building.  The
        # batched first-occurrence keys are dom * ndof + gid, so an
        # out-of-range gid would alias into the next domain's key space
        # instead of giving a detectably bad table.
        check_index_table(
            "EnsembleSpace input space.dofs", space.dofs, space.ndof, allow_pad=False
        )

        # --- elements per subdomain (ascending global order) ----------------
        counts = np.bincount(labels, minlength=n_domains)
        if counts.min() < 1:
            raise ValueError("every subdomain needs at least one element")
        self.n_elems = counts.astype(np.int32)
        mx_elems = int(counts.max())
        self.mx_elems = mx_elems
        el_pos, _, _ = _grouped_positions(labels, n_domains)
        self.elems = np.full((n_domains, mx_elems), -1, dtype=np.int32)
        self.elems[labels, el_pos] = np.arange(nel, dtype=np.int32)
        self.el2s = el_pos.astype(np.int32)  # global element -> local index

        # --- faces per subdomain (global edge-id order) ---------------------
        # a subdomain face is a boundary edge of one of its elements, or an
        # interior edge whose two elements carry different labels; side-0
        # entries precede side-1 entries of the same edge
        ee = mesh.edge_elements
        S0e = labels[ee[:, 0]]
        S1e = np.where(ee[:, 1] >= 0, labels[np.maximum(ee[:, 1], 0)], -1)
        is_shared = (ee[:, 1] >= 0) & (S0e != S1e)
        take0 = (ee[:, 1] < 0) | is_shared
        e0 = np.nonzero(take0)[0]
        e1 = np.nonzero(is_shared)[0]
        f_dom = np.concatenate([S0e[e0], S1e[e1]])
        f_edge = np.concatenate([e0, e1])
        f_side = np.concatenate([np.zeros(len(e0), np.int64), np.ones(len(e1), np.int64)])
        minor = np.argsort(f_edge * 2 + f_side, kind="stable")
        f_dom, f_edge, f_side = f_dom[minor], f_edge[minor], f_side[minor]
        f_pos, f_counts, _ = _grouped_positions(f_dom, n_domains)
        self.n_faces = f_counts.astype(np.int32)
        mx_faces = int(self.n_faces.max()) if n_domains else 0
        self.mx_faces = mx_faces
        self.faces = np.full((n_domains, mx_faces), -1, dtype=np.int32)
        self.face_side = np.full((n_domains, mx_faces), -1, dtype=np.int32)
        self.faces[f_dom, f_pos] = f_edge.astype(np.int32)
        self.face_side[f_dom, f_pos] = f_side.astype(np.int32)
        # shared-face records (S0, S1, l0, l1) in edge order, for cmap below
        lpos = np.empty(len(f_dom), dtype=np.int64)
        lpos[minor] = f_pos
        l0_of = lpos[: len(e0)]
        l1_of = lpos[len(e0):]
        sh_S0 = S0e[e1]
        sh_S1 = S1e[e1]
        sh_l0 = l0_of[is_shared[e0]]
        sh_l1 = l1_of

        # --- subspace DOF numbering (first occurrence over el, iy, ix) ------
        # keys (domain, global dof) over the domain-major traversal: each
        # domain's uniques are contiguous and in first-occurrence order
        gels = np.maximum(self.elems, 0)
        evalid = np.repeat((self.elems >= 0).reshape(-1), nb * nb)
        g_ids = space.dofs[gels].reshape(n_domains, mx_elems, nb, nb)
        dom_of = np.repeat(np.arange(n_domains, dtype=np.int64), mx_elems * nb * nb)
        keys = (dom_of * space.ndof + g_ids.reshape(-1))[evalid]
        dom_v = dom_of[evalid]
        uniq, inv = first_occurrence_unique(keys)
        udom = uniq // space.ndof
        sizes = np.bincount(udom, minlength=n_domains)
        self.sizes = sizes.astype(np.int32)
        self.mx_ndof = int(sizes.max())
        d_off = np.zeros(n_domains + 1, dtype=np.int64)
        np.cumsum(sizes, out=d_off[1:])
        self.gI = np.full((n_domains, self.mx_ndof), -1, dtype=np.int32)
        self.gI[udom, np.arange(len(uniq)) - d_off[udom]] = (uniq % space.ndof).astype(
            np.int32
        )
        local = inv - d_off[dom_v]
        flat_local = np.full(n_domains * mx_elems * nb * nb, -1, dtype=np.int32)
        flat_local[evalid] = local.astype(np.int32)
        self.local_dofs = flat_local.reshape(n_domains, mx_elems, nb, nb)

        # --- face-space numbering -------------------------------------------
        fvalid = (self.faces >= 0).reshape(-1)
        es = np.maximum(self.faces, 0).reshape(-1)
        sides = np.maximum(self.face_side, 0).reshape(-1)
        g_el = ee[es, sides]
        s = mesh.edge_sides[es, sides]
        rev = (sides == 1) & (mesh.edge_delta[es] < 0)
        i = np.arange(nb)
        J = np.where(rev[:, None], nb - 1 - i[None, :], i[None, :])
        ix, iy = side_to_volume(J, s[:, None], nb)
        fdom_of = np.repeat(np.arange(n_domains, dtype=np.int64), mx_faces)
        sub_idx = self.local_dofs[fdom_of[:, None], self.el2s[g_el][:, None], iy, ix]
        fkeys = (fdom_of[:, None] * self.mx_ndof + sub_idx).reshape(-1)
        fvalid_n = np.repeat(fvalid, nb)
        fdom_v = np.repeat(fdom_of, nb)[fvalid_n]
        funiq, finv = first_occurrence_unique(fkeys[fvalid_n])
        fudom = funiq // self.mx_ndof
        fsizes = np.bincount(fudom, minlength=n_domains)
        self.fsizes = fsizes.astype(np.int32)
        self.mx_fdof = int(fsizes.max()) if n_domains else 0
        f_off = np.zeros(n_domains + 1, dtype=np.int64)
        np.cumsum(fsizes, out=f_off[1:])
        self.pI = np.full((n_domains, self.mx_fdof), -1, dtype=np.int32)
        self.pI[fudom, np.arange(len(funiq)) - f_off[fudom]] = (
            funiq % self.mx_ndof
        ).astype(np.int32)
        flat_fI = np.full(n_domains * mx_faces * nb, -1, dtype=np.int32)
        flat_fI[fvalid_n] = (finv - f_off[fdom_v]).astype(np.int32)
        self.fI = flat_fI.reshape(n_domains, mx_faces, nb)

        # --- connectivity map: unique shared face-DOF pairs ------------------
        # traversal order (shared edge ascending, node within) with one
        # first-occurrence dedup per ((min,max) domain pair, lower domain's
        # face dof)
        if len(e1):
            j0 = self.fI[sh_S0[:, None], sh_l0[:, None], i[None, :]].reshape(-1)
            j1 = self.fI[sh_S1[:, None], sh_l1[:, None], i[None, :]].reshape(-1)
            S0r = np.repeat(sh_S0, nb)
            S1r = np.repeat(sh_S1, nb)
            pairkey = np.minimum(S0r, S1r) + np.int64(n_domains) * np.maximum(S0r, S1r)
            lkey = np.where(S0r < S1r, j0, j1)
            comb = pairkey * np.int64(max(self.mx_fdof, 1)) + lkey
            _, first_idx = np.unique(comb, return_index=True)
            keep = np.sort(first_idx)
            self.cmap = np.stack([S0r[keep], S1r[keep], j0[keep], j1[keep]], axis=1).astype(
                np.int32
            )
        else:
            self.cmap = np.zeros((0, 4), dtype=np.int32)
        self.n_shared_dofs = len(self.cmap)
        self._debug_audit()

    def _debug_audit(self):
        """CUDDH_DEBUG index-table audit of the built tables."""
        if not debug_enabled():
            return
        space, mesh = self.space, self.space.mesh
        check_index_table("EnsembleSpace.elems", self.elems, mesh.n_elem)
        check_index_table("EnsembleSpace.faces", self.faces, mesh.n_edges)
        check_index_table("EnsembleSpace.gI", self.gI, space.ndof)
        check_index_table("EnsembleSpace.local_dofs", self.local_dofs, self.mx_ndof)
        check_index_table("EnsembleSpace.fI", self.fI, self.mx_fdof)
        check_index_table("EnsembleSpace.pI", self.pI, self.mx_ndof)
        if self.n_shared_dofs:
            check_index_table("EnsembleSpace.cmap[:, :2]", self.cmap[:, :2], self.n_domains,
                              allow_pad=False)
            check_index_table("EnsembleSpace.cmap[:, 2:]", self.cmap[:, 2:], self.mx_fdof,
                              allow_pad=False)

    def __repr__(self) -> str:
        return (
            f"EnsembleSpace(n_domains={self.n_domains}, mx_ndof={self.mx_ndof}, "
            f"mx_fdof={self.mx_fdof}, n_shared={self.n_shared_dofs})"
        )


def structured_labels(nx: int, ny: int, elems_per_dom_x: int, elems_per_dom_y: int):
    """Element labels for a ``uniform_rect`` mesh: square blocks of elements.

    Element el = i + nx*j gets label (i // ex) + ndx * (j // ey).
    """
    if nx % elems_per_dom_x or ny % elems_per_dom_y:
        raise ValueError("nx, ny must be multiples of the block size")
    ndx = nx // elems_per_dom_x
    i, j = np.meshgrid(np.arange(nx), np.arange(ny), indexing="ij")
    lab = (i // elems_per_dom_x) + ndx * (j // elems_per_dom_y)
    return lab.T.reshape(-1), ndx * (ny // elems_per_dom_y)


def coordinate_bisection_labels(mesh, n_target: int, cut_sweep: int = 0) -> tuple[np.ndarray, int]:
    """Partition a mesh into ~n_target subdomains by recursive coordinate
    bisection of element centroids.

    ``cut_sweep=0`` splits the largest part at the median of its wider
    coordinate extent.  ``cut_sweep=k > 1`` sweeps ``k`` balanced candidate
    cuts (quantiles 0.35..0.65) along both axes and keeps the one crossing
    the fewest interior edges, then the most balanced.  Returns ``(labels,
    n_parts)``; ``n_parts`` is below ``n_target`` (with a warning) when every
    part is down to one element.
    """
    cent = mesh.element_corner_coords().mean(axis=1)  # (nel, 2)
    nel = mesh.n_elem
    if cut_sweep > 1:
        iee = mesh.edge_elements[mesh.interior_edges]  # (nie, 2) adjacency
        side = np.zeros(nel, dtype=bool)
    parts = [np.arange(nel)]
    while len(parts) < n_target:
        sizes = [len(p) for p in parts]
        k = int(np.argmax(sizes))
        if sizes[k] <= 1:
            warnings.warn(
                f"coordinate_bisection_labels: mesh exhausted at {len(parts)} "
                f"single-element parts (requested {n_target})",
                stacklevel=2,
            )
            break
        part = parts.pop(k)
        c = cent[part]
        lo = hi = None
        if cut_sweep > 1 and len(part) > 2:
            in_part = np.zeros(nel, dtype=bool)
            in_part[part] = True
            cand = iee[in_part[iee[:, 0]] & in_part[iee[:, 1]]]
            best = None
            for axis in (0, 1):
                if np.ptp(c[:, axis]) <= 0:
                    continue
                for q in np.linspace(0.35, 0.65, cut_sweep):
                    cut = np.quantile(c[:, axis], q)
                    lo_mask = c[:, axis] <= cut
                    n_lo = int(lo_mask.sum())
                    if n_lo == 0 or n_lo == len(part):
                        continue
                    side[part] = lo_mask
                    crossing = int((side[cand[:, 0]] != side[cand[:, 1]]).sum())
                    key = (crossing, abs(2 * n_lo - len(part)))
                    if best is None or key < best[0]:
                        best = (key, part[lo_mask], part[~lo_mask])
            if best is not None:
                _, lo, hi = best
        if lo is None:
            axis = int(np.argmax(c.max(axis=0) - c.min(axis=0)))
            med = np.median(c[:, axis])
            lo = part[c[:, axis] <= med]
            hi = part[c[:, axis] > med]
            if len(lo) == 0 or len(hi) == 0:
                order = np.argsort(c[:, axis], kind="stable")
                half = len(part) // 2
                lo, hi = part[order[:half]], part[order[half:]]
        parts.extend([lo, hi])
    labels = np.zeros(nel, dtype=np.int64)
    for p, els in enumerate(parts):
        labels[els] = p
    return labels, len(parts)
