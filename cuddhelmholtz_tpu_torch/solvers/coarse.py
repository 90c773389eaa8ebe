"""Two-level DDH: a plane-wave coarse space on the interface (lambda) system.

Counterpart of ``cuddhelmholtz_tpu/solvers/coarse.py``.  One-level
substructuring hits a frequency wall (the restarts grow with nx at a fixed
subdomain size); the coarse space projects the residual onto a few slowly
resolved interface modes per superdomain, solves that coarse problem and
corrects.

* Coarse columns are plane waves localised to superdomains (clusters of
  subdomains from median bisection of their centroids): for each
  superdomain, side (lambda / mu) and mode ``phi_j`` in
  ``{1} + {cos(omega e_r . x), sin(omega e_r . x)}`` over ``n_dir``
  directions, the column holds ``phi_j(x)`` at every surviving trace unknown
  of the superdomain's subdomains and 0 elsewhere.
* The Galerkin matrix ``E = Z^T (I - U) Z`` is assembled exactly on the
  host in float64 from the identity-folded per-subdomain transfer stack:
  the own-slot B1 scatter is collision-free, so the assembly is a
  per-domain dense contraction and a scatter-add over (superdomain, mode)
  pairs.  The scatter-adds sum in a fixed order (a stable sort of the
  targets, then ``np.add.reduceat``), so a build repeats bitwise.
* ``method="direct"`` (``CoarseSpace``): E is normalised, ridge-regularised
  and inverted once.  The host inverts in float64 up to nc = 8,192; above,
  the card inverts in float64 with ``torch.linalg.inv`` (the JAX package
  inverts there in fp32 on the TPU, which has no native fp64; the H100
  has).
* ``method="iterative"`` (``SparseCoarseSpace``): E is kept block-sparse
  over the superdomain adjacency graph and solved on the device by GMRES
  (deferred, single-pass CGS) with a block-Jacobi preconditioner; the
  matvec is one batched (nS, 2nm, K 2nm) @ (nS, K 2nm) product.

The restriction ``Z^T v`` sums each superdomain's subdomains through a
host-built member table (a gather and a row sum, no atomics), so a
two-level solve repeats bitwise.  The correction is a right preconditioner
of FGMRES on the lambda system (``DDH.solver(coarse=...)``): additive
``v + q`` or multiplicative ``q + v - A q`` with ``q = Z E^{-1} Z^T v``.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..ops.mass import assembly_table
from .ddh import _read_traces
from .gmres import gmres

# dense inverses above this many coarse unknowns run on the card
HOST_INVERSE_MAX_NC = 8192


class CoarseSpace(NamedTuple):
    """Device data of the dense coarse correction.  ``nm`` modes per
    (superdomain, side); ``nc = 2 nS nm`` coarse unknowns ordered (side,
    superdomain, mode), the lambda side first."""

    V: torch.Tensor  # (ndom, pf, nm) mode values at own trace slots (masked)
    sd: torch.Tensor  # (ndom,) int64 superdomain of each subdomain
    Einv: torch.Tensor  # (nc, nc) inverse of the normalised Galerkin matrix
    dscale: torch.Tensor  # (nc,) normalisation 1 / sqrt(|diag E|)
    members: torch.Tensor  # (nS, k) int64 subdomains of each superdomain, padded with ndom


class SparseCoarseSpace(NamedTuple):
    """Block-sparse coarse space solved iteratively on the device.

    ``nbr[r]`` lists the column superdomains coupled to row superdomain r
    (-1 padded to the largest degree K, self included); ``Eb[r]`` holds
    their normalised (2, 2, nm, nm) side-coupling blocks (ridge included) in
    batched-matmul layout ``Eb[r, (t, j), (k, s, l)]``; ``Pinv`` is the
    inverse of each row's own (2nm, 2nm) diagonal block, the block-Jacobi
    preconditioner of the coarse GMRES.
    """

    V: torch.Tensor  # (ndom, pf, nm) mode values at own trace slots (masked)
    sd: torch.Tensor  # (ndom,) int64 superdomain of each subdomain
    dscale: torch.Tensor  # (2, nS, nm) normalisation 1 / sqrt(|diag E|)
    nbr: torch.Tensor  # (nS, K) int64 neighbour superdomains (-1 pad)
    Eb: torch.Tensor  # (nS, 2nm, K 2nm)
    Pinv: torch.Tensor  # (nS, 2nm, 2nm) block-Jacobi inverse
    members: torch.Tensor  # (nS, k) int64 subdomains of each superdomain, padded with ndom


def superdomain_labels(points: np.ndarray, n_super: int) -> np.ndarray:
    """Cluster points into ``n_super`` (a power of two) groups by recursive
    median bisection along the widest axis, as the element partitioner does,
    applied to subdomain centroids."""
    n = points.shape[0]
    depth = max(0, int(round(np.log2(max(1, n_super)))))
    labels = np.zeros(n, dtype=np.int64)

    def split(idx: np.ndarray, lab: int, d: int) -> None:
        if d == 0 or idx.size <= 1:
            labels[idx] = lab
            return
        p = points[idx]
        ax = int(np.argmax(p.max(axis=0) - p.min(axis=0)))
        order = np.argsort(p[:, ax], kind="stable")
        half = idx.size // 2
        split(idx[order[:half]], 2 * lab, d - 1)
        split(idx[order[half:]], 2 * lab + 1, d - 1)

    split(np.arange(n), 0, depth)
    _, inv = np.unique(labels, return_inverse=True)
    return inv.reshape(-1)


def _mode_values(xy: np.ndarray, omega: float, n_dir: int) -> np.ndarray:
    """phi_j(x) for j = 0..nm-1: the constant, then cos and sin plane waves
    over ``n_dir`` equispaced directions in [0, pi)."""
    out = [np.ones(xy.shape[:-1])]
    for r in range(n_dir):
        th = np.pi * r / max(1, n_dir)
        ph = omega * (np.cos(th) * xy[..., 0] + np.sin(th) * xy[..., 1])
        out.append(np.cos(ph))
        out.append(np.sin(ph))
    return np.stack(out, axis=-1)


def _scatter_add(out: np.ndarray, idx: np.ndarray, vals: np.ndarray) -> None:
    """out[idx[i]] += vals[i] along the leading axis, in a fixed order: a
    stable sort of the targets, then one ``np.add.reduceat`` per target."""
    idx = np.asarray(idx).reshape(-1)
    vals = vals.reshape(idx.size, *out.shape[1:])
    order = np.argsort(idx, kind="stable")
    tgt, starts = np.unique(idx[order], return_index=True)
    out[tgt] += np.add.reduceat(vals[order], starts, axis=0)


def _coarse_ingredients(ddh, n_dir: int, domains_per_super: int):
    """Shared setup of both assemblies: mode columns ``V``, superdomain
    labels ``sd`` and count ``nS``, the identity-folded deduped transfer
    stack ``A_u`` with its ``groups``, the valid dual targets ``tgt_ok`` and
    their superdomains ``sdd``."""
    if ddh._T_u is None:
        raise ValueError("coarse space needs the transfer operator: run prepare()")
    fslot = ddh._fslot_np  # (ndom, pf)
    B0, B1, gI = ddh._B0_np, ddh._B1_np, ddh._gI_np
    ndom, pf = fslot.shape
    coords = np.asarray(ddh.space.coords)

    # mode values at the own trace slots, masked to surviving unknowns
    ok = (fslot >= 0) & (B0 >= 0)
    gdof = np.where(ok, np.take_along_axis(gI, np.maximum(fslot, 0), axis=1), 0)
    xy = coords[gdof]  # (ndom, pf, 2)
    V = _mode_values(xy, ddh.omega, n_dir) * ok[:, :, None]

    # superdomains from subdomain centroids (mean of the valid slot coords)
    cnt = np.maximum(ok.sum(axis=1), 1)
    cen = (xy * ok[:, :, None]).sum(axis=1) / cnt[:, None]
    sd = superdomain_labels(cen, max(1, ndom // max(1, domains_per_super)))
    nS = int(sd.max()) + 1

    # the roll route's fold: row i < pf gives y_l = -x_l - (T x)_l, else
    # y_m = -x_m + (T x)_m
    T_u = np.asarray(ddh._T_u, dtype=np.float64)
    if not np.isfinite(T_u).all():
        raise ValueError(
            "transfer operator contains non-finite values (an unstable "
            "nt_override breaks the leapfrog CFL limit)"
        )
    A_u = np.concatenate([-T_u[:, :pf, :], T_u[:, pf:, :]], axis=1)
    A_u[:, np.arange(2 * pf), np.arange(2 * pf)] -= 1.0

    tgt_ok = (B1 >= 0) & (B1 < ddh.n_own)
    sdd = sd[np.where(tgt_ok, B1 // pf, 0)]  # (ndom, pf) superdomain of each dual target
    return V, sd, nS, A_u, ddh._T_groups, tgt_ok, sdd


def _domain_chunk(ndom: int, pf: int) -> int:
    """Domains per chunk of the A_u[groups] expansion: 128 MB of float64."""
    return max(1, min(ndom, (1 << 27) // max(1, 4 * pf * pf * 8)))


def _members(sd: np.ndarray, nS: int, device) -> torch.Tensor:
    return torch.as_tensor(assembly_table(sd, nS), device=device)


def _device(ddh) -> torch.device:
    return ddh.gmask.device


def build_coarse_space(ddh, n_dir: int = 4, domains_per_super: int = 16, ridge: float = 1e-8,
                       dtype=torch.float32) -> CoarseSpace:
    """Assemble the dense coarse space of a DDH whose transfer operator has
    been precomputed (``ddh.prepare()`` or ``precompute_transfer``)."""
    V, sd, nS, A_u, groups, tgt_ok, sdd = _coarse_ingredients(ddh, n_dir, domains_per_super)
    ndom, pf, nm = V.shape
    nc = 2 * nS * nm
    dev = _device(ddh)

    # E = Z^T Z - Z^T U Z; writes to the lost tail (B1 >= n_own) leave the
    # coarse space (Z is zero there) and are masked out
    E = np.zeros(nc * nc)
    jj, ll = np.meshgrid(np.arange(nm), np.arange(nm), indexing="ij")

    # Z^T Z: block diagonal over (side, superdomain)
    blocks = np.zeros((nS, nm, nm))
    _scatter_add(blocks, sd, np.einsum("dkj,dkl->djl", V, V))
    for side in (0, 1):
        base = side * nS * nm
        rows = base + (np.arange(nS)[:, None, None] * nm + jj[None])
        cols = base + (np.arange(nS)[:, None, None] * nm + ll[None])
        _scatter_add(E, rows * nc + cols, blocks)

    # minus Z^T U Z, chunked over domains to bound the A_u[groups] expansion
    chunk = _domain_chunk(ndom, pf)
    for d0 in range(0, ndom, chunk):
        d1 = min(ndom, d0 + chunk)
        A_c = A_u[groups[d0:d1]]  # (c, 2pf, 2pf)
        V_c = V[d0:d1]
        m_c = tgt_ok[d0:d1]
        for t in (0, 1):  # target side (lambda / mu rows)
            for s in (0, 1):  # source side (lambda / mu columns)
                Y = A_c[:, t * pf:(t + 1) * pf, s * pf:(s + 1) * pf] @ V_c  # (c, pf, nm)
                # E[(t, sdd, j'), (s, sd, j)] -= V[d, k, j'] Y[d, k, j]
                vals = (V_c[:, :, :, None] * Y[:, :, None, :]) * m_c[:, :, None, None]
                rows = (t * nS + sdd[d0:d1, :, None, None]) * nm + jj[None, None]
                cols = (s * nS + sd[d0:d1, None, None, None]) * nm + ll[None, None]
                flat = np.broadcast_to(rows * nc + cols, vals.shape)
                _scatter_add(E, flat, -vals)
    E = E.reshape(nc, nc)

    # symmetric diagonal normalisation and ridge, then one dense inverse
    d = np.sqrt(np.abs(np.diag(E)))
    d = np.where(d > 1e-12 * max(d.max(), 1.0), d, 1.0)
    En = E / d[:, None] / d[None, :]
    En[np.arange(nc), np.arange(nc)] += ridge
    if nc > HOST_INVERSE_MAX_NC and dev.type == "cuda":
        # float64 LU on the card: host LAPACK needs minutes at this size
        Einv = torch.linalg.inv(torch.as_tensor(En, dtype=torch.float64, device=dev))
    else:
        Einv = torch.as_tensor(np.linalg.inv(En), device=dev)

    return CoarseSpace(
        V=torch.as_tensor(V, dtype=dtype, device=dev),
        sd=torch.as_tensor(sd, device=dev),
        Einv=Einv.to(dtype),
        dscale=torch.as_tensor(1.0 / d, dtype=dtype, device=dev),
        members=_members(sd, nS, dev),
    )


def build_coarse_space_sparse(ddh, n_dir: int = 4, domains_per_super: int = 4,
                              ridge: float = 1e-8, dtype=torch.float32, ortho: bool = True,
                              ortho_tol: float = 1e-8) -> SparseCoarseSpace:
    """Assemble the block-sparse coarse space (the exact Galerkin algebra of
    ``build_coarse_space``; only the storage and the solve change).

    ``ortho=True`` orthonormalises the mode columns within each superdomain
    (eigen-filter of the local Gram matrix; directions below ``ortho_tol`` of
    the largest eigenvalue become zero columns).  At one subdomain per
    superdomain raw plane waves on a sub-wavelength trace patch are nearly
    dependent, and their near-singular diagonal blocks break the block-Jacobi
    coarse solve; the filter makes Z^T Z the identity on the kept directions
    and the dropped ones pure ridge.  ``ortho=False`` keeps the raw columns
    (comparable with ``build_coarse_space``)."""
    V, sd, nS, A_u, groups, tgt_ok, sdd = _coarse_ingredients(ddh, n_dir, domains_per_super)
    ndom, pf, nm = V.shape
    dev = _device(ddh)

    W = None
    if ortho:
        G = np.zeros((nS, nm, nm))  # the Z^T Z diagonal block of each superdomain
        _scatter_add(G, sd, np.einsum("dkj,dkl->djl", V, V))
        lam, Q = np.linalg.eigh(G)  # ascending eigenvalues
        keep = lam > ortho_tol * np.maximum(lam[:, -1:], 1e-300)
        inv_sqrt = np.where(keep, 1.0 / np.sqrt(np.where(keep, lam, 1.0)), 0.0)
        W = Q * inv_sqrt[:, None, :]  # (nS, nm, nm): columns scaled or zeroed
        V_raw = V
        V = np.einsum("dkj,djl->dkl", V, W[sd])

    # (row-super, col-super) pairs: every diagonal pair (Z^T Z and the ridge
    # live there) and each pair a dual-trace target reaches
    diag_pids = np.arange(nS, dtype=np.int64) * nS + np.arange(nS)
    off_pids = (sdd.astype(np.int64) * nS + sd[:, None])[tgt_ok]
    pair_ids = np.unique(np.concatenate([diag_pids, off_pids]))
    npair = len(pair_ids)
    rows_p = pair_ids // nS
    cols_p = pair_ids % nS
    diag_pidx = np.searchsorted(pair_ids, diag_pids)
    B = np.zeros((npair, 2, 2, nm, nm))

    # Z^T Z: block diagonal over (side, superdomain)
    blocks = np.zeros((nS, nm, nm))
    _scatter_add(blocks, sd, np.einsum("dkj,dkl->djl", V, V))
    B[diag_pidx, 0, 0] += blocks
    B[diag_pidx, 1, 1] += blocks

    # minus Z^T U Z scattered to pair blocks; invalid targets carry zeros and
    # go to the own diagonal pair.  The row factor is the row (dual target)
    # superdomain's column at the trace point: with ortho that is the dual
    # superdomain's W, not the own one's.
    own_diag = (sd.astype(np.int64) * nS + sd)[:, None]
    pid_safe = np.where(tgt_ok, sdd.astype(np.int64) * nS + sd[:, None], own_diag)
    pidx_all = np.searchsorted(pair_ids, pid_safe)  # (ndom, pf)
    chunk = _domain_chunk(ndom, pf)
    for d0 in range(0, ndom, chunk):
        d1 = min(ndom, d0 + chunk)
        A_c = A_u[groups[d0:d1]]  # (c, 2pf, 2pf)
        V_c = V[d0:d1]
        if W is None:
            Vrow_c = V_c
        else:
            Vrow_c = np.einsum("dkl,dklj->dkj", V_raw[d0:d1], W[sdd[d0:d1]])
        m_c = tgt_ok[d0:d1]
        pidx_c = pidx_all[d0:d1].reshape(-1)
        for t in (0, 1):  # target side (lambda / mu rows)
            for s in (0, 1):  # source side (lambda / mu columns)
                Y = A_c[:, t * pf:(t + 1) * pf, s * pf:(s + 1) * pf] @ V_c  # (c, pf, nm)
                # [domain, slot, row mode j', col mode j]
                vals = (Vrow_c[:, :, :, None] * Y[:, :, None, :]) * m_c[:, :, None, None]
                _scatter_add(B[:, t, s], pidx_c, -vals)

    # symmetric diagonal normalisation (the dense path's, shaped (side,
    # superdomain, mode)) and the ridge on the diagonal
    Dblk = B[diag_pidx]  # (nS, 2, 2, nm, nm)
    dsq = np.stack([np.einsum("rjj->rj", Dblk[:, 0, 0]), np.einsum("rjj->rj", Dblk[:, 1, 1])])
    d = np.sqrt(np.abs(dsq))  # (2, nS, nm)
    d = np.where(d > 1e-12 * max(d.max(), 1.0), d, 1.0)
    rfac = np.transpose(d[:, rows_p, :], (1, 0, 2))[:, :, None, :, None]
    cfac = np.transpose(d[:, cols_p, :], (1, 0, 2))[:, None, :, None, :]
    Bn = B / (rfac * cfac)
    jdx = np.arange(nm)
    for t in (0, 1):
        Bn[diag_pidx[:, None], t, t, jdx[None, :], jdx[None, :]] += ridge

    # block-Jacobi: the inverse of each superdomain's (2nm, 2nm) diagonal block
    Dm = Bn[diag_pidx].transpose(0, 1, 3, 2, 4).reshape(nS, 2 * nm, 2 * nm)
    Pinv = np.linalg.inv(Dm)

    # padded neighbour layout: K = the largest superdomain degree (self included)
    order = np.argsort(rows_p, kind="stable")
    r_sorted = rows_p[order]
    counts = np.bincount(r_sorted, minlength=nS)
    K = int(counts.max())
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slots = np.arange(npair) - starts[r_sorted]
    nbr = np.full((nS, K), -1, np.int64)
    Eb = np.zeros((nS, K, 2, 2, nm, nm))
    nbr[r_sorted, slots] = cols_p[order]
    Eb[r_sorted, slots] = Bn[order]
    # matmul layout: [r, k, t, s, j, l] -> [r, (t j), (k s l)]
    Ebm = np.transpose(Eb, (0, 2, 4, 1, 3, 5)).reshape(nS, 2 * nm, K * 2 * nm)

    return SparseCoarseSpace(
        V=torch.as_tensor(V, dtype=dtype, device=dev),
        sd=torch.as_tensor(sd, device=dev),
        dscale=torch.as_tensor(1.0 / d, dtype=dtype, device=dev),
        nbr=torch.as_tensor(nbr, device=dev),
        Eb=torch.as_tensor(Ebm, dtype=dtype, device=dev),
        Pinv=torch.as_tensor(Pinv, dtype=dtype, device=dev),
        members=_members(sd, nS, dev),
    )


def coarse_arrays(cs) -> dict[str, np.ndarray]:
    """The space's arrays as the setup cache stores them (the JAX package's
    ``coarse_*`` fields; index tables as int32)."""
    out = {"V": cs.V, "sd": cs.sd, "dscale": cs.dscale}
    if isinstance(cs, SparseCoarseSpace):
        out.update(nbr=cs.nbr, Eb=cs.Eb, Pinv=cs.Pinv)
    else:
        out["Einv"] = cs.Einv
    return {k: v.cpu().numpy().astype(np.int32) if k in ("sd", "nbr") else v.cpu().numpy()
            for k, v in out.items()}


def coarse_from_arrays(arrays: dict[str, np.ndarray], device):
    """The space ``coarse_arrays`` stored, on ``device``."""
    t = {k: torch.as_tensor(v, dtype=torch.int64 if k in ("sd", "nbr") else None, device=device)
         for k, v in arrays.items()}
    nS = int(arrays["sd"].max()) + 1
    members = _members(np.asarray(arrays["sd"]), nS, device)
    if "Eb" in t:
        return SparseCoarseSpace(V=t["V"], sd=t["sd"], dscale=t["dscale"], nbr=t["nbr"],
                                 Eb=t["Eb"], Pinv=t["Pinv"], members=members)
    return CoarseSpace(V=t["V"], sd=t["sd"], Einv=t["Einv"], dscale=t["dscale"],
                       members=members)


def _sparse_coarse_matvec(cs: SparseCoarseSpace, h: torch.Tensor) -> torch.Tensor:
    """y[t, r, j] = sum over (k, s, l) of E[(t, r, j), (s, nbr[r, k], l)]
    h[s, nbr[r, k], l], as one batched (nS, 2nm, K 2nm) @ (nS, K 2nm)
    product."""
    nS, K = cs.nbr.shape
    nm = h.shape[2]
    hn = h[:, cs.nbr.clamp_min(0)]  # (2, nS, K, nm)
    hn = hn * (cs.nbr >= 0)[None, :, :, None].to(h.dtype)
    hnf = hn.permute(1, 2, 0, 3).reshape(nS, K * 2 * nm, 1)
    y = torch.bmm(cs.Eb, hnf)  # (nS, 2nm, 1)
    return y.reshape(nS, 2, nm).transpose(0, 1)


def _sparse_coarse_pc(cs: SparseCoarseSpace, r: torch.Tensor) -> torch.Tensor:
    """Block-Jacobi: z_r = Pinv_r r_r per superdomain, both sides stacked."""
    nm = r.shape[2]
    rr = torch.cat([r[0], r[1]], dim=1)  # (nS, 2nm)
    z = torch.bmm(cs.Pinv, rr[:, :, None])[:, :, 0]
    return torch.stack([z[:, :nm], z[:, nm:]])


def _restrict_scaled(cs, params, v: torch.Tensor, n_own: int) -> torch.Tensor:
    """Z^T v as (2, nS, nm): per-domain mode products, summed over each
    superdomain's members in table order."""
    n_lambda = v.shape[0] // 2
    lam0, mu0 = _read_traces(params, v[None], n_lambda, n_own)  # (1, ndom, pf)
    V = cs.V
    g = torch.einsum("dkj,sdk->sdj", V, torch.cat([lam0, mu0]).to(V.dtype))  # (2, ndom, nm)
    g = torch.cat([g, g.new_zeros(2, 1, g.shape[2])], dim=1)  # the padding member
    return g[:, cs.members].sum(dim=2)


def _prolong_scaled(cs, h2: torch.Tensor, v_dtype, n_lambda: int, n_own: int) -> torch.Tensor:
    """q = Z h from h (2, nS, nm), zero on the lost tail."""
    z = torch.einsum("dkj,sdj->sdk", cs.V, h2[:, cs.sd]).reshape(2, -1).to(v_dtype)
    tail = z.new_zeros(2, n_lambda - n_own)
    return torch.cat([z, tail], dim=1).reshape(-1)


def coarse_apply(cs, params, v: torch.Tensor, n_own: int, *, solve_m: int = 40,
                 solve_maxit: int = 4, solve_tol: float = 1e-3) -> torch.Tensor:
    """q = Z E^{-1} Z^T v on ``v``'s device.

    ``params`` is the owning DDH's ``DDHParams`` (for the trace layout).  A
    dense ``CoarseSpace`` applies its inverse; a ``SparseCoarseSpace`` runs
    block-Jacobi left-preconditioned GMRES on the block-sparse matrix
    (``solve_*``; an approximate coarse solve is fine under the flexible
    outer FGMRES) in the deferred mode with single-pass CGS: exits at
    restart boundaries, one host sync per restart, as the JAX package runs
    it."""
    n_lambda = v.shape[0] // 2
    g2 = _restrict_scaled(cs, params, v, n_own)
    if isinstance(cs, SparseCoarseSpace):
        shape = g2.shape
        g2 = g2 * cs.dscale

        def mv(x):
            return _sparse_coarse_matvec(cs, x.reshape(shape)).reshape(-1)

        def pc(x):
            return _sparse_coarse_pc(cs, x.reshape(shape)).reshape(-1)

        out = gmres(mv, g2.reshape(-1), precond=pc, m=solve_m, maxit=solve_maxit,
                    tol=solve_tol, deferred=True, reorth=False)
        h2 = out.x.reshape(shape) * cs.dscale
    else:
        nS = cs.members.shape[0]
        h = (cs.Einv @ (g2.reshape(-1) * cs.dscale)) * cs.dscale
        h2 = h.reshape(2, nS, -1)
    return _prolong_scaled(cs, h2, v.dtype, n_lambda, n_own)
