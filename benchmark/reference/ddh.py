"""Plain reference of the upstream DDH substructured solve on a structured grid.

A transliteration of upstream CuDDHelmholtz's ``source/DDH.cpp`` (the setup,
and the ``ddh_action`` kernel with its rhs, action and postprocess uses) for
square subdomains of ``block`` x ``block`` DOFs on a uniform grid, written
from the algorithm and independent of the program under test:

* every subdomain gets the FULL global forcing at its nodes;
* the interface unknowns are the incoming impedance traces (lambda, mu) at
  each shared face node; the pairs of subdomains sharing a node are listed
  in the upstream's order (shared edges by first occurrence over elements,
  element-major with sides bottom, right, top, left; nodes along the edge;
  one entry per pair and node) and written into the trace tables in that
  order, so at a corner shared by four subdomains the last pair wins;
* each subdomain solve is ``wh_maxit`` WaveHoltz iterations of a leapfrog
  over one period with the collocated (GLL) stiffness and lumped mass.

The solve runs in float64: the transfer map of each distinct subdomain is
probed once with one-hot trace columns through the plain cycle, the interface
system is solved by restarted GMRES to a tight tolerance, and the rhs and the
solution come from the plain cycle itself.  The result is the global [u; v]
in the canonical numbering of ``grid.Grid``.
"""

from __future__ import annotations

import numpy as np
import torch

from .grid import Grid, gll, lagrange


class ReferenceDDH:
    """The DDH operator of one wave-speed model (nodal ``a`` in the canonical
    numbering), float64 on ``device``."""

    def __init__(self, grid: Grid, omega: float, a_nodal: np.ndarray, block: int, wh_maxit: int,
                 device, dtype=torch.float64):
        nb, deg, nx = grid.nb, grid.deg, grid.nx
        if block % nb:
            raise ValueError("block must be a multiple of deg + 1")
        epd = block // nb  # elements per subdomain side
        if nx % epd:
            raise ValueError("nx must be a multiple of the elements per subdomain side")
        self.grid, self.omega, self.wh_maxit = grid, float(omega), int(wh_maxit)
        self.device, self.dtype = device, dtype
        nd = nx // epd
        nl1 = epd * deg + 1
        nloc = nl1 * nl1
        self.ndom, self.nloc = nd * nd, nloc
        h = grid.h
        xi, w = gll(nb)
        _, D = lagrange(xi, xi)

        # local -> global node ids, subdomain d = I + nd J
        I, J = np.meshgrid(np.arange(nd), np.arange(nd), indexing="xy")
        I, J = I.reshape(-1), J.reshape(-1)
        ly, lx = np.divmod(np.arange(nloc), nl1)
        gx = I[:, None] * epd * deg + lx[None, :]
        gy = J[:, None] * epd * deg + ly[None, :]
        gI = gy * grid.n1 + gx  # (ndom, nloc)

        # subdomain stiffness (GLL-collocated) and lumped mass; every
        # element is the same square, so one matrix serves all subdomains
        K1 = D.T @ np.diag(w) @ D
        Kel = np.kron(np.diag(w), K1) + np.kron(K1, np.diag(w))  # [(iy,ix),(jy,jx)]
        S = np.zeros((nloc, nloc))
        m_loc = np.zeros(nloc)
        mel = (0.25 * h * h * np.outer(w, w)).reshape(-1)
        for ey in range(epd):
            for ex in range(epd):
                ids = ((ey * deg + np.arange(nb))[:, None] * nl1
                       + ex * deg + np.arange(nb)[None, :]).reshape(-1)
                S[np.ix_(ids, ids)] += Kel
                m_loc[ids] += mel

        # face damping H: every side of a block is a subdomain face
        H = np.zeros(nloc)
        for e in range(epd):
            along = e * deg + np.arange(nb)
            for ids in (along, (nl1 - 1) * nl1 + along, along * nl1, along * nl1 + nl1 - 1):
                np.add.at(H, ids, 0.5 * h * w)
        fnode = np.nonzero(H)[0]  # the face slots: the block's boundary nodes
        pf = len(fnode)
        slot_of = np.full(nloc, -1)
        slot_of[fnode] = np.arange(pf)

        gm = grid.lumped_mass()
        a = np.asarray(a_nodal, dtype=np.float64)[gI]  # (ndom, nloc)

        # WaveHoltz time grid, filter and phases
        T = 2 * np.pi / omega
        dt = 0.2 * 0.5 * h / (nb * nb)
        nt = int(np.ceil(T / dt))
        dt = T / nt
        self.nt, self.dt = nt, dt
        k = np.arange(nt + 1)
        filt = dt * (omega / np.pi) * (np.cos(omega * k * dt) - 0.25)
        filt[0] *= 0.5
        filt[nt] *= 0.5
        th = 0.5 * np.arange(2 * nt + 1) * dt
        self.cs = (-np.cos(omega * th)).tolist()
        self.sn = np.sin(omega * th).tolist()
        self.filt = filt.tolist()

        self._trace_tables(grid, epd, nd, gI, slot_of)

        dev = dict(device=device, dtype=dtype)
        self.gI = torch.as_tensor(gI, device=device)
        self.S = torch.as_tensor(S, **dev)
        self.fnode = torch.as_tensor(fnode, device=device)
        self.pf = pf
        self.Hf = torch.as_tensor(H[fnode], **dev)
        self.H = torch.as_tensor(H, **dev)
        self.M = torch.as_tensor(m_loc[None, :] / gm[gI], **dev)  # partition-of-unity weight
        self.a = torch.as_tensor(a, **dev)
        self.inv_mi = 1.0 / (self.a * self.a * torch.as_tensor(m_loc, **dev))
        self.Ha = self.H * self.a
        self.S2 = 2.0 * omega * self.a[:, fnode]  # (ndom, pf)

        # distinct subdomains: the cycle data that varies is a alone
        _, first, groups = np.unique(a, axis=0, return_index=True, return_inverse=True)
        self.uidx = torch.as_tensor(first, device=device)
        self.groups = torch.as_tensor(groups.reshape(-1), device=device)
        self.T = self._probe_transfer()  # (nu, 2pf, 2pf)

    def _trace_tables(self, grid: Grid, epd: int, nd: int, gI: np.ndarray, slot_of):
        """B0 (where each subdomain reads its incoming traces) and B1 (where
        it writes its outgoing ones), (ndom, pf) ids into lambda, -1 where
        none, in the upstream's pair order with the last write winning."""
        nx, deg = grid.nx, grid.deg
        dom_of_el = lambda ex, ey: (ex // epd) + nd * (ey // epd)  # noqa: E731
        edges = []  # (edge order key, s0, s1, global nodes along the edge)
        i = np.arange(deg + 1)
        for ey in range(nx):
            for ex in range(nx):
                el = ex + nx * ey
                if (ex + 1) % epd == 0 and ex + 1 < nx:  # right side (1), bottom to top
                    nodes = (ey * deg + i) * grid.n1 + (ex + 1) * deg
                    edges.append((4 * el + 1, dom_of_el(ex, ey), dom_of_el(ex + 1, ey), nodes))
                if (ey + 1) % epd == 0 and ey + 1 < nx:  # top side (2), left to right
                    nodes = (ey + 1) * deg * grid.n1 + ex * deg + i
                    edges.append((4 * el + 2, dom_of_el(ex, ey), dom_of_el(ex, ey + 1), nodes))
        edges.sort(key=lambda e: e[0])
        seen, pairs = set(), []
        for _, s0, s1, nodes in edges:
            for g in nodes.tolist():
                key = (min(s0, s1), max(s0, s1), g)
                if key not in seen:
                    seen.add(key)
                    pairs.append((s0, s1, g))
        n = len(pairs)
        self.n_lambda = 2 * n
        # local slot of a global node in a subdomain
        loc = {}
        for d in {p[0] for p in pairs} | {p[1] for p in pairs}:
            loc[d] = dict(zip(gI[d].tolist(), range(gI.shape[1])))
        B0 = np.full((self.ndom, len(np.nonzero(slot_of >= 0)[0])), -1, dtype=np.int64)
        B1 = B0.copy()
        for k, (s0, s1, g) in enumerate(pairs):
            j0, j1 = slot_of[loc[s0][g]], slot_of[loc[s1][g]]
            B0[s0, j0], B1[s0, j0] = k, n + k
            B0[s1, j1], B1[s1, j1] = n + k, k
        self.B0 = torch.as_tensor(B0, device=self.device)
        self.B1 = torch.as_tensor(B1, device=self.device)

    # ------------------------------------------------------------ the cycle

    def cycle(self, rows: torch.Tensor, F: torch.Tensor, G: torch.Tensor):
        """The subdomain solve of ``rows`` (R,) subdomain ids with forcings F,
        G (R, nloc): ``wh_maxit`` WaveHoltz iterations; returns (u, v / omega)."""
        Ha, inv_mi = self.Ha[rows], self.inv_mi[rows]
        dt, half = self.dt, 0.5 * self.dt
        cs, sn, filt = self.cs, self.sn, self.filt
        u = torch.zeros_like(F)
        v = torch.zeros_like(F)
        for _ in range(self.wh_maxit):
            p, q = u.clone(), v.clone()
            u.mul_(filt[0])
            v.mul_(filt[0])
            for it in range(1, self.nt + 1):
                z = torch.addcmul(p @ self.S, Ha, q, value=-1.0)
                z.add_(F, alpha=cs[2 * it - 2]).add_(G, alpha=sn[2 * it - 2]).mul_(inv_mi)
                p_half = p - half * q
                q_half = q + half * z
                p.sub_(q_half, alpha=dt)
                z = torch.addcmul(p_half @ self.S, Ha, q_half, value=-1.0)
                z.add_(F, alpha=cs[2 * it - 1]).add_(G, alpha=sn[2 * it - 1]).mul_(inv_mi)
                q.add_(z, alpha=dt)
                u.add_(p, alpha=filt[it])
                v.add_(q, alpha=filt[it])
        return u, v / self.omega

    def _probe_transfer(self) -> torch.Tensor:
        """T[g] (2pf, 2pf): incoming (lambda, mu) at the face slots ->
        (2 a omega v, 2 a omega u) there, for each distinct subdomain."""
        nu, pf, nloc = len(self.uidx), self.pf, self.nloc
        ncol = 2 * pf
        rows = self.uidx.repeat_interleave(ncol)
        F = torch.zeros(nu * ncol, nloc, device=self.device, dtype=self.dtype)
        G = torch.zeros_like(F)
        r = torch.arange(nu * ncol, device=self.device)
        col = r % ncol
        lam = col < pf
        node = self.fnode[col % pf]
        F[r[lam], node[lam]] = self.Hf[col[lam]]
        G[r[~lam], node[~lam]] = self.Hf[col[~lam] - pf]
        u, v = self.cycle(rows, F, G)
        S2 = self.S2[rows]
        out = torch.cat([S2 * v[:, self.fnode], S2 * u[:, self.fnode]], dim=1)
        return out.reshape(nu, ncol, ncol).transpose(1, 2).contiguous()

    # --------------------------------------------------------------- the uses

    def _traces(self, lam: torch.Tensor):
        """(lambda_t, mu_t) at each subdomain's face slots, (K, ndom, pf)."""
        has = self.B0 >= 0
        idx = self.B0.clamp_min(0)
        n = self.n_lambda
        lt = torch.where(has, lam[:, idx], 0.0)
        mt = torch.where(has, lam[:, n + idx], 0.0)
        return lt, mt

    def _scatter(self, upd_l: torch.Tensor, upd_m: torch.Tensor) -> torch.Tensor:
        """Outgoing face values (K, ndom, pf) written at B1: (K, 2 n_lambda)."""
        K, n = upd_l.shape[0], self.n_lambda
        has = self.B1 >= 0
        out = upd_l.new_zeros((K, 2 * n))
        tgt = self.B1[has]
        out[:, tgt] = upd_l[:, has]
        out[:, n + tgt] = upd_m[:, has]
        return out

    def action(self, lam: torch.Tensor) -> torch.Tensor:
        """lambda - S(lambda) for (K, 2 n_lambda)."""
        lt, mt = self._traces(lam)
        Tg = self.T[self.groups]  # (ndom, 2pf, 2pf)
        w = torch.einsum("dij,kdj->kdi", Tg, torch.cat([lt, mt], dim=2))
        return lam - self._scatter(-lt - w[..., :self.pf], -mt + w[..., self.pf:])

    def _forcing(self, f: torch.Tensor):
        """(K, 2 ndof) global forcings -> per-subdomain F, G (K, ndom, nloc)."""
        n = self.grid.ndof
        return f[:, :n][:, self.gI], f[:, n:][:, self.gI]

    def _cycle_all(self, F: torch.Tensor, G: torch.Tensor):
        K = F.shape[0]
        rows = torch.arange(self.ndom, device=self.device).repeat(K)
        u, v = self.cycle(rows, F.reshape(-1, self.nloc), G.reshape(-1, self.nloc))
        return u.reshape(K, self.ndom, -1), v.reshape(K, self.ndom, -1)

    def rhs(self, f: torch.Tensor) -> torch.Tensor:
        F, G = self._forcing(f)
        u, v = self._cycle_all(F, G)
        S2 = self.S2
        return self._scatter(-S2 * v[..., self.fnode], S2 * u[..., self.fnode])

    def postprocess(self, lam: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        F, G = self._forcing(f)
        lt, mt = self._traces(lam)
        F = F.clone()
        G = G.clone()
        F[..., self.fnode] += self.Hf * lt
        G[..., self.fnode] += self.Hf * mt
        u, v = self._cycle_all(F, G)
        K, n = f.shape[0], self.grid.ndof
        y = f.new_zeros((K, 2 * n))
        idx = self.gI.reshape(-1)
        y[:, :n].index_add_(1, idx, (self.M * u).reshape(K, -1))
        y[:, n:].index_add_(1, idx, (self.M * v).reshape(K, -1))
        return y

    def solve(self, f: torch.Tensor, tol: float = 1e-10, m: int = 60, maxit: int = 200,
              strict: bool = True):
        """U (K, 2 ndof) for forcings f (K, 2 ndof): rhs, GMRES on the
        interface system to ``tol`` for each forcing, postprocess.
        ``strict`` raises where GMRES does not reach ``tol``."""
        f = f.to(self.dtype)
        g = self.rhs(f)
        lam = torch.stack([gmres(lambda x: self.action(x[None])[0], gk, tol, m, maxit, strict)
                           for gk in g])
        return self.postprocess(lam, f)


def build(config: dict, grid: Grid, a_nodal: np.ndarray, device, dtype) -> ReferenceDDH:
    """The reference of a configuration on the structured grid: its square
    subdomains of ``block_size`` DOFs a side."""
    c = config
    return ReferenceDDH(grid, c["omega"], a_nodal, c["block_size"], c["wh_maxit"], device, dtype)


def gmres(matvec, b: torch.Tensor, tol: float, m: int, maxit: int,
          strict: bool = True) -> torch.Tensor:
    """Restarted GMRES(m) with two-pass classical Gram-Schmidt; the least
    squares problem of each restart solved on the host in float64.  A
    restart ends where its estimate falls below ``tol`` (a tenth of it with
    ``strict``), the solve where the true residual does; with ``strict`` it
    raises when that never happens."""
    x = torch.zeros_like(b)
    bn = float(b.norm())
    r = b.clone()
    for _ in range(maxit):
        beta = float(r.norm())
        if beta <= tol * bn:
            return x
        V = b.new_zeros((m + 1, b.shape[0]))
        Hm = np.zeros((m + 1, m))
        V[0] = r / beta
        k = 0
        for k in range(m):
            w = matvec(V[k])
            h = V[:k + 1] @ w
            w = w - V[:k + 1].T @ h
            h2 = V[:k + 1] @ w
            w = w - V[:k + 1].T @ h2
            hn = float(w.norm())
            Hm[:k + 1, k] = (h + h2).cpu().numpy()
            Hm[k + 1, k] = hn
            e1 = np.zeros(k + 2)
            e1[0] = beta
            y, *_ = np.linalg.lstsq(Hm[:k + 2, :k + 1], e1, rcond=None)
            est = np.linalg.norm(Hm[:k + 2, :k + 1] @ y - e1)
            if hn == 0.0 or est <= (0.1 if strict else 1.0) * tol * bn:
                break
            V[k + 1] = w / hn
        x = x + V[:k + 1].T @ torch.as_tensor(y, dtype=b.dtype, device=b.device)
        r = b - matvec(x)
    if strict and float(r.norm()) > tol * bn:
        raise RuntimeError(f"reference GMRES reached {float(r.norm()) / bn:.3e}, not {tol:.1e}")
    return x
