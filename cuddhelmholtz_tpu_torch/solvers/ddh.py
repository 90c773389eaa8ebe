"""DDH: substructured domain-decomposition WaveHoltz preconditioner (direct path).

Counterpart of ``cuddhelmholtz_tpu/solvers/ddh.py``.  Each application runs
``wh_maxit`` fixed-point WaveHoltz iterations of a staggered-leapfrog wave
integrator on every subdomain, with impedance coupling on subdomain faces and
transmission variables (lambda, mu) exchanged between face-DOF duals.  GMRES
solves the substructured system ``(I - S) lambda = b`` on the interfaces.

The setup is the JAX package's, in NumPy float64: WaveHoltz tables, the
lambda B-tables with the reference's last-write-wins order, the own-slot
lambda layout and the dense assembled subdomain stiffness.  Device state is
float32.  This is the direct path: every ``action``, ``rhs`` and
``postprocess`` runs one wave cycle (``ops/cuda/wave_cycle.py``; one kernel
launch on a GPU).  The trace-transfer/io precompute, the disk cache and the
coarse space are not ported yet.

The port pads a subdomain to a multiple of ``PAD_MULTIPLE`` = 8 DOFs (169 ->
176 at the flagship) instead of the JAX package's 128, so the fp32 stiffness
(124 KB) fits in one SM's shared memory.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.cuda.wave_cycle import WH_MAXIT, wave_cycle
from ..ops.mass import lumped_mass_diagonal
from ..spaces.ensemble import EnsembleSpace, structured_labels
from ..spaces.h1 import H1Space
from .gmres import GmresResult, gmres

PAD_MULTIPLE = 8


class DDHParams(NamedTuple):
    """Device data of the batched DDH apply (the JAX ``DDHParams`` fields).

    Subdomain rows are (ndom, pad); the trace exchange runs on compact
    (ndom, pf) face-slot arrays.  Index tables are int64 with -1 padding.
    ``K0``, ``dt`` and ``omega`` are the float32 values as Python floats.
    """

    S: torch.Tensor  # (pad, pad) shared or (ndom, pad, pad) per-domain stiffness
    gI: torch.Tensor  # subdomain slot -> global DOF
    gmask: torch.Tensor  # 1.0 where a slot is a real DOF
    F_weight: torch.Tensor  # forcing gather weight
    Ha: torch.Tensor  # a * H (impedance damping)
    inv_mi: torch.Tensor  # 1 / (a^2 m) on real slots, 0 on padding
    m_gmi: torch.Tensor  # m * (global lumped mass)^-1 partition-of-unity weight
    fslot: torch.Tensor  # (ndom, pf): face-space dof -> pad slot
    Hf: torch.Tensor  # (ndom, pf) face mass at face slots
    a2wf: torch.Tensor  # (ndom, pf) 2 a omega at face slots
    B0: torch.Tensor  # (ndom, pf) own lambda id == d*pf + k (-1 none/lost)
    B1: torch.Tensor  # (ndom, pf) dual lambda id, own-slot layout (-1 none)
    tables: torch.Tensor  # (nt, 5): cs_half0, sn_half0, cs_half1, sn_half1, K_t
    K0: float  # half-weighted filter at t=0
    dt: float
    omega: float


_TENSOR_FIELDS = DDHParams._fields[:13]
_ROW_FIELDS = ("gI", "gmask", "F_weight", "Ha", "inv_mi", "m_gmi")  # (ndom, pad)
_INDEX_FIELDS = ("gI", "fslot", "B0", "B1")


def _pad_to(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _f32(x) -> float:
    return float(np.float32(x))


def _assemble_subdomain_stiffness(
    space: H1Space, efem: EnsembleSpace, local_dofs_perm: np.ndarray, pad: int
) -> tuple[np.ndarray, bool]:
    """Dense assembled subdomain stiffness from GLL-collocated factors.

    Returns ``(S, shared)``: one ``(pad, pad)`` matrix with ``shared=True``
    when every subdomain provably assembles the same matrix (identical local
    numbering and element geometry), else the ``(ndom, pad, pad)`` stack.
    """
    nb = space.n_basis
    nb2 = nb * nb
    quad = space.basis.quadrature
    J = space.mesh.element_metrics(quad).jacobians  # (nel, ix, iy, a, b)
    x_xi, x_eta = J[..., 0, 0], J[..., 0, 1]
    y_xi, y_eta = J[..., 1, 0], J[..., 1, 1]
    detj = x_xi * y_eta - x_eta * y_xi
    w2 = np.outer(quad.w, quad.w)
    A = (w2 * (y_eta**2 + x_eta**2) / detj).transpose(0, 2, 1)  # (nel, iy, ix)
    B = (-w2 * (y_xi * y_eta + x_xi * x_eta) / detj).transpose(0, 2, 1)
    C = (w2 * (y_xi**2 + x_xi**2) / detj).transpose(0, 2, 1)
    nel = space.mesh.n_elem
    # the element stiffness is linear in these per-element factors
    G = np.concatenate([A.reshape(nel, nb2), B.reshape(nel, nb2), C.reshape(nel, nb2)], axis=1)
    Kb = _stiffness_factor_basis(space.basis.derivative_matrix)

    ndom = efem.n_domains
    n_elems = efem.n_elems[:ndom]
    mx = local_dofs_perm.shape[1]
    idx = local_dofs_perm.reshape(ndom, mx, nb2)

    ne0 = int(n_elems[0])
    same_shape = bool(np.all(n_elems == ne0)) and bool(np.all(idx[:, :ne0] == idx[0, :ne0]))
    if same_shape:
        gels = efem.elems[:, :ne0]
        shared = bool(
            np.abs(G[gels] - G[gels[0]][None]).max() <= 1e-12 * max(np.abs(G).max(), 1.0)
        )
        if shared:
            S_el0 = (G[gels[0]] @ Kb).reshape(ne0, nb2, nb2)
            S0 = np.zeros((pad, pad))
            for el in range(ne0):
                ix = idx[0, el]
                S0[np.ix_(ix, ix)] += S_el0[el]
            return S0, True

    # general case: one matmul for all element matrices, then one flat
    # scatter-add over all (domain, element) pairs
    S_el = (G @ Kb).reshape(nel, nb2, nb2)
    valid = np.arange(mx)[None, :] < n_elems[:, None]
    gels = np.where(valid, efem.elems[:, :mx], 0)
    vals = S_el[gels] * valid[:, :, None, None]
    ix = np.where(valid[:, :, None], idx, 0)
    dom = np.arange(ndom)[:, None, None, None]
    flat = (dom * pad + ix[:, :, :, None]) * pad + ix[:, :, None, :]
    S = np.zeros(ndom * pad * pad)
    np.add.at(S, flat.reshape(-1), vals.reshape(-1))
    return S.reshape(ndom, pad, pad), False


def _stiffness_factor_basis(D: np.ndarray) -> np.ndarray:
    """(3 nb2, nb2*nb2) matrix mapping collocated factors (A, B, C) to the
    flattened element stiffness: ``S_el = [A B C].flat @ Kb``."""
    nb = D.shape[0]
    nb2 = nb * nb
    eye = np.eye(nb2).reshape(nb2, nb, nb)
    Ux = np.einsum("qk,blk->blq", D, eye)  # du/dxi  at (l, qx)
    Uy = np.einsum("ql,blk->bqk", D, eye)  # du/deta at (qy, k)
    Z = np.zeros((nb2, nb, nb))
    Af = np.concatenate([eye, Z, Z])
    Bf = np.concatenate([Z, eye, Z])
    Cf = np.concatenate([Z, Z, eye])
    fx = Af[:, None] * Ux[None] + Bf[:, None] * Uy[None]
    fy = Bf[:, None] * Ux[None] + Cf[:, None] * Uy[None]
    out = np.einsum("qk,gblq->gblk", D, fx) + np.einsum("ql,gbqk->gblk", D, fy)
    # rows = (l, k) test index, columns = b trial index
    return out.reshape(3 * nb2, nb2, nb2).transpose(0, 2, 1).reshape(3 * nb2, -1)


def _to_device(arrays: dict, device) -> dict:
    out = {}
    for name in _TENSOR_FIELDS:
        dtype = torch.int64 if name in _INDEX_FIELDS else torch.float32
        out[name] = torch.tensor(np.asarray(arrays[name]), dtype=dtype, device=device)
    return out


def ddh_params_from_jax(arrays: dict[str, np.ndarray], pad: int, device) -> DDHParams:
    """The port's ``DDHParams`` from the JAX package's ``DDHParams`` fields.

    ``arrays`` maps each field name to a NumPy array.  Subdomain rows and S
    are re-padded from the JAX pad to ``pad``: cut when ``pad`` is smaller
    (the cut slots must be padding) or extended with padding when larger.
    """
    gI = np.asarray(arrays["gI"])
    old = gI.shape[1]
    if pad < old and (gI[:, pad:] >= 0).any():
        raise ValueError(f"pad={pad} would cut real subdomain slots (pad {old})")
    host = {}
    for name in _TENSOR_FIELDS:
        a = np.asarray(arrays[name])
        if name in _ROW_FIELDS:
            if pad <= old:
                a = a[:, :pad]
            else:
                fill = -1 if name == "gI" else 0
                a = np.pad(a, ((0, 0), (0, pad - old)), constant_values=fill)
        elif name == "S":
            lead = [(0, 0)] * (a.ndim - 2)
            a = a[..., :pad, :pad] if pad <= old else np.pad(a, lead + [(0, pad - old)] * 2)
        host[name] = a
    return DDHParams(
        **_to_device(host, device),
        K0=_f32(arrays["K0"]),
        dt=_f32(arrays["dt"]),
        omega=_f32(arrays["omega"]),
    )


class DDH(nn.Module):
    """The substructured DDH operator for an H1 space.

    For structured meshes pass ``nx``, ``ny`` (square subdomains of
    ``block_size`` DOFs per side); otherwise pass ``element_labels``.  The
    device tensors are buffers on ``device``; ``forward(lam)`` is the action.
    """

    def __init__(
        self,
        omega: float,
        a_nodal: np.ndarray,
        space: H1Space,
        nx: int | None = None,
        ny: int | None = None,
        element_labels: np.ndarray | None = None,
        n_domains: int | None = None,
        block_size: int = 16,
        nt_override: int | None = None,
        wh_maxit: int = WH_MAXIT,
        *,
        device,
    ):
        super().__init__()
        nb = space.n_basis
        mesh = space.mesh

        if element_labels is None:
            if nx is None or ny is None:
                raise ValueError("need nx, ny (structured) or element_labels")
            epd = block_size // nb
            if epd < 1 or block_size % nb:
                raise ValueError("block_size must be a multiple of n_basis")
            element_labels, n_domains = structured_labels(nx, ny, epd, epd)
        elif n_domains is None:
            n_domains = int(np.max(element_labels)) + 1

        efem = EnsembleSpace(space, n_domains, element_labels)
        self.efem = efem
        self.space = space
        self.omega = float(omega)
        self.g_ndof = space.ndof
        self.n_domains = n_domains
        self.wh_maxit = int(wh_maxit)

        # --- WaveHoltz time grid and filter ---------------------------------
        T = 2 * np.pi / omega
        dt = 0.2 * 0.5 * mesh.min_h() / (nb * nb)
        nt = int(np.ceil(T / dt)) if nt_override is None else int(nt_override)
        dt = T / nt
        self.nt = nt
        self.dt = dt
        k = np.arange(nt + 1)
        filt = dt * (omega / np.pi) * (np.cos(omega * k * dt) - 0.25)
        filt[0] *= 0.5
        filt[nt] *= 0.5
        th = 0.5 * np.arange(2 * nt + 1) * dt
        cs = -np.cos(omega * th)
        sn = np.sin(omega * th)
        it = np.arange(1, nt + 1)
        tables = np.stack(
            [cs[2 * it - 2], sn[2 * it - 2], cs[2 * it - 1], sn[2 * it - 1], filt[it]], axis=1
        )

        # --- lambda numbering: dual-trace B tables from cmap -----------------
        # The reference fills B row by row over cmap (side 0, then side 1 of
        # row k, k ascending); at corner slots touched by several rows the
        # LAST write in that interleaved order wins.  Stamp each write with
        # its sequence number and keep the max per slot.
        n_shared = efem.n_shared_dofs
        mx_fdof = efem.mx_fdof
        B = np.full((n_domains, mx_fdof, 2), -1, dtype=np.int32)
        cm = efem.cmap
        if n_shared > 0:
            k = np.arange(n_shared, dtype=np.int64)
            slots = np.empty(2 * n_shared, dtype=np.int64)
            slots[0::2] = cm[:, 0].astype(np.int64) * mx_fdof + cm[:, 2]
            slots[1::2] = cm[:, 1].astype(np.int64) * mx_fdof + cm[:, 3]
            order = np.arange(2 * n_shared, dtype=np.int64)
            last = np.full(n_domains * mx_fdof, -1, dtype=np.int64)
            np.maximum.at(last, slots, order)
            win = last[slots] == order
            val0 = np.empty(2 * n_shared, dtype=np.int64)  # B(., 0): own trace
            val0[0::2] = k
            val0[1::2] = n_shared + k
            val1 = np.empty(2 * n_shared, dtype=np.int64)  # B(., 1): dual trace
            val1[0::2] = n_shared + k
            val1[1::2] = k
            B.reshape(-1, 2)[slots[win], 0] = val0[win]
            B.reshape(-1, 2)[slots[win], 1] = val1[win]

        # --- own-slot lambda layout ------------------------------------------
        # A surviving lambda's id IS its compact face-slot position d*pf + k,
        # so reading the own traces is a reshape.  Ids overwritten at corner
        # slots (last-write-wins) are appended as a tail: written by duals,
        # never read.
        own = B[:, :, 0].reshape(-1)
        validslot = own >= 0
        n_own = n_domains * mx_fdof
        newid = np.full(2 * n_shared, -1, dtype=np.int64)
        newid[own[validslot]] = np.nonzero(validslot)[0]
        lost = np.nonzero(newid < 0)[0]
        newid[lost] = n_own + np.arange(lost.size)
        self.n_own = n_own
        self.n_lost = int(lost.size)
        self.n_lambda = n_own + self.n_lost
        # reference-numbering id -> own-slot id (maps trace vectors between
        # the two layouts in the reference-oracle tests)
        self.lambda_newid = newid.copy()
        if n_shared > 0:
            B = np.where(B >= 0, newid[np.maximum(B, 0)], -1).astype(np.int32)

        # --- DOF layout: face data embedded at natural subspace slots --------
        mx_dof = efem.mx_ndof
        pad = _pad_to(mx_dof, PAD_MULTIPLE)
        self.pad = pad
        gI = np.full((n_domains, pad), -1, dtype=np.int32)
        gI[:, :mx_dof] = efem.gI
        local_dofs_perm = efem.local_dofs

        # --- subdomain operators --------------------------------------------
        quad = space.basis.quadrature
        detj = mesh.element_metrics(quad).measures.transpose(0, 2, 1)  # (nel, iy, ix)
        w2 = np.outer(quad.w, quad.w)

        # lumped subdomain mass: one flat scatter-add over (domain, element)
        emask = efem.elems >= 0
        gels = np.maximum(efem.elems, 0)
        mvals = (w2[None, None] * detj[gels]) * emask[:, :, None, None]
        mslots = np.maximum(local_dofs_perm, 0)
        mflat = np.arange(n_domains, dtype=np.int64)[:, None, None, None] * pad + mslots
        m_sub = np.zeros(n_domains * pad)
        np.add.at(m_sub, mflat.reshape(-1), mvals.reshape(-1))
        m_sub = m_sub.reshape(n_domains, pad)

        gmi = 1.0 / lumped_mass_diagonal(space)
        a_nodal = np.asarray(a_nodal, dtype=np.float64)
        valid = gI >= 0
        a_sub = np.where(valid, a_nodal[np.maximum(gI, 0)], 0.0)
        gmi_sub = np.where(valid, gmi[np.maximum(gI, 0)], 0.0)

        # face damping H: flat scatter-add over (domain, face, node)
        H_sub = np.zeros(n_domains * pad)
        edge_meas = 0.5 * mesh.edge_lengths()
        if efem.mx_faces > 0:
            es = np.maximum(efem.faces, 0)
            fvals = edge_meas[es][:, :, None] * quad.w[None, None, :]
            ok = efem.fI >= 0
            fvals = np.where(ok, fvals, 0.0).reshape(n_domains, -1)
            fidx = np.maximum(efem.fI, 0).reshape(n_domains, -1)
            fslots = np.take_along_axis(efem.pI, fidx, axis=1)
            fslots = np.where(ok.reshape(n_domains, -1), np.maximum(fslots, 0), 0)
            fflat = np.arange(n_domains, dtype=np.int64)[:, None] * pad + fslots
            np.add.at(H_sub, fflat.reshape(-1), fvals.reshape(-1))
        H_sub = H_sub.reshape(n_domains, pad)

        with np.errstate(divide="ignore"):
            inv_mi = np.where(valid, 1.0 / (a_sub**2 * np.where(valid, m_sub, 1.0)), 0.0)

        S, shared = _assemble_subdomain_stiffness(space, efem, local_dofs_perm, pad)
        if shared or n_domains == 1:
            self.shared_S = True
            S_dev = S if S.ndim == 2 else S[0]
        else:
            # numeric detection via two random matvec probes; agreement below
            # fp32 resolution counts as identical
            scale = np.abs(S[0]).max() or 1.0
            probes = np.random.default_rng(0).standard_normal((pad, 2))
            sp = S @ probes
            self.shared_S = bool(
                np.abs(sp - sp[0]).max() < 1e-6 * scale * np.abs(probes).max() * pad
            )
            S_dev = S[0] if self.shared_S else S

        # compact trace-exchange tables over face-space DOFs (pf = mx_fdof)
        fslot = efem.pI[:, :mx_fdof].astype(np.int32, copy=True)
        fs_safe = np.maximum(fslot, 0)
        Hf = np.where(fslot >= 0, np.take_along_axis(H_sub, fs_safe, axis=1), 0.0)
        a2wf = np.where(
            fslot >= 0, 2.0 * omega * np.take_along_axis(a_sub, fs_safe, axis=1), 0.0
        )

        # the full global rhs row feeds every subdomain that touches it (the
        # reference's forcing; the JAX package's rhs_split="mass" is not ported)
        host = {
            "S": S_dev, "gI": gI, "gmask": valid, "F_weight": valid,
            "Ha": H_sub * a_sub, "inv_mi": inv_mi, "m_gmi": m_sub * gmi_sub,
            "fslot": fslot, "Hf": Hf, "a2wf": a2wf, "B0": B[:, :, 0], "B1": B[:, :, 1],
            "tables": tables,
        }
        for name, t in _to_device(host, device).items():
            self.register_buffer(name, t)
        self.K0 = _f32(filt[0])
        self.dt32 = _f32(dt)
        self.omega32 = _f32(omega)

    @property
    def params(self) -> DDHParams:
        return DDHParams(
            **{name: getattr(self, name) for name in _TENSOR_FIELDS},
            K0=self.K0,
            dt=self.dt32,
            omega=self.omega32,
        )

    @property
    def size(self) -> int:
        """DOFs of the substructured problem: (lambda, mu) pairs."""
        return 2 * self.n_lambda

    def forward(self, lam: torch.Tensor) -> torch.Tensor:
        return self.action(lam)

    def action(self, lam: torch.Tensor) -> torch.Tensor:
        """y = lambda - S(lambda): the GMRES operator."""
        return ddh_action(self.params, lam, n_own=self.n_own, wh_maxit=self.wh_maxit)

    def rhs(self, f: torch.Tensor) -> torch.Tensor:
        """Substructured rhs from the Helmholtz forcing."""
        return ddh_rhs(self.params, f, self.g_ndof, self.n_lambda, wh_maxit=self.wh_maxit)

    def postprocess(self, lam: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """Recover the [u; v] solution."""
        return ddh_postprocess(
            self.params, lam, f, self.g_ndof, n_own=self.n_own, wh_maxit=self.wh_maxit
        )

    def solver(self, m: int, maxit: int, tol: float):
        """The whole solve, b -> (GmresResult, U): rhs, lambda-GMRES(m),
        postprocess."""

        def run(b: torch.Tensor) -> tuple[GmresResult, torch.Tensor]:
            Y = self.rhs(b)
            out = gmres(self.action, Y, m=m, maxit=maxit, tol=tol)
            return out, self.postprocess(out.x, b)

        return run


# ---------------------------------------------------------------- the apply


def _read_traces(params: DDHParams, lam: torch.Tensor, n_lambda: int, n_own: int):
    """Own-side compact traces (lam0, mu0): masked reshapes of lam."""
    ndom, pf = params.B0.shape
    lam0 = lam[:n_own].reshape(ndom, pf)
    mu0 = lam[n_lambda:n_lambda + n_own].reshape(ndom, pf)
    has = params.B0 >= 0
    return torch.where(has, lam0, 0.0), torch.where(has, mu0, 0.0)


def _forcing(params: DDHParams, x, lam, g_ndof: int, n_own: int | None = None):
    """Gather forcing and lambda traces into subdomain slots: F, G (ndom, pad)
    and the compact own traces lam0, mu0 (ndom, pf)."""
    gI = params.gI.clamp_min(0)
    if x is not None:
        x = x.to(params.gmask.dtype)
        F = params.F_weight * x[gI]
        G = params.F_weight * x[g_ndof + gI]
    else:
        F = torch.zeros_like(params.gmask)
        G = torch.zeros_like(params.gmask)
    if lam is not None and lam.shape[0] > 0:
        lam0, mu0 = _read_traces(params, lam, lam.shape[0] // 2, n_own)
        # H*lam0 at the face slots; padded face slots carry Hf == 0, so their
        # clamped slot-0 adds are exact no-ops
        ndom, pad = F.shape
        rows = torch.arange(ndom, device=F.device)[:, None] * pad
        flat = (rows + params.fslot.clamp_min(0)).reshape(-1)
        F = F.reshape(-1).index_add(0, flat, (params.Hf * lam0).reshape(-1)).reshape(ndom, pad)
        G = G.reshape(-1).index_add(0, flat, (params.Hf * mu0).reshape(-1)).reshape(ndom, pad)
    else:
        lam0 = torch.zeros_like(params.Hf)
        mu0 = torch.zeros_like(params.Hf)
    return F, G, lam0, mu0


def _scatter_updates(params: DDHParams, lam0, mu0, u, v, n_lambda: int) -> torch.Tensor:
    """Transmission update written to the dual trace slots.  The valid B1 ids
    are unique, so the write order of the scatter does not matter; invalid
    slots all write 0 to a dropped extra entry."""
    fs = params.fslot.clamp_min(0)
    uf = u.gather(1, fs)
    vf = v.gather(1, fs)
    has = params.B1 >= 0
    idx = torch.where(has, params.B1, n_lambda).reshape(-1)
    out = torch.zeros((2, n_lambda + 1), dtype=u.dtype, device=u.device)
    out[0, idx] = torch.where(has, -lam0 - params.a2wf * vf, 0.0).reshape(-1)
    out[1, idx] = torch.where(has, -mu0 + params.a2wf * uf, 0.0).reshape(-1)
    return out[:, :n_lambda].reshape(-1)


def _scatter_solution(params: DDHParams, u, v, g_ndof: int) -> torch.Tensor:
    """Mass-weighted scatter-add of the subdomain solutions (atomic on a
    GPU, so the summation order varies from run to run)."""
    w = params.m_gmi
    idx = torch.where(params.gI >= 0, params.gI, g_ndof).reshape(-1)
    y = torch.zeros((2, g_ndof + 1), dtype=u.dtype, device=u.device)
    y[0].index_add_(0, idx, (w * u).reshape(-1))
    y[1].index_add_(0, idx, (w * v).reshape(-1))
    return y[:, :g_ndof].reshape(-1)


def ddh_action(
    params: DDHParams,
    lam: torch.Tensor,
    n_own: int | None = None,
    wh_maxit: int = WH_MAXIT,
    cycle: Callable = wave_cycle,
) -> torch.Tensor:
    """lambda - S(lambda): fixed-point form of the substructured system.
    ``cycle`` is the wave cycle to run (the kernel wrapper by default)."""
    n_lambda = lam.shape[0] // 2
    if n_own is None:
        n_own = params.B0.numel()
    F, G, lam0, mu0 = _forcing(params, None, lam, 0, n_own)
    u, v = cycle(params, F, G, wh_maxit)
    v = v / params.omega
    return lam - _scatter_updates(params, lam0, mu0, u, v, n_lambda)


def ddh_rhs(
    params: DDHParams,
    f: torch.Tensor,
    g_ndof: int,
    n_lambda: int,
    wh_maxit: int = WH_MAXIT,
    cycle: Callable = wave_cycle,
) -> torch.Tensor:
    """b: transmission traces generated by the volume forcing alone."""
    F, G, lam0, mu0 = _forcing(params, f, None, g_ndof)
    u, v = cycle(params, F, G, wh_maxit)
    v = v / params.omega
    return _scatter_updates(params, lam0, mu0, u, v, n_lambda)


def ddh_postprocess(
    params: DDHParams,
    lam: torch.Tensor,
    f: torch.Tensor,
    g_ndof: int,
    n_own: int | None = None,
    wh_maxit: int = WH_MAXIT,
    cycle: Callable = wave_cycle,
) -> torch.Tensor:
    """Recover [u; v] from the substructured solution and the forcing."""
    if n_own is None:
        n_own = params.B0.numel()
    F, G, _, _ = _forcing(params, f, lam, g_ndof, n_own)
    u, v = cycle(params, F, G, wh_maxit)
    v = v / params.omega
    return _scatter_solution(params, u, v, g_ndof)
