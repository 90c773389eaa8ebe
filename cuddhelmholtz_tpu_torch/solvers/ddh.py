"""DDH: substructured domain-decomposition WaveHoltz preconditioner.

Counterpart of ``cuddhelmholtz_tpu/solvers/ddh.py``.  Each application runs
``wh_maxit`` fixed-point WaveHoltz iterations of a staggered-leapfrog wave
integrator on every subdomain, with impedance coupling on subdomain faces and
transmission variables (lambda, mu) exchanged between face-DOF duals.  GMRES
solves the substructured system ``(I - S) lambda = b`` on the interfaces.

The setup is the JAX package's, in NumPy float64: WaveHoltz tables, the
lambda B-tables with the reference's last-write-wins order, the own-slot
lambda layout and the dense assembled subdomain stiffness.  Device state is
float32 (``DDH(dtype=)``: float64 runs the plain cycle on the CPU; the
kernels take float32 only).  Two paths:

  * direct (upstream's own algorithm; no ``prepare``, no maps): every
    ``action``, ``rhs`` and ``postprocess`` runs one wave cycle
    (``ops/cuda/wave_cycle.py``; one kernel launch on a GPU);
  * transfer/io (``prepare``): one-hot probe columns go through the wave
    cycle once per unique subdomain, giving the per-subdomain trace-transfer
    matrices (``precompute_transfer``) and the rhs/postprocess maps
    (``precompute_io_maps``); the solve then runs no wave cycle, only
    batched matmuls and the trace exchange (rolled, or one scatter).

``prepare`` keeps the precomputed maps (and a coarse space built later) in
a disk cache keyed by a hash of the cycle data, so a repeat run of a
configuration loads them and runs no probe.  On a row-major grid numbering
(``GridH1Space``) the io maps run through window patches (``patch_io``):
the forcing gather is one ``unfold`` and the solution assembly one
``fold``.  ``make_coarse`` and ``solver(coarse=...)`` add the two-level
plane-wave coarse correction of ``solvers/coarse.py``.

The port pads a subdomain to a multiple of ``PAD_MULTIPLE`` = 8 DOFs (169 ->
176 at the flagship, 625 -> 632 with 32-DOF blocks) instead of the JAX
package's 128.  On the card each wave cycle runs a ``K1`` kernel that
``ops/cuda/wave_cycle.py::k1_kernel`` chose for S and the operator's
``element_factors`` (what ``_assemble_subdomain_stiffness`` sums S from),
with the form of S it reads.  The operator holds two, each built on first
use and handed to every later cycle: ``k1`` for its own cycles (the rule's kernel for a
shared S, the per-row one for a per-domain S) and ``k1_probe`` for its
probes (``k1`` for a shared S; for a per-domain S the rule's kernel for
the unique subdomains' matrices).

On the card the transfer apply is host-bound: about 40 small launches
whose device work is a tenth of their host time.  ``action`` therefore
replays it as one CUDA graph for each input shape and dtype
(``_ApplyGraph``), captured on the first apply of that shape and kept on
the operator until a tensor it reads is replaced (``prepare``,
``set_io_maps``, a reassignment of the route, the transfer stack, a device
buffer or ``use_transfer``, a ``.to(...)``).  A CPU tensor and the direct
path run eagerly.

Spans (``utils/spans.py``): ``ddh.init`` (the constructor), ``ddh.prepare``
and in it ``ddh.groups``, ``ddh.probe`` (one per probe chunk), ``ddh.route``
and ``ddh.io_maps``; ``ddh.solve`` (one ``solver`` run), ``ddh.rhs``,
``ddh.action``, ``ddh.postprocess`` and ``ddh.precond`` (one application
of ``DDHPreconditioner``).  Counters: ``ddh.action.direct`` (each direct
apply, one wave cycle), ``ddh.action.graphed`` (each replay),
``ddh.action.eager`` (each eager transfer apply) and ``ddh.action.captures``
(each capture).
"""

from __future__ import annotations

import hashlib
import os
import time
import zipfile
from collections import defaultdict
from typing import Callable, NamedTuple

import numpy as np
import torch
from torch import nn

from ..ops.cuda.wave_cycle import (
    K1,
    ROWS_PER_BLOCK,
    WH_MAXIT,
    ElementFactors,
    k1_kernel,
    wave_cycle,
)
from ..ops.mass import assembly_table, lumped_mass_diagonal
from ..spaces.ensemble import EnsembleSpace, structured_labels
from ..spaces.h1 import H1Space
from ..utils.debug import check_finite, check_index_table
from ..utils.device import check_device  # noqa: F401 (re-exported to the drivers)
from ..utils.graphs import capture
from ..utils.spans import count, span, spanned
from .gmres import (
    BlockGmresResult,
    GmresResult,
    LockstepResult,
    block_gmres,
    fgmres,
    gmres,
    gmres_lockstep,
)

PAD_MULTIPLE = 8
# probe columns go through the cycle in chunks of at most this many state
# elements per (rows, pad) array: 128 MB of float32
PROBE_STATE_ELEMS = 1 << 25
# version of the setup cache's file layout and key (the port's own: its
# entries never share a key with the JAX package's)
CACHE_FORMAT_VERSION = 1
# the setup cache's directory when neither ``prepare(cache_dir=)`` nor
# CUDDH_CACHE_DIR names one: ``.ddh_cache_torch/`` at the repository root
DEFAULT_CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".ddh_cache_torch",
)
_IO_FIELDS = ("Pu", "Pv", "R", "Pul", "Pvl")


class DDHParams(NamedTuple):
    """Device data of the batched DDH apply (the JAX ``DDHParams`` fields).

    Subdomain rows are (ndom, pad); the trace exchange runs on compact
    (ndom, pf) face-slot arrays.  Index tables are int64 with -1 padding.
    ``K0``, ``dt`` and ``omega`` are the values in the compute dtype as Python
    floats.
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
    sol_table: torch.Tensor  # (g_ndof, k) ``assembly_table`` of gI (the port's own)
    K0: float  # half-weighted filter at t=0
    dt: float
    omega: float


_TENSOR_FIELDS = DDHParams._fields[:13]  # the JAX package's tensor fields
_ROW_FIELDS = ("gI", "gmask", "F_weight", "Ha", "inv_mi", "m_gmi")  # (ndom, pad)
_INDEX_FIELDS = ("gI", "fslot", "B0", "B1")
# the DDH attributes a captured transfer apply reads or depends on: assigning
# one empties the operator's cache of graphs
_GRAPH_READS = frozenset((*_TENSOR_FIELDS, "sol_table", "K0", "dt32", "omega32",
                          "use_transfer", "route", "_T_u", "_T_groups", "_T_dev"))


def _pad_to(n: int, mult: int) -> int:
    return max(mult, ((n + mult - 1) // mult) * mult)


def _f32(x) -> float:
    return float(np.float32(x))


def _assemble_subdomain_stiffness(
    space: H1Space, efem: EnsembleSpace, local_dofs_perm: np.ndarray, pad: int
) -> tuple[np.ndarray, bool, ElementFactors]:
    """Dense assembled subdomain stiffness from GLL-collocated factors.

    Returns ``(S, shared, factors)``: one ``(pad, pad)`` matrix with
    ``shared=True`` when every subdomain provably assembles the same matrix
    (identical local numbering and element geometry), else the ``(ndom,
    pad, pad)`` stack; and the ``ElementFactors`` S is summed from (the
    derivative matrix, each element's A, B, C and its nodes' slots), one
    group for the shared S, else one a subdomain.
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
    D = np.asarray(space.basis.derivative_matrix, dtype=np.float64)
    Kb = _stiffness_factor_basis(D)

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
            factors = ElementFactors(D, G[gels[0]].reshape(1, ne0, 3, nb2), idx[:1, :ne0])
            return S0, True, factors

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
    factors = ElementFactors(D, (G[gels] * valid[:, :, None]).reshape(ndom, mx, 3, nb2),
                             np.where(valid[:, :, None], idx, -1))
    return S.reshape(ndom, pad, pad), False, factors


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


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _to_device(arrays: dict, device, dtype=torch.float32) -> dict:
    """The device tensors of ``DDHParams``: the JAX package's fields from
    ``arrays`` (floats in ``dtype``) and the solution assembly table built
    from its ``gI``."""
    out = {}
    for name in _TENSOR_FIELDS:
        t = torch.int64 if name in _INDEX_FIELDS else dtype
        out[name] = torch.tensor(np.asarray(arrays[name]), dtype=t, device=device)
    gI = np.asarray(arrays["gI"])
    out["sol_table"] = torch.as_tensor(assembly_table(gI, int(gI.max()) + 1), device=device)
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


def load_jax_maps(ddh: "DDH", maps: dict[str, np.ndarray], jax_pad: int) -> None:
    """Install the JAX package's precomputed maps in a port ``DDH``.

    ``maps`` holds NumPy arrays under the JAX names: ``T_u`` (nu, 2pf, 2pf)
    and ``groups`` (ndom,), and optionally the io maps ``Pu``, ``Pv`` (nu,
    jax_pad, 2 jax_pad), ``R`` (nu, 2pf, 2 jax_pad), ``Pul``, ``Pvl`` (nu,
    jax_pad, 2pf).  Their slot axes are cut from ``jax_pad`` to the port's
    pad (a multiple of 8, never above the JAX package's multiple of 128).
    """
    pad = ddh.pad
    if pad > jax_pad:
        raise ValueError(f"the port's pad {pad} exceeds the JAX pad {jax_pad}")

    def slots(a, axis):  # one slot axis of length jax_pad -> pad
        return np.take(np.asarray(a), np.arange(pad), axis=axis)

    def fg_cols(a):  # the [F | G] input axis of length 2 jax_pad -> 2 pad
        a = np.asarray(a)
        return np.concatenate([slots(a[..., :jax_pad], -1), slots(a[..., jax_pad:], -1)], -1)

    groups = np.asarray(maps["groups"]).reshape(-1)
    ddh.set_transfer(maps["T_u"], groups)
    if "Pu" in maps:
        ddh.set_io_maps(
            fg_cols(slots(maps["Pu"], 1)), fg_cols(slots(maps["Pv"], 1)), fg_cols(maps["R"]),
            slots(maps["Pul"], 1), slots(maps["Pvl"], 1), groups,
        )


class DDH(nn.Module):
    """The substructured DDH operator for an H1 space.

    For structured meshes pass ``nx``, ``ny`` (square subdomains of
    ``block_size`` DOFs per side); otherwise pass ``element_labels``.  The
    device tensors are buffers on ``device``; ``forward(lam)`` is the action.
    ``rhs_split`` is the forcing split across subdomains: ``"full"`` (the
    reference's) or ``"mass"`` (by the partition-of-unity mass weight).
    """

    @spanned("ddh.init")
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
        rhs_split: str = "full",
        *,
        device="cuda",
        dtype=torch.float32,
    ):
        super().__init__()
        self._drop_graphs()
        device = check_device(device)
        if rhs_split not in ("full", "mass"):
            raise ValueError("rhs_split must be 'full' or 'mass'")
        self.rhs_split = rhs_split
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

        S, shared, factors = _assemble_subdomain_stiffness(space, efem, local_dofs_perm, pad)
        if shared or n_domains == 1:
            self.shared_S = True
            S_dev = S if S.ndim == 2 else S[0]
            factors = factors.take([0])
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
            if self.shared_S:
                factors = factors.take([0])
        # what S is summed from, kept for the factored K1 kernel (``k1``)
        self.element_factors = factors

        # compact trace-exchange tables over face-space DOFs (pf = mx_fdof)
        fslot = efem.pI[:, :mx_fdof].astype(np.int32, copy=True)
        fs_safe = np.maximum(fslot, 0)
        Hf = np.where(fslot >= 0, np.take_along_axis(H_sub, fs_safe, axis=1), 0.0)
        a2wf = np.where(
            fslot >= 0, 2.0 * omega * np.take_along_axis(a_sub, fs_safe, axis=1), 0.0
        )

        # host copies for the dedup and cache keys, the transfer route and
        # io maps, and the coarse-space assembly
        self._fslot_np = fslot
        self._Hf_np = Hf
        self._B0_np = B[:, :, 0].copy()
        self._B1_np = B[:, :, 1].copy()
        self._gI_np = gI
        self._Ha_np = H_sub * a_sub
        self._mi_np = inv_mi
        self._a2wf_np = a2wf
        self._S_np = S_dev
        self._tables_np = tables
        self._groups = None
        self._setup_key: str | None = None
        # transfer/io state (``prepare``): the deduped host transfer stack
        # _T_u with its group vector; the full per-domain stack ``T`` is
        # expanded on first use (the rolled exchange never reads it)
        self._T_u: np.ndarray | None = None
        self._T_groups: np.ndarray | None = None
        self._T_dev: torch.Tensor | None = None
        self.use_transfer = False
        self.route: RollRoute | None = None
        self.io: IOMaps | None = None
        self._patch: tuple | None = None  # (PatchIO, pshape) or (None, None), built lazily
        self.coarse_space = None  # CoarseSpace | SparseCoarseSpace (``make_coarse``)
        self._coarse_meta: tuple | None = None
        self.coarse_solve = (40, 4, 1e-3)  # (m, maxit, tol) of an iterative coarse solve
        self._cache_dir: str | None = None  # set by ``prepare``; ``make_coarse`` saves there
        self.transfer_stats: dict = {}
        self.io_stats: dict = {}

        # forcing split across subdomains: "full" feeds the full global rhs
        # row to every subdomain that touches it (the reference's forcing,
        # which double-counts interface loads); "mass" splits it by the
        # partition-of-unity weight m_p / m, so interface rows sum exactly
        F_weight = m_sub * gmi_sub if rhs_split == "mass" else valid

        # CUDDH_DEBUG audit of the apply path's index tables: the apply masks
        # their -1 padding, so a corrupted entry would otherwise go unnoticed
        check_index_table("DDH.gI", gI, self.g_ndof)
        check_index_table("DDH.fslot", fslot, pad)
        check_index_table("DDH.B0", B[:, :, 0], self.n_lambda)
        check_index_table("DDH.B1", B[:, :, 1], self.n_lambda)

        host = {
            "S": S_dev, "gI": gI, "gmask": valid, "F_weight": F_weight,
            "Ha": H_sub * a_sub, "inv_mi": inv_mi, "m_gmi": m_sub * gmi_sub,
            "fslot": fslot, "Hf": Hf, "a2wf": a2wf, "B0": B[:, :, 0], "B1": B[:, :, 1],
            "tables": tables,
        }
        for name, t in _to_device(host, device, dtype).items():
            self.register_buffer(name, t)
        self._k1: K1 | None = None
        self._k1_probe: K1 | None = None
        self.k1_seconds: float | None = None  # build time of k1
        # K0, dt and omega rounded to the compute dtype, as the JAX package's
        # dtype scalars
        self._np_dtype = torch.empty((), dtype=dtype).numpy().dtype
        self.K0 = float(self._np_dtype.type(filt[0]))
        self.dt32 = float(self._np_dtype.type(dt))
        self.omega32 = float(self._np_dtype.type(omega))

    @property
    def params(self) -> DDHParams:
        return DDHParams(
            **{name: getattr(self, name) for name in (*_TENSOR_FIELDS, "sol_table")},
            K0=self.K0,
            dt=self.dt32,
            omega=self.omega32,
        )

    @property
    def k1(self) -> K1:
        """The K1 kernel of this operator's cycles and the form of S it
        reads (``k1_kernel``, given the operator's ``element_factors``): the
        rule's kernel for a shared S, the per-row one for a per-domain S.
        Built on first use (timed in ``k1_seconds``) and kept for every
        later cycle."""
        if self._k1 is None:
            t0 = time.perf_counter()
            self._k1 = k1_kernel(self.S, per_row=self.S.dim() == 3,
                                 factors=self.element_factors)
            _sync(self.S.device)
            self.k1_seconds = time.perf_counter() - t0
        return self._k1

    @property
    def k1_probe(self) -> K1:
        """The K1 kernel of this operator's probes: ``k1`` for a shared S;
        for a per-domain S the rule's kernel for the unique subdomains'
        matrices (``_domain_groups``), built on first use."""
        if self.S.dim() == 2:
            return self.k1
        if self._k1_probe is None:
            uidx, _, _ = self._domain_groups()
            self._k1_probe = k1_kernel(self.S, torch.as_tensor(uidx, device=self.S.device),
                                       factors=self.element_factors)
        return self._k1_probe

    @property
    def size(self) -> int:
        """DOFs of the substructured problem: (lambda, mu) pairs."""
        return 2 * self.n_lambda

    @property
    def T(self) -> torch.Tensor | None:
        """Full per-domain trace-transfer stack (ndom, 2pf, 2pf), expanded
        from the deduped form on first access."""
        if self._T_dev is None and self._T_u is not None:
            self._T_dev = torch.as_tensor(self._T_u[self._T_groups], device=self.gmask.device)
        return self._T_dev

    def __setattr__(self, name, value):
        if name in _GRAPH_READS:
            self._drop_graphs()
        super().__setattr__(name, value)

    def _apply(self, *args, **kwargs):
        # ``.to(...)``, ``.cuda()``, ``.float()``: the buffers are replaced
        self._drop_graphs()
        return super()._apply(*args, **kwargs)

    def _drop_graphs(self) -> None:
        """Empty the cache of captured transfer applies (and let their
        memory pool go with them)."""
        self._graphs: dict = {}
        self._graph_pool = None

    def forward(self, lam: torch.Tensor) -> torch.Tensor:
        return self.action(lam)

    @spanned("ddh.action")
    def action(self, lam: torch.Tensor) -> torch.Tensor:
        """y = lambda - S(lambda): the GMRES operator.  On the direct path
        (no ``prepare``) one wave cycle, counted ``ddh.action.direct``.  On
        the transfer path a CUDA tensor replays the apply's graph for its
        shape and dtype, captured on the first such apply; a CPU tensor runs
        it eagerly."""
        check_finite("DDH.action input", lam)
        if not self.use_transfer:
            count("ddh.action.direct")
            return ddh_action(self.params, lam, n_own=self.n_own, wh_maxit=self.wh_maxit,
                              cycle=self._cycle)
        if not lam.is_cuda:
            count("ddh.action.eager")
            return self._transfer_apply()(lam)
        key = (tuple(lam.shape), lam.dtype)
        graph = self._graphs.get(key)
        if graph is None:
            if self._graph_pool is None:
                self._graph_pool = torch.cuda.graph_pool_handle()
            graph = self._graphs[key] = _ApplyGraph(self._transfer_apply(), lam,
                                                    self._graph_pool)
            count("ddh.action.captures")
        count("ddh.action.graphed")
        return graph(lam)

    def _transfer_apply(self) -> Callable:
        """The transfer apply on this operator's current tables: the rolled
        exchange where a route was found, else the scatter."""
        params, n_own, route = self.params, self.n_own, self.route
        if route is not None:
            return lambda lam: ddh_action_transfer_rolled(params, route, lam, n_own)
        T = self.T
        return lambda lam: ddh_action_transfer(params, T, lam, n_own)

    @property
    def io_path(self) -> str:
        """The path ``rhs`` and ``postprocess`` take: ``"patch"`` (the io maps
        through window patches), ``"gather"`` (the io maps through the slot
        gather and the assembly table) or ``"cycle"`` (a wave cycle each)."""
        if not (self.use_transfer and self.io is not None):
            return "cycle"
        return "gather" if self.patch_io()[0] is None else "patch"

    def patch_io(self) -> tuple:
        """(PatchIO, pshape) of the window-patch io path, or (None, None)
        when there are no io maps or the numbering is not window-regular
        (``_build_patch_io``).  Built once per set of io maps."""
        if self.io is None:
            return (None, None)
        if self._patch is None:
            self._patch = _build_patch_io(self.space, self.params, self.io)
        return self._patch

    @spanned("ddh.rhs")
    def rhs(self, f: torch.Tensor) -> torch.Tensor:
        """Substructured rhs from the Helmholtz forcing."""
        check_finite("DDH.rhs input", f)
        if self.use_transfer and self.io is not None:
            pio, pshape = self.patch_io()
            if pio is not None:
                return ddh_rhs_io_patch(self.params, self.io, pio, f, self.g_ndof,
                                        self.n_lambda, pshape)
            return ddh_rhs_io(self.params, self.io, f, self.g_ndof, self.n_lambda)
        return ddh_rhs(self.params, f, self.g_ndof, self.n_lambda, wh_maxit=self.wh_maxit,
                       cycle=self._cycle)

    @spanned("ddh.postprocess")
    def postprocess(self, lam: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """Recover the [u; v] solution."""
        check_finite("DDH.postprocess lambda", lam)
        if self.use_transfer and self.io is not None:
            pio, pshape = self.patch_io()
            if pio is not None:
                return ddh_postprocess_io_patch(self.params, self.io, pio, lam, f,
                                                self.g_ndof, self.n_own, pshape)
            return ddh_postprocess_io(self.params, self.io, lam, f, self.g_ndof, self.n_own)
        return ddh_postprocess(
            self.params, lam, f, self.g_ndof, n_own=self.n_own, wh_maxit=self.wh_maxit,
            cycle=self._cycle,
        )

    def _cycle(self, params: DDHParams, F, G, wh_maxit: int):
        """The wave cycle on this operator's S; on the card on its kernel
        ``k1``, whose per-row form a cycle of K sources of a per-domain S
        repeats K times (``K1.repeat``).  The CPU runs the plain cycle,
        which reads no kernel."""
        if not F.is_cuda:
            return wave_cycle(params, F, G, wh_maxit)
        kernel = self.k1
        if params.S.dim() == 3:
            kernel = kernel.repeat(F.shape[0] // self.n_domains)
        return wave_cycle(params, F, G, wh_maxit, kernel=kernel)

    # ------------------------------------------------------ transfer / io

    def _domain_groups(self) -> tuple[np.ndarray, np.ndarray, int]:
        """Identical-subdomain dedup: (unique indices, group of each domain,
        unique count).  Domains whose cycle data (S, Ha, inv_mi, Hf, fslot,
        a2wf) agree in float32 have identical probe responses.  The key has
        the JAX package's parts and order; for a per-domain S its exact
        float32 rows take the place of the JAX package's device probe."""
        if self._groups is None:
            with span("ddh.groups"):
                f32 = np.float32
                parts = [
                    self._Ha_np.astype(f32),
                    self._mi_np.astype(f32),
                    self._a2wf_np.astype(f32),
                    self._Hf_np,
                    self._fslot_np.astype(np.float64),
                ]
                if self._S_np.ndim == 3:
                    parts.append(self._S_np.astype(f32).reshape(self.n_domains, -1))
                key = np.concatenate([np.asarray(x, dtype=np.float64) for x in parts], axis=1)
                _, uidx, inv = np.unique(key, axis=0, return_index=True, return_inverse=True)
                self._groups = (uidx, inv.reshape(-1), len(uidx))
        return self._groups

    def _probe(self, cols: np.ndarray, stats: str) -> tuple:
        """Run one-hot probe columns through the wave cycle for the unique
        subdomains.  ``cols`` is (ncols, 2, nu, pad): the F and G rows of each
        column.  Returns (U, V/omega), each (ncols, nu, pad), and the stats.

        A shared S runs layout (a) with rows ordered (column, domain); a
        per-domain S runs layout (b) with rows ordered (domain, column), one
        run of ``c8`` rows per unique matrix (columns zero-padded to a
        multiple of 8).  Columns go in chunks of at most PROBE_STATE_ELEMS
        state elements per array, each chunk the span ``ddh.probe``."""
        uidx, _, nu = self._domain_groups()
        ncols, pad = cols.shape[0], self.pad
        p = self.params
        dev = self.gmask.device
        ui = torch.as_tensor(uidx, device=dev)
        Ha_u, mi_u = self.Ha[ui], self.inv_mi[ui]
        grouped = p.S.dim() == 3
        S_u = p.S[ui].contiguous() if grouped else p.S
        kernel = self.k1_probe if dev.type == "cuda" else None

        chunk = max(1, min(ncols, PROBE_STATE_ELEMS // (nu * pad)))
        if grouped:
            chunk = max(ROWS_PER_BLOCK, chunk // ROWS_PER_BLOCK * ROWS_PER_BLOCK)
        us, vs, rows = [], [], 0
        for k0 in range(0, ncols, chunk):
            c = min(chunk, ncols - k0)
            with span("ddh.probe"):
                if grouped:
                    c8 = -(-c // ROWS_PER_BLOCK) * ROWS_PER_BLOCK
                    rows += nu * c8
                    fg = np.zeros((2, nu, c8, pad), cols.dtype)
                    fg[:, :, :c] = cols[k0:k0 + c].transpose(1, 2, 0, 3)
                    fg = torch.as_tensor(fg, device=dev).reshape(2, nu * c8, pad)
                    pc = p._replace(
                        S=S_u, Ha=Ha_u.repeat_interleave(c8, dim=0),
                        inv_mi=mi_u.repeat_interleave(c8, dim=0),
                    )
                    u, v = wave_cycle(pc, fg[0], fg[1], self.wh_maxit, s_group_size=c8,
                                      kernel=kernel)
                    u = u.reshape(nu, c8, pad)[:, :c].transpose(0, 1)
                    v = v.reshape(nu, c8, pad)[:, :c].transpose(0, 1)
                else:
                    fg = torch.as_tensor(cols[k0:k0 + c].transpose(1, 0, 2, 3), device=dev)
                    fg = fg.reshape(2, c * nu, pad)
                    pc = p._replace(Ha=Ha_u.repeat(c, 1), inv_mi=mi_u.repeat(c, 1))
                    rows += nu * c
                    u, v = wave_cycle(pc, fg[0], fg[1], self.wh_maxit, kernel=kernel)
                    u, v = u.reshape(c, nu, pad), v.reshape(c, nu, pad)
                us.append(u)
                vs.append(v / p.omega)
        info = {
            f"{stats}_nu": int(nu),
            f"{stats}_ncols": int(ncols),
            f"{stats}_chunk_cols": int(chunk),
            f"{stats}_layout": "grouped" if grouped else "shared",
            f"{stats}_rows": rows,
        }
        return torch.cat(us), torch.cat(vs), info

    def _trace_columns(self, ncols: int, base: int) -> np.ndarray:
        """(ncols, 2, nu, pad) probe columns, zero but for the one-hot trace
        columns base + k (lam side, F) and base + pf + k (mu side, G): each
        puts Hf[d, k] at fslot[d, k], as the action's trace forcing does."""
        uidx, _, nu = self._domain_groups()
        pf = self._fslot_np.shape[1]
        fslot_u, Hf_u = self._fslot_np[uidx], self._Hf_np[uidx]
        cols = np.zeros((ncols, 2, nu, self.pad), self._np_dtype)
        kk, dd = np.meshgrid(np.arange(pf), np.arange(nu), indexing="ij")
        sl = np.maximum(fslot_u, 0)
        cols[base + kk, 0, dd, sl[dd, kk]] = Hf_u[dd, kk]
        cols[base + pf + kk, 1, dd, sl[dd, kk]] = Hf_u[dd, kk]
        return cols

    def _face_values(self, U: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
        """[a2wf v_f, a2wf u_f] at the face slots of the unique subdomains:
        (ncols, nu, pad) -> (ncols, nu, 2pf)."""
        uidx, _, _ = self._domain_groups()
        ui = torch.as_tensor(uidx, device=U.device)
        fs = self.fslot[ui].clamp_min(0).expand(U.shape[0], -1, -1)
        a2wf = self.a2wf[ui]
        return torch.cat([a2wf * V.gather(2, fs), a2wf * U.gather(2, fs)], dim=2)

    def precompute_transfer(self) -> np.ndarray:
        """Precompute the per-subdomain trace-transfer matrices.

        The wave cycle is linear in the incoming traces: for each subdomain
        the map from its 2 pf compact trace inputs (lam0, mu0) to its
        transmission outputs (a 2w v_f, a 2w u_f) is a fixed (2pf, 2pf)
        matrix.  It is probed once per unique subdomain with one-hot trace
        columns; every matvec is then one batched (ndom, 2pf) @ (2pf, 2pf)
        product.  Returns the deduped host stack (nu, 2pf, 2pf) and builds
        the rolled exchange route when the dual graph admits one.
        """
        _, inv, _ = self._domain_groups()
        ncols = 2 * self._fslot_np.shape[1]
        U, V, self.transfer_stats = self._probe(self._trace_columns(ncols, 0), "transfer")
        T_u = self._face_values(U, V).permute(1, 2, 0)  # (nu, row, col)
        self.set_transfer(T_u.cpu().numpy(), inv)
        return self._T_u

    def set_transfer(self, T_u: np.ndarray, groups: np.ndarray) -> None:
        """Use the deduped transfer stack ``T_u`` (nu, 2pf, 2pf) with the
        group of each domain; builds the rolled exchange route when the dual
        graph admits one, else the action scatters."""
        self._T_u = np.ascontiguousarray(T_u, dtype=self._np_dtype)
        self._T_groups = np.asarray(groups)
        self._T_dev = None
        self.use_transfer = True
        with span("ddh.route"):
            self.route = _build_roll_route(
                self._T_u, self._T_groups, self._B1_np, self.n_own, self.gmask.device
            )

    def precompute_io_maps(self, max_bytes: int = 1 << 30):
        """Precompute the rhs/postprocess linear maps (see ``IOMaps``).

        Probes the cycle with one-hot forcing columns (2 pad) and one-hot
        trace columns (2 pf) for the unique subdomains; afterwards ``rhs``
        and ``postprocess`` are batched matmuls.  Returns None, leaving the
        wave path in use, when the maps would exceed ``max_bytes``.
        """
        _, inv, nu = self._domain_groups()
        pf, pad = self._fslot_np.shape[1], self.pad
        need = 4 * nu * (2 * pad * 2 * pad + 2 * pf * 2 * pad + 2 * pad * 2 * pf)
        if need > max_bytes:
            return None
        base = 2 * pad
        cols = self._trace_columns(base + 2 * pf, base)
        cols[np.arange(pad), 0, :, np.arange(pad)] = 1.0
        cols[pad + np.arange(pad), 1, :, np.arange(pad)] = 1.0
        U, V, self.io_stats = self._probe(cols, "io")
        R = self._face_values(U[:base], V[:base])

        def maps(X):  # (ncols, nu, n) -> (nu, n, ncols)
            return X.permute(1, 2, 0)

        return self.set_io_maps(
            maps(U[:base]), maps(V[:base]), maps(R), maps(U[base:]), maps(V[base:]), inv
        )

    @spanned("ddh.io_maps")
    def set_io_maps(self, Pu, Pv, R, Pul, Pvl, groups: np.ndarray) -> "IOMaps":
        """Use these rhs/postprocess maps (shapes in ``IOMaps``) with the
        group of each domain."""
        dev = self.gmask.device
        nu = int(np.max(groups)) + 1

        dtype = self.gmask.dtype
        self._drop_graphs()

        def t(a):
            if not isinstance(a, torch.Tensor):
                a = np.array(a, dtype=self._np_dtype)
            return torch.as_tensor(a, dtype=dtype, device=dev).contiguous()

        maj, spec = _iomaps_split(groups, dev)
        self.io = IOMaps(
            Pu=t(Pu), Pv=t(Pv), R=t(R), Pul=t(Pul), Pvl=t(Pvl),
            onehot=t(groups[None, :] == np.arange(nu)[:, None]), maj=maj, spec_idx=spec,
        )
        self._patch = None
        return self.io

    # ------------------------------------------------------------ setup cache

    def setup_cache_key(self) -> str:
        """Content hash naming this operator's precomputed maps in the setup
        cache.  T and the io maps are functions of the per-subdomain cycle
        data (S, Ha, inv_mi, Hf, a2wf, fslot, the time tables) and the
        cycle parameters, so any DDH with the same hash can load them."""
        if self._setup_key is None:
            self._setup_key = self._compute_setup_key()
        return self._setup_key

    def _compute_setup_key(self) -> str:
        """The JAX package's key parts from the port's host staging arrays,
        in float32 (the compute dtype) and int32, plus the cache format
        version and a backend tag: ``torch``, the device type and the cycle
        that runs the probes (the variant of ``k1_probe``, or the plain
        cycle on the CPU).  Probes of different cycles differ at fp32
        round-off, so an entry of the JAX package or of another device is
        never loaded."""
        h = hashlib.sha256()
        S = np.asarray(self._S_np)
        if S.ndim == 3 and S.size > (1 << 24):
            # large per-domain stacks: two seeded probe responses
            S = S @ np.random.default_rng(0).standard_normal((self.pad, 2))
        for arr in (S, self._Ha_np, self._mi_np, self._Hf_np, self._a2wf_np, self._tables_np):
            h.update(np.ascontiguousarray(arr, dtype=np.float32).tobytes())
        for arr in (self._fslot_np, self._B0_np, self._B1_np):
            h.update(np.ascontiguousarray(arr, dtype=np.int32).tobytes())
        dev = self.gmask.device
        cycle = self.k1_probe.variant if dev.type == "cuda" else "plain"
        h.update(repr((
            CACHE_FORMAT_VERSION, "torch", dev.type, cycle, self.wh_maxit, self.pad,
            self.n_own, self.n_lost, self.nt, float(self.omega), float(self.dt),
            str(self._np_dtype),
        )).encode())
        return h.hexdigest()[:24]

    def _cache_path(self, cache_dir: str) -> str:
        return os.path.join(cache_dir, f"ddh_{self.setup_cache_key()}.npz")

    def save_precomputed(self, cache_dir: str) -> str:
        """Write the deduped transfer stack, the io maps and the coarse space
        (the JAX package's ``.npz`` layout) under ``setup_cache_key``: to a
        file named with the pid, then moved into place, so a reader never
        sees a partial file."""
        from .coarse import coarse_arrays

        os.makedirs(cache_dir, exist_ok=True)
        path = self._cache_path(cache_dir)
        data = {"groups": self._T_groups}
        if self._T_u is not None:
            data["T_u"] = self._T_u
        if self.io is not None:
            for name in _IO_FIELDS:
                data[name] = getattr(self.io, name).cpu().numpy()
        if self.coarse_space is not None:
            for k, v in coarse_arrays(self.coarse_space).items():
                data[f"coarse_{k}"] = v
            data["coarse_meta"] = np.asarray(self._coarse_meta, dtype=np.float64)
        tmp = f"{path}.tmp.{os.getpid()}.npz"
        np.savez(tmp, **data)
        os.replace(tmp, path)
        return path

    def try_load_precomputed(self, cache_dir: str) -> bool:
        """Load this operator's cache entry if there is one; True on a hit.
        Restores the transfer stack (and the roll route), the io maps and the
        coarse space that the entry holds; no probe runs.  A file that does
        not read counts as a miss and is deleted."""
        from .coarse import coarse_from_arrays

        path = self._cache_path(cache_dir)
        if not os.path.exists(path):
            return False
        try:
            with np.load(path) as z:
                if "T_u" not in z.files:
                    return False
                groups, T_u = z["groups"], z["T_u"]
                io = {k: z[k] for k in _IO_FIELDS} if "Pu" in z.files else None
                coarse = ({k[len("coarse_"):]: z[k] for k in z.files if k.startswith("coarse_")}
                          if "coarse_V" in z.files else None)
        except (OSError, EOFError, ValueError, zipfile.BadZipFile):
            # truncated or corrupt (a writer that died): drop it, so the
            # next save replaces it
            try:
                os.unlink(path)
            except OSError:
                pass
            return False
        self.set_transfer(T_u, groups)
        if io is not None:
            self.set_io_maps(*(io[k] for k in _IO_FIELDS), groups)
        if coarse is not None:
            self._coarse_meta = tuple(coarse.pop("meta").tolist())
            self.coarse_space = coarse_from_arrays(coarse, self.gmask.device)
        return True

    @spanned("ddh.prepare")
    def prepare(self, cache_dir: str | None = None, want_io: bool = True) -> dict:
        """Load or compute the transfer (and optionally io) maps; returns
        the stats: ``cache_hit``, ``cache_dir``, and ``load_seconds`` on a
        hit, else the seconds per phase, unique domains, columns and layout.

        ``cache_dir=None`` resolves CUDDH_CACHE_DIR, by default
        ``.ddh_cache_torch/`` at the repository root; ``""`` disables the
        cache.  A hit whose entry lacks the io maps computes them when
        ``want_io`` is set and saves the entry again."""
        if cache_dir is None:
            cache_dir = os.environ.get("CUDDH_CACHE_DIR", DEFAULT_CACHE_DIR)
        self._cache_dir = cache_dir or None
        stats: dict = {"cache_hit": False, "cache_dir": self._cache_dir}
        dev = self.gmask.device
        t0 = time.perf_counter()
        if cache_dir and self.try_load_precomputed(cache_dir):
            _sync(dev)
            stats["cache_hit"] = True
            stats["load_seconds"] = time.perf_counter() - t0
            if self.io is None and want_io:
                t0 = time.perf_counter()
                io = self.precompute_io_maps()
                _sync(dev)
                stats["io_seconds"] = time.perf_counter() - t0
                stats.update(self.io_stats)
                if io is not None:
                    self.save_precomputed(cache_dir)
            return stats
        self.precompute_transfer()
        stats["transfer_seconds"] = time.perf_counter() - t0
        stats.update(self.transfer_stats)
        if want_io:
            t0 = time.perf_counter()
            self.precompute_io_maps()
            _sync(dev)
            stats["io_seconds"] = time.perf_counter() - t0
            stats.update(self.io_stats)
        if cache_dir:
            self.save_precomputed(cache_dir)
        return stats

    # --------------------------------------------------------------- two-level

    def make_coarse(self, n_dir: int = 4, domains_per_super: int = 16, ridge: float = 1e-8,
                    method: str = "direct", solve_m: int = 40, solve_maxit: int = 4,
                    solve_tol: float = 1e-3, ortho: bool = True):
        """Build (and keep) the two-level plane-wave coarse space from the
        transfer stack (``prepare`` first); see ``solvers/coarse.py``.
        ``method="direct"`` keeps a dense inverse, ``"iterative"`` the
        block-sparse form solved by block-Jacobi GMRES (``solve_*``, with
        ``ortho``).  A space with the same parameters, built before or loaded
        by ``prepare``, is returned as it is; a new one is saved in the cache
        directory ``prepare`` used."""
        from .coarse import build_coarse_space, build_coarse_space_sparse

        if method not in ("direct", "iterative"):
            raise ValueError("method must be 'direct' or 'iterative'")
        self.coarse_solve = (int(solve_m), int(solve_maxit), float(solve_tol))
        iterative = method == "iterative"
        meta = (float(n_dir), float(domains_per_super), float(ridge), float(iterative),
                float(ortho if iterative else 0.0))
        if self.coarse_space is not None and self._coarse_meta == meta:
            return self.coarse_space
        if iterative:
            self.coarse_space = build_coarse_space_sparse(
                self, n_dir=n_dir, domains_per_super=domains_per_super, ridge=ridge, ortho=ortho)
        else:
            self.coarse_space = build_coarse_space(
                self, n_dir=n_dir, domains_per_super=domains_per_super, ridge=ridge)
        self._coarse_meta = meta
        if self._cache_dir:
            self.save_precomputed(self._cache_dir)
        return self.coarse_space

    def coarse_correct(self, v: torch.Tensor) -> torch.Tensor:
        """q = Z E^{-1} Z^T v: the coarse component of the correction."""
        from .coarse import coarse_apply

        sm, smx, stl = self.coarse_solve
        return coarse_apply(self.coarse_space, self.params, v, self.n_own,
                            solve_m=sm, solve_maxit=smx, solve_tol=stl)

    def solver(self, m: int, maxit: int, tol: float, gmres_opts: dict | None = None,
               block: bool = False, vmapped: bool = False, coarse: str | None = None):
        """The whole solve: rhs, lambda-GMRES(m), postprocess.

        ``gmres_opts`` go to the GMRES (``deferred``, ``reorth``).  By default
        the solver maps one forcing b to (``GmresResult``, U).  With ``block``
        or ``vmapped`` it maps a (K, 2 g_ndof) block of K forcings to the
        (K, 2 g_ndof) solutions: ``block`` runs ``block_gmres`` (one shared
        block-Krylov space; ``reorth`` is its one option), ``vmapped`` runs
        ``gmres_lockstep`` (each source its own space, as a solo solve).
        Each batched rhs, matvec and postprocess is one apply over the K
        ndom subdomain rows.

        ``coarse="additive"`` or ``"multiplicative"`` (after ``make_coarse``)
        runs ``fgmres`` on the action, right-preconditioned by the coarse
        correction: P v = v + q or q + v - A q with q = ``coarse_correct(v)``
        (``gmres_opts`` do not apply); it takes one forcing (``block`` and
        ``vmapped`` do not compose with it)."""
        if coarse and self.coarse_space is None:
            raise ValueError("coarse solver requested but make_coarse() not run")
        if coarse not in (None, "additive", "multiplicative"):
            raise ValueError("coarse must be None, 'additive', or 'multiplicative'")
        if coarse:
            if block or vmapped:
                raise ValueError("block=True or vmapped=True does not compose with coarse yet")
            return self._coarse_solver(m, maxit, tol, coarse)
        opts = dict(gmres_opts or {})
        if block:
            @spanned("ddh.solve")
            def run_block(bs: torch.Tensor) -> tuple[BlockGmresResult, torch.Tensor]:
                out = block_gmres(self.action, self.rhs(bs), m=m, maxit=maxit, tol=tol, **opts)
                return out, self.postprocess(out.x, bs)

            return run_block
        if vmapped:
            @spanned("ddh.solve")
            def run_lockstep(bs: torch.Tensor) -> tuple[LockstepResult, torch.Tensor]:
                out = gmres_lockstep(self.action, self.rhs(bs), m=m, maxit=maxit, tol=tol, **opts)
                return out, self.postprocess(out.x, bs)

            return run_lockstep

        @spanned("ddh.solve")
        def run(b: torch.Tensor) -> tuple[GmresResult, torch.Tensor]:
            out = gmres(self.action, self.rhs(b), m=m, maxit=maxit, tol=tol, **opts)
            return out, self.postprocess(out.x, b)

        return run

    def _coarse_solver(self, m: int, maxit: int, tol: float, coarse: str):
        """The two-level solve of ``solver(coarse=...)``."""
        def P(v: torch.Tensor) -> torch.Tensor:
            q = self.coarse_correct(v)
            if coarse == "multiplicative":
                # the residual sweep q + (v - A q): one more action per step
                return q + v - self.action(q)
            return v + q

        @spanned("ddh.solve")
        def run(b: torch.Tensor) -> tuple[GmresResult, torch.Tensor]:
            out = fgmres(self.action, self.rhs(b), P, m=m, maxit=maxit, tol=tol)
            return out, self.postprocess(out.x, b)

        return run


class DDHPreconditioner:
    """P(v) for FGMRES on the coupled Helmholtz system: the DDH rhs of v,
    one bounded fp32 lambda-GMRES (``inner_m``, ``inner_maxit`` restarts,
    tol 0: no early exit, so the work per apply is fixed) and the DDH
    postprocess, cast back to v's dtype.  The one P of
    ``run_helmholtz_ddh`` and ``models/inverse.py::ddh_solve_hook``;
    ``gmres_opts`` go to the inner GMRES and ``calls`` counts the
    applications."""

    def __init__(self, ddh: DDH, inner_m: int = 20, inner_maxit: int = 3,
                 gmres_opts: dict | None = None):
        self.ddh, self.inner_m, self.inner_maxit = ddh, inner_m, inner_maxit
        self.gmres_opts = dict(gmres_opts or {})
        self.calls = 0

    @spanned("ddh.precond")
    def __call__(self, v: torch.Tensor) -> torch.Tensor:
        self.calls += 1
        v32 = v.to(self.ddh.gmask.dtype)
        out = gmres(self.ddh.action, self.ddh.rhs(v32), m=self.inner_m,
                    maxit=self.inner_maxit, tol=0.0, **self.gmres_opts)
        return self.ddh.postprocess(out.x, v32).to(v.dtype)


# ---------------------------------------------------------------- the apply
#
# Every apply takes one vector or a (K, n) block of K sources (``DDH.solver``
# with ``block`` or ``vmapped``).  Internally the sources lead: subdomain
# arrays are (K, ndom, pad) and face arrays (K, ndom, pf), so each product,
# roll, gather and scatter runs once over the K * ndom rows.


def _block(v: torch.Tensor) -> torch.Tensor:
    """A vector as a block of one source; a (K, n) block as it is."""
    return v[None] if v.dim() == 1 else v


def _unblock(out: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """The apply's (K, n) result in the shape of its input ``like``."""
    return out[0] if like.dim() == 1 else out


def _rows(params: DDHParams, K: int) -> DDHParams:
    """The cycle's per-row operands for K sources stacked source-major
    (row k * ndom + d): Ha and inv_mi, and a per-domain S, repeated K times."""
    if K == 1:
        return params
    S = params.S.repeat(K, 1, 1) if params.S.dim() == 3 else params.S
    return params._replace(S=S, Ha=params.Ha.repeat(K, 1), inv_mi=params.inv_mi.repeat(K, 1))


def _read_traces(params: DDHParams, lam: torch.Tensor, n_lambda: int, n_own: int):
    """Own-side compact traces (lam0, mu0), each (K, ndom, pf): masked
    reshapes of the rows of ``lam`` (K, 2 n_lambda)."""
    ndom, pf = params.B0.shape
    K = lam.shape[0]
    lam0 = lam[:, :n_own].reshape(K, ndom, pf)
    mu0 = lam[:, n_lambda:n_lambda + n_own].reshape(K, ndom, pf)
    has = params.B0 >= 0
    return torch.where(has, lam0, 0.0), torch.where(has, mu0, 0.0)


def _forcing(params: DDHParams, x, lam, g_ndof: int, n_own: int | None = None):
    """Gather forcing and lambda traces into subdomain slots: F, G (K, ndom,
    pad) and the compact own traces lam0, mu0 (K, ndom, pf), for the rows of
    ``x`` (K, 2 g_ndof) and ``lam`` (K, 2 n_lambda); one of them may be
    None."""
    gI = params.gI.clamp_min(0)
    ndom, pad = params.gmask.shape
    K = (x if x is not None else lam).shape[0]
    if x is not None:
        x = x.to(params.gmask.dtype)
        F = params.F_weight * x[:, gI]
        G = params.F_weight * x[:, g_ndof + gI]
    else:
        F = params.gmask.new_zeros((K, ndom, pad))
        G = params.gmask.new_zeros((K, ndom, pad))
    if lam is not None and lam.shape[1] > 0:
        lam0, mu0 = _read_traces(params, lam, lam.shape[1] // 2, n_own)
        # H*lam0 at the face slots; padded face slots carry Hf == 0, so their
        # clamped slot-0 adds are exact no-ops
        rows = torch.arange(ndom, device=F.device)[:, None] * pad
        flat = (rows + params.fslot.clamp_min(0)).reshape(-1)
        F = F.reshape(K, -1).index_add(1, flat, (params.Hf * lam0).reshape(K, -1))
        G = G.reshape(K, -1).index_add(1, flat, (params.Hf * mu0).reshape(K, -1))
        F, G = F.reshape(K, ndom, pad), G.reshape(K, ndom, pad)
    else:
        lam0 = params.Hf.new_zeros((K, *params.Hf.shape))
        mu0 = params.Hf.new_zeros((K, *params.Hf.shape))
    return F, G, lam0, mu0


def _run_cycle(cycle: Callable, params: DDHParams, F, G, wh_maxit: int):
    """One wave cycle over all K * ndom rows of F, G (K, ndom, pad): one call
    of ``cycle`` (one kernel launch on the card); (u, v / omega) shaped like
    F."""
    K, ndom, pad = F.shape
    u, v = cycle(_rows(params, K), F.reshape(K * ndom, pad), G.reshape(K * ndom, pad), wh_maxit)
    return u.reshape(K, ndom, pad), v.reshape(K, ndom, pad) / params.omega


def _scatter_updates(params: DDHParams, lam0, mu0, u, v, n_lambda: int) -> torch.Tensor:
    """Transmission update written to the dual trace slots (``_b1_scatter``)."""
    fs = params.fslot.clamp_min(0).expand(u.shape[0], -1, -1)
    uf = u.gather(2, fs)
    vf = v.gather(2, fs)
    return _b1_scatter(params, -lam0 - params.a2wf * vf, -mu0 + params.a2wf * uf, n_lambda)


def _scatter_solution(params: DDHParams, u, v, g_ndof: int) -> torch.Tensor:
    """Mass-weighted assembly of the subdomain solutions (K, ndom, pad) into
    [u; v] rows of length 2 g_ndof: each global DOF sums its slots in a fixed
    order (``assemble``'s table, ``sol_table``), so no float atomics decide
    the order of a sum and the result repeats bitwise."""
    table = params.sol_table
    if table.shape[0] != g_ndof:
        raise ValueError(f"sol_table covers {table.shape[0]} DOFs, not {g_ndof}")

    def assemble_rows(vals):
        flat = torch.cat([vals.reshape(vals.shape[0], -1), vals.new_zeros(vals.shape[0], 1)], 1)
        return flat[:, table].sum(dim=2)

    w = params.m_gmi
    return torch.cat([assemble_rows(w * u), assemble_rows(w * v)], dim=1)


def ddh_action(
    params: DDHParams,
    lam: torch.Tensor,
    n_own: int | None = None,
    wh_maxit: int = WH_MAXIT,
    cycle: Callable = wave_cycle,
) -> torch.Tensor:
    """lambda - S(lambda): fixed-point form of the substructured system.
    ``cycle`` is the wave cycle to run (the kernel wrapper by default)."""
    lam2 = _block(lam)
    n_lambda = lam2.shape[1] // 2
    if n_own is None:
        n_own = params.B0.numel()
    F, G, lam0, mu0 = _forcing(params, None, lam2, 0, n_own)
    u, v = _run_cycle(cycle, params, F, G, wh_maxit)
    return _unblock(lam2 - _scatter_updates(params, lam0, mu0, u, v, n_lambda), lam)


def ddh_rhs(
    params: DDHParams,
    f: torch.Tensor,
    g_ndof: int,
    n_lambda: int,
    wh_maxit: int = WH_MAXIT,
    cycle: Callable = wave_cycle,
) -> torch.Tensor:
    """b: transmission traces generated by the volume forcing alone."""
    F, G, lam0, mu0 = _forcing(params, _block(f), None, g_ndof)
    u, v = _run_cycle(cycle, params, F, G, wh_maxit)
    return _unblock(_scatter_updates(params, lam0, mu0, u, v, n_lambda), f)


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
    F, G, _, _ = _forcing(params, _block(f), _block(lam), g_ndof, n_own)
    u, v = _run_cycle(cycle, params, F, G, wh_maxit)
    return _unblock(_scatter_solution(params, u, v, g_ndof), f)


# ------------------------------------------------------- the transfer/io apply


class IOMaps(NamedTuple):
    """Precomputed linear maps of ``rhs`` and ``postprocess`` (the JAX
    ``IOMaps``).  The cycle is linear in its forcing (F, G) and incoming
    traces, so both collapse to batched matmuls against maps probed once per
    unique subdomain.  Shapes: nu unique domains, pad slots, pf face slots.
    """

    Pu: torch.Tensor  # (nu, pad, 2pad)  (F, G) -> u
    Pv: torch.Tensor  # (nu, pad, 2pad)  (F, G) -> v/omega
    R: torch.Tensor  # (nu, 2pf, 2pad)  (F, G) -> [a2wf vf, a2wf uf]
    Pul: torch.Tensor  # (nu, pad, 2pf)  (lam0, mu0) -> u
    Pvl: torch.Tensor  # (nu, pad, 2pf)  (lam0, mu0) -> v/omega
    onehot: torch.Tensor  # (nu, ndom) group membership
    # majority split (set when >= half the domains share one matrix): one
    # shared matmul plus the special domains' rows recomputed
    maj: int | None = None  # majority group id
    spec_idx: torch.Tensor | None = None  # (nspec,) sorted special domains


class RollRoute(NamedTuple):
    """Roll-based trace exchange for (near-)regular subdomain graphs (the
    JAX ``RollRoute``).

    Discovered from the B1 dual table: sender slot k of domain d routing to
    slot sigma(k) of domain d + off, for a fixed flat offset, is exchanged
    with a mask, a ``torch.roll`` over the domain axis and a fixed column
    gather.  ``A`` is the transfer matrix with the identity terms folded in,
    rows at the sender slots.  The remainder (writes to overwritten-corner
    tail ids, irregular senders) goes through one small scatter.
    """

    A: torch.Tensor | None  # (ndom, 2pf, 2pf) identity-folded -I -/+ T
    masks: torch.Tensor  # (n_route, ndom, 2pf+1) 0/1 sender masks, bf16
    offs: tuple  # (n_route,) flat domain offset of each route
    perms: torch.Tensor  # (n_route, 2pf) target slot <- sender column
    irr_src: torch.Tensor  # (n_irr,) flat (ndom*pf) sender index per half
    irr_tgt: torch.Tensor  # (n_irr,) into the n_lambda-sized side vector
    A0: torch.Tensor | None  # (2pf, 2pf) shared majority matrix
    A_spec: torch.Tensor | None  # (nspec, 2pf, 2pf) corrections A[spec] - A0
    spec_idx: torch.Tensor | None  # (nspec,) sorted special-domain rows


def _build_roll_route(
    T_u: np.ndarray,
    groups: np.ndarray,
    B1_np: np.ndarray,
    n_own: int,
    device,
    max_routes: int = 16,
    min_uniform_frac: float = 0.5,
) -> RollRoute | None:
    """Discover (offset, slot-map) routes in B1 and build a RollRoute.

    Senders are grouped by (domain offset, sender slot, target slot); groups
    sharing an offset pack greedily into routes with injective slot maps.
    Returns None when fewer than ``min_uniform_frac`` of the senders fit a
    route; the scatter exchange is used then.
    """
    ndom, pf = B1_np.shape
    d = np.repeat(np.arange(ndom), pf)
    k = np.tile(np.arange(pf), ndom)
    t = B1_np.reshape(-1).astype(np.int64)
    send = t >= 0
    own_t = send & (t < n_own)
    td, tk = np.divmod(np.where(own_t, t, 0), pf)
    off_all = td - d

    flat = np.nonzero(own_t)[0]
    if flat.size == 0:
        return None
    offf = off_all[flat]
    omin = int(offf.min())
    key = ((offf - omin).astype(np.int64) * pf + k[flat]) * pf + tk[flat]
    order = np.argsort(key, kind="stable")
    uk, starts, counts = np.unique(key[order], return_index=True, return_counts=True)
    tt_u = (uk % pf).astype(np.int64)
    kk_u = ((uk // pf) % pf).astype(np.int64)
    off_u = (uk // (pf * pf)).astype(np.int64) + omin

    def members_of(gi: int) -> np.ndarray:
        return flat[order[starts[gi]:starts[gi] + counts[gi]]]

    # pack groups into routes: per route one offset + an injective slot map
    per_off: dict = defaultdict(list)  # off -> [(used_k, used_t, members)]
    for gi in np.argsort(-counts, kind="stable"):
        o, kk, tt = int(off_u[gi]), int(kk_u[gi]), int(tt_u[gi])
        for sk, st, members in per_off[o]:
            if kk not in sk and tt not in st:
                sk.add(kk)
                st.add(tt)
                members[kk] = (tt, gi)
                break
        else:
            per_off[o].append(({kk}, {tt}, {kk: (tt, gi)}))

    route_list = [(o, members) for o, lst in per_off.items() for _, _, members in lst]
    route_list.sort(key=lambda om: -sum(counts[gi] for _, gi in om[1].values()))
    route_list = route_list[:max_routes]

    covered = np.zeros(ndom * pf, bool)
    offs: list[int] = []
    perms: list[np.ndarray] = []
    masks = np.zeros((len(route_list), ndom, 2 * pf + 1), np.float32)
    for i, (o, members) in enumerate(route_list):
        # target slot c <- sender slot perm[c]; uncovered targets read the
        # zero pad column 2pf
        perm = np.full(2 * pf, 2 * pf, np.int64)
        for kk, (tt, gi) in members.items():
            perm[tt] = kk
            perm[pf + tt] = pf + kk
            ii = members_of(gi)
            masks[i, ii // pf, kk] = 1.0
            masks[i, ii // pf, pf + kk] = 1.0
            covered[ii] = True
        offs.append(int(o))
        perms.append(perm)

    if int(covered.sum()) < min_uniform_frac * int(send.sum()):
        return None

    # A = identity-folded (-I -/+ T) at the deduped level: row i < pf gives
    # -x_l - w_l, row i >= pf gives -x_m + w_m
    A_u = np.concatenate([-T_u[:, :pf, :], T_u[:, pf:, :]], axis=1)
    A_u[:, np.arange(2 * pf), np.arange(2 * pf)] -= 1.0

    irr = np.nonzero(send & ~covered)[0]
    irr = irr[np.argsort(t[irr], kind="stable")]

    def dev(a, dtype=None):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=dtype, device=device)

    A0 = A_spec = spec_idx = A_full = None
    counts = np.bincount(groups)
    maj = int(np.argmax(counts))
    if counts[maj] >= 0.5 * ndom:
        A0 = dev(A_u[maj])
        spec = np.nonzero(groups != maj)[0]
        if spec.size:
            A_spec = dev(A_u[groups[spec]] - A_u[maj][None])
            spec_idx = dev(spec, torch.int64)
    else:
        A_full = dev(A_u[groups])

    return RollRoute(
        A=A_full,
        masks=dev(masks, torch.bfloat16),
        offs=tuple(offs),
        perms=dev(np.stack(perms)),
        irr_src=dev(irr, torch.int64),
        irr_tgt=dev(t[irr], torch.int64),
        A0=A0,
        A_spec=A_spec,
        spec_idx=spec_idx,
    )


def _iomaps_split(inv: np.ndarray, device):
    """Majority-split metadata for ``_group_apply``: (maj, spec_idx), both
    None when no group covers at least half the domains."""
    counts = np.bincount(inv)
    maj = int(np.argmax(counts))
    if counts[maj] < 0.5 * inv.size:
        return None, None
    spec = np.nonzero(inv != maj)[0]
    return maj, torch.as_tensor(spec, dtype=torch.int64, device=device)


def _group_apply(M, x, onehot, maj=None, spec_idx=None) -> torch.Tensor:
    """y[..., d, :] = M[group(d)] @ x[..., d, :] for x (..., ndom, n): the
    leading (source) axes ride along in every product.

    With majority metadata: one shared matmul over all rows plus the
    special domains' rows recomputed (their indices are unique, so the
    overwrite order does not matter).  Otherwise: above nu > ndom/4 gather
    each domain's matrix and run one batched product; below, one product per
    unique matrix and a one-hot combine."""
    if spec_idx is not None:
        y = x @ M[maj].T
        if spec_idx.numel() > 0:
            ys = _group_apply(M, x[..., spec_idx, :], onehot[:, spec_idx])
            y.index_copy_(x.dim() - 2, spec_idx, ys)
        return y
    nu, ndom = onehot.shape
    if 4 * nu > ndom:
        return torch.einsum("doi,...di->...do", M[onehot.argmax(dim=0)], x)
    ys = torch.einsum("uoi,...di->...udo", M, x)
    return torch.einsum("...udo,ud->...do", ys, onehot)


def _b1_scatter(params: DDHParams, upd_l, upd_m, n_lambda: int) -> torch.Tensor:
    """Write per-domain face updates (K, ndom, pf) to the dual trace slots of
    K rows (K, 2 n_lambda).  The valid B1 ids are unique, so the write order
    does not matter; invalid slots all write 0 to a dropped extra entry."""
    K = upd_l.shape[0]
    has = params.B1 >= 0
    idx = torch.where(has, params.B1, n_lambda).reshape(-1)
    out = upd_l.new_zeros((K, 2, n_lambda + 1))
    out[:, 0, idx] = torch.where(has, upd_l, 0.0).reshape(K, -1)
    out[:, 1, idx] = torch.where(has, upd_m, 0.0).reshape(K, -1)
    return out[:, :, :n_lambda].reshape(K, -1)


def ddh_action_transfer(params: DDHParams, T, lam, n_own: int) -> torch.Tensor:
    """lambda - S(lambda) via the per-subdomain transfer matrices T (ndom,
    2pf, 2pf) and one scatter: the exchange when no roll route was found."""
    lam2 = _block(lam)
    n_lambda = lam2.shape[1] // 2
    pf = params.Hf.shape[1]
    lam0, mu0 = _read_traces(params, lam2, n_lambda, n_own)
    w = torch.einsum("dik,bdk->bdi", T, torch.cat([lam0, mu0], dim=2))
    upd = _b1_scatter(params, -lam0 - w[..., :pf], -mu0 + w[..., pf:], n_lambda)
    return _unblock(lam2 - upd, lam)


def _transfer_matmul(route: RollRoute, x: torch.Tensor) -> torch.Tensor:
    """u2 = A x batched over subdomains for x (K, ndom, 2pf): with the
    shared-majority split one product over all K * ndom rows, the special
    rows added (they are unique per source, so ``index_add_`` order does not
    matter)."""
    if route.A0 is not None:
        u2 = x @ route.A0.T
        if route.A_spec is not None:
            ws = torch.einsum("sik,bsk->bsi", route.A_spec, x[:, route.spec_idx])
            u2.index_add_(1, route.spec_idx, ws)
        return u2
    return torch.einsum("dik,bdk->bdi", route.A, x)


def ddh_action_transfer_rolled(params: DDHParams, route: RollRoute, lam, n_own: int):
    """lambda - S(lambda) with the roll-based trace exchange: one batched
    product against the identity-folded transfer matrix, then per route a
    mask, a roll over each source's domain axis and a column gather; the
    remainder through one scatter with unique targets."""
    lam2 = _block(lam)
    K = lam2.shape[0]
    n_lambda = lam2.shape[1] // 2
    pf = params.B0.shape[1]
    lam0, mu0 = _read_traces(params, lam2, n_lambda, n_own)
    u2 = _transfer_matmul(route, torch.cat([lam0, mu0], dim=2))
    u2p = torch.nn.functional.pad(u2, (0, 1))  # zero pad column for dead slots
    out_own = torch.zeros_like(u2)
    for off, mask, perm in zip(route.offs, route.masks, route.perms):
        out_own += torch.roll(mask * u2p, off, dims=1)[..., perm]
    tail = lam2.new_zeros((K, n_lambda - n_own))
    out_l = torch.cat([out_own[..., :pf].reshape(K, -1), tail], dim=1)
    out_m = torch.cat([out_own[..., pf:].reshape(K, -1), tail], dim=1)
    if route.irr_src.numel() > 0:
        out_l[:, route.irr_tgt] = u2[..., :pf].reshape(K, -1)[:, route.irr_src]
        out_m[:, route.irr_tgt] = u2[..., pf:].reshape(K, -1)[:, route.irr_src]
    return _unblock(lam2 - torch.cat([out_l, out_m], dim=1), lam)


class _ApplyGraph:
    """One transfer apply captured as a CUDA graph for one input shape and
    dtype: a static input the call copies into, the graph, and its static
    output, which the call clones, so that a later replay never overwrites a
    result its caller still holds.  The same kernels run in the same order
    as the eager apply, so a replay equals it bit for bit.

    The graphs of one operator share one memory pool.  That is safe here
    because every replay writes each of its intermediates before it reads
    it, and its output is cloned before the next replay on the stream."""

    def __init__(self, apply: Callable, lam: torch.Tensor, pool):
        self.x = lam.clone()
        self.graph, self.y = capture(apply, (self.x,), pool)

    def __call__(self, lam: torch.Tensor) -> torch.Tensor:
        self.x.copy_(lam)
        self.graph.replay()
        return self.y.clone()


def ddh_rhs_io(params: DDHParams, io: IOMaps, f, g_ndof: int, n_lambda: int):
    """``ddh_rhs`` through the precomputed forcing -> trace map: no wave
    cycle runs."""
    F, G, _, _ = _forcing(params, _block(f), None, g_ndof)
    pf = params.Hf.shape[1]
    w = _group_apply(io.R, torch.cat([F, G], dim=2), io.onehot, io.maj, io.spec_idx)
    return _unblock(_b1_scatter(params, -w[..., :pf], w[..., pf:], n_lambda), f)


def ddh_postprocess_io(params: DDHParams, io: IOMaps, lam, f, g_ndof: int, n_own: int):
    """``ddh_postprocess`` through the precomputed maps: u = Pu [F; G] +
    Pul [lam0; mu0] (likewise v), then the mass-weighted global scatter."""
    lam2 = _block(lam)
    F, G, _, _ = _forcing(params, _block(f), None, g_ndof)
    lam0, mu0 = _read_traces(params, lam2, lam2.shape[1] // 2, n_own)
    x = torch.cat([F, G], dim=2)
    tr = torch.cat([lam0, mu0], dim=2)

    def ga(M, z):
        return _group_apply(M, z, io.onehot, io.maj, io.spec_idx)

    u = ga(io.Pu, x) + ga(io.Pul, tr)
    v = ga(io.Pv, x) + ga(io.Pvl, tr)
    return _unblock(_scatter_solution(params, u, v, g_ndof), f)


# ------------------------------------------------------------- the patch io path


class PatchIO(NamedTuple):
    """Window-ordered io maps for grid-native numberings (the JAX
    ``PatchIO``).

    On a row-major grid DOF numbering every subdomain's global ids form one
    (h, h) window at stride (s, s), so the forcing gather is one ``unfold``
    and the solution assembly its transpose, one ``fold`` (an overlap-add
    that each output element sums over its covering windows: no atomics).
    The io matrices are permuted to window order once; ``_build_patch_io``
    checks the window model against ``gI``.  Here nwin = h * h.
    """

    Rw: torch.Tensor  # (nu, 2pf, 2nwin)  [F; G] window columns -> traces
    # the four postprocess maps as one grouped matrix [[Pu, Pul], [Pv, Pvl]]
    # acting on z = [Fw; Gw; lam0; mu0]
    Mw: torch.Tensor  # (nu, 2nwin, 2nwin + 2pf)
    w_F: torch.Tensor  # (ndom, 2nwin) forcing weights of F and G, window order
    m_w: torch.Tensor  # (ndom, 2nwin) solution weights of u and v, window order


def _build_patch_io(space, params: DDHParams, io: IOMaps) -> tuple:
    """(PatchIO, (H, W, h, s)) or (None, None).

    Builds exactly when (a) the space's DOF coordinates are row-major
    grid-ordered, (b) every subdomain's valid ``gI`` ids are one full
    (h, h) window with a slot order shared by all subdomains, (c) the window
    bases tile the grid row-major at a uniform stride s, and (d) h <= 2 s
    (the JAX package's parity overlap-add needs it; its
    ``_build_patch_io`` does not check it).  Everything is checked on the
    host against ``gI``.
    """
    gI = params.gI.cpu().numpy()
    ndom, pad = gI.shape
    coords = np.asarray(space.coords)
    if coords.shape[0] < 4:
        return None, None
    ys = coords[:, 1]
    changes = np.nonzero(ys != ys[0])[0]
    if changes.size == 0:
        return None, None
    W = int(changes[0])
    if W <= 1 or coords.shape[0] % W:
        return None, None
    H = coords.shape[0] // W
    valid = gI >= 0
    nv = valid.sum(axis=1)
    if not np.all(nv == nv[0]):
        return None, None
    nwin = int(nv[0])
    if not (np.all(valid[:, :nwin]) and not np.any(valid[:, nwin:])):
        return None, None
    core = gI[:, :nwin].astype(np.int64)
    base = core.min(axis=1)
    rel = core - base[:, None]
    if not np.all(rel == rel[0]):
        return None, None
    dr, dc = rel[0] // W, rel[0] % W
    h, w = int(dr.max()) + 1, int(dc.max()) + 1
    if h != w or h * w != nwin:
        return None, None
    wpos = dr * w + dc  # slot -> window-row-major position
    if np.unique(wpos).size != nwin:
        return None, None
    br, bc = base // W, base % W
    ubr, ubc = np.unique(br), np.unique(bc)
    nby, nbx = ubr.size, ubc.size
    if nby * nbx != ndom:
        return None, None
    sr = int(ubr[1] - ubr[0]) if nby > 1 else h
    sc = int(ubc[1] - ubc[0]) if nbx > 1 else w
    if sr != sc or np.any(np.diff(ubr) != sr) or np.any(np.diff(ubc) != sc):
        return None, None
    if ubr[0] != 0 or ubc[0] != 0 or ubr[-1] + h != H or ubc[-1] + w != W:
        return None, None
    if h > 2 * sr:
        return None, None
    # identity domain order: d == by * nbx + bx
    if not (np.array_equal(br, np.repeat(ubr, nbx)) and np.array_equal(bc, np.tile(ubc, nby))):
        return None, None

    slot_of_w = np.empty(nwin, np.int64)
    slot_of_w[wpos] = np.arange(nwin)  # window position -> slot
    sw = torch.as_tensor(slot_of_w, device=io.Pu.device)

    def in_cols(M):  # (..., 2pad) -> (..., 2nwin): [F; G] blocks in window order
        return torch.cat([M[..., sw], M[..., pad + sw]], dim=-1)

    def two(A):  # (ndom, pad) -> (ndom, 2nwin), the window weights twice
        Aw = A.to(io.Pu.dtype)[:, sw]
        return torch.cat([Aw, Aw], dim=1).contiguous()

    Mu = torch.cat([in_cols(io.Pu[:, sw, :]), io.Pul[:, sw, :]], dim=-1)
    Mv = torch.cat([in_cols(io.Pv[:, sw, :]), io.Pvl[:, sw, :]], dim=-1)
    pio = PatchIO(
        Rw=in_cols(io.R).contiguous(),
        Mw=torch.cat([Mu, Mv], dim=1).contiguous(),
        w_F=two(params.F_weight),
        m_w=two(params.m_gmi),
    )
    return pio, (H, W, h, sr)


def _patch_extract(x: torch.Tensor, H: int, W: int, h: int, s: int) -> torch.Tensor:
    """(K, 2, H*W) -> (K, 2 h h, nby * nbx): every (h, h) window at stride
    s, features ordered (channel, window-row-major), windows row-major."""
    return torch.nn.functional.unfold(x.reshape(x.shape[0], 2, H, W), (h, h), stride=s)


def _patch_combine(uv: torch.Tensor, H: int, W: int, h: int, s: int) -> torch.Tensor:
    """Transpose of ``_patch_extract``: overlap-add (K, 2 h h, nby * nbx)
    back to (K, 2 H*W)."""
    y = torch.nn.functional.fold(uv, (H, W), (h, h), stride=s)
    return y.reshape(uv.shape[0], 2 * H * W)


def ddh_rhs_io_patch(params: DDHParams, io: IOMaps, pio: PatchIO, f, g_ndof: int,
                     n_lambda: int, pshape: tuple):
    """``ddh_rhs_io`` with the forcing gather as one patch extraction."""
    H, W, h, s = pshape
    f2 = _block(f).to(pio.w_F.dtype)
    xin = _patch_extract(f2.reshape(f2.shape[0], 2, g_ndof), H, W, h, s).transpose(1, 2)
    w = _group_apply(pio.Rw, xin * pio.w_F, io.onehot, io.maj, io.spec_idx)
    pf = params.Hf.shape[1]
    return _unblock(_b1_scatter(params, -w[..., :pf], w[..., pf:], n_lambda), f)


def ddh_postprocess_io_patch(params: DDHParams, io: IOMaps, pio: PatchIO, lam, f,
                             g_ndof: int, n_own: int, pshape: tuple):
    """``ddh_postprocess_io`` with the patch extraction of the forcing, one
    grouped product of the fused maps, and the mass-weighted assembly as the
    patch transpose (overlap-add)."""
    H, W, h, s = pshape
    lam2 = _block(lam)
    f2 = _block(f).to(pio.w_F.dtype)
    xin = _patch_extract(f2.reshape(f2.shape[0], 2, g_ndof), H, W, h, s).transpose(1, 2)
    lam0, mu0 = _read_traces(params, lam2, lam2.shape[1] // 2, n_own)
    z = torch.cat([xin * pio.w_F, lam0.to(xin.dtype), mu0.to(xin.dtype)], dim=2)
    uv = _group_apply(pio.Mw, z, io.onehot, io.maj, io.spec_idx) * pio.m_w  # [u_w | v_w]
    return _unblock(_patch_combine(uv.transpose(1, 2), H, W, h, s), f)
