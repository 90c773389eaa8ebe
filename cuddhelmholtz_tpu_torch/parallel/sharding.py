"""Multi-device execution: elements and subdomains sharded over ranks.

Counterpart of ``cuddhelmholtz_tpu/parallel/sharding.py``, on
``torch.distributed`` with one process per device (SPMD).  Where JAX shards
arrays of one program over a ``Mesh`` with ``shard_map``, each rank here
keeps its own slab of rows and the partial results meet in collectives:

  * **Operators (element parallel)**: rank r applies the elements
    ``[r L, (r + 1) L)`` (L = ceil(nel / n)) of a replicated vector and
    assembles them into a full-length partial; the partials are summed over
    the ranks (JAX: ``psum``).
  * **DDH (subdomain parallel)**: the subdomain rows are padded to a
    multiple of the world size and each rank keeps a row slab of every
    (ndom, ...) table; lambda stays replicated.  Each rank runs the wave
    cycle (the kernel on the card) on its slab, and the transmission
    updates are summed over the ranks.  With precomputed transfer matrices
    the action is one small batched product per rank, and with a roll route
    the trace exchange sends only the halo rows to the neighbouring ranks.

Every rank must hold the same bits, and a repeated solve must repeat
bitwise, whatever order the backend's reductions take.  Lambda updates have
one writer per entry (every other rank adds 0), so their sums are one
``all_reduce``, exact in any order.  Sums with several writers per entry
(the assembled solution, the element partials) gather the partials
(``all_gather``) and add them in rank order.  GMRES runs replicated on every
rank on identical inputs.

A ``mesh`` argument is a ``DeviceMesh`` over every rank (``device_mesh``,
``distributed.hybrid_device_mesh``), flattened row-major; ``None`` is the
default group, or this process alone when ``torch.distributed`` is not
initialised.  At world size 1 no collective runs and the halo is a local
copy.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.distributed as dist

from ..models.helmholtz import HelmholtzOp
from ..ops.cuda.wave_cycle import k1_kernel, wave_cycle
from ..ops.face_mass import apply_face_mass
from ..ops.mass import (
    MassOp,
    assembly_table,
    gather_elements,
    mass_element_kernel,
    scatter_elements,
)
from ..ops.stiffness import StiffnessOp, stiffness_element_kernel
from ..solvers.ddh import (
    DDH,
    DDHParams,
    _b1_scatter,
    _forcing,
    _read_traces,
    _run_cycle,
    _scatter_solution,
    _scatter_updates,
)
from .distributed import mesh_device_type


def device_mesh(n_devices: int | None = None, axis: str = "shard"):
    """A 1-axis ``DeviceMesh`` over every rank of the default group.
    ``n_devices``, if given, must be the world size (a torch mesh spans the
    ranks that run the program)."""
    from torch.distributed.device_mesh import init_device_mesh

    if not (dist.is_available() and dist.is_initialized()):
        raise RuntimeError("device_mesh: call parallel.initialize_from_env first")
    world = dist.get_world_size()
    if n_devices is not None and n_devices != world:
        raise ValueError(f"device_mesh: {n_devices} devices requested, world size {world}")
    return init_device_mesh(mesh_device_type(), (world,), mesh_dim_names=(axis,))


class _Ranks:
    """This process's place among the ranks of a mesh: the world size n,
    the ranks in mesh (row-major) order and this rank's index among them.
    Collectives run on the default group."""

    def __init__(self, mesh=None):
        if not (dist.is_available() and dist.is_initialized()):
            if mesh is not None:
                raise RuntimeError("a mesh needs torch.distributed to be initialised")
            self.n, self.index, self.ranks = 1, 0, [0]
            return
        world = dist.get_world_size()
        ranks = list(range(world)) if mesh is None else mesh.mesh.flatten().tolist()
        if sorted(ranks) != list(range(world)):
            raise ValueError(f"the mesh must span every rank of the default group, got {ranks}")
        self.n, self.index, self.ranks = world, ranks.index(dist.get_rank()), ranks

    def rows(self, count: int) -> tuple[int, int]:
        """(padded count, rows per rank) of ``count`` rows over the ranks."""
        per = -(-count // self.n)
        return per * self.n, per

    def gather(self, x: torch.Tensor) -> list[torch.Tensor]:
        """Every rank's ``x`` (same shape on each), in mesh order."""
        if self.n == 1:
            return [x]
        parts = [torch.empty_like(x) for _ in range(self.n)]  # in rank order
        dist.all_gather(parts, x.contiguous())
        return [parts[r] for r in self.ranks]

    def sum_disjoint(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's ``x`` where each entry is nonzero on one rank
        at most: one ``all_reduce`` (in place when ``x`` is contiguous),
        exact whatever order it adds in."""
        if self.n > 1:
            x = x.contiguous()
            dist.all_reduce(x)
        return x

    def sum(self, x: torch.Tensor) -> torch.Tensor:
        """Sum of every rank's ``x`` in mesh order: the same bits on every
        rank and on every repeat."""
        parts = self.gather(x)
        total = parts[0]
        for p in parts[1:]:
            total = total + p
        return total


def _local_elements(op, ranks: _Ranks, fields: tuple[str, ...]):
    """``op`` cut to this rank's element slab, with the assembly table of
    the slab's dofs; ``fields`` names the other element-batched fields."""
    _, per = ranks.rows(op.dofs.shape[0])
    lo = min(ranks.index * per, op.dofs.shape[0])
    sl = slice(lo, lo + per)
    dofs = op.dofs[sl]
    table = torch.as_tensor(assembly_table(dofs.cpu().numpy(), op.ndof), device=dofs.device)
    return op._replace(dofs=dofs, table=table, **{k: getattr(op, k)[sl] for k in fields})


def shard_stiffness_op(op: StiffnessOp, mesh=None) -> StiffnessOp:
    """This rank's element slab of a stiffness operator."""
    return _local_elements(op, _Ranks(mesh), ("A", "B", "C"))


def sharded_stiffness_apply(op: StiffnessOp, mesh=None) -> Callable:
    """y = S x with elements sharded over the ranks: ``apply(sharded_op, x)``
    for the rank's ``shard_stiffness_op`` and a replicated x; the partial
    assemblies are summed over the ranks."""
    ranks = _Ranks(mesh)

    def apply(sop: StiffnessOp, x: torch.Tensor) -> torch.Tensor:
        ye = stiffness_element_kernel(sop, gather_elements(sop.dofs, x))
        return ranks.sum(scatter_elements(sop.table, ye))

    return apply


def shard_mass_op(op: MassOp, mesh=None) -> MassOp:
    """This rank's element slab of a (weighted) mass operator."""
    return _local_elements(op, _Ranks(mesh), ("wdetj",))


def sharded_mass_apply(op: MassOp, mesh=None) -> Callable:
    """y = M x with elements sharded over the ranks (see
    ``sharded_stiffness_apply``)."""
    ranks = _Ranks(mesh)

    def apply(sop: MassOp, x: torch.Tensor) -> torch.Tensor:
        ye = mass_element_kernel(sop, gather_elements(sop.dofs, x))
        return ranks.sum(scatter_elements(sop.table, ye))

    return apply


def sharded_helmholtz_matvec(op: HelmholtzOp, mesh=None) -> Callable:
    """Element-sharded coupled Helmholtz action ``U -> A U``.

    Each rank applies its slab of the stiffness and weighted-mass elements
    to the stacked (u, v) pair, and one sum over the ranks of the (2, ndof)
    partials completes the volume terms.  The face-mass boundary terms act
    on O(sqrt(ndof)) DOFs and are computed replicated.  U is replicated."""
    if op.stiffness is None or op.mass is None:
        raise ValueError(
            "sharded_helmholtz_matvec needs the generic element-batched "
            "operators; build the op with make_helmholtz_op(..., kron=False)"
        )
    ranks = _Ranks(mesh)
    sop = shard_stiffness_op(op.stiffness, mesh)
    mop = shard_mass_op(op.mass, mesh)
    n = op.ndof
    w2 = op.omega * op.omega

    def matvec(U: torch.Tensor) -> torch.Tensor:
        UV = torch.stack([U[:n], U[n:]])
        ys = torch.stack([scatter_elements(sop.table, stiffness_element_kernel(
            sop, gather_elements(sop.dofs, w))) for w in UV])
        ym = torch.stack([scatter_elements(mop.table, mass_element_kernel(
            mop, gather_elements(mop.dofs, w))) for w in UV])
        Y = ranks.sum(ys - w2 * ym)
        Hu = apply_face_mass(op.face_mass, U[:n][op.face_proj])
        Hv = apply_face_mass(op.face_mass, U[n:][op.face_proj])
        Au = Y[0].index_add(0, op.face_proj, -op.omega * Hv)
        Av = -Y[1].index_add(0, op.face_proj, op.omega * Hu)
        return torch.cat([Au, Av])

    return matvec


_ROW_TABLES = ("gI", "gmask", "F_weight", "Ha", "inv_mi", "m_gmi", "fslot", "Hf", "a2wf",
               "B0", "B1")
_INDEX_TABLES = ("gI", "fslot", "B0", "B1")


class ShardedDDH:
    """Subdomain-sharded DDH: the ``action``, ``rhs`` and ``postprocess`` of
    ``DDH`` with the subdomain rows split over the ranks of ``mesh``.

    The rows are padded to a multiple of the world size (padded rows are
    inert: no DOF, no face slot, zero forcing) and rank r keeps rows
    ``[r L, (r + 1) L)`` of every table; lambda vectors are replicated.
    ``rhs`` and ``postprocess``, and ``action`` on the direct path, run one
    wave cycle over the rank's rows (one kernel launch on the card).  When
    ``ddh`` has its transfer matrices the action is the rank's batched
    transfer product; with a roll route whose offsets fit in one rank's
    rows, the rolled exchange sends each route's boundary rows to the
    neighbouring rank (products for those rows first, sends in flight
    while the interior product runs).
    """

    def __init__(self, ddh: DDH, mesh=None):
        self.inner = ddh
        self.ranks = ranks = _Ranks(mesh)
        p = ddh.params
        ndom = ddh.n_domains
        ndom_pad, L = ranks.rows(ndom)
        self.rows_per_rank = L
        lo = ranks.index * L
        self.row0 = lo

        def slab(t: torch.Tensor, fill=0) -> torch.Tensor:
            if ndom_pad != ndom:
                pad = t.new_full((ndom_pad - ndom, *t.shape[1:]), fill)
                t = torch.cat([t, pad])
            return t[lo:lo + L].contiguous()

        local = {k: slab(getattr(p, k), -1 if k in _INDEX_TABLES else 0) for k in _ROW_TABLES}
        S = slab(p.S) if p.S.dim() == 3 else p.S
        gI = local["gI"]
        sol_table = torch.as_tensor(assembly_table(gI.cpu().numpy(), ddh.g_ndof),
                                    device=gI.device)
        self.params = DDHParams(S=S, tables=p.tables, sol_table=sol_table, K0=p.K0, dt=p.dt,
                                omega=p.omega, **local)
        self.g_ndof = ddh.g_ndof
        self.n_lambda = ddh.n_lambda
        self.n_own = ddh.n_own
        self.size = ddh.size
        self.wh_maxit = ddh.wh_maxit
        self.pf = p.Hf.shape[1]
        self._k1 = None  # the kernel of a per-row S's cycles, built on first use

        self.use_transfer = ddh.use_transfer
        self.T = slab(ddh.T) if ddh.use_transfer else None
        # the rolled exchange, when every route offset fits in one rank's rows
        self.route_offs: tuple = ()
        self._roll = None
        route = ddh.route
        if ddh.use_transfer and route is not None and all(abs(o) <= L for o in route.offs):
            if route.A is not None:
                A_full = route.A
            else:
                A_full = route.A0.expand(ndom, -1, -1).clone()
                if route.A_spec is not None:
                    A_full[route.spec_idx] += route.A_spec
            masks = route.masks
            if ndom_pad != ndom:
                masks = torch.cat([masks, masks.new_zeros(
                    (masks.shape[0], ndom_pad - ndom, masks.shape[2]))], dim=1)
            src = route.irr_src.cpu().numpy()
            mine = (src // self.pf >= lo) & (src // self.pf < lo + L)
            dev = route.irr_src.device
            self.route_offs = tuple(route.offs)
            self._roll = (
                slab(A_full),
                masks[:, lo:lo + L].contiguous(),
                route.perms,
                torch.as_tensor(src[mine] - lo * self.pf, device=dev),
                route.irr_tgt[torch.as_tensor(np.nonzero(mine)[0], device=dev)],
            )

    # ----------------------------------------------------------- helpers

    def _cycle(self, params: DDHParams, F, G, wh_maxit: int):
        """The wave cycle on the rank's rows; on the card on the operator's
        kernel for a shared S (``DDH.k1``), or on the per-row kernel of the
        rank's slab of a per-domain S (built once), repeated for K
        sources."""
        if not F.is_cuda:
            return wave_cycle(params, F, G, wh_maxit)
        if params.S.dim() == 2:
            return wave_cycle(params, F, G, wh_maxit, kernel=self.inner.k1)
        if self._k1 is None:
            self._k1 = k1_kernel(self.params.S, per_row=True)
        kernel = self._k1.repeat(F.shape[0] // self.rows_per_rank)
        return wave_cycle(params, F, G, wh_maxit, kernel=kernel)

    def _local_lam(self, lam: torch.Tensor) -> torch.Tensor:
        """The rank's rows of the own-slot traces of ``lam`` (K, 2 n_lambda)
        as a (K, 2 L pf) vector in the own-slot layout of the slab."""
        n_own, pf = self.n_own, self.pf
        lo, hi = self.row0 * pf, (self.row0 + self.rows_per_rank) * pf
        halves = []
        for off in (0, self.n_lambda):
            own = lam[:, off:off + n_own]
            if hi > n_own:
                own = torch.cat([own, own.new_zeros((own.shape[0], hi - n_own))], dim=1)
            halves.append(own[:, lo:hi])
        return torch.cat(halves, dim=1)

    def _traces(self, lam2: torch.Tensor):
        n = self.rows_per_rank * self.pf
        return _read_traces(self.params, self._local_lam(lam2), n, n)

    # --------------------------------------------------------- operators

    def action(self, lam: torch.Tensor) -> torch.Tensor:
        """y = lambda - S(lambda) for a replicated lambda (2 n_lambda,)."""
        lam2 = lam[None]
        if self._roll is not None:
            return self._action_rolled(lam2)[0]
        if self.use_transfer:
            pf = self.pf
            lam0, mu0 = self._traces(lam2)
            w = torch.einsum("dik,bdk->bdi", self.T, torch.cat([lam0, mu0], dim=2))
            upd = _b1_scatter(self.params, -lam0 - w[..., :pf], -mu0 + w[..., pf:],
                              self.n_lambda)
        else:
            n = self.rows_per_rank * self.pf
            F, G, lam0, mu0 = _forcing(self.params, None, self._local_lam(lam2), 0, n)
            u, v = _run_cycle(self._cycle, self.params, F, G, self.wh_maxit)
            upd = _scatter_updates(self.params, lam0, mu0, u, v, self.n_lambda)
        return (lam2 - self.ranks.sum_disjoint(upd))[0]

    def rhs(self, f: torch.Tensor) -> torch.Tensor:
        """Substructured rhs of a replicated forcing f (2 g_ndof,): a wave
        cycle over the rank's rows."""
        f2 = f.to(self.params.gmask.dtype)[None]
        F, G, lam0, mu0 = _forcing(self.params, f2, None, self.g_ndof)
        u, v = _run_cycle(self._cycle, self.params, F, G, self.wh_maxit)
        return self.ranks.sum_disjoint(
            _scatter_updates(self.params, lam0, mu0, u, v, self.n_lambda))[0]

    def postprocess(self, lam: torch.Tensor, f: torch.Tensor) -> torch.Tensor:
        """[u; v] from a replicated lambda and forcing: a wave cycle over the
        rank's rows, the mass-weighted assembly summed over the ranks."""
        f2 = f.to(self.params.gmask.dtype)[None]
        n = self.rows_per_rank * self.pf
        F, G, _, _ = _forcing(self.params, f2, self._local_lam(lam[None]), self.g_ndof, n)
        u, v = _run_cycle(self._cycle, self.params, F, G, self.wh_maxit)
        return self.ranks.sum(_scatter_solution(self.params, u, v, self.g_ndof))[0]

    def _action_rolled(self, lam2: torch.Tensor) -> torch.Tensor:
        """The rolled trace exchange with halo sends.  Per route, a roll by
        ``off`` over the domain axis moves the rank's last ``off`` rows (or
        first ``-off``) to the next (previous) rank: those rows' products
        are computed first and sent, the interior product runs while they
        are in flight, then each route's rows are shifted locally and
        completed by the received halo.  The own-slot results are gathered
        from every rank; the irregular remainder (one writer per entry) is
        summed."""
        A, masks, perms, irr_src, irr_tgt = self._roll
        ranks, pf, n_own, n_lambda = self.ranks, self.pf, self.n_own, self.n_lambda
        K = lam2.shape[0]
        lam0, mu0 = self._traces(lam2)
        x = torch.cat([lam0, mu0], dim=2)
        L = x.shape[1]
        sends, recvs = [], []
        for i, off in enumerate(self.route_offs):
            if off == 0:
                recvs.append(None)
                continue
            rows = slice(L - off, L) if off > 0 else slice(0, -off)
            u2b = torch.einsum("dik,bdk->bdi", A[rows], x[:, rows])
            mu_b = masks[i, rows] * torch.nn.functional.pad(u2b, (0, 1))
            if ranks.n == 1:
                recvs.append(mu_b)  # the neighbour is this rank: a local copy
                continue
            step = 1 if off > 0 else -1
            to = ranks.ranks[(ranks.index + step) % ranks.n]
            frm = ranks.ranks[(ranks.index - step) % ranks.n]
            buf = torch.empty_like(mu_b)
            sends += [dist.P2POp(dist.isend, mu_b.contiguous(), to),
                      dist.P2POp(dist.irecv, buf, frm)]
            recvs.append(buf)
        reqs = dist.batch_isend_irecv(sends) if sends else []
        u2 = torch.einsum("dik,bdk->bdi", A, x)  # interior, while the halo travels
        u2p = torch.nn.functional.pad(u2, (0, 1))
        for r in reqs:
            r.wait()
        out_loc = torch.zeros_like(u2)
        for i, off in enumerate(self.route_offs):
            mu_ = masks[i] * u2p
            if off > 0:
                shifted = torch.cat([recvs[i], mu_[:, :L - off]], dim=1)
            elif off < 0:
                shifted = torch.cat([mu_[:, -off:], recvs[i]], dim=1)
            else:
                shifted = mu_
            out_loc = out_loc + shifted[..., perms[i]]
        full = torch.cat(ranks.gather(out_loc), dim=1)  # (K, ndom_pad, 2pf)
        tail = lam2.new_zeros((K, n_lambda - n_own))
        out_l = torch.cat([full[..., :pf].reshape(K, -1)[:, :n_own], tail], dim=1)
        out_m = torch.cat([full[..., pf:].reshape(K, -1)[:, :n_own], tail], dim=1)
        add2 = lam2.new_zeros((K, 2, n_lambda + 1))
        add2[:, 0, irr_tgt] = u2[..., :pf].reshape(K, -1)[:, irr_src]
        add2[:, 1, irr_tgt] = u2[..., pf:].reshape(K, -1)[:, irr_src]
        add2 = ranks.sum_disjoint(add2)
        out = torch.cat([out_l + add2[:, 0, :n_lambda], out_m + add2[:, 1, :n_lambda]], dim=1)
        return lam2 - out
