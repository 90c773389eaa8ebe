"""Matrix-free (weighted) mass operator, its lumped diagonal and inverse.

Counterpart of ``cuddhelmholtz_tpu/ops/mass.py``.  Setup collocates
``a * w_i * w_j * detJ`` on a Gauss-Legendre grid per element on the host in
float64; the action is gather -> 1D interpolation (sum factorisation) ->
pointwise scale -> transpose interpolation -> assembly, as batched einsums.

The assembly is deterministic on every device: where the JAX package calls
``segment_sum``, the port gathers each global DOF's element contributions
through a padded table built once on the host (``assembly_table``) and sums
them in a fixed order, so no float atomics decide the order of a sum.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from ..spaces.h1 import H1Space
from ..utils.device import check_device
from ..utils.quadrature import QuadratureRule


def assembly_table(ids: np.ndarray, n: int) -> np.ndarray:
    """(n, k) int64 table of the flat positions of ``ids`` that hold each
    target 0..n-1, in ascending position order, padded with ``ids.size``
    (the index of an appended zero; see ``assemble``).  Negative ids are
    padding and belong to no target."""
    flat = np.asarray(ids).reshape(-1).astype(np.int64)
    pos = np.nonzero(flat >= 0)[0]
    target = flat[pos]
    order = np.argsort(target, kind="stable")
    counts = np.bincount(target, minlength=n)
    starts = np.zeros(n + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    target = target[order]
    table = np.full((n, max(int(counts.max(initial=0)), 1)), flat.size, dtype=np.int64)
    table[target, np.arange(target.size) - starts[target]] = pos[order]
    return table


def assemble(table: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """y[i] = sum of the ``vals`` (flattened) that ``table`` row i names, in
    table order: a gather and a row sum, no atomics."""
    flat = torch.cat([vals.reshape(-1), vals.new_zeros(1)])
    return flat[table].sum(dim=1)


class _Gather(torch.autograd.Function):
    """x[idx] whose backward sums the gradient through an assembly table."""

    @staticmethod
    def forward(x, idx, table):
        return x[idx]

    @staticmethod
    def setup_context(ctx, inputs, output):
        ctx.save_for_backward(inputs[2])

    @staticmethod
    def backward(ctx, grad):
        (table,) = ctx.saved_tensors
        return assemble(table, grad), None, None


def gather(x: torch.Tensor, idx: torch.Tensor, table: torch.Tensor) -> torch.Tensor:
    """``x[idx]`` for an index array with repeated entries, differentiable
    in ``x`` with a deterministic backward: the gradient of entry i of x is
    ``assemble(table, grad)``, the sum over the positions ``table`` row i
    names (``table = assembly_table(idx, x.shape[0])``) in a fixed order.
    Plain indexing would sum by ``index_put_(accumulate=True)``, float
    atomics in no fixed order on CUDA."""
    return _Gather.apply(x, idx, table)


class MassOp(NamedTuple):
    """Collocated mass-operator data.

    dofs:  (nel, nb, nb) int64   [el, iy, ix] -> global DOF
    P:     (nq, nb)              1D basis-to-quadrature interpolation
    wdetj: (nel, nq, nq)         a * w_qx * w_qy * detJ at [el, qy, qx]
    ndof:  number of global DOFs
    table: (ndof, k) int64       ``assembly_table`` of ``dofs``
    """

    dofs: torch.Tensor
    P: torch.Tensor
    wdetj: torch.Tensor
    ndof: int
    table: torch.Tensor


def variable_coeff_n_quad(space: H1Space) -> int:
    """The reference's quadrature size for a variable coefficient:
    1 + 3*nb/2 + mesh order."""
    return 1 + (3 * space.n_basis) // 2 + space.mesh.max_element_order


def collocate_mass(
    space: H1Space, coeff: np.ndarray | None = None, n_quad: int | None = None
) -> tuple[np.ndarray, np.ndarray]:
    """Host-side collocated mass data ``(P, a*w*w*detJ)`` (NumPy float64).

    ``coeff`` is a nodal global vector (a at the GLL nodes), interpolated to
    the quadrature grid.  The quadrature size defaults to nb + mesh order for
    a == 1 and ``variable_coeff_n_quad`` for a variable a.
    """
    nb = space.n_basis
    if n_quad is None:
        n_quad = nb + space.mesh.max_element_order if coeff is None else variable_coeff_n_quad(space)
    quad = QuadratureRule(n_quad, QuadratureRule.GaussLegendre)
    P = space.basis.eval(quad.x)  # (nq, nb)
    detj = space.mesh.element_metrics(quad).measures.transpose(0, 2, 1)  # (nel, qy, qx)
    wdetj = np.outer(quad.w, quad.w)[None] * detj
    if coeff is not None:
        a_e = np.asarray(coeff)[space.dofs]  # (nel, iy, ix)
        wdetj = wdetj * np.einsum("qi,rj,eji->erq", P, P, a_e)
    return P, wdetj


def element_tables(space: H1Space, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(dofs, assembly table) of ``space`` as int64 tensors on ``device``."""
    return (torch.as_tensor(space.dofs, dtype=torch.int64, device=device),
            torch.as_tensor(assembly_table(space.dofs, space.ndof), device=device))


def make_mass_op(
    space: H1Space,
    coeff: np.ndarray | None = None,
    dtype=torch.float64,
    n_quad: int | None = None,
    *,
    device="cuda",
) -> MassOp:
    """Mass-operator data for ``(a(x) u, v)`` on ``space`` (see
    ``collocate_mass`` for the quadrature conventions), on ``device`` (the
    card unless the caller asks for the CPU)."""
    device = check_device(device)
    P, wdetj = collocate_mass(space, coeff, n_quad)
    dofs, table = element_tables(space, device)
    return MassOp(
        dofs=dofs,
        P=torch.as_tensor(P, dtype=dtype, device=device),
        wdetj=torch.as_tensor(wdetj, dtype=dtype, device=device),
        ndof=space.ndof,
        table=table,
    )


def mass_op_with_coeff(base: MassOp, coeff: torch.Tensor) -> MassOp:
    """Re-weight a unit-coefficient ``MassOp`` by the nodal field ``coeff``,
    differentiably: ``a_q = P a_e P^T`` per element, ``wdetj * a_q``.

    ``base`` must be built by ``make_mass_op(space, n_quad=
    variable_coeff_n_quad(space))`` so its quadrature is the
    variable-coefficient rule; the result then equals
    ``make_mass_op(space, coeff=...)``'s collocation."""
    a_e = gather(coeff, base.dofs, base.table).to(base.P.dtype)  # (nel, iy, ix)
    a_q = torch.einsum("qi,rj,eji->erq", base.P, base.P, a_e)
    return base._replace(wdetj=base.wdetj * a_q)


def gather_elements(dofs: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x[dofs]: (nel, nb, nb) element tensors from the global vector."""
    return x[dofs]


def scatter_elements(table: torch.Tensor, ye: torch.Tensor) -> torch.Tensor:
    """CG assembly: sum element contributions per global DOF (``assemble``
    with the op's table)."""
    return assemble(table, ye)


def mass_element_kernel(op, xe: torch.Tensor) -> torch.Tensor:
    """(nel, iy, ix) element tensors -> weighted-mass element contributions
    (shared by the generic and the structured assembly)."""
    t = torch.einsum("qi,eji->ejq", op.P, xe)  # interp x -> (nel, iy, qx)
    u = torch.einsum("rj,ejq->erq", op.P, t)  # interp y -> (nel, qy, qx)
    u = u * op.wdetj
    t = torch.einsum("qi,erq->eri", op.P, u)  # integrate x -> (nel, qy, ix)
    return torch.einsum("rj,eri->eji", op.P, t)  # integrate y -> (nel, iy, ix)


def apply_mass(op: MassOp, x: torch.Tensor) -> torch.Tensor:
    """y = M x (matrix-free, batched over elements)."""
    return scatter_elements(op.table, mass_element_kernel(op, gather_elements(op.dofs, x)))


def lumped_mass_diagonal(space: H1Space, coeff: np.ndarray | None = None) -> np.ndarray:
    """Global lumped mass diagonal sum_e a w_i w_j detJ (GLL collocation)."""
    quad = space.basis.quadrature
    detj = space.mesh.element_metrics(quad).measures.transpose(0, 2, 1)  # (nel, iy, ix)
    m_e = np.outer(quad.w, quad.w)[None] * detj
    if coeff is not None:
        m_e = m_e * np.asarray(coeff)[space.dofs]
    diag = np.zeros(space.ndof, dtype=np.float64)
    np.add.at(diag, space.dofs.reshape(-1), m_e.reshape(-1))
    return diag


class DiagInvMassOp(NamedTuple):
    """p = 1 / diag(M) via GLL collocation lumping."""

    p: torch.Tensor


def make_diag_inv_mass_op(
    space: H1Space, coeff: np.ndarray | None = None, dtype=torch.float64, *, device="cuda"
) -> DiagInvMassOp:
    device = check_device(device)
    return DiagInvMassOp(
        p=torch.as_tensor(1.0 / lumped_mass_diagonal(space, coeff), dtype=dtype, device=device))


def apply_diag_inv_mass(op: DiagInvMassOp, x: torch.Tensor) -> torch.Tensor:
    return op.p * x
