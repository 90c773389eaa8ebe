"""Coupled real-imaginary Helmholtz operator, its forcing and coefficient projection.

Counterpart of ``cuddhelmholtz_tpu/models/helmholtz.py``.  The bilinear form

  a([u, v], phi) = [ (grad u, grad phi) - omega^2 (a^2 u, phi) - omega <a v, phi>;
                   -((grad v, grad phi) - omega^2 (a^2 v, phi) + omega <a u, phi>) ]

acts on U = [u; v] (U = u + i v), with first-order absorbing boundaries as
the face-mass term; the sign flip of the second block symmetrises the
system.  Three stiffness/mass paths, as in the JAX package: generic
(gather + table assembly), structured (``grid=``, strided slices on a
``GridH1Space``) and kron (dense 1D factors; chosen by ``make_helmholtz_op``
on a ``GridH1Space``).  The JAX package's differentiable templates
(``HelmholtzTemplate``, ``helmholtz_op_with_coeff``) wait for the inverse
problem.
"""

from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ..ops.face_mass import (
    FaceMassOp,
    apply_diag_inv_face_mass,
    apply_face_mass,
    make_diag_inv_face_mass_op,
    make_face_mass_op,
)
from ..ops.functional import face_linear_functional, linear_functional
from ..ops.kron import (
    KronMassOp,
    KronStiffnessOp,
    apply_mass_kron,
    apply_stiffness_kron,
    make_kron_mass_op,
    make_kron_stiffness_op,
)
from ..ops.mass import (
    MassOp,
    apply_diag_inv_mass,
    apply_mass,
    assembly_table,
    make_diag_inv_mass_op,
    make_mass_op,
)
from ..ops.stiffness import StiffnessOp, apply_stiffness, make_stiffness_op
from ..ops.structured import GridH1Space, apply_mass_structured, apply_stiffness_structured
from ..solvers.gmres import gmres
from ..spaces.h1 import FaceSpace, H1Space
from ..utils.quadrature import QuadratureRule


class HelmholtzOp(NamedTuple):
    """Data for the coupled (u, v) Helmholtz operator."""

    stiffness: StiffnessOp | None  # None when the kron fast path supersedes it
    mass: MassOp | None  # weighted by a^2; None when kron supersedes it
    face_mass: FaceMassOp  # weighted by a
    face_proj: torch.Tensor  # (fdof,) int64 global indices of face DOFs
    omega: float
    ndof: int
    kron_stiffness: KronStiffnessOp | None = None
    kron_mass: KronMassOp | None = None


def make_helmholtz_op(
    omega: float,
    a2_nodal: np.ndarray,
    a_face_nodal: np.ndarray,
    space: H1Space,
    fs: FaceSpace,
    dtype=torch.float64,
    kron: bool | None = None,
    *,
    device="cpu",
) -> HelmholtzOp:
    """``kron=None`` chooses the 1D-factorised dense-matmul path
    (``ops/kron.py``) when ``space`` is a ``GridH1Space``; it then builds no
    generic stiffness or mass data."""
    if kron is None:
        kron = isinstance(space, GridH1Space)
    ks = km = stiffness = mass = None
    if kron:
        ks = make_kron_stiffness_op(space, dtype=dtype, device=device)
        km = make_kron_mass_op(space, coeff=a2_nodal, dtype=dtype, device=device)
    else:
        stiffness = make_stiffness_op(space, dtype=dtype, device=device)
        mass = make_mass_op(space, coeff=a2_nodal, dtype=dtype, device=device)
    return HelmholtzOp(
        stiffness=stiffness,
        mass=mass,
        face_mass=make_face_mass_op(fs, coeff=a_face_nodal, dtype=dtype, device=device),
        face_proj=torch.as_tensor(fs.proj, dtype=torch.int64, device=device),
        omega=float(omega),
        ndof=space.ndof,
        kron_stiffness=ks,
        kron_mass=km,
    )


def apply_helmholtz(op: HelmholtzOp, U: torch.Tensor, grid: tuple | None = None) -> torch.Tensor:
    """Y = A U for U = [u; v] of length 2*ndof.  Pass ``grid=(nx, ny)`` on a
    GridH1Space to use the strided-slice structured assembly (the kron path
    takes precedence when the op has it)."""
    n = op.ndof
    u, v = U[:n], U[n:]
    w2 = op.omega * op.omega
    if op.kron_stiffness is not None:
        def S(w):
            return apply_stiffness_kron(op.kron_stiffness, w)

        def M(w):
            return apply_mass_kron(op.kron_mass, w)
    elif grid is not None:
        def S(w):
            return apply_stiffness_structured(op.stiffness, grid, w)

        def M(w):
            return apply_mass_structured(op.mass, grid, w)
    else:
        def S(w):
            return apply_stiffness(op.stiffness, w)

        def M(w):
            return apply_mass(op.mass, w)

    Su = S(u) - w2 * M(u)
    Sv = S(v) - w2 * M(v)
    Hu = apply_face_mass(op.face_mass, u[op.face_proj])
    Hv = apply_face_mass(op.face_mass, v[op.face_proj])
    # face_proj is unique, so these adds have one writer per entry
    Au = Su.index_add(0, op.face_proj, -op.omega * Hv)
    Av = -Sv.index_add(0, op.face_proj, op.omega * Hu)
    return torch.cat([Au, Av])


def helmholtz_rhs(space: H1Space, f: Callable, dtype=torch.float64) -> torch.Tensor:
    """b = [(f, phi); 0] using the collocation functional."""
    bu = linear_functional(space, f, dtype=dtype)
    return torch.cat([bu, torch.zeros_like(bu)])


def project_coefficients(
    space: H1Space, fs: FaceSpace, a_fn: Callable, dtype=torch.float64
) -> tuple[np.ndarray, np.ndarray]:
    """L2-project a^2 onto the H1 space and a onto the face space, on the
    host: 2*nb-point Gauss-Legendre functionals, mass solves by GMRES(5),
    <= 10 restarts, tol 1e-12, diagonal preconditioning.  Returns nodal
    numpy vectors."""
    quad = QuadratureRule(2 * space.n_basis, QuadratureRule.GaussLegendre)

    b = linear_functional(space, lambda xy: a_fn(xy) ** 2, quad, dtype=dtype)
    mass = make_mass_op(space, dtype=dtype)
    pinv = make_diag_inv_mass_op(space, dtype=dtype)
    out = gmres(lambda x: apply_mass(mass, x), b, m=5, maxit=10, tol=1e-12,
                precond=lambda x: apply_diag_inv_mass(pinv, x))

    bf = face_linear_functional(fs, a_fn, quad, dtype=dtype)
    fmass = make_face_mass_op(fs, dtype=dtype)
    fpinv = make_diag_inv_face_mass_op(fs, dtype=dtype)
    outf = gmres(lambda x: apply_face_mass(fmass, x), bf, m=5, maxit=10, tol=1e-12,
                 precond=lambda x: apply_diag_inv_face_mass(fpinv, x))
    return out.x.numpy(), outf.x.numpy()


def helmholtz_op_from_jax(arrays: dict[str, np.ndarray], device) -> HelmholtzOp:
    """The port's ``HelmholtzOp`` from the JAX ``HelmholtzOp``'s fields as
    numpy arrays: keys ``omega``, ``ndof``, ``face_proj``, ``face_mass.<f>``
    and, where the JAX op has them, ``stiffness.<f>``, ``mass.<f>``,
    ``kron_stiffness.<f>`` and ``kron_mass.<f>`` (``<f>`` a field of the
    JAX sub-op).  The assembly tables are rebuilt from the index fields."""
    def sub(prefix):
        d = {k.split(".", 1)[1]: v for k, v in arrays.items() if k.startswith(prefix + ".")}
        return d or None

    def t(a, dtype=None):
        return torch.as_tensor(np.array(a), dtype=dtype, device=device)

    ndof = int(arrays["ndof"])
    stiffness = mass = ks = km = None
    if (d := sub("stiffness")) is not None:
        table = t(assembly_table(d["dofs"], ndof))
        stiffness = StiffnessOp(dofs=t(d["dofs"], torch.int64), P=t(d["P"]), D=t(d["D"]),
                                A=t(d["A"]), B=t(d["B"]), C=t(d["C"]), ndof=ndof, table=table)
    if (d := sub("mass")) is not None:
        mass = MassOp(dofs=t(d["dofs"], torch.int64), P=t(d["P"]), wdetj=t(d["wdetj"]),
                      ndof=ndof, table=t(assembly_table(d["dofs"], ndof)))
    if (d := sub("kron_stiffness")) is not None:
        ks = KronStiffnessOp(**{k: t(d[k]) for k in KronStiffnessOp._fields})
    if (d := sub("kron_mass")) is not None:
        km = KronMassOp(**{k: t(d[k]) for k in KronMassOp._fields})
    fm = sub("face_mass")
    fdof = int(fm["fdof"])
    face_mass = FaceMassOp(fdofs=t(fm["fdofs"], torch.int64), P=t(fm["P"]), wds=t(fm["wds"]),
                           fdof=fdof, table=t(assembly_table(fm["fdofs"], fdof)))
    return HelmholtzOp(
        stiffness=stiffness, mass=mass, face_mass=face_mass,
        face_proj=t(arrays["face_proj"], torch.int64), omega=float(arrays["omega"]),
        ndof=ndof, kron_stiffness=ks, kron_mass=km,
    )
