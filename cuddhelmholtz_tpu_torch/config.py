"""Problem/solver configuration dataclasses.

Counterpart of ``cuddhelmholtz_tpu/config.py`` (copied: importing the JAX
module would import jax).  Three DDH entries are carried, ``ddh_structured``,
``ddh_unstructured_square`` and ``ddh_512_block32``, with the fields the port
reads; the JAX package's ``coarse``, ``rhs_split`` and ``n_sources`` fields
come with the code that reads them.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field


@dataclass(frozen=True)
class GmresConfig:
    m: int = 20
    maxit: int = 100
    tol: float = 1e-6


@dataclass(frozen=True)
class ProblemConfig:
    name: str
    kind: str = "ddh"  # the JAX package's other kinds are not ported
    nx: int = 128
    deg: int = 3
    mesh: str = "uniform_rect"  # or "unstructured_square"
    gmres: GmresConfig = field(default_factory=GmresConfig)
    wh_maxit: int = 5
    n_domains: int | None = None  # for unstructured partitions
    # precompute the per-subdomain trace-transfer matrices (and, on a GPU,
    # the io maps): the production DDH matvec
    transfer: bool = True
    # DDH subdomain side length in DOFs
    block_size: int = 16

    @property
    def omega(self) -> float:
        return 2 * math.pi * self.nx / 10


DDH_STRUCTURED = ProblemConfig(
    name="ddh_structured",
    nx=128,
    gmres=GmresConfig(m=20, maxit=100, tol=1e-4),
)

DDH_UNSTRUCTURED_SQUARE = ProblemConfig(
    name="ddh_unstructured_square",
    nx=8,  # sets omega; geometry comes from the mesh file
    mesh="unstructured_square",
    n_domains=8,
    gmres=GmresConfig(m=20, maxit=100, tol=1e-4),
)

# 2.4M DOFs at 4x the reference frequency with 32-DOF subdomain blocks
# (4,096 subdomains of 625 DOFs, pad 632): the dense stiffness (1.6 MB)
# exceeds a block's shared memory, its non-zeros (58 KB) do not, so its
# probes run the sparse kernel
DDH_512_BLOCK32 = ProblemConfig(
    name="ddh_512_block32",
    nx=512,  # omega = 2*pi*51.2
    block_size=32,
    gmres=GmresConfig(m=20, maxit=100, tol=1e-4),
)
