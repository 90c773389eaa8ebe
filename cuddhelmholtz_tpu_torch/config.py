"""Problem/solver configuration dataclasses.

Counterpart of ``cuddhelmholtz_tpu/config.py`` (copied: importing the JAX
module would import jax).  ``BASELINE_CONFIGS`` holds the JAX package's nine
entries in its order and with its values; each also has a module constant
(``DDH_STRUCTURED``, ...).  The JAX package's ``rhs_split`` field is left
out: no JAX driver reads it (the option is ``DDH(rhs_split=)``).
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
    kind: str = "ddh"  # "poisson" | "helmholtz" | "ddh" | "helmholtz_ddh" | "ddh_multi"
    nx: int = 128
    deg: int = 3
    mesh: str = "uniform_rect"  # or "unstructured_square"
    gmres: GmresConfig = field(default_factory=GmresConfig)
    wh_maxit: int = 5
    n_domains: int | None = None  # for unstructured partitions
    # precompute the per-subdomain trace-transfer matrices (and, on a GPU,
    # the io maps): the production DDH matvec
    transfer: bool = True
    # kind="ddh_multi": right-hand sides solved in one batched solve
    n_sources: int = 8
    # DDH subdomain side length in DOFs
    block_size: int = 16
    # two-level coarse correction: None | "additive" | "multiplicative"
    # (solvers/coarse.py; needs transfer=True)
    coarse: str | None = None

    @property
    def omega(self) -> float:
        return 2 * math.pi * self.nx / 10


POISSON_STRUCTURED = ProblemConfig(
    name="poisson_structured",
    kind="poisson",
    nx=15,
    gmres=GmresConfig(m=20, maxit=20, tol=1e-6),
)

# unpreconditioned GMRES(200) on the coupled system; it stagnates, so a cut
# maxit pins a residual level
HELMHOLTZ_UNPRECONDITIONED = ProblemConfig(
    name="helmholtz_unpreconditioned",
    kind="helmholtz",
    nx=128,
    gmres=GmresConfig(m=200, maxit=10_000, tol=1e-6),
)

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

# 591,361 DOFs at twice the reference frequency: 4,096 subdomains of 169
# DOFs, as the flagship's
DDH_HIGH_FREQUENCY = ProblemConfig(
    name="ddh_high_frequency",
    nx=256,  # omega = 2*pi*25.6
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

# the coupled system to 1e-6: fp64 refinement of fp32 FGMRES, a bounded
# fp32 DDH solve as the right preconditioner
HELMHOLTZ_DDH_1E6 = ProblemConfig(
    name="helmholtz_ddh_1e6",
    kind="helmholtz_ddh",
    nx=128,
    gmres=GmresConfig(m=20, maxit=100, tol=1e-6),
)

# the target metric: outer iterations to 1e-6 on the unstructured square,
# DDH-preconditioned (coordinate-bisection partition)
HELMHOLTZ_DDH_UNSTRUCTURED_1E6 = ProblemConfig(
    name="helmholtz_ddh_unstructured_1e6",
    kind="helmholtz_ddh",
    nx=8,  # sets omega; geometry comes from the mesh file
    mesh="unstructured_square",
    n_domains=8,
    gmres=GmresConfig(m=20, maxit=100, tol=1e-6),
)

# 8 ring sources in one batched substructured solve; m=40 for the block
# solver, whose shared space of m*K directions cuts the restarts
DDH_MULTI_SOURCE_8 = ProblemConfig(
    name="ddh_multi_source_8",
    kind="ddh_multi",
    nx=128,
    n_sources=8,
    gmres=GmresConfig(m=40, maxit=100, tol=1e-4),
)

BASELINE_CONFIGS = (
    POISSON_STRUCTURED,
    HELMHOLTZ_UNPRECONDITIONED,
    DDH_STRUCTURED,
    DDH_UNSTRUCTURED_SQUARE,
    DDH_HIGH_FREQUENCY,
    DDH_512_BLOCK32,
    HELMHOLTZ_DDH_1E6,
    HELMHOLTZ_DDH_UNSTRUCTURED_1E6,
    DDH_MULTI_SOURCE_8,
)
