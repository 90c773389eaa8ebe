"""Problem/solver configuration dataclasses.

Counterpart of ``cuddhelmholtz_tpu/config.py`` (copied: importing the JAX
module would import jax).  Only the flagship entry, ``ddh_structured``, is
carried, with the fields the port's direct path reads; the JAX package's
``transfer``, ``coarse``, ``rhs_split``, ``n_sources`` and mesh-file fields
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
    nx: int = 128
    deg: int = 3
    gmres: GmresConfig = field(default_factory=GmresConfig)
    wh_maxit: int = 5
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
