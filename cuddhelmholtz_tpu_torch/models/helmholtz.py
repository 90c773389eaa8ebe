"""Forcing of the coupled real-imaginary Helmholtz system.

Counterpart of ``helmholtz_rhs`` in ``cuddhelmholtz_tpu/models/helmholtz.py``.
The coupled operator itself is not on the direct DDH path and is not ported
yet.
"""

from __future__ import annotations

from typing import Callable

import torch

from ..ops.functional import linear_functional
from ..spaces.h1 import H1Space


def helmholtz_rhs(space: H1Space, f: Callable, dtype=torch.float64) -> torch.Tensor:
    """b = [(f, phi); 0] using the collocation functional."""
    bu = linear_functional(space, f, dtype=dtype)
    return torch.cat([bu, torch.zeros_like(bu)])
