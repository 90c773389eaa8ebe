"""Vector norm used by the solvers (counterpart of ``utils/linalg.norm``)."""

from __future__ import annotations

import torch


def norm(x: torch.Tensor) -> torch.Tensor:
    """Euclidean norm as a 0-d tensor on ``x``'s device (no host sync)."""
    return torch.linalg.vector_norm(x)
