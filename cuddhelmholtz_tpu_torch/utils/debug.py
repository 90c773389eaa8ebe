"""Opt-in debug validation (``CUDDH_DEBUG``).

Counterpart of ``cuddhelmholtz_tpu/utils/debug.py``.  The apply path masks
the -1 padding of its index tables (clamped gathers, scatters to a dropped
slot), so a corrupted table would give wrong numbers silently.  Setting
``CUDDH_DEBUG=1`` turns on:

  * setup-time audits of the index tables (every entry -1 padding or in
    range): ``H1Space``, ``FaceSpace``, ``EnsembleSpace`` and ``DDH`` run
    them in their constructors;
  * finiteness checks on the inputs of ``DDH.action``, ``DDH.rhs`` and
    ``DDH.postprocess``.

The flag is read on every call, so tests can toggle it with ``monkeypatch``.
With it off no check runs and nothing is copied to the host.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def debug_enabled() -> bool:
    v = os.environ.get("CUDDH_DEBUG", "")
    return v not in ("", "0", "false", "False")


def check_index_table(name: str, table, size: int, allow_pad: bool = True) -> None:
    """Audit an index table: every entry in [0, size), or -1 padding.

    No-op unless ``CUDDH_DEBUG`` is set.  Raises ``ValueError`` naming the
    first offending entry."""
    if not debug_enabled():
        return
    arr = table.cpu().numpy() if isinstance(table, torch.Tensor) else np.asarray(table)
    lo = -1 if allow_pad else 0
    bad = (arr < lo) | (arr >= size)
    if bad.any():
        idx = np.unravel_index(int(np.argmax(bad)), arr.shape)
        raise ValueError(
            f"CUDDH_DEBUG: index table '{name}' entry {idx} = "
            f"{int(arr[idx])} outside [{lo}, {size})"
        )


def check_finite(name: str, x) -> None:
    """Raise ``FloatingPointError`` if ``x`` holds NaN or Inf.  No-op unless
    ``CUDDH_DEBUG`` is set; a tensor is checked where it lies and only the
    count of bad entries comes to the host."""
    if not debug_enabled():
        return
    if isinstance(x, torch.Tensor):
        n_bad = int((~torch.isfinite(x)).sum())
    else:
        n_bad = int((~np.isfinite(np.asarray(x))).sum())
    if n_bad:
        raise FloatingPointError(f"CUDDH_DEBUG: '{name}' contains {n_bad} non-finite entries")
