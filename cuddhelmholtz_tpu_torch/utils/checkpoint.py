"""Solver checkpoint and resume.

Counterpart of ``cuddhelmholtz_tpu/utils/checkpoint.py``.  Restarted GMRES
is checkpointable at a restart: its state is the iterate x and the residual
history, and ``gmres(..., x0=x)`` resumes from it exactly.  These helpers
keep that state, and any solver metadata, in one ``.npz``.
"""

from __future__ import annotations

import os

import numpy as np
import torch


def _host(v) -> np.ndarray:
    return v.detach().cpu().numpy() if isinstance(v, torch.Tensor) else np.asarray(v)


def save_solver_state(path: str, x, res_norm=None, **meta) -> None:
    """Write an iterate (a tensor or array), its residual history and
    metadata (``meta_<key>`` entries) to ``path``."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    payload = {"x": _host(x)}
    if res_norm is not None:
        payload["res_norm"] = _host(res_norm)
    for k, v in meta.items():
        payload[f"meta_{k}"] = _host(v)
    np.savez(path, **payload)


def load_solver_state(path: str) -> dict:
    """Read a checkpoint: {'x': ..., 'res_norm': ..., <meta keys>}, NumPy
    arrays (``torch.as_tensor`` puts ``x`` back on a device)."""
    with np.load(path) as data:
        return {(k[5:] if k.startswith("meta_") else k): data[k] for k in data.files}
