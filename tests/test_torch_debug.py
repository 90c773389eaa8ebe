"""The port's ``CUDDH_DEBUG`` mode (``utils/debug.py``): the four cases of
``tests/test_debug_mode.py``, against the port.

With the flag set, the constructors audit their index tables and the DDH
checks its inputs for NaN and Inf; a corrupted table must raise instead of
being masked.  With it unset nothing is checked.
"""

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.ensemble import EnsembleSpace, structured_labels
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis
from cuddhelmholtz_tpu_torch.utils.debug import check_finite, check_index_table


@pytest.fixture
def debug_on(monkeypatch):
    monkeypatch.setenv("CUDDH_DEBUG", "1")


@pytest.fixture
def small_space():
    mesh = Mesh2D.uniform_rect(4, -1, 1, 4, -1, 1)
    return mesh, H1Space(mesh, Basis(4))


def test_checks_are_noops_when_disabled(monkeypatch, small_space):
    monkeypatch.delenv("CUDDH_DEBUG", raising=False)
    check_index_table("t", np.array([99]), 3)  # out of range, but flag off
    check_finite("x", np.array([np.nan]))
    check_finite("x", torch.tensor([float("nan")]))


def test_valid_setup_passes_audit(debug_on, small_space):
    mesh, fem = small_space
    labels, nd = structured_labels(4, 4, 2, 2)
    efem = EnsembleSpace(fem, nd, labels)  # runs the audit internally
    DDH(2 * np.pi, np.ones(fem.ndof), fem, nx=4, ny=4, block_size=8, nt_override=4,
        device="cpu")
    assert efem.n_domains == nd


def test_corrupt_table_raises(debug_on, small_space):
    """An out-of-range entry in a padded index table raises in debug mode
    (without the flag the apply would mask it)."""
    mesh, fem = small_space
    bad = fem.dofs.copy()
    bad[0, 0, 0] = fem.ndof + 7
    with pytest.raises(ValueError, match="index table"):
        check_index_table("H1Space.dofs", bad, fem.ndof, allow_pad=False)
    with pytest.raises(ValueError, match="index table"):
        check_index_table("H1Space.dofs", torch.as_tensor(bad), fem.ndof, allow_pad=False)

    # end to end: the audit fires at the constructor's entry, before the
    # batched dom * ndof + gid keys could alias the bad id into a neighbour
    fem.dofs[0, 0, 0] = fem.ndof + 7
    labels, nd = structured_labels(4, 4, 2, 2)
    with pytest.raises(ValueError, match="dofs"):
        EnsembleSpace(fem, nd, labels)
    fem.dofs[0, 0, 0] = 0


def test_nonfinite_input_raises(debug_on, small_space):
    mesh, fem = small_space
    ddh = DDH(2 * np.pi, np.ones(fem.ndof), fem, nx=4, ny=4, block_size=8, nt_override=4,
              device="cpu")
    lam = torch.zeros(ddh.size)
    lam[3] = float("nan")
    with pytest.raises(FloatingPointError, match="non-finite"):
        ddh.action(lam)
    f = torch.zeros(2 * fem.ndof)
    f[0] = float("inf")
    with pytest.raises(FloatingPointError, match="non-finite"):
        ddh.rhs(f)
    with pytest.raises(FloatingPointError, match="non-finite"):
        ddh.postprocess(lam, torch.zeros(2 * fem.ndof))
