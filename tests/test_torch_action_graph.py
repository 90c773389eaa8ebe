"""The DDH transfer apply replayed as a CUDA graph (``DDH.action``).

On the transfer path a CUDA tensor replays one captured graph of the apply
per input shape and dtype (``solvers/ddh.py::_ApplyGraph``); a CPU tensor
and the direct path run eagerly.  The cache of graphs lives on the operator
and is emptied wherever a tensor the graph reads is replaced.

On the CPU (structured nx 8, block 8, omega = 2 pi nx / 2.5, a uniform
medium, as ``test_torch_transfer.py``): a CPU apply counts
``ddh.action.eager`` and captures nothing; ``prepare``, a load from the
setup cache and every other replacement empty the cache; the direct path
never touches it and counts ``ddh.action.direct``.

The tests marked ``cuda`` run at nx 16 on the card and hold the graphed
apply to the eager one bit for bit: the rolled and the scattered exchange
at K = 1 and K = 8, two applies in a row on different inputs (no result
aliases the graph's output), a whole ``solver`` run (one capture, the eager
run's counts and solution), a re-``prepare`` or a new model (a new
capture), and a new operator per model (the memory held does not grow).
They skip where there is no GPU.  On a machine without JAX run
``python -m pytest --noconftest tests/test_torch_action_graph.py -m cuda``.
"""

import gc

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.solvers import ddh as ddh_mod
from cuddhelmholtz_tpu_torch.solvers.gmres import gmres
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils import spans
from cuddhelmholtz_tpu_torch.utils.basis import Basis

torch.set_num_threads(1)

DEG, BLOCK = 3, 8
COUNTERS = "ddh.action."


def _ddh(device, nx: int, rough: bool = False, cache_dir: str = "") -> ddh_mod.DDH:
    """A prepared transfer DDH on ``device``: uniform medium, or a seeded
    rough one (every subdomain distinct)."""
    fem = H1Space(Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), Basis(DEG + 1))
    a = (1.0 + 0.3 * np.random.default_rng(nx).random(fem.ndof)) if rough else np.ones(fem.ndof)
    ddh = ddh_mod.DDH(2 * np.pi * nx / 2.5, a, fem, nx=nx, ny=nx, block_size=BLOCK,
                      device=device)
    ddh.prepare(cache_dir=cache_dir)
    return ddh


def _lam(ddh, K: int, seed: int = 0) -> torch.Tensor:
    """A seeded trace vector (K = 1) or (K, 2 n_lambda) block on the DDH's
    device."""
    shape = (ddh.size,) if K == 1 else (K, ddh.size)
    x = np.random.default_rng(seed).standard_normal(shape).astype(np.float32)
    return torch.from_numpy(x).to(ddh.gmask.device)


def _eager(ddh, lam):
    """The transfer apply called directly, outside ``DDH.action``."""
    if ddh.route is not None:
        return ddh_mod.ddh_action_transfer_rolled(ddh.params, ddh.route, lam, ddh.n_own)
    return ddh_mod.ddh_action_transfer(ddh.params, ddh.T, lam, ddh.n_own)


# ------------------------------------------------------------------ on the CPU


@pytest.fixture(scope="module")
def cpu_ddh():
    return _ddh("cpu", 8)


@pytest.mark.parametrize("K", [1, 4])
def test_cpu_apply_stays_eager(cpu_ddh, K):
    lam = _lam(cpu_ddh, K)
    spans.reset(COUNTERS)
    got = cpu_ddh.action(lam)
    assert spans.totals(COUNTERS) == {"eager": 1}
    assert cpu_ddh._graphs == {} and cpu_ddh._graph_pool is None
    assert got.shape == lam.shape
    assert torch.equal(got, _eager(cpu_ddh, lam))


def _replace(ddh, event: str, tmp_path) -> None:
    """Replace what a captured apply reads, in one of the ways the cache
    must notice."""
    if event == "prepare":
        ddh.prepare(cache_dir="")
    elif event == "cache_load":
        ddh.save_precomputed(str(tmp_path))
        assert ddh.try_load_precomputed(str(tmp_path))
    elif event == "prepare_hit":
        ddh.save_precomputed(str(tmp_path))
        assert ddh.prepare(cache_dir=str(tmp_path))["cache_hit"]
    elif event == "set_io_maps":
        io = ddh.io
        ddh.set_io_maps(io.Pu, io.Pv, io.R, io.Pul, io.Pvl, ddh._T_groups)
    elif event == "route":
        ddh.route = ddh.route
    elif event == "use_transfer":
        ddh.use_transfer = True
    elif event == "buffer":
        ddh.B1 = ddh.B1.clone()
    elif event == "transfer_stack":
        ddh.set_transfer(ddh._T_u, ddh._T_groups)
    elif event == "to":
        ddh.to("cpu")
    else:
        raise ValueError(event)


@pytest.mark.parametrize("event", ["prepare", "cache_load", "prepare_hit", "set_io_maps",
                                   "route", "use_transfer", "buffer", "transfer_stack", "to"])
def test_replacing_what_the_graph_reads_empties_the_cache(cpu_ddh, event, tmp_path):
    lam = _lam(cpu_ddh, 1, seed=1)
    want = _eager(cpu_ddh, lam)
    cpu_ddh._graphs[("stale",)] = object()
    cpu_ddh._graph_pool = object()
    _replace(cpu_ddh, event, tmp_path)
    assert cpu_ddh._graphs == {} and cpu_ddh._graph_pool is None
    assert torch.equal(cpu_ddh.action(lam), want)


def test_direct_path_never_touches_the_cache():
    fem = H1Space(Mesh2D.uniform_rect(4, -1, 1, 4, -1, 1), Basis(DEG + 1))
    ddh = ddh_mod.DDH(2 * np.pi * 4 / 2.5, np.ones(fem.ndof), fem, nx=4, ny=4,
                      block_size=BLOCK, device="cpu")
    assert not ddh.use_transfer
    stale = ddh._graphs[("stale",)] = object()
    spans.reset(COUNTERS)
    y = ddh.action(_lam(ddh, 1))
    assert ddh._graphs == {("stale",): stale} and ddh._graph_pool is None
    assert spans.totals(COUNTERS) == {"direct": 1}
    assert y.shape == (ddh.size,) and torch.isfinite(y).all()


# ------------------------------------------------------------------ on the GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def gpu_ddh(cuda):
    return _ddh(cuda, 16)


@pytest.mark.cuda
@pytest.mark.parametrize("exchange", ["rolled", "scatter"])
@pytest.mark.parametrize("K", [1, 8])
def test_graphed_apply_is_the_eager_apply_bitwise(gpu_ddh, exchange, K):
    ddh = gpu_ddh
    if exchange == "scatter":
        ddh.route = None
    else:
        assert ddh.route is not None
    lam = _lam(ddh, K)
    spans.reset(COUNTERS)
    first, second = ddh.action(lam), ddh.action(lam)
    want = _eager(ddh, lam)
    assert spans.totals(COUNTERS) == {"captures": 1, "graphed": 2}
    assert torch.equal(first, want) and torch.equal(second, want)
    if K > 1:
        # a strided input (one Krylov column of a block basis) copies in
        V = torch.stack([_lam(ddh, K, seed=s) for s in (1, 2, 3)], dim=1)
        assert torch.equal(ddh.action(V[:, 1]), _eager(ddh, V[:, 1]))
        assert spans.total(COUNTERS + "captures") == 1


@pytest.mark.cuda
def test_consecutive_applies_keep_their_results(gpu_ddh):
    ddh = gpu_ddh
    a, b = _lam(ddh, 1, seed=1), _lam(ddh, 1, seed=2)
    ya = ddh.action(a)
    yb = ddh.action(b)
    (graph,) = ddh._graphs.values()
    assert graph.y.data_ptr() not in (ya.data_ptr(), yb.data_ptr())
    assert torch.equal(ya, _eager(ddh, a)) and torch.equal(yb, _eager(ddh, b))
    assert not torch.equal(ya, yb)


@pytest.mark.cuda
def test_solver_captures_once_and_matches_eager(gpu_ddh):
    ddh = gpu_ddh
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(2 * ddh.g_ndof))
    g = g.to(ddh.gmask.device)
    spans.reset(COUNTERS)
    out, U = ddh.solver(20, 20, 1e-4)(g)
    got = spans.totals(COUNTERS)
    calls = []

    def eager(lam):
        calls.append(1)
        return _eager(ddh, lam)

    ref = gmres(eager, ddh.rhs(g), m=20, maxit=20, tol=1e-4)
    assert out.success
    assert got == {"captures": 1, "graphed": len(calls)}
    assert (out.num_iter, out.num_matvec) == (ref.num_iter, ref.num_matvec)
    assert torch.equal(out.x, ref.x)
    assert torch.equal(U, ddh.postprocess(ref.x, g))


@pytest.mark.cuda
def test_a_new_operator_per_model_leaves_no_memory_behind(cuda):
    """One operator, capture and solve per model, as an inversion or the
    model stream runs them: what the process holds afterwards does not grow
    with the number of models."""
    def one_model(k):
        ddh = _ddh(cuda, 16, rough=bool(k % 2))
        ddh.action(_lam(ddh, 1, seed=k))
        torch.cuda.synchronize()

    for k in range(2):  # both media: what stays with the process is made here
        one_model(k)
    gc.collect()
    held = torch.cuda.memory_allocated()
    spans.reset(COUNTERS)
    for k in range(2, 6):
        one_model(k)
    gc.collect()
    assert spans.total(COUNTERS + "captures") == 4
    assert torch.cuda.memory_allocated() - held < 1 << 20


@pytest.mark.cuda
def test_new_prepare_or_model_captures_anew(gpu_ddh, cuda):
    ddh = gpu_ddh
    lam = _lam(ddh, 1)
    ddh.action(lam)
    ddh.prepare(cache_dir="")
    assert ddh._graphs == {}
    spans.reset(COUNTERS)
    assert torch.equal(ddh.action(lam), _eager(ddh, lam))
    other = _ddh(cuda, 16, rough=True)
    y = other.action(lam)
    assert spans.totals(COUNTERS) == {"captures": 2, "graphed": 2}
    assert torch.equal(y, _eager(other, lam))
    assert not torch.equal(y, _eager(ddh, lam))
