"""The factored form of the subdomain stiffness and the factored WaveHoltz kernel.

``factored_form`` holds S as what it is summed from (``ElementFactors``: the
derivative matrix D and each element's collocated factors A, B, C, as
upstream's ``stiffness<NB>`` applies them) and, on rectangles (B = 0), as
each subdomain's grid lines: segments of 4 nodes with the summed line
matrices of the elements that hold them, each slot at a position of a
kernel row; the factored kernel (``csrc/wave_cycle_factored.cu``) applies S
line by line from it and is the default on rectangles of degree 3.  On the
CPU these tests hold the form (densified, it gives the DDH's float64 S back
to 1e-13; every slot on one x line and one y line), the plain cycle through
it (float64, to 1e-12 of the dense plain cycle, in layouts (a) and (b), on
rectangles through the kernel's lines and on the unstructured square
through the general sum factorisation), the dispatch rule at each configuration's
shape (a per-row S and an S without factors keep today's kernel) and the
flagship-shaped transfer solve at nx 32 with every cycle through the plain
factored form (JAX's 11 / 222).

The tests marked ``cuda`` hold the factored kernel to the plain cycle (2e-4
relative to the max, as ``test_torch_sparse_cycle.py``) in layouts (a) and
(b), with padded slots zero, a repeat bitwise and a CUDA-graph replay
bitwise against the eager launch; they skip where there is no GPU.  On a
machine without JAX run
``python -m pytest --noconftest tests/test_torch_factored_cycle.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import cuddhelmholtz_tpu_torch.solvers.ddh as ddh_mod
from cuddhelmholtz_tpu_torch.config import DDH_UNSTRUCTURED_SQUARE as UCFG
from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
from cuddhelmholtz_tpu_torch.spaces.ensemble import coordinate_bisection_labels
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

from test_torch_sparse_cycle import LIMIT, _h100_limit, _rel_max, _structured, _unstructured

# Small shapes: torch's intra-op thread pool costs more than it saves here,
# and beside other busy test processes it slows these tests a hundredfold.
torch.set_num_threads(1)

TOL = 2e-4
EXACT = 1e-12  # float64: the factored and dense sums differ only in order


def _dense(form: wc.FactoredS, pad: int) -> torch.Tensor:
    """(ngroups, pad, pad): the matrices the form applies, as the plain
    apply of the form to the identity's rows."""
    ng = form.slots.shape[0]
    eye = torch.eye(pad, dtype=form.factors.dtype, device=form.factors.device)
    return wc._factored_apply(form, pad)(eye.repeat(ng, 1)).reshape(ng, pad, pad)


def _ddh64(case: str, omega_scale: float = 1.0) -> DDH:
    """A float64 operator at nx 32: 16-DOF (pad 176) or 32-DOF (pad 632, one
    subdomain) blocks on a uniform grid, or the unstructured square's 8
    domains (pad 168)."""
    rng = np.random.default_rng(3)
    if case == "unstructured":
        mesh = load_unstructured_square()
        labels, _ = coordinate_bisection_labels(mesh, UCFG.n_domains)
        fem = H1Space(mesh, Basis(UCFG.deg + 1))
        return DDH(UCFG.omega * omega_scale, 1.0 + 0.2 * rng.random(fem.ndof), fem,
                   element_labels=labels, wh_maxit=1, device="cpu", dtype=torch.float64)
    nx, block = {"structured-16": (32, 16), "structured-32": (32, 32)}[case]
    fem = H1Space(Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), Basis(4))
    return DDH(20.0 * omega_scale, 1.0 + 0.2 * rng.random(fem.ndof), fem, nx=nx, ny=nx,
               block_size=block, wh_maxit=1, device="cpu", dtype=torch.float64)


# (pad, (nlines, rs, L), rectangles)
CASES = {
    "structured-16": (176, (26, 176, 4), True),
    "structured-32": (632, (50, 640, 8), True),
    "unstructured": (168, (0, 168, 1), False),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_factored_form_densifies_to_S(case):
    """The form gives the DDH's float64 S back to 1e-13 (the flagship-shaped
    shared S, pad 632's, and each of the unstructured square's 8 groups);
    ``order`` puts every slot at one position; on rectangles B is held as
    0, the first ``nlx`` lines run along x, every element's nodes lie on
    the lines and each slot of an element on exactly one x line and one y
    line; elsewhere the form holds no line."""
    pad, shape, rect = CASES[case]
    ddh = _ddh64(case)
    factors = ddh.element_factors
    assert factors.rectangles == rect and ddh.pad == pad
    form = wc.factored_form(factors, pad, torch.float64)
    assert form.shape == shape
    S3 = ddh.S if ddh.S.dim() == 3 else ddh.S[None]
    assert _rel_max(_dense(form, pad), S3) < 1e-13
    assert bool((form.factors[:, :, 1] == 0).all()) == rect
    for g in range(form.order.shape[0]):
        order = form.order[g].long()
        assert sorted(order[order >= 0].tolist()) == list(range(pad))
        live = factors.slots[g, :, 0] >= 0
        real = set(factors.slots[g][live].ravel().tolist())
        slot = order[form.slots[g][live].long()]
        assert torch.equal(slot, torch.as_tensor(factors.slots[g][live]))
        if not rect:
            continue
        on = order[form.lines[g].long()]
        for lines in (on[:form.nlx], on[form.nlx:]):
            held = lines[lines >= 0].tolist()
            assert sorted(held) == sorted(real)  # each real slot once a direction


def test_factored_plain_matches_dense():
    """Layout (a) on the pad-176 shared S (line matrices) and layout (b) on
    the unstructured square's groups (the general sum factorisation) and on
    a stack of scaled rectangles' factors, float64: the plain cycle through
    the form equals the dense plain cycle; ``take`` picks groups as
    ``S[index]`` does."""
    ddh = _ddh64("structured-16", omega_scale=8.0)
    assert ddh.nt < 200
    p = ddh.params
    rng = np.random.default_rng(5)
    form = wc.factored_form(ddh.element_factors, ddh.pad, torch.float64)
    m = ddh.gmask
    F = torch.from_numpy(rng.standard_normal(m.shape)) * m
    G = torch.from_numpy(rng.standard_normal(m.shape)) * m
    u, v = wc.wave_cycle_plain(p, F, G, 2, factored=form)
    u0, v0 = wc.wave_cycle_plain(p, F, G, 2)
    assert _rel_max(u, u0) < EXACT and _rel_max(v, v0) < EXACT

    # (b): three groups of scaled rectangles, runs of 8 rows
    ng, c = 3, 8
    ef = ddh.element_factors
    ef3 = ef._replace(factors=np.concatenate([ef.factors * (1 + 0.02 * g) for g in range(ng)]),
                      slots=np.repeat(ef.slots, ng, 0))
    rows = torch.arange(ng * c) % ddh.n_domains
    gp = p._replace(S=torch.stack([p.S * (1 + 0.02 * g) for g in range(ng)]),
                    Ha=p.Ha[rows], inv_mi=p.inv_mi[rows])
    form3 = wc.factored_form(ef3, ddh.pad, torch.float64)
    ub, vb = wc.wave_cycle_plain(gp, F[rows], G[rows], 2, c, factored=form3)
    ub0, vb0 = wc.wave_cycle_plain(gp, F[rows], G[rows], 2, c)
    assert _rel_max(ub, ub0) < EXACT and _rel_max(vb, vb0) < EXACT

    # (b): the unstructured square's groups 5, 0, 3 in runs of 4 rows
    uddh = _ddh64("unstructured", omega_scale=40.0)
    assert uddh.nt < 60 and uddh.S.dim() == 3
    up = uddh.params
    uform = wc.factored_form(uddh.element_factors, uddh.pad, torch.float64)
    ui = torch.tensor([5, 0, 3])
    c = 4
    sub = uform.take(ui)
    assert torch.equal(_dense(sub, uddh.pad), _dense(uform, uddh.pad)[ui])
    gp = up._replace(S=up.S[ui], Ha=up.Ha[ui].repeat_interleave(c, 0),
                     inv_mi=up.inv_mi[ui].repeat_interleave(c, 0))
    um = uddh.gmask[ui].repeat_interleave(c, 0)
    Fb = torch.from_numpy(rng.standard_normal(um.shape)) * um
    Gb = torch.from_numpy(rng.standard_normal(um.shape)) * um
    ub, vb = wc.wave_cycle_plain(gp, Fb, Gb, 2, c, factored=sub)
    ub0, vb0 = wc.wave_cycle_plain(gp, Fb, Gb, 2, c)
    assert _rel_max(ub, ub0) < EXACT and _rel_max(vb, vb0) < EXACT


# (pad, factored shape or None where the elements are not rectangles, tile
# pairs, sparse stride, the default kernel) of every configuration the repo
# runs, at each one's own nx: the flagship (nx 128), ddh_512_block32 (nx
# 512), the unstructured square (8 domains) and L3 (256 domains)
CONFIG_SHAPES = {
    "ddh_structured": (176, (26, 176, 4), 158, 2496, "factored"),
    "ddh_512_block32": (632, (50, 640, 8), 731, 10336, "factored"),
    "ddh_unstructured_square": (168, None, 231, 4512, "mma"),
    "large_unstructured_L3": (320, None, 489, 7712, "sparse"),
}


@pytest.mark.parametrize("config", sorted(CONFIG_SHAPES))
def test_dispatch_rule_at_every_configuration(config):
    """By default the factored kernel runs wherever it has a form
    (rectangles, degree 3) that fits; a per-row stack (layout (c)) and an
    S without a factored form keep today's kernel; a forced
    ``"factored"`` raises where it has no form or too little shared
    memory."""
    pad, shape, pairs, stride, want = CONFIG_SHAPES[config]
    assert wc.kernel_variant(pad, LIMIT, stride, pairs=pairs, factored=shape) == want
    today = "mma" if wc.mma_preferred(pad, pairs) else "sparse"
    assert wc.kernel_variant(pad, LIMIT, stride, pairs=pairs) == today
    assert wc.kernel_variant(pad, LIMIT, stride, per_row=True, pairs=pairs,
                             factored=shape) == "sparse"
    with pytest.raises(ValueError, match="no kernel factored"):
        wc.kernel_variant(pad, LIMIT, stride, variant="factored", per_row=True, factored=shape)
    if shape is None:
        with pytest.raises(ValueError, match="no kernel factored"):
            wc.kernel_variant(pad, LIMIT, stride, variant="factored", pairs=pairs)
        return
    rows = wc.factored_rows(*shape)
    need = wc.factored_shared_memory_bytes(rows, shape[1])
    assert rows >= 1 and need <= LIMIT
    assert wc.kernel_variant(pad, LIMIT, stride, variant="factored", factored=shape) == "factored"
    with pytest.raises(ValueError, match="no kernel factored"):
        wc.kernel_variant(pad, need - 1, stride, variant="factored", factored=shape)


def test_rows_and_row_stride():
    """A block's rows: the most of 8, 4, 2, 1 whose two vectors' line items
    fit FACTORED_THREADS threads and whose positions fit ``factored_pairs``
    a thread; lines of 4 or 8 segments only; the row stride makes a
    block's rows span a multiple of 16 floats."""
    assert wc.FACTORED_THREADS == 128
    assert wc.factored_rows(26, 176, 4) == 2  # the flagship: 104 items, 352 positions
    assert wc.factored_rows(50, 640, 8) == 1  # pad 632: 100 items, 640 positions
    assert wc.factored_rows(26, 200, 4) == 1  # 400 positions exceed 3 a thread
    assert wc.factored_rows(65, 176, 4) == 0  # one row's items exceed the block
    assert wc.factored_rows(26, 176, 5) == 0  # no instance for 5 segments
    assert wc.factored_row_stride(176, 2) == 176
    assert wc.factored_row_stride(170, 2) == 176
    assert wc.factored_row_stride(632, 1) == 640
    assert wc.factored_shared_memory_bytes(2, 176) == 4 * 6 * 2 * 176


@pytest.mark.parametrize("unstructured", [False, True])
def test_ddh_passes_its_factors(unstructured, monkeypatch):
    """A shared S on rectangles runs the factored kernel for its cycles and
    probes, from the operator's own factors; ``k1_kernel`` without them
    keeps the sparse kernel; the unstructured square (B != 0) keeps the
    tensor-core kernel for its probes and the sparse per-row one for its
    cycles, and a forced factored kernel raises there."""
    _h100_limit(monkeypatch)
    if unstructured:
        ddh = _unstructured("cpu")
        assert not ddh.element_factors.rectangles
        assert ddh.k1_probe.variant == "mma" and ddh.k1.variant == "sparse"
        with pytest.raises(ValueError, match="no kernel factored"):
            wc.k1_kernel(ddh.S, torch.tensor([0, 1]), variant="factored",
                         factors=ddh.element_factors)
        return
    ddh = _structured("cpu", 32, 16, 20.0)
    kernel = ddh.k1
    assert kernel.variant == "factored" and type(kernel.form) is wc.FactoredS
    assert ddh.k1_probe is kernel and kernel.form.shape == (26, 176, 4)
    assert kernel.form.factors.dtype == torch.float32
    assert _rel_max(_dense(kernel.form, ddh.pad)[0], ddh.S) < 1e-6
    assert wc.k1_kernel(ddh.S).variant == "sparse"
    with pytest.raises(ValueError, match="needs S's element factors"):
        wc.k1_kernel(ddh.S, variant="factored")
    route = wc.cycle_route("factored", 64, None)
    assert route == wc.Route("factored_shared", 64, 1, 1, 0)
    assert wc.cycle_route("factored", 24, 3, 8) == wc.Route("factored_grouped", 24, 3, 1, 8)
    with pytest.raises(ValueError, match="factored kernel does not take a per-row stack"):
        wc.cycle_route("factored", 64, 64)


def test_transfer_solve_through_the_factored_form_keeps_jax_counts(monkeypatch):
    """``run_ddh(nx=32, transfer=True)`` with every cycle through the plain
    factored form of the operator's own factors (the kernel's math): JAX's
    11 restarts / 222 matvecs (``test_torch_studies.py``'s sweep row)."""
    from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh

    made, calls = [], []
    assemble = ddh_mod._assemble_subdomain_stiffness

    def spy(*args):
        out = assemble(*args)
        made.append(out[2])
        return out

    def cycle(params, F, G, wh_maxit=wc.WH_MAXIT, s_group_size=None, **_):
        assert params.S.dim() == 2
        calls.append(tuple(F.shape))
        form = wc.factored_form(made[-1], params.S.shape[0], params.S.dtype)
        return wc.wave_cycle_plain(params, F, G, wh_maxit, s_group_size, factored=form)

    monkeypatch.setattr(ddh_mod, "_assemble_subdomain_stiffness", spy)
    monkeypatch.setattr(ddh_mod, "wave_cycle", cycle)
    monkeypatch.setenv("CUDDH_CACHE_DIR", "")
    res = run_ddh(nx=32, transfer=True, device="cpu")
    assert made[-1].rectangles and made[-1].slots.shape[:2] == (1, 16)
    assert calls == [(768, 176), (64, 176), (64, 176)]
    assert res.success and (res.num_iter, res.num_matvec) == (11, 222)


# ------------------------------------------------------------ on the GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


STRUCTURED = {176: (16, 16, 2 * np.pi * 1.6), 632: (16, 32, 2 * np.pi * 12.8)}


def _masked(rng, mask):
    m = mask.cpu().numpy()
    return torch.from_numpy((rng.standard_normal(m.shape) * m).astype(np.float32)).to(mask.device)


def _run(p, F, G, key, mask, kernel, s_group_size=None):
    before = wc.launch_counts()
    u, v = wc.wave_cycle(p, F, G, 1, s_group_size, kernel=kernel)
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, key: before[key] + 1}
    assert (u[mask == 0] == 0).all() and (v[mask == 0] == 0).all()
    return u, v


def _close(u, v, u0, v0):
    assert float(u0.abs().max()) > 0
    assert _rel_max(u.cpu(), u0.cpu()) < TOL and _rel_max(v.cpu(), v0.cpu()) < TOL


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [176, 632])
def test_factored_shared_matches_plain_and_repeats_bitwise(cuda, pad):
    """Layout (a): the operator's kernel is the factored one; against the
    plain cycle and the sparse kernel on the same rows; a repeat is
    bitwise."""
    ddh = _structured(cuda, *STRUCTURED[pad])
    assert ddh.pad == pad and ddh.k1.variant == "factored"
    rng = np.random.default_rng(6)
    F, G = _masked(rng, ddh.gmask), _masked(rng, ddh.gmask)
    p = ddh.params
    u, v = _run(p, F, G, "factored_shared", ddh.gmask, ddh.k1)
    _close(u, v, *wc.wave_cycle_plain(p, F, G, 1))
    _close(u, v, *_run(p, F, G, "sparse_shared", ddh.gmask, wc.k1_kernel(p.S)))
    u2, v2 = _run(p, F, G, "factored_shared", ddh.gmask, ddh.k1)
    assert torch.equal(u, u2) and torch.equal(v, v2)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [176, 632])
@pytest.mark.parametrize("c", [8, 24])
def test_factored_grouped_matches_plain(cuda, pad, c):
    """Layout (b): runs of c rows, each run against its own scaled
    rectangles' factors."""
    ddh = _structured(cuda, *STRUCTURED[pad])
    ng = 3
    p = ddh.params
    ef = ddh.element_factors
    ef3 = ef._replace(factors=np.concatenate([ef.factors * (1 + 0.02 * g) for g in range(ng)]),
                      slots=np.repeat(ef.slots, ng, 0))
    rows = torch.arange(ng * c, device=cuda) % ddh.n_domains
    S3 = torch.stack([p.S * (1 + 0.02 * g) for g in range(ng)]).contiguous()
    gp = p._replace(S=S3, Ha=p.Ha[rows].contiguous(), inv_mi=p.inv_mi[rows].contiguous())
    kernel = wc.k1_kernel(S3, factors=ef3)
    assert kernel.variant == "factored"
    mask = ddh.gmask[rows]
    rng = np.random.default_rng(7)
    F, G = _masked(rng, mask), _masked(rng, mask)
    u, v = _run(gp, F, G, "factored_grouped", mask, kernel, s_group_size=c)
    _close(u, v, *wc.wave_cycle_plain(gp, F, G, 1, c))


@pytest.mark.cuda
def test_factored_graph_replay_is_bitwise(cuda):
    """The factored launch captured in a CUDA graph and replayed gives the
    eager launch's outputs bit for bit."""
    ddh = _structured(cuda, *STRUCTURED[176])
    rng = np.random.default_rng(8)
    F, G = _masked(rng, ddh.gmask), _masked(rng, ddh.gmask)
    p, kernel = ddh.params, ddh.k1
    u, v = wc.wave_cycle(p, F, G, 1, kernel=kernel)
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        wc.wave_cycle(p, F, G, 1, kernel=kernel)  # warm-up off the default stream
    torch.cuda.current_stream().wait_stream(stream)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        ug, vg = wc.wave_cycle(p, F, G, 1, kernel=kernel)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(u, ug) and torch.equal(v, vg)
