"""The sparse form of the subdomain stiffness and the sparse WaveHoltz kernel.

``sparse_form`` stores the exact non-zeros of S by output column (CSC of S);
the sparse kernel (``csrc/wave_cycle_sparse.cu``) reads that form from shared
memory and is the default on the card.  On the CPU these tests hold the form
(densified, it gives S back bitwise; padded columns are empty; the pinned
non-zero counts), the plain cycle through it (float64, to 1e-12 of the dense
plain cycle, whose sums it only reorders), the dispatch rule, the DDH's
kernel (``k1_kernel`` with the card's limit set to an H100's) and the route
of each layout (``cycle_route``: a per-row stack runs each row once).  The JAX
comparisons of the plain sparse cycle are in ``test_torch_wave_cycle.py``
(layouts (a), (c)) and ``test_torch_large_pad.py`` (pad 632).

Non-zero counts depend on the mesh size: on rectangles the stiffness couples
a DOF to its elements' grid lines only, but round-off in the element
geometry leaves a few tiny cross terms whose number varies with nx (16-DOF
blocks: 2,281 at nx = 32 and 64, 1,993 at the flagship's nx = 128; 32-DOF
blocks: 8,881 at nx = 64, 9,841 at ``ddh_512_block32``'s nx = 512).

The tests marked ``cuda`` hold the sparse kernel to the plain cycle in
layouts (a), (b) and (c) (its per-row instance) at pad 176 and 632, and to each dense kernel forced
on the same rows (tolerance 2e-4 relative to the max, as
``test_torch_wave_cycle.py``), and a world-1 ``ShardedDDH`` to its DDH's
own kernel object; they skip where there is no GPU.  On a
machine without JAX run
``python -m pytest --noconftest tests/test_torch_sparse_cycle.py -m cuda``.
"""

import numpy as np
import pytest
import torch

from cuddhelmholtz_tpu_torch.config import DDH_UNSTRUCTURED_SQUARE as UCFG
from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, _rows
from cuddhelmholtz_tpu_torch.spaces.ensemble import coordinate_bisection_labels
from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
from cuddhelmholtz_tpu_torch.utils.basis import Basis

# Small shapes: torch's intra-op thread pool costs more than it saves here,
# and beside other busy test processes it slows these tests a hundredfold.
torch.set_num_threads(1)

TOL = 2e-4
LIMIT = 232448  # H100 opt-in shared memory per block


def _h100_limit(monkeypatch) -> None:
    """Let ``k1_kernel`` choose on the CPU as on an H100: its one reader of
    the card's shared memory per block returns LIMIT."""
    monkeypatch.setattr(wc, "_shared_memory_limit", lambda dev: LIMIT)


def _rel_max(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _structured(device, nx, block, omega, wh_maxit=1):
    fem = H1Space(Mesh2D.uniform_rect(nx, -1, 1, nx, -1, 1), Basis(4))
    a_nodal = 1.0 + 0.2 * np.random.default_rng(3).random(fem.ndof)
    return DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=block, wh_maxit=wh_maxit,
               device=device)


def _unstructured(device, omega_scale=1.0, wh_maxit=1):
    """``ddh_unstructured_square``'s partition (8 domains, pad 168, one S
    each with ragged nnz); ``omega_scale`` raises omega to cut nt."""
    mesh = load_unstructured_square()
    labels, _ = coordinate_bisection_labels(mesh, UCFG.n_domains)
    fem = H1Space(mesh, Basis(UCFG.deg + 1))
    a_nodal = 1.0 + 0.2 * np.random.default_rng(3).random(fem.ndof)
    return DDH(UCFG.omega * omega_scale, a_nodal, fem, element_labels=labels,
               wh_maxit=wh_maxit, device=device)


def _dense(form: wc.SparseS, pad: int) -> torch.Tensor:
    """(ngroups, pad, pad) from the form's CSC arrays, one entry at a time."""
    ng = form.ptr.shape[0]
    counts = form.ptr.diff(dim=1).long()
    out = torch.zeros((ng, pad, pad), dtype=form.val.dtype)
    for g in range(ng):
        n = int(form.ptr[g, -1])
        cols = torch.repeat_interleave(torch.arange(pad), counts[g])
        out[g, form.idx[g, :n].long(), cols] = form.val[g, :n]
        assert (form.val[g, n:] == 0).all() and (form.idx[g, n:] == 0).all()
    return out


# (S, pad, real DOFs per subdomain, pinned nnz of the first S)
CASES = {
    "structured-16": (lambda: _structured("cpu", 32, 16, 20.0).S, 176, 169, 2281),
    "structured-32": (lambda: _structured("cpu", 64, 32, 20.0).S, 632, 625, 8881),
    "unstructured": (lambda: _unstructured("cpu").S, 168, None, 3496),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sparse_form_densifies_to_S(case):
    """The form gives S back bitwise, every column holds exactly S's
    non-zeros, padded columns are empty, the slot order sorts the columns
    by falling nnz, and the nnz are the pinned counts."""
    make, pad, real, nnz0 = CASES[case]
    S = make()
    form = wc.sparse_form(S)
    S3 = S if S.dim() == 3 else S[None]
    assert torch.equal(_dense(form, pad), S3)
    counts = form.ptr.diff(dim=1)
    assert torch.equal(counts, (S3 != 0).sum(1).to(torch.int32))
    nnz = (S3 != 0).sum((1, 2))
    assert int(nnz[0]) == nnz0
    # the kernel stages a warp's 32 columns as 32 x its longest one
    staged = 32 * counts.gather(1, form.order.long())[:, ::32].sum(1)
    assert form.stride == int(staged.max()) >= int(nnz.max())
    if real is not None:
        assert (counts[:, real:] == 0).all() and (counts[:, :real] > 0).all()
    else:
        assert int(nnz.min()) < form.stride  # ragged: shorter groups carry a zero tail
    assert form.idx.dtype == torch.int16 and form.ptr.dtype == torch.int32
    slots = counts.gather(1, form.order.long())
    assert (slots[:, 1:] <= slots[:, :-1]).all()
    assert torch.equal(form.order.long().sort(dim=1).values, torch.arange(pad).expand(S3.shape[0], pad))


def test_sparse_plain_ragged_groups_match_dense():
    """Layouts (b) and (c) on the unstructured square's per-domain stack
    (ragged nnz), float64: the plain cycle through the form equals the
    dense plain cycle; ``take`` picks groups as ``S[index]`` does."""
    ddh = _unstructured("cpu", omega_scale=40.0)
    assert ddh.nt < 60 and ddh.S.dim() == 3
    p = ddh.params
    p = p._replace(**{k: getattr(p, k).double() for k in ("S", "Ha", "inv_mi", "tables")})
    form = wc.sparse_form(p.S)
    rng = np.random.default_rng(5)
    m = ddh.gmask.double()
    F = torch.from_numpy(rng.standard_normal(m.shape)) * m
    G = torch.from_numpy(rng.standard_normal(m.shape)) * m
    u, v = wc.wave_cycle_plain(p, F, G, 2, sparse=form)
    u0, v0 = wc.wave_cycle_plain(p, F, G, 2)
    assert _rel_max(u, u0) < 1e-12 and _rel_max(v, v0) < 1e-12

    ui = torch.tensor([5, 0, 3])
    c = 4
    gp = p._replace(S=p.S[ui], Ha=p.Ha[ui].repeat_interleave(c, 0),
                    inv_mi=p.inv_mi[ui].repeat_interleave(c, 0))
    sub = form.take(ui)
    assert torch.equal(_dense(sub, ddh.pad), gp.S)
    Fb, Gb = F[ui].repeat_interleave(c, 0), G[ui].repeat_interleave(c, 0)
    ub, vb = wc.wave_cycle_plain(gp, Fb, Gb, 2, s_group_size=c, sparse=sub)
    ub0, vb0 = wc.wave_cycle_plain(gp, Fb, Gb, 2, s_group_size=c)
    assert _rel_max(ub, ub0) < 1e-12 and _rel_max(vb, vb0) < 1e-12


def test_ddh_holds_its_sparse_form(monkeypatch):
    """The operator builds its kernel, the sparse one with the form of its
    own S, on first use, on its device, and keeps it; cycles on the CPU do
    not build it.  A per-domain S (the unstructured square's) runs its
    cycles on the sparse kernel's per-row instance; a shared S on
    rectangles runs the factored kernel (``test_torch_factored_cycle.py``)."""
    _h100_limit(monkeypatch)
    ddh = _unstructured("cpu")
    ddh.action(torch.zeros(ddh.size))
    assert ddh._k1 is None and ddh.k1_seconds is None
    kernel = ddh.k1
    assert kernel.variant == "sparse"
    assert torch.equal(_dense(kernel.form, ddh.pad), ddh.S)
    assert kernel.form.val.dtype == torch.float32 and ddh.k1_seconds >= 0
    assert ddh.k1 is kernel and ddh.k1_probe is not kernel


# (pad, sparse-form stride) of every configuration the repo runs, from this
# module's form at each one's own nx: the flagship (nx 128; 1,993 nnz), the
# unstructured square (8 domains; at most 3,526), ddh_512_block32 (nx 512;
# 9,841), L3 with 256 domains (at most 6,991)
CONFIG_SHAPES = {
    "ddh_structured": (176, 2496),
    "ddh_unstructured_square": (168, 4512),
    "ddh_512_block32": (632, 10336),
    "large_unstructured_L3": (320, 7712),
}


@pytest.mark.parametrize("config", sorted(CONFIG_SHAPES))
def test_dispatch_picks_sparse_at_every_configuration(config):
    pad, nnz = CONFIG_SHAPES[config]
    assert wc.kernel_variant(pad, LIMIT, nnz) == "sparse"
    assert wc.sparse_shared_memory_bytes(pad, nnz) <= LIMIT // 2  # two blocks per SM fit
    dense = "resident" if pad <= 224 else "streamed"
    assert wc.kernel_variant(pad, LIMIT) == dense  # no form: the dense rule
    assert wc.kernel_variant(pad, LIMIT, nnz, variant="streamed") == "streamed"
    assert wc.kernel_variant(pad, LIMIT, nnz, variant="sparse") == "sparse"
    if dense == "resident":
        assert wc.kernel_variant(pad, LIMIT, nnz, variant="resident") == "resident"
    else:
        with pytest.raises(ValueError, match="no kernel resident"):
            wc.kernel_variant(pad, LIMIT, nnz, variant="resident")


@pytest.mark.parametrize("config", sorted(CONFIG_SHAPES))
def test_per_row_instance_needs_less_shared_memory(config):
    """The per-row instance holds one row's [p ; p_half] buffers (16 pad
    bytes) beside the staged S, where a block of SPARSE_ROWS_PER_BLOCK
    rows holds 64 pad; the dispatch asks for the per-row bytes."""
    pad, stride = CONFIG_SHAPES[config]
    one = wc.sparse_shared_memory_bytes(pad, stride, rows=1)
    assert one == 16 * pad + 6 * stride
    assert wc.sparse_shared_memory_bytes(pad, stride) - one == 48 * pad
    assert wc.kernel_variant(pad, one, stride, per_row=True) == "sparse"
    with pytest.raises(ValueError, match="no kernel sparse"):
        wc.kernel_variant(pad, one, stride, variant="sparse")  # 4 rows do not fit there


@pytest.mark.parametrize("variant", wc.VARIANTS)
def test_route_of_each_layout(variant):
    """(a) and (b) run the caller's rows; (c) runs each row once in the
    sparse kernel's per-row instance, and ROWS_PER_BLOCK times in layout
    (b) on a dense kernel, whose blocks need runs of that many rows; the
    tensor-core and factored kernels do not take (c)."""
    prefix = {"mma": "mma_", "sparse": "sparse_", "resident": "",
              "streamed": "streamed_", "factored": "factored_"}[variant]
    assert wc.cycle_route(variant, 1024, None) == wc.Route(prefix + "shared", 1024, 1, 1, 0)
    assert wc.cycle_route(variant, 960, 8, 120) == wc.Route(prefix + "grouped", 960, 8, 1, 120)
    r = wc.ROWS_PER_BLOCK
    if variant in ("mma", "factored"):
        with pytest.raises(ValueError, match="per-row stack"):
            wc.cycle_route(variant, 1024, 1024)
    else:
        want = (wc.Route("sparse_per_row", 1024, 1024, 1, 1) if variant == "sparse"
                else wc.Route(prefix + "grouped", r * 1024, 1024, r, r))
        assert wc.cycle_route(variant, 1024, 1024) == want
    with pytest.raises(ValueError, match="per-row stack of 8 matrices for 16 rows"):
        wc.cycle_route(variant, 16, 8)
    with pytest.raises(ValueError, match="multiple of 8"):
        wc.cycle_route(variant, 36, 3, 12)
    with pytest.raises(ValueError, match="s_group_size"):
        wc.cycle_route(variant, 16, None, 8)


@pytest.mark.parametrize("K", [1, 3])
def test_per_row_cycle_of_k_sources_runs_each_row_once(K, monkeypatch):
    """The DDH's cycle on K sources with a per-domain S (rhs, postprocess
    and the direct matvec of an unstructured mesh): K ndom rows on the
    operator's per-row sparse kernel, its form repeated K times
    source-major, one group per row, no replicas."""
    _h100_limit(monkeypatch)
    ddh = _unstructured("cpu")
    nd = ddh.n_domains
    p = _rows(ddh.params, K)
    assert ddh.k1.variant == "sparse"
    kernel = ddh.k1.repeat(K)
    form = kernel.form
    assert kernel.variant == "sparse" and p.S.shape[0] == form.ptr.shape[0] == K * nd
    for name in wc.SparseS._fields:
        assert torch.equal(getattr(form, name), getattr(ddh.k1.form, name).repeat(K, 1)), name
    route = wc.cycle_route(kernel.variant, K * nd, p.S.shape[0])
    assert route == wc.Route("sparse_per_row", K * nd, K * nd, 1, 1)


@pytest.mark.parametrize("pad,nnz,want", [
    (216, 216 * 216, "resident"),  # a dense S's form exceeds shared memory
    (632, 632 * 60, "streamed"),
    (640, 9000, "sparse"),  # the sparse kernel's largest pad
    (648, 9000, "streamed"),
    (1032, 9000, None),  # above every kernel's pad
])
def test_dispatch_falls_to_dense_when_the_form_does_not_fit(pad, nnz, want):
    if want is None:
        with pytest.raises(ValueError, match="no kernel takes pad=1032"):
            wc.kernel_variant(pad, LIMIT, nnz)
        with pytest.raises(ValueError, match="no kernel sparse"):
            wc.kernel_variant(pad, LIMIT, nnz, variant="sparse")
    else:
        assert wc.kernel_variant(pad, LIMIT, nnz) == want
    with pytest.raises(ValueError, match="unknown variant"):
        wc.kernel_variant(pad, LIMIT, nnz, variant="dense")


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


def _run(p, F, G, key, mask, wh_maxit=1, s_group_size=None, **kw):
    before = wc.launch_counts()
    u, v = wc.wave_cycle(p, F, G, wh_maxit, s_group_size, **kw)
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, key: before[key] + 1}
    assert (u[mask == 0] == 0).all() and (v[mask == 0] == 0).all()
    return u, v


def _close(u, v, u0, v0):
    assert float(u0.abs().max()) > 0
    assert _rel_max(u.cpu(), u0.cpu()) < TOL and _rel_max(v.cpu(), v0.cpu()) < TOL


def _stack(S, n):
    """n symmetric stiffness matrices, S scaled by 1, 1.02, ... (stable at
    the operator's dt)."""
    return torch.stack([S * (1 + 0.02 * g) for g in range(n)]).contiguous()


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [176, 632])
def test_sparse_shared_matches_plain_and_dense(cuda, pad):
    """Layout (a): the sparse kernel against the plain cycle and against
    each dense kernel that takes the pad, forced, on the same rows."""
    ddh = _structured(cuda, *STRUCTURED[pad])
    assert ddh.pad == pad
    rng = np.random.default_rng(6)
    F, G = _masked(rng, ddh.gmask), _masked(rng, ddh.gmask)
    p = ddh.params
    u, v = _run(p, F, G, "sparse_shared", ddh.gmask, kernel=wc.k1_kernel(p.S))
    _close(u, v, *wc.wave_cycle_plain(p, F, G, 1))
    for variant in ("resident", "streamed") if pad == 176 else ("streamed",):
        key = "shared" if variant == "resident" else "streamed_shared"
        _close(u, v, *_run(p, F, G, key, ddh.gmask, kernel=wc.k1_kernel(p.S, variant=variant)))


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [176, 632])
@pytest.mark.parametrize("c", [8, 24])
def test_sparse_grouped_matches_plain_and_dense(cuda, pad, c):
    """Layout (b): runs of c rows, each run against its own S."""
    ddh = _structured(cuda, *STRUCTURED[pad])
    ng = 3
    p = ddh.params
    rows = torch.arange(ng * c, device=cuda) % ddh.n_domains
    gp = p._replace(S=_stack(p.S, ng), Ha=p.Ha[rows].contiguous(),
                    inv_mi=p.inv_mi[rows].contiguous())
    mask = ddh.gmask[rows]
    rng = np.random.default_rng(7)
    F, G = _masked(rng, mask), _masked(rng, mask)
    u, v = _run(gp, F, G, "sparse_grouped", mask, s_group_size=c)
    _close(u, v, *wc.wave_cycle_plain(gp, F, G, 1, c))
    u_s, v_s = _run(gp, F, G, "streamed_grouped", mask, s_group_size=c,
                    kernel=wc.k1_kernel(gp.S, variant="streamed"))
    _close(u, v, u_s, v_s)


@pytest.mark.cuda
@pytest.mark.parametrize("pad", [176, 632])
def test_sparse_per_row_matches_plain(cuda, pad):
    """Layout (c): one S per row, in the sparse kernel's per-row instance
    (one launch over the ndom rows, no replicas), against the plain cycle."""
    ddh = _structured(cuda, *STRUCTURED[pad])
    p = ddh.params
    pp = p._replace(S=_stack(p.S, ddh.n_domains))
    rng = np.random.default_rng(8)
    F, G = _masked(rng, ddh.gmask), _masked(rng, ddh.gmask)
    u, v = _run(pp, F, G, "sparse_per_row", ddh.gmask)
    _close(u, v, *wc.wave_cycle_plain(pp, F, G, 1))


@pytest.mark.cuda
def test_sharded_ddh_runs_the_operators_kernel(cuda, monkeypatch):
    """A world-1 ``ShardedDDH`` over a card DDH with a shared S runs its
    cycles on the DDH's own kernel object (``DDH.k1``, the factored one on
    these rectangles), under the same launch key, and builds no kernel of
    its own."""
    from cuddhelmholtz_tpu_torch.parallel import sharding

    ddh = _structured(cuda, *STRUCTURED[176])
    sharded = sharding.ShardedDDH(ddh)
    kernels, run = [], sharding.wave_cycle

    def spy(*args, kernel=None, **kw):
        kernels.append(kernel)
        return run(*args, kernel=kernel, **kw)

    monkeypatch.setattr(sharding, "wave_cycle", spy)
    rng = np.random.default_rng(9)
    lam = torch.from_numpy(rng.standard_normal(ddh.size).astype(np.float32)).to(cuda)
    before = wc.launch_counts()
    sharded.action(lam)
    torch.cuda.synchronize()
    assert len(kernels) == 1 and kernels[0] is ddh.k1 and sharded._k1 is None
    key = ddh.k1.variant + "_shared"
    assert wc.launch_counts() == {**before, key: before[key] + 1}
    ddh.action(lam)
    torch.cuda.synchronize()
    assert wc.launch_counts()[key] == before[key] + 2
