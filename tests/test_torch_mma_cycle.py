"""The tile form of the subdomain stiffness and the tensor-core WaveHoltz kernel.

``tile_form`` stores S as its non-zero 8 (k) x 8 (i) tiles, the B operands
of ``mma.sync.m16n8k8``, in the order the kernel's warps walk them; the
tensor-core kernel (``csrc/wave_cycle_mma.cu``) reads that form from shared
memory.  On the card it is the default in layouts (a) and (b) where the
rule of ``mma_preferred`` picks it: pad <= 192 and at least 9 non-zero
tiles per output tile in S's largest group (the unstructured square's
probes); the FFMA sparse kernel runs the rest.  On the CPU
these tests hold the form (densified, it gives S back bitwise; the pinned
tile counts; every output tile dealt to one warp slot, its pairs the
tile's non-zero k-tiles), the plain cycle through it (float64, to 1e-12 of
the dense plain cycle and of the JAX package's ``_wave_cycle_xla`` at
"highest", whose sums it only reorders), the CPU model of the kernel's
3-pass TF32 split (within its bound of the exact product, where one TF32
pass is not), the flagship-shaped transfer solve at nx 32 with its probe
cycles through that model (JAX's 11 / 222), and the dispatch rule.

Tile counts (8 x 8 tiles holding a non-zero): 168 of 484 at pad 176 (nx
32, 16-DOF blocks), 158 at the flagship's nx 128, 731 of 6,241 at pad 632
(nx 64, 32-DOF blocks), 174-231 on the unstructured square's 8 domains
(pad 168) and at most 489 on L3's 256 domains (pad 320).

The tests marked ``cuda`` hold the tensor-core kernel to the plain cycle
(2e-4 relative to the max, as ``test_torch_wave_cycle.py``) and to the
sparse kernel forced on the same rows, in layouts (a) and (b), with padded
slots zero and repeats bitwise; they skip where there is no GPU.  On a
machine without JAX run
``python -m pytest --noconftest tests/test_torch_mma_cycle.py -m cuda``.
"""

import numpy as np
import pytest
import torch

import cuddhelmholtz_tpu_torch.solvers.ddh as ddh_mod
from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc

from test_torch_sparse_cycle import LIMIT, _h100_limit, _rel_max, _structured, _unstructured
from test_torch_wave_cycle import _f64, _jax_case, _jax_f64

# Small shapes: torch's intra-op thread pool costs more than it saves here,
# and beside other busy test processes it slows these tests a hundredfold.
torch.set_num_threads(1)

TOL = 2e-4
EXACT = 1e-12  # float64: the tile and dense sums differ only in order


def _check_layout(form: wc.TileS, S3: torch.Tensor) -> None:
    """Every output-column tile sits in exactly one (warp, slot), and the
    slot's pairs are that tile's non-zero k-tiles, ascending."""
    ng, pad, _ = S3.shape
    n = pad // wc.TILE
    slots, warps = wc.mma_layout(pad)
    assert form.col.shape == (ng, slots * warps) and form.ptr.shape == (ng, slots * warps + 1)
    nz = wc._tiles_of(S3).ne(0).any(4).any(3)  # [g, kt, it]
    for g in range(ng):
        col = form.col[g].long()
        assert sorted(col[col >= 0].tolist()) == list(range(n))
        for q in range(slots * warps):
            lo, hi = int(form.ptr[g, q]), int(form.ptr[g, q + 1])
            want = nz[g, :, col[q]].nonzero().flatten().tolist() if col[q] >= 0 else []
            assert form.kt[g, lo:hi].tolist() == want
            assert (form.it[g, lo:hi] == max(int(col[q]), 0)).all()
        count = int(form.ptr[g, -1])
        assert (form.val[g, count:] == 0).all() and (form.kt[g, count:] == 0).all()


# (S, pad, tile count of the first S)
CASES = {
    "structured-16": (lambda: _structured("cpu", 32, 16, 20.0).S, 176, 168),
    "structured-32": (lambda: _structured("cpu", 64, 32, 20.0).S, 632, 731),
    "unstructured": (lambda: _unstructured("cpu").S, 168, 182),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_form_densifies_to_S(case):
    """The form gives S back bitwise, its tiles are exactly S's non-zero
    8 x 8 tiles, dealt one per (warp, slot), and the counts are pinned."""
    make, pad, count0 = CASES[case]
    S = make()
    form = wc.tile_form(S)
    S3 = S if S.dim() == 3 else S[None]
    assert torch.equal(wc.tile_dense(form, pad), S3)
    counts = form.ptr[:, -1]
    assert int(counts[0]) == count0
    assert torch.equal(counts.long(), wc._tiles_of(S3).ne(0).any(4).any(3).sum((1, 2)))
    assert form.pairs == int(counts.max())
    if case == "unstructured":
        assert (int(counts.min()), form.pairs) == (174, 231)  # ragged: a zero tail
    assert form.val.dtype == torch.float32 and form.kt.dtype == torch.int16
    assert form.ptr.dtype == torch.int32 and form.col.dtype == torch.int16
    _check_layout(form, S3)
    sub = form.take(torch.tensor([0]))
    assert torch.equal(wc.tile_dense(sub, pad), S3[:1])


def test_fragment_order_of_a_tile():
    """Lane 4 n + t of a pair holds S[8 k + t, 8 i + n] and S[8 k + t + 4,
    8 i + n] (the B fragment of m16n8k8), and the warps' slots are dealt by
    falling pair count in snake order."""
    pad = 16
    S = torch.arange(1, pad * pad + 1, dtype=torch.float32).reshape(pad, pad)
    S[8:, :8] = 0  # k-tile 1 of i-tile 0 is empty
    form = wc.tile_form(S)
    assert wc.mma_layout(pad) == (1, 2)
    assert form.col.tolist() == [[1, 0]]  # i-tile 1 has two pairs, i-tile 0 one
    assert form.ptr.tolist() == [[0, 2, 3]] and form.kt.tolist() == [[0, 1, 0]]
    for j, (k, i) in enumerate(zip(form.kt[0].tolist(), form.it[0].tolist())):
        for lane in range(32):
            n, t = divmod(lane, 4)
            assert form.val[0, j, 2 * lane] == S[8 * k + t, 8 * i + n]
            assert form.val[0, j, 2 * lane + 1] == S[8 * k + t + 4, 8 * i + n]


def test_layouts_of_the_instances():
    """(slots, warps) of each pad: the fewest slots whose warp cap covers
    pad / 8 tiles; above MMA_MAX_PAD the form still builds, no kernel runs."""
    assert wc.mma_layout(168) == (1, 21) and wc.mma_layout(176) == (1, 22)
    assert wc.mma_layout(192) == (1, 24) and wc.mma_layout(200) == (2, 13)
    assert wc.mma_layout(320) == (2, 20) and wc.mma_layout(328) == (3, 14)
    assert wc.mma_layout(512) == (4, 16) and wc.MMA_MAX_PAD == 512
    assert wc.mma_layout(632) == (5, 16)
    assert wc.mma_shared_memory_bytes(176, 168) == 128 * 176 + 258 * 168


def test_tile_plain_matches_dense_and_xla_scan():
    """Layout (a): the plain cycle through the tile form equals the dense
    plain cycle and the JAX scan in float64."""
    jddh_mod, jparams, F, G, port, pad = _jax_case()
    import jax.numpy as jnp

    p64 = _f64(port)
    F64, G64 = torch.from_numpy(F[:, :pad]).double(), torch.from_numpy(G[:, :pad]).double()
    form = wc.tile_form(p64.S)
    assert form.val.dtype == torch.float64 and form.ptr.shape[0] == 1
    u, v = wc.wave_cycle_plain(p64, F64, G64, tiles=form)
    u0, v0 = wc.wave_cycle_plain(p64, F64, G64)
    assert _rel_max(u, u0) < EXACT and _rel_max(v, v0) < EXACT
    u_x, v_x = jddh_mod._wave_cycle_xla(_jax_f64(jparams), jnp.asarray(F, jnp.float64),
                                        jnp.asarray(G, jnp.float64), 5, precision="highest")
    assert _rel_max(u, np.asarray(u_x)[:, :pad]) < EXACT
    assert _rel_max(v, np.asarray(v_x)[:, :pad]) < EXACT


def test_tile_plain_grouped_matches_dense_and_xla_scan():
    """Layout (b) on a per-domain stack: runs of c rows against each
    domain's S through the tile form, against the dense plain cycle and the
    JAX scan (each row given its run's S), float64."""
    jddh_mod, jparams, F, G, port, pad = _jax_case(nt_override=60, jitter=True)
    import jax.numpy as jnp

    p64 = _f64(port)
    form = wc.tile_form(p64.S)
    c = 3
    gp = p64._replace(Ha=p64.Ha.repeat_interleave(c, 0), inv_mi=p64.inv_mi.repeat_interleave(c, 0))
    F64, G64 = torch.from_numpy(F[:, :pad]).double(), torch.from_numpy(G[:, :pad]).double()
    Fb, Gb = F64.repeat_interleave(c, 0), G64.repeat_interleave(c, 0)
    ub, vb = wc.wave_cycle_plain(gp, Fb, Gb, 2, s_group_size=c, tiles=form)
    ub0, vb0 = wc.wave_cycle_plain(gp, Fb, Gb, 2, s_group_size=c)
    assert _rel_max(ub, ub0) < EXACT and _rel_max(vb, vb0) < EXACT
    jp = _jax_f64(jparams)
    jp = jp._replace(**{k: jnp.repeat(getattr(jp, k), c, axis=0) for k in ("S", "Ha", "inv_mi")})
    u_x, v_x = jddh_mod._wave_cycle_xla(jp, jnp.asarray(np.repeat(F, c, 0), jnp.float64),
                                        jnp.asarray(np.repeat(G, c, 0), jnp.float64), 2,
                                        precision="highest")
    assert _rel_max(ub, np.asarray(u_x)[:, :pad]) < EXACT
    assert _rel_max(vb, np.asarray(v_x)[:, :pad]) < EXACT
    with pytest.raises(ValueError, match="tile form of 1 groups"):
        wc.wave_cycle_plain(gp, Fb, Gb, 1, s_group_size=c, tiles=form.take(torch.tensor([0])))


def test_tf32_round_is_rna():
    """``tf32_round`` keeps 10 mantissa bits, rounding to nearest with ties
    away from zero (``cvt.rna.tf32.f32``)."""
    one = 1.0
    ulp = 2.0 ** -10  # TF32's spacing above 1
    x = torch.tensor([one + ulp / 2, -(one + ulp / 2), one + ulp / 2 - 2 ** -23,
                      one + 1.5 * ulp, 3.0, 0.0], dtype=torch.float32)
    want = torch.tensor([one + ulp, -(one + ulp), one, one + 2 * ulp, 3.0, 0.0])
    assert torch.equal(wc.tf32_round(x), want)
    assert torch.equal(wc.tf32_truncate(x), torch.tensor([one, -one, one, one + ulp, 3.0, 0.0]))
    x = torch.from_numpy(np.random.default_rng(10).standard_normal(1000).astype(np.float32))
    hi, lo = wc.tf32_split(x)
    for part in (hi, lo):
        assert ((part.view(torch.int32) & 0x1FFF) == 0).all()
    assert ((hi.double() - x.double()).abs() <= 2.0 ** -11 * x.double().abs()).all()
    assert ((hi.double() + lo.double() - x.double()).abs() <= 2.0 ** -21 * x.double().abs()).all()


# of |P| @ |S|: the dropped lo lo (2^-22) and the two truncated lo (2^-21 each)
SPLIT_BOUND = 2.0 ** -19


def test_split_model_within_its_bound():
    """The kernel's product as the CPU model computes it (TF32 hi/lo parts
    of P and S, three products in float32) is within 2^-19 |P| |S| (plus
    float32 summation) of the exact product at the flagship shape; one
    TF32 pass is 2^-11 off and breaks that bound."""
    S = _structured("cpu", 32, 16, 20.0).S
    form = wc.tile_form(S)
    rng = np.random.default_rng(11)
    P = torch.from_numpy(rng.standard_normal((16, S.shape[0])).astype(np.float32))
    exact = P.double() @ S.double()
    scale = P.double().abs() @ S.double().abs()
    model = wc._tile_apply(form, S.shape[0], split=True)(P).double()
    sum32 = 2.0 ** -24 * 2 * 61 * scale  # float32 sums of at most 61 products, two partials
    assert ((model - exact).abs() <= SPLIT_BOUND * scale + sum32).all()
    one_pass = wc.tf32_round(P).double() @ wc.tf32_round(S).double()
    assert ((one_pass - exact).abs() > SPLIT_BOUND * scale + sum32).any()


def test_transfer_solve_with_split_probes_keeps_jax_counts(monkeypatch):
    """``run_ddh(nx=32, transfer=True)`` with every probe cycle through the
    split model of the tensor-core kernel: JAX's 11 restarts / 222
    matvecs (``test_torch_studies.py``'s sweep row)."""
    from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh

    calls = []

    def cycle(params, F, G, wh_maxit=wc.WH_MAXIT, s_group_size=None, **_):
        calls.append(tuple(F.shape))
        return wc.wave_cycle_plain(params, F, G, wh_maxit, s_group_size,
                                   tiles=wc.tile_form(params.S), split=True)

    monkeypatch.setattr(ddh_mod, "wave_cycle", cycle)
    monkeypatch.setenv("CUDDH_CACHE_DIR", "")
    res = run_ddh(nx=32, transfer=True, device="cpu")
    # the transfer probes of the 12 unique subdomains' 64 columns, then rhs
    # and postprocess (the CPU builds no io maps)
    assert calls == [(768, 176), (64, 176), (64, 176)]
    assert res.success and (res.num_iter, res.num_matvec) == (11, 222)


def test_ddh_holds_its_tile_form(monkeypatch):
    """The operator builds the tile form of the matrices its tensor-core
    kernel reads (the probes of the unstructured square's unique S) on
    first use, on its device, and keeps it; cycles on the CPU do not build
    it."""
    _h100_limit(monkeypatch)
    ddh = _unstructured("cpu", omega_scale=32.0)  # few steps: the cycle's input is zero
    ddh.action(torch.zeros(ddh.size))
    assert ddh._k1_probe is None
    kernel = ddh.k1_probe
    uidx, _, _ = ddh._domain_groups()
    assert kernel.variant == "mma"
    assert torch.equal(wc.tile_dense(kernel.form, ddh.pad), ddh.S[torch.as_tensor(uidx)])
    assert ddh.k1_probe is kernel and ddh._k1 is None


# (pad, tile pairs, sparse-form stride, default) of every configuration the
# repo runs, from the forms at each one's own size: the flagship (nx 128),
# the unstructured square (8 domains), L3 with 256 domains; ddh_512_block32's
# pad 632 is above every tensor-core instance
CONFIG_SHAPES = {
    "ddh_structured": (176, 158, 2496, "sparse"),
    "ddh_unstructured_square": (168, 231, 4512, "mma"),
    "large_unstructured_L3": (320, 489, 7712, "sparse"),
    "ddh_512_block32": (632, 731, 10336, "sparse"),
}


@pytest.mark.parametrize("config", sorted(CONFIG_SHAPES))
def test_dispatch_follows_the_measured_rule(config):
    """By default the tensor-core kernel runs where its form fits and
    ``mma_preferred`` holds (pad <= 192 and at least 9 k-tiles per output
    tile in the largest group: the unstructured square), the sparse kernel
    elsewhere and for the per-row layout (c), a dense one where no sparse
    form is given; a forced ``"mma"`` runs wherever its form fits and
    raises where it does not (pad 632, per-row, too little shared
    memory)."""
    pad, pairs, stride, want = CONFIG_SHAPES[config]
    fits = pad <= wc.MMA_MAX_PAD
    dense = "resident" if pad <= 224 else "streamed"
    assert wc.mma_preferred(pad, pairs) == (want == "mma")
    assert wc.kernel_variant(pad, LIMIT, stride, pairs=pairs) == want
    assert wc.kernel_variant(pad, LIMIT, stride) == "sparse"  # no tile form
    assert wc.kernel_variant(pad, LIMIT, stride, per_row=True, pairs=pairs) == "sparse"
    assert wc.kernel_variant(pad, LIMIT, stride, variant="sparse", pairs=pairs) == "sparse"
    assert wc.kernel_variant(pad, LIMIT, None, pairs=pairs) == ("mma" if want == "mma" else dense)
    with pytest.raises(ValueError, match="no kernel mma"):
        wc.kernel_variant(pad, LIMIT, stride, variant="mma", per_row=True, pairs=pairs)
    if fits:
        assert wc.kernel_variant(pad, LIMIT, stride, variant="mma", pairs=pairs) == "mma"
        need = wc.mma_shared_memory_bytes(pad, pairs)
        assert need <= LIMIT
        with pytest.raises(ValueError, match="no kernel mma"):
            wc.kernel_variant(pad, need - 1, stride, variant="mma", pairs=pairs)
        assert wc.kernel_variant(pad, need - 1, stride, pairs=pairs) == "sparse"
    else:
        with pytest.raises(ValueError, match="no kernel mma"):
            wc.kernel_variant(pad, LIMIT, stride, variant="mma", pairs=pairs)


@pytest.mark.parametrize("pad,pairs,want", [
    (168, 189, "mma"), (168, 188, "sparse"),  # 9 k-tiles per output tile: 9 x 21
    (192, 216, "mma"), (200, 300, "sparse"),  # two slots a warp above pad 192
])
def test_mma_preferred_threshold(pad, pairs, want):
    assert wc.kernel_variant(pad, LIMIT, 8000, pairs=pairs) == want


def _form_kind(kernel: wc.K1):
    return {"mma": wc.TileS, "sparse": wc.SparseS}[kernel.variant]


@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_pairs_counts_without_the_form(case, monkeypatch):
    """``tile_pairs`` is the form's ``pairs``, of every group or of the
    groups ``index``, and ``k1_kernel`` applies the rule to it on an H100
    and builds only the chosen kernel's form, of those groups: the
    tensor-core kernel for the square's dense tiles, the sparse kernel at
    nx 32's pad 176 (168 tiles, 7.6 an output tile) and at pad 632."""
    _h100_limit(monkeypatch)
    make, pad, _ = CASES[case]
    S = make()
    assert wc.tile_pairs(S) == wc.tile_form(S).pairs
    want = "mma" if case == "unstructured" else "sparse"
    kernel = wc.k1_kernel(S)
    assert kernel.variant == want and type(kernel.form) is _form_kind(kernel)
    if S.dim() == 3:
        index = torch.tensor([1, 0])
        assert wc.tile_pairs(S, index) == wc.tile_form(S[index]).pairs
        kernel = wc.k1_kernel(S, index)
        assert kernel.variant == ("mma" if wc.mma_preferred(
            pad, wc.tile_pairs(S, index)) else "sparse")
        assert type(kernel.form) is _form_kind(kernel) and kernel.form.ptr.shape[0] == 2


@pytest.mark.parametrize("unstructured", [False, True])
def test_ddh_builds_only_the_form_it_runs(unstructured, monkeypatch):
    """A shared S's cycles and probes run one kernel, the rule's (on these
    rectangles the factored one, from the operator's element factors), and
    the operator builds only its form; a per-domain S's probes run the rule's
    kernel for the unique matrices, whose form is built without the
    cycles' per-row one.  The setup-cache key on the CPU builds no
    kernel."""
    _h100_limit(monkeypatch)
    ddh = _unstructured("cpu") if unstructured else _structured("cpu", 32, 16, 20.0)
    ddh.setup_cache_key()
    assert ddh._k1 is None and ddh._k1_probe is None
    if unstructured:  # a per-domain S: its probes decide from the unique matrices
        uidx, _, _ = ddh._domain_groups()
        probe = ddh.k1_probe
        assert probe.variant == "mma" and probe.form.ptr.shape[0] == len(uidx)
        assert ddh._k1 is None
        return
    kernel = ddh.k1
    assert kernel.variant == "factored" and type(kernel.form) is wc.FactoredS
    assert ddh.k1_probe is kernel


def test_k1_study_needs_a_card(monkeypatch, capsys):
    """The study of the two K1 kernels runs only on a card: without one it
    exits 2 with a message, before building anything."""
    from cuddhelmholtz_tpu_torch.examples import k1_study

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    assert k1_study.main() == 2
    assert "needs a CUDA device" in capsys.readouterr().err
    assert set(k1_study.ABLATIONS.values()) == {"trunc", "one_pass", "no_split", "no_mma"}


# ------------------------------------------------------------ on the GPU


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _masked(rng, mask):
    m = mask.cpu().numpy()
    return torch.from_numpy((rng.standard_normal(m.shape) * m).astype(np.float32)).to(mask.device)


def _launch(p, F, G, key, mask, s_group_size=None, **kw):
    before = wc.launch_counts()
    u, v = wc.wave_cycle(p, F, G, 1, s_group_size, **kw)
    torch.cuda.synchronize()
    assert wc.launch_counts() == {**before, key: before[key] + 1}
    assert (u[mask == 0] == 0).all() and (v[mask == 0] == 0).all()
    return u, v


def _close(u, v, u0, v0):
    assert float(u0.abs().max()) > 0
    assert _rel_max(u.cpu(), u0.cpu()) < TOL and _rel_max(v.cpu(), v0.cpu()) < TOL


@pytest.mark.cuda
def test_mma_shared_matches_plain_and_sparse(cuda):
    """Layout (a) at pad 176 on 62 rows (the last block partial): the
    tensor-core kernel forced against the plain cycle and the sparse kernel
    (the default there); a repeat is bitwise."""
    ddh = _structured(cuda, 32, 16, 2 * np.pi * 1.6)
    p = ddh.params
    p = p._replace(Ha=p.Ha[:62].contiguous(), inv_mi=p.inv_mi[:62].contiguous())
    mask = ddh.gmask[:62]
    rng = np.random.default_rng(12)
    F, G = _masked(rng, mask), _masked(rng, mask)
    mma = wc.k1_kernel(p.S, variant="mma")
    u, v = _launch(p, F, G, "mma_shared", mask, kernel=mma)
    _close(u, v, *wc.wave_cycle_plain(p, F, G, 1))
    _close(u, v, *_launch(p, F, G, "sparse_shared", mask))
    u2, v2 = _launch(p, F, G, "mma_shared", mask, kernel=wc.k1_kernel(p.S, variant="mma"))
    assert torch.equal(u, u2) and torch.equal(v, v2)


@pytest.mark.cuda
def test_mma_grouped_matches_plain_and_sparse(cuda):
    """Layout (b) on the unstructured square's ragged per-domain stack
    (pad 168), runs of 16 rows: the tensor-core kernel by default."""
    ddh = _unstructured(cuda, omega_scale=8.0)
    p = ddh.params
    c = 16
    gp = p._replace(Ha=p.Ha.repeat_interleave(c, 0), inv_mi=p.inv_mi.repeat_interleave(c, 0))
    mask = ddh.gmask.repeat_interleave(c, 0)
    rng = np.random.default_rng(13)
    F, G = _masked(rng, mask), _masked(rng, mask)
    u, v = _launch(gp, F, G, "mma_grouped", mask, s_group_size=c)
    _close(u, v, *wc.wave_cycle_plain(gp, F, G, 1, c))
    _close(u, v, *_launch(gp, F, G, "sparse_grouped", mask, s_group_size=c,
                          kernel=wc.k1_kernel(gp.S, variant="sparse")))


@pytest.mark.cuda
def test_mma_refuses_per_row_and_large_pad(cuda):
    """A forced ``"mma"`` raises on a per-row stack and at pad 632; the
    defaults there run the sparse kernel."""
    ddh = _structured(cuda, 64, 32, 2 * np.pi * 12.8)
    p = ddh.params
    z = torch.zeros_like(ddh.Ha[:8])
    with pytest.raises(ValueError, match="no kernel mma"):
        wc.k1_kernel(p.S, variant="mma")
    pp = p._replace(S=p.S.expand(8, -1, -1).contiguous(), Ha=z, inv_mi=z)
    with pytest.raises(ValueError, match="no kernel mma"):
        wc.k1_kernel(pp.S, per_row=True, variant="mma")
    _launch(pp, z, z, "sparse_per_row", torch.ones_like(z))
