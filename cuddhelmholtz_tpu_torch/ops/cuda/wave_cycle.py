"""The DDH WaveHoltz cycle: Hopper kernel wrappers and their plain PyTorch version.

Counterpart of ``cuddhelmholtz_tpu/ops/pallas/wave_cycle.py``.  ``wave_cycle``
runs ``wh_maxit`` WaveHoltz iterations of ``nt`` staggered-leapfrog steps on
every subdomain row with one launch of a hand-written CUDA kernel, in the
Pallas kernel's three stiffness layouts:

  (a) one shared (pad, pad) S;
  (b) an (ngroups, pad, pad) stack with rows in runs of ``s_group_size``;
  (c) one S per row (ndom, pad, pad): the sparse kernel's per-row instance,
      one row per block, where the JAX package's solver tiles each row x8
      onto (b) (its ``solvers/ddh.py::_wave_cycle``: free on the TPU's 8-row
      tile, 8x the work here).  ``cycle_route`` decides.

Five kernels serve the layouts.  ``k1_kernel`` is the one place that chooses
among them: it applies the rule of ``kernel_variant`` once, on S's shape,
tiles, non-zeros and element factors and the card's shared memory, and
builds only the form of S the chosen kernel reads (a ``K1``).
``csrc/wave_cycle_factored.cu`` never forms S: from the derivative matrix
and the element factors upstream's ``stiffness<NB>`` applies it from (the
DDH's ``ElementFactors``), it applies S grid line by grid line
(``factored_form``: on rectangles, B = 0, each element's stiffness is a
sum of line matrices), in layouts (a) and (b), the default wherever it is
given those factors and its form fits.  ``csrc/wave_cycle_mma.cu``
applies S on the tensor cores (``mma.sync`` m16n8k8, a 3-pass TF32 split,
the counterpart of the Pallas kernel's 3-pass bf16 split on the MXU) from
its non-zero 8 x 8 tiles (``tile_form``), in layouts (a) and (b), the
default where that form fits and the card measured it faster
(``mma_preferred``); ``csrc/wave_cycle_sparse.cu`` applies S from its
exact non-zeros (``sparse_form``, a CSC of S) held in shared memory with
FP32 FFMA, the default elsewhere and for layout (c); ``csrc/wave_cycle.cu``
keeps the dense S resident in shared memory (pad <= 224 on an H100) and
``csrc/wave_cycle_streamed.cu`` streams it through shared memory in panels
(pad up to 1024), the rule's last resorts, which a caller can also force.
For tensors on the CPU ``wave_cycle`` runs ``wave_cycle_plain``, the JAX
package's ``_wave_cycle_xla`` loop as torch ops; for a CUDA tensor it
launches a kernel or raises.

All compute the stiffness product as ``P @ S`` (the Pallas kernel's
orientation); the JAX scan computes ``S P``.  They agree because the
assembled subdomain stiffness is symmetric (to round-off, for a per-domain
S on an unstructured mesh).

The kernels are compiled with ``nvcc`` from the package's sources at first
use into ``cuddhelmholtz_tpu_torch/_build/`` (one process per source, all
started together) and bound with ``ctypes`` to plain C entry points.
Nothing is built or loaded at import time.

Every cycle is counted in the counters of ``utils/spans.py``: ``k1.rows``
(the rows it runs) and ``k1.flop``, 2 * 2 * wh_maxit * nt * the sum over
those rows of nnz(S of the row's group), on either device and whatever
form of S the kernel reads; each kernel launch in ``k1.launches.<route
key>`` (``launch_counts``).
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.weak import WeakIdKeyDictionary

from ...utils.spans import count, totals

WH_MAXIT = 5  # fixed-point WaveHoltz iterations per apply
# kRows of the dense kernels, and the unit of every run of rows sharing one S
# (checked when a library loads); the sparse kernel's kRows divides it
ROWS_PER_BLOCK = 8
SPARSE_ROWS_PER_BLOCK = 4  # kRows in csrc/wave_cycle_sparse.cu, layouts (a) and (b)
SPARSE_MAX_PAD = 640  # csrc/wave_cycle_sparse.cu: one thread per column
MAX_THREADS = 512  # kMaxThreads in csrc/wave_cycle.cu: two threads per column
STREAMED_MAX_PAD = 1024  # csrc/wave_cycle_streamed.cu: pad / 2 threads, at most 512
TILE = 8  # the tensor-core kernel's S tiles: 8 (k) x 8 (i), the k and n of m16n8k8
MMA_ROWS_PER_BLOCK = ROWS_PER_BLOCK  # kRows in csrc/wave_cycle_mma.cu: [p ; p_half] is M = 16
# (slots, warp cap) of each instance of csrc/wave_cycle_mma.cu: a warp owns up
# to `slots` output-column tiles; the cap keeps the block's registers on an SM
MMA_INSTANCES = ((1, 24), (2, 20), (3, 16), (4, 16))
MMA_MAX_PAD = TILE * max(slots * cap for slots, cap in MMA_INSTANCES)
# The default runs the tensor-core kernel ahead of the sparse one only where
# the card measured it faster (``mma_preferred``): one slot a warp (pad <=
# MMA_PREFERRED_MAX_PAD) and S's non-zero 8 x 8 tiles dense enough, at least
# MMA_PREFERRED_TILES k-tiles per output-column tile in its largest group.
MMA_PREFERRED_MAX_PAD = TILE * MMA_INSTANCES[0][1]  # one slot a warp: 192
MMA_PREFERRED_TILES = 9
# csrc/wave_cycle_factored.cu: threads a block, a segment's nodes (degree 3),
# and the segments a line the kernel takes
FACTORED_THREADS = 128
FACTORED_NB = 4
FACTORED_SEGMENTS = (4, 8)
# |B| at or below this share of the largest |A|, |C| is the round-off of a
# rectangle's geometry: the factored form reads it as 0
FACTORED_B_ROUNDOFF = 1e-12
VARIANTS = ("mma", "sparse", "resident", "streamed", "factored")
# the counter prefix of the kernel launches, and the route keys it counts
LAUNCHES = "k1.launches."
ROUTE_KEYS = ("shared", "grouped", "streamed_shared", "streamed_grouped", "sparse_shared",
              "sparse_grouped", "sparse_per_row", "mma_shared", "mma_grouped", "factored_shared",
              "factored_grouped")

_PKG = Path(__file__).resolve().parents[2]
SOURCES = {
    "factored": _PKG / "csrc" / "wave_cycle_factored.cu",
    "mma": _PKG / "csrc" / "wave_cycle_mma.cu",
    "sparse": _PKG / "csrc" / "wave_cycle_sparse.cu",
    "resident": _PKG / "csrc" / "wave_cycle.cu",
    "streamed": _PKG / "csrc" / "wave_cycle_streamed.cu",
}
# prefix of each library's C entry points
_ENTRY = {
    "factored": "wave_cycle_factored_", "mma": "wave_cycle_mma_", "sparse": "wave_cycle_sparse_",
    "resident": "wave_cycle_", "streamed": "wave_cycle_streamed_",
}
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def shared_memory_bytes(pad: int) -> int:
    """Dynamic shared memory one block of the resident kernel needs: S, the
    stacked [p ; p - dt/2 q] rows of its ROWS_PER_BLOCK subdomains and the
    partial sums the two k-groups hand each other."""
    return 4 * (pad * pad + 2 * 2 * ROWS_PER_BLOCK * pad)


def streamed_shared_memory_bytes(pad: int) -> int:
    """Dynamic shared memory one block of the streamed kernel needs: the
    stacked rows (2 x 8 pad floats), the sums the two thread groups hand
    each other (8 pad) and a ring of three 8-row S panels (24 pad)."""
    return 4 * (2 * ROWS_PER_BLOCK + ROWS_PER_BLOCK + 3 * 8) * pad


def sparse_shared_memory_bytes(pad: int, stride: int, rows: int = SPARSE_ROWS_PER_BLOCK) -> int:
    """Dynamic shared memory one block of the sparse kernel needs: two
    buffers of the stacked [p ; p_half] rows of its ``rows`` subdomains
    (SPARSE_ROWS_PER_BLOCK, or 1 in the per-row instance of layout (c)), and
    one S's ``stride`` staged values (4 B) and row indices (2 B)."""
    return 4 * 4 * rows * pad + 6 * stride


def mma_preferred(pad: int, pairs: int) -> bool:
    """Whether the default runs the tensor-core kernel ahead of the sparse
    (FFMA) one at ``pad`` for an S whose largest group holds ``pairs``
    non-zero 8 x 8 tiles (``TileS.pairs``, ``tile_pairs``): one output tile
    a warp (pad <= MMA_PREFERRED_MAX_PAD) and at least MMA_PREFERRED_TILES
    k-tiles per output tile in that group.  A rule on S's shape alone, from
    the two kernels timed in turns over a ladder of 384 to 12,288 rows on an
    NVIDIA H100 80GB HBM3 at 700 W (``examples/k1_study.py``; PERF.md
    section 6): the rows do not decide.  The unstructured square's S (pad
    168, 231 tiles, 11 per output tile) runs faster on the tensor cores at
    every row count, 960 to 12,032 (17.36 against 21.39 ms at 960, 61.54
    against 66.94 at 3,648, 185.2 against 202.4 at 12,032); the flagship's
    (pad 176, 158 tiles, 7.2) slower at every one, 384 to 12,000 (6.28
    against 6.13 at 1,024, 74.24 against 61.71 at 12,000); L3's (pad 320,
    two output tiles a warp) slower at 1,024 to 12,288 (24.03 against
    20.65 at 1,024)."""
    return pad <= MMA_PREFERRED_MAX_PAD and TILE * pairs >= MMA_PREFERRED_TILES * pad


def factored_pairs(L: int) -> int:
    """(row, position) pairs a thread of the factored kernel updates for
    lines of ``L`` segments (``pairs_for`` in csrc/wave_cycle_factored.cu)."""
    return 3 if L <= 4 else 5


def factored_rows(nlines: int, rs: int, L: int) -> int:
    """Rows a block of the factored kernel owns for ``nlines`` lines of
    ``L`` segments a row and a row stride of ``rs`` positions (``rows_for``
    in csrc/wave_cycle_factored.cu): the most of 8, 4, 2, 1 whose 2 R nlines
    line items fit its FACTORED_THREADS threads and whose R rs positions
    they hold, ``factored_pairs(L)`` each; 0 when none does or the kernel
    has no instance for L."""
    if L not in FACTORED_SEGMENTS:
        return 0
    for r in (8, 4, 2, 1):
        if 2 * r * nlines <= FACTORED_THREADS and r * rs <= factored_pairs(L) * FACTORED_THREADS:
            return r
    return 0


def factored_shared_memory_bytes(rows: int, rs: int) -> int:
    """Dynamic shared memory one block of the factored kernel needs: the
    stacked [p ; p_half] rows of its ``rows`` subdomains and the x and y
    planes of line products for both, ``rs`` floats a row each."""
    return 4 * 6 * rows * rs


def kernel_variant(pad: int, limit: int, stride: int | None = None,
                   variant: str | None = None, per_row: bool = False,
                   pairs: int | None = None,
                   factored: tuple[int, int, int] | None = None) -> str:
    """The kernel that runs a cycle at ``pad`` on a card that allows
    ``limit`` bytes of shared memory per block, for a factored form of
    shape ``factored`` (``(nlines, rs, L)`` of a ``FactoredS``,
    ``FactoredS.shape``; None: no such form), a tile form of
    ``pairs`` non-zero 8 x 8 tiles per group (``TileS.pairs``; None: no
    form) and a sparse form of ``stride`` entries per group
    (``SparseS.stride``: the non-zeros as the kernel stages them, at least
    the nnz; None: no form).  ``per_row``: a layout-(c) stack, which the
    sparse kernel runs one row per block and the factored and tensor-core
    kernels do not take.

    By default: ``"factored"`` wherever its form fits (``factored_rows`` >
    0, ``factored_shared_memory_bytes`` <= limit): on an NVIDIA H100 80GB
    HBM3 at 700 W it ran 2.1 to 3.2 times as fast as the sparse kernel at
    every shape timed, 384 to 12,000 rows at pad 176 and 1,024 and 12,480
    at pad 632 (``examples/k1_study.py``; PERF.md section 6), and the
    tensor-core kernel is slower than the sparse one there; else ``"mma"`` when
    ``mma_preferred`` holds and the tile form and the row state fit (pad <=
    MMA_MAX_PAD and ``mma_shared_memory_bytes`` <= limit), else
    ``"sparse"`` when the sparse form and the row state fit (pad <=
    SPARSE_MAX_PAD and ``sparse_shared_memory_bytes`` <= limit), else
    ``"resident"`` when the dense S and the row state fit and pad <=
    MAX_THREADS / 2, else ``"streamed"`` (pad <= STREAMED_MAX_PAD).  The
    choice rests on these shapes alone.  ``variant`` names the kernel
    instead.  Raises when the chosen kernel does not take the shape."""
    block_rows = 1 if per_row else SPARSE_ROWS_PER_BLOCK
    f_rows = 0 if factored is None else factored_rows(*factored)
    fits = {
        "factored": f_rows > 0 and not per_row and factored[1] >= pad
        and factored_shared_memory_bytes(f_rows, factored[1]) <= limit,
        "mma": pairs is not None and not per_row and pad <= MMA_MAX_PAD and pad % TILE == 0
        and mma_shared_memory_bytes(pad, pairs) <= limit,
        "sparse": stride is not None and pad <= SPARSE_MAX_PAD
        and sparse_shared_memory_bytes(pad, stride, block_rows) <= limit,
        "resident": 2 * pad <= MAX_THREADS and shared_memory_bytes(pad) <= limit,
        "streamed": pad <= STREAMED_MAX_PAD and streamed_shared_memory_bytes(pad) <= limit,
    }
    if variant is None:
        first = ("factored",) + (("mma",) if pairs is not None and mma_preferred(pad, pairs)
                                 else ())
        for name in (*first, "sparse", "resident", "streamed"):
            if fits[name]:
                return name
    elif variant not in fits:
        raise ValueError(f"wave_cycle: unknown variant {variant!r}; one of {VARIANTS}")
    elif fits[variant]:
        return variant
    need = {
        "factored": None if not f_rows else factored_shared_memory_bytes(f_rows, factored[1]),
        "mma": None if pairs is None else mma_shared_memory_bytes(pad, pairs),
        "sparse": None if stride is None else sparse_shared_memory_bytes(pad, stride, block_rows),
        "resident": shared_memory_bytes(pad),
        "streamed": streamed_shared_memory_bytes(pad),
    }
    raise ValueError(
        f"wave_cycle: no kernel{'' if variant is None else ' ' + variant} takes pad={pad} "
        f"(factored {factored}, tile pairs {pairs}, sparse stride {stride}"
        f"{', per-row S' if per_row else ''}): bytes of shared memory per block {need}, the "
        f"card allows {limit} B; pad <= {MMA_MAX_PAD} (mma, layouts (a) and (b)), "
        f"{SPARSE_MAX_PAD} (sparse), {MAX_THREADS // 2} (resident), {STREAMED_MAX_PAD} "
        f"(streamed); factored: layouts (a) and (b), 2 x lines <= {FACTORED_THREADS}, "
        f"{FACTORED_SEGMENTS} segments a line"
    )


class Route(NamedTuple):
    """How ``wave_cycle`` runs one cycle on the kernel it chose."""

    key: str  # its launches are counted in ``k1.launches.<key>``
    rows: int  # rows the kernel computes
    groups: int  # stiffness matrices it reads (sparse-form groups)
    tile: int  # copies of each caller row among them (1: none)
    s_group_size: int  # rows per matrix it is given (0: one shared S)


def cycle_route(variant: str, ndom: int, ngroups: int | None,
                s_group_size: int | None = None) -> Route:
    """The route of a cycle of ``ndom`` rows on ``variant``'s kernel, for a
    shared S (``ngroups`` None) or a stack of ``ngroups`` matrices, in runs
    of ``s_group_size`` rows (layout (b)) or one per row (layout (c), no
    ``s_group_size``).  The sparse kernel runs (c) in its per-row instance,
    ``ndom`` rows against ``ndom`` groups with no copies; the dense kernels'
    blocks need runs of ROWS_PER_BLOCK rows, so they take each row
    ROWS_PER_BLOCK times in layout (b), as the JAX solver does; the
    tensor-core and factored kernels do not take (c).  Raises when the rows do not
    match the groups."""
    prefix = {"factored": "factored_", "mma": "mma_", "sparse": "sparse_", "resident": "",
              "streamed": "streamed_"}[variant]
    if ngroups is None:
        if s_group_size is not None:
            raise ValueError("wave_cycle: s_group_size needs a 3-D stiffness stack")
        return Route(prefix + "shared", ndom, 1, 1, 0)
    if s_group_size is not None:
        _check_groups(ngroups, s_group_size, ndom)
        if s_group_size % ROWS_PER_BLOCK:
            raise ValueError(
                f"wave_cycle: s_group_size={s_group_size} must be a multiple of "
                f"{ROWS_PER_BLOCK} (the rows of one block share one S)"
            )
        return Route(prefix + "grouped", ndom, ngroups, 1, s_group_size)
    if ngroups != ndom:
        raise ValueError(f"wave_cycle: a per-row stack of {ngroups} matrices for {ndom} rows")
    if variant == "sparse":
        return Route("sparse_per_row", ndom, ndom, 1, 1)
    if variant in ("mma", "factored"):
        raise ValueError(f"wave_cycle: the {variant} kernel does not take a per-row stack "
                         "(layout (c)); the sparse per-row instance does")
    r = ROWS_PER_BLOCK
    return Route(prefix + "grouped", r * ndom, ndom, r, r)


class SparseS(NamedTuple):
    """The stiffness by output column (CSC of S) for ``ngroups`` matrices,
    the form the sparse kernel reads: ``out[:, i] = sum_j P[:, idx[j]]
    val[j]`` over ``ptr[i] <= j < ptr[i + 1]``.  A 2-D S is one group.

    ``order`` lists the columns by falling nnz (stable): the kernel's thread
    t takes column ``order[t]``, and stages the entries of a warp's 32
    columns interleaved, 32 times the warp's longest column.  ``stride``,
    the entries kept per group (the tail past a group's nnz is zero), is
    the largest such staged length over the groups, at least the largest
    nnz.
    """

    ptr: torch.Tensor  # (ngroups, pad + 1) int32 column offsets
    idx: torch.Tensor  # (ngroups, stride) int16 row indices k
    val: torch.Tensor  # (ngroups, stride) S[k, i], S's dtype
    order: torch.Tensor  # (ngroups, pad) int16 slot -> column

    @property
    def stride(self) -> int:
        return self.idx.shape[1]

    def take(self, index: torch.Tensor) -> "SparseS":
        """The form of the groups ``index`` (as ``S[index]``)."""
        return SparseS(*(t[index].contiguous() for t in self))


def sparse_form(S: torch.Tensor) -> SparseS:
    """The exact non-zeros of ``S`` ((pad, pad), or (ngroups, pad, pad)) as a
    ``SparseS``, built with torch ops on S's device: each column's entries
    in increasing row order, an all-zero column empty."""
    S3 = S if S.dim() == 3 else S.unsqueeze(0)
    ng, pad, _ = S3.shape
    cols = S3.transpose(1, 2)  # cols[g, i, k] = S[g, k, i]
    nz = cols != 0
    counts = nz.sum(2)
    order = torch.sort(counts, dim=1, descending=True, stable=True).indices
    # a warp's staged length is 32 x its first (longest) column's nnz
    staged = 32 * counts.gather(1, order)[:, ::32].sum(1)
    stride = max(1, int(staged.max()))
    per_group = counts.sum(1)
    ptr = torch.zeros((ng, pad + 1), dtype=torch.int32, device=S.device)
    ptr[:, 1:] = counts.cumsum(1)
    g, i, k = nz.nonzero(as_tuple=True)  # by group, then column, then row
    pos = torch.arange(g.numel(), device=S.device) - (per_group.cumsum(0) - per_group)[g]
    idx = torch.zeros((ng, stride), dtype=torch.int16, device=S.device)
    idx[g, pos] = k.to(torch.int16)
    val = torch.zeros((ng, stride), dtype=S.dtype, device=S.device)
    val[g, pos] = cols[g, i, k]
    return SparseS(ptr, idx, val, order.to(torch.int16))


def mma_layout(pad: int) -> tuple[int, int]:
    """(slots, warps) of the tensor-core kernel at ``pad``: each warp owns
    up to ``slots`` output-column tiles of 8 (the SLOTS instances in
    ``csrc/wave_cycle_mma.cu``), in as few slots as an instance's warp cap
    allows.  Above MMA_MAX_PAD no instance runs; the layout is then the
    last cap's, which a ``tile_form`` of such an S (for its counts and the
    plain cycle) still uses."""
    n_i = -(-pad // TILE)
    for slots, cap in MMA_INSTANCES:
        if n_i <= slots * cap:
            return slots, -(-n_i // slots)
    slots = -(-n_i // MMA_INSTANCES[-1][1])
    return slots, -(-n_i // slots)


def mma_shared_memory_bytes(pad: int, pairs: int) -> int:
    """Dynamic shared memory one block of the tensor-core kernel needs: two
    buffers of the stacked [p ; p_half] rows of its MMA_ROWS_PER_BLOCK
    subdomains (2 x 16 pad floats, in fragment order) and one S's ``pairs``
    non-zero 8 x 8 tiles (64 floats and a 2-byte k-tile offset each)."""
    return 4 * 2 * 2 * MMA_ROWS_PER_BLOCK * pad + (4 * TILE * TILE + 2) * pairs


class TileS(NamedTuple):
    """The stiffness as its non-zero 8 (k) x 8 (i) tiles for ``ngroups``
    matrices, the form the tensor-core kernel reads: ``out[:, 8 i:8 i + 8]
    += P[:, 8 k:8 k + 8] @ tile`` for every pair (k-tile, i-tile) whose tile
    holds a non-zero.  A 2-D S is one group.

    The pairs of a group run in (warp, slot) order, ascending k-tile within
    a slot: warp w of the kernel computes output-column tile ``col[w *
    slots + s]`` (-1: none) of its slots s from pairs ``ptr[w * slots + s]
    <= j < ptr[w * slots + s + 1]``, with (slots, warps) = ``mma_layout(pad)``.
    The i-tiles are dealt to the warps by falling pair count in snake
    order, so the warps' loops run nearly one length.  Each tile's 64
    values are stored in the ``mma.sync`` B-fragment order: lane ``4 n + t``
    holds S[8 k + t, 8 i + n] and S[8 k + t + 4, 8 i + n].  ``pairs``, the
    tiles kept per group (the tail past a group's count is zero), is the
    largest count over the groups.
    """

    val: torch.Tensor  # (ngroups, pairs, 64) tile values in fragment order, S's dtype
    kt: torch.Tensor  # (ngroups, pairs) int16 k-tile of each pair
    it: torch.Tensor  # (ngroups, pairs) int16 i-tile of each pair
    ptr: torch.Tensor  # (ngroups, warps * slots + 1) int32 pair offsets per (warp, slot)
    col: torch.Tensor  # (ngroups, warps * slots) int16 i-tile of each (warp, slot), -1 none

    @property
    def pairs(self) -> int:
        return self.kt.shape[1]

    def take(self, index: torch.Tensor) -> "TileS":
        """The form of the groups ``index`` (as ``S[index]``)."""
        return TileS(*(t[index].contiguous() for t in self))


def _tiles_of(S3: torch.Tensor) -> torch.Tensor:
    """(ng, pad, pad) -> (ng, k-tiles, i-tiles, 8, 8) views of its tiles."""
    ng, pad, _ = S3.shape
    n = pad // TILE
    return S3.reshape(ng, n, TILE, n, TILE).permute(0, 1, 3, 2, 4)


def tile_pairs(S: torch.Tensor, index: torch.Tensor | None = None) -> int:
    """The most non-zero 8 x 8 tiles in one group of ``S`` (of the groups
    ``index`` of a stack; None: all), ``TileS.pairs`` of the form of those
    groups, counted without building it."""
    S3 = S if S.dim() == 3 else S.unsqueeze(0)
    counts = (_tiles_of(S3) != 0).any(4).any(3).sum((1, 2))
    return max(1, int((counts if index is None else counts[index]).max()))


def tile_form(S: torch.Tensor) -> TileS:
    """The non-zero 8 x 8 tiles of ``S`` ((pad, pad), or (ngroups, pad,
    pad); pad a multiple of 8) as a ``TileS``, built with torch ops on S's
    device.  The kernel takes it up to MMA_MAX_PAD."""
    S3 = S if S.dim() == 3 else S.unsqueeze(0)
    ng, pad, _ = S3.shape
    if pad % TILE:
        raise ValueError(f"wave_cycle: pad={pad} must be a multiple of {TILE}")
    slots, warps = mma_layout(pad)
    n = pad // TILE
    dev = S.device
    tiles = _tiles_of(S3)  # [g, kt, it, k, i]
    nz = (tiles != 0).any(4).any(3)  # [g, kt, it]
    counts = nz.sum(1)  # pairs per i-tile
    order = torch.sort(counts, dim=1, descending=True, stable=True).indices  # rank -> i-tile
    # (warp, slot) -> rank: slot s deals ranks s W .. s W + W - 1, forward on
    # even slots and backward on odd ones
    w = torch.arange(warps, device=dev)
    s = torch.arange(slots, device=dev)
    rank = s[None, :] * warps + torch.where(s[None, :] % 2 == 0, w[:, None], warps - 1 - w[:, None])
    rank = rank.reshape(-1)  # index w * slots + s
    ok = rank < n
    col = torch.full((ng, warps * slots), -1, dtype=torch.long, device=dev)
    col[:, ok] = order[:, rank[ok]]
    # pairs in (group, warp-slot, k-tile) order
    sel = nz.transpose(1, 2).gather(1, col.clamp_min(0)[:, :, None].expand(ng, warps * slots, n))
    sel &= (col >= 0)[:, :, None]
    g, q, k = sel.nonzero(as_tuple=True)
    per_slot = sel.sum(2)
    per_group = per_slot.sum(1)
    pairs = max(1, int(per_group.max()))
    ptr = torch.zeros((ng, warps * slots + 1), dtype=torch.int32, device=dev)
    ptr[:, 1:] = per_slot.cumsum(1)
    pos = torch.arange(g.numel(), device=dev) - (per_group.cumsum(0) - per_group)[g]
    i = col[g, q]
    # B-fragment order: [n][t][h] holds tile[t + 4 h, n]
    frag = tiles[g, k, i].reshape(-1, 2, 4, TILE).permute(0, 3, 2, 1).reshape(-1, TILE * TILE)
    val = torch.zeros((ng, pairs, TILE * TILE), dtype=S.dtype, device=dev)
    val[g, pos] = frag
    kt = torch.zeros((ng, pairs), dtype=torch.int16, device=dev)
    kt[g, pos] = k.to(torch.int16)
    it = torch.zeros((ng, pairs), dtype=torch.int16, device=dev)
    it[g, pos] = i.to(torch.int16)
    return TileS(val, kt, it, ptr, col.to(torch.int16))


def tile_matrices(form: TileS) -> torch.Tensor:
    """(ngroups, pairs, 8, 8): each pair's tile as S[8 k + r, 8 i + c] at
    [r, c], from the fragment order (zero past a group's count)."""
    ng, pairs, _ = form.val.shape
    return form.val.reshape(ng, pairs, TILE, 4, 2).permute(0, 1, 4, 3, 2).reshape(
        ng, pairs, TILE, TILE)


def tf32_round(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` rounded to TF32 (10 mantissa bits) to nearest, ties
    away from zero, as ``cvt.rna.tf32.f32`` does."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & -0x2000).view(torch.float32)


def tf32_truncate(x: torch.Tensor) -> torch.Tensor:
    """Float32 ``x`` cut to TF32 toward zero: the 19 bits a TF32 ``mma``
    reads of a float32 register."""
    return (x.contiguous().view(torch.int32) & -0x2000).view(torch.float32)


def tf32_split(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo) TF32 parts of float32 ``x`` as the tensor-core kernel forms
    them: hi = ``tf32_round(x)``, lo = x - hi (exact) as the ``mma`` reads
    it, ``tf32_truncate(x - hi)``; hi + lo holds x to 2^-21 of its
    magnitude."""
    hi = tf32_round(x)
    return hi, tf32_truncate(x - hi)


def tile_dense(form: TileS, pad: int) -> torch.Tensor:
    """(ngroups, pad, pad): the matrices the form holds, each pair's tile
    put back in place (the inverse of ``tile_form``)."""
    ng = form.val.shape[0]
    n = pad // TILE
    out = torch.zeros((ng, n, n, TILE, TILE), dtype=form.val.dtype, device=form.val.device)
    count = form.ptr[:, -1].long()
    live = torch.arange(form.pairs, device=count.device)[None, :] < count[:, None]
    g, j = live.nonzero(as_tuple=True)
    out[g, form.kt[g, j].long(), form.it[g, j].long()] = tile_matrices(form)[g, j]
    return out.permute(0, 1, 3, 2, 4).reshape(ng, pad, pad)


def _tile_apply(form: TileS, pad: int, split: bool = False):
    """``p -> p @ S`` through the form's tiles (gather the k-tile columns of
    each pair, multiply by its tile, add into its i-tile); ``p``'s rows run
    in ``ngroups`` equal runs, one per group.  With ``split`` it is the CPU
    model of the tensor-core kernel's product (float32 only): p and the
    tiles split into TF32 parts (``tf32_split``), p_hi S_hi summed apart
    from p_hi S_lo + p_lo S_hi and the two sums added last, on the dense
    matrices of the form's tiles (their zeros add exact zeros)."""
    ng, pairs, _ = form.val.shape
    if split:
        hi, lo = tf32_split(tile_dense(form, pad))

        def apply_split(p):
            p_hi, p_lo = tf32_split(p.reshape(ng, -1, pad))
            big = torch.bmm(p_hi, hi)
            small = torch.bmm(p_hi, lo) + torch.bmm(p_lo, hi)
            return (big + small).reshape(p.shape)

        return apply_split
    mats = tile_matrices(form)
    kt = form.kt.long()[:, None, :, None]
    it = form.it.long()[:, None, :, None]

    def apply_S(p):
        pg = p.reshape(ng, -1, p.shape[1] // TILE, TILE)
        c = pg.shape[1]
        a = torch.gather(pg, 2, kt.expand(ng, c, pairs, TILE))  # [g, c, pair, k]
        prod = torch.einsum("gcjk,gjki->gcji", a, mats)
        return torch.zeros_like(pg).scatter_add_(2, it.expand(ng, c, pairs, TILE),
                                                 prod).reshape(p.shape)

    return apply_S


def _sparse_apply(form: SparseS):
    """``p -> p @ S`` through the form's CSC arrays (gather, then add into
    each entry's column); ``p``'s rows run in ``ngroups`` equal runs, one per
    group."""
    ng, stride = form.idx.shape
    pad = form.order.shape[1]
    j = torch.arange(stride, device=form.ptr.device).expand(ng, stride).contiguous()
    # the column of each entry; the zero tail adds 0 to the last column
    col = torch.searchsorted(form.ptr[:, 1:].contiguous(), j, right=True).clamp_max(pad - 1)
    idx = form.idx.long()

    def apply_S(p):
        pg = p.reshape(ng, -1, pad)
        c = pg.shape[1]
        prod = torch.gather(pg, 2, idx[:, None, :].expand(ng, c, stride)) * form.val[:, None, :]
        out = torch.zeros_like(pg).scatter_add_(2, col[:, None, :].expand(ng, c, stride), prod)
        return out.reshape(p.shape)

    return apply_S


class ElementFactors(NamedTuple):
    """The subdomain stiffness of ``ngroups`` matrices as the data upstream's
    ``stiffness<NB>`` applies it from, on the host in float64
    (``solvers/ddh.py::_assemble_subdomain_stiffness`` computes them):
    ``S = sum_e P_e^T K_e P_e`` over a group's elements, K_e the element
    stiffness from the derivative matrix D and the element's factors A, B,
    C collocated at its nodes, P_e the slots of its nodes.  Node (iy, ix)
    of an element is index ``nb * iy + ix``."""

    D: np.ndarray  # (nb, nb): D[q, k], basis k's derivative at node q
    factors: np.ndarray  # (ngroups, nel, 3, nb * nb): A, B, C at each node
    slots: np.ndarray  # (ngroups, nel, nb * nb) slot of each node; -1: a padding element

    def take(self, index) -> "ElementFactors":
        """The factors of the groups ``index`` (as ``S[index]``)."""
        index = np.asarray(index.cpu() if isinstance(index, torch.Tensor) else index)
        return ElementFactors(self.D, self.factors[index], self.slots[index])

    @property
    def rectangles(self) -> bool:
        """B vanishes in every element, to FACTORED_B_ROUNDOFF of the
        largest |A|, |C|: the elements are axis-aligned rectangles."""
        scale = max(float(np.abs(self.factors[:, :, 0::2]).max(initial=0.0)), 1e-300)
        return float(np.abs(self.factors[:, :, 1]).max(initial=0.0)) <= FACTORED_B_ROUNDOFF * scale


class FactoredS(NamedTuple):
    """The stiffness as what it is summed from, for ``ngroups`` matrices:
    the derivative matrix, each element's factors and its nodes' positions
    (for any element, the CPU's plain apply), and, on rectangles (B = 0,
    held as 0), the form the factored kernel reads: each grid line of a
    subdomain as ``L`` segments of nb nodes with the symmetric matrix of
    each, the sum over the elements that hold the segment of their line
    matrices ``D^T diag(A[l, :]) D`` (rows, x lines first: ``nlx`` of them)
    or ``D^T diag(C[:, k]) D`` (columns).  Every real node lies on one x
    line and one y line.  A kernel row holds ``rs`` >= pad positions;
    ``order`` maps each to its slot.  A line shorter than L ends in
    segments of zeros whose nodes sit at a position no slot holds.
    """

    D: torch.Tensor  # (nb, nb) D[q, k], S's dtype
    factors: torch.Tensor  # (ngroups, nel, 3, nb * nb) A, B, C at node (iy, ix), S's dtype
    slots: torch.Tensor  # (ngroups, nel, nb * nb) int16 position of each element node, -1 padding
    order: torch.Tensor  # (ngroups, rs) int16 slot at each position, -1 none
    lines: torch.Tensor  # (ngroups, nlines, 3 L + 1) int16 position of each line node
    mats: torch.Tensor  # (ngroups, nlines, L, 10) segment matrices, upper triangle by rows
    nlx: int  # the lines along x (the first ones)

    @property
    def shape(self) -> tuple[int, int, int]:
        """(nlines, rs, L), the shape ``kernel_variant`` reads."""
        return self.lines.shape[1], self.order.shape[1], self.mats.shape[2]

    def take(self, index: torch.Tensor) -> "FactoredS":
        """The form of the groups ``index`` (as ``S[index]``)."""
        return FactoredS(self.D, *(t[index].contiguous() for t in self[1:6]), self.nlx)


def factored_row_stride(pad: int, rows: int) -> int:
    """Positions of a factored-kernel row: the least rs >= pad whose
    ``rows`` rows span a multiple of 16 floats, so that the planes and
    vectors of a block start in bank 0 and a line writes its plane in the
    banks it reads its row from."""
    unit = 16 // np.gcd(16, rows)
    return -(-pad // unit) * unit


def _place_slots(nodes: np.ndarray, pad: int, rs: int, rows: int) -> np.ndarray:
    """The position of each of ``pad`` slots in a row of ``rs`` positions
    for phase-1 items reading the slots ``nodes`` (nitems, nn) (-1: none)
    of each row: item i is line i % nitems of block row (i / nitems) %
    rows in vector i / (nitems rows), 32 to a warp.  Greedy, slot by slot
    in falling count of items: the bank (position mod 32) in which the
    lanes that read the slot find fewest slots of the same node index
    already; within a bank in that order.  Slots no item reads take the
    positions left."""
    nl, nn = nodes.shape
    items = np.arange(2 * rows * nl)
    line = items % nl
    off = (((items // (nl * rows)) * rows + (items // nl) % rows) * rs) % 32
    warp = items // 32
    node_of = np.full((pad, nl), -1)
    ll, jj = np.nonzero(nodes >= 0)
    node_of[nodes[ll, jj], ll] = jj
    inc = np.bincount(nodes[nodes >= 0], minlength=pad)
    order = np.argsort(-inc, kind="stable")
    order = order[inc[order] > 0]
    counts = np.zeros((warp[-1] + 1, nn, 32), np.int64)
    cap = np.array([len(range(b, rs, 32)) for b in range(32)])
    banks = np.arange(32)
    pos = np.full(pad, -1)
    for s in order:
        n = node_of[s, line]
        lane = n >= 0
        w, nd, o = warp[lane], n[lane], off[lane]
        cost = counts[w[:, None], nd[:, None], (banks[None, :] + o[:, None]) % 32].sum(0)
        cost[cap == 0] = np.iinfo(np.int64).max
        b = int(np.argmin(cost))
        pos[s] = b + 32 * (len(range(b, rs, 32)) - cap[b])
        cap[b] -= 1
        np.add.at(counts, (w, nd, (b + o) % 32), 1)
    rest = np.nonzero(pos < 0)[0]
    pos[rest] = np.setdiff1d(np.arange(rs), pos[pos >= 0])[:len(rest)]
    return pos


def _grid_lines(D: np.ndarray, factors: np.ndarray, slots: np.ndarray):
    """One group's grid lines on rectangles: (x lines, y lines), each a list
    of chains [(nodes (nb,), matrix (nb, nb)), ...] whose consecutive
    segments share a node.  Element rows (x) and columns (y) on the same
    nodes are one segment whose matrix is the sum of theirs; segments are
    linked at shared end nodes.  Raises where the segments do not form
    lines (a node shared by more than two segments of a direction, or a
    closed loop)."""
    nb = D.shape[0]
    live = slots[:, 0] >= 0
    A = factors[live, 0].reshape(-1, nb, nb)
    C = factors[live, 2].reshape(-1, nb, nb)
    sl = slots[live].reshape(-1, nb, nb)  # [e, iy, ix]
    kx = np.einsum("qa,elq,qb->elab", D, A, D)  # row l of each element
    ky = np.einsum("qa,eqk,qb->ekab", D, C, D)  # column k
    out = []
    for nodes_of, mats in ((sl, kx), (sl.transpose(0, 2, 1), ky)):
        segs = {}
        for e in range(sl.shape[0]):
            for i in range(nb):
                key, mat = tuple(nodes_of[e, i]), mats[e, i]
                if key[::-1] in segs:
                    key, mat = key[::-1], mat[::-1, ::-1]
                segs[key] = segs.get(key, 0) + mat
        ends = {}
        for key in segs:
            for end in (key[0], key[-1]):
                ends.setdefault(end, []).append(key)
        if any(len(v) > 2 for v in ends.values()):
            raise ValueError("wave_cycle: the elements' segments do not form grid lines")
        chains, seen = [], set()
        for start in sorted(n for n, v in ends.items() if len(v) == 1):
            node, chain = start, []
            while True:
                nxt = [k for k in ends[node] if k not in seen]
                if not nxt:
                    break
                key = nxt[0]
                seen.add(key)
                mat = segs[key]
                if key[0] != node:
                    key, mat = key[::-1], mat[::-1, ::-1]
                chain.append((np.asarray(key), mat))
                node = key[-1]
            if chain:
                chains.append(chain)
        if len(seen) != len(segs):
            raise ValueError("wave_cycle: the elements' segments close a loop")
        out.append(chains)
    return out


def factored_form(factors: ElementFactors, pad: int, dtype: torch.dtype = torch.float32,
                  device=None) -> FactoredS:
    """The ``FactoredS`` of ``factors`` for rows of ``pad`` slots, in
    ``dtype`` on ``device``.  On rectangles (``ElementFactors.rectangles``)
    B is set to 0 and each group's grid lines are built (``_grid_lines``),
    padded to the longest with segments of zeros, and the slots placed in
    a row of ``factored_row_stride`` positions by ``_place_slots``; else
    the form holds no line (``nlines`` 0) and only the plain apply reads
    it."""
    ng, nel, nb2 = factors.slots.shape
    nb = factors.D.shape[0]
    live = factors.slots[:, :, 0] >= 0
    fac = factors.factors.copy()
    rect = factors.rectangles
    groups = [_grid_lines(factors.D, fac[g], factors.slots[g]) for g in range(ng)] if rect else []
    if rect:
        fac[:, :, 1] = 0.0
        nlx = max(len(x) for x, _ in groups)
        nlines = max(len(x) + len(y) for x, y in groups)
        L = max(len(c) for x, y in groups for c in x + y)
        L = next((k for k in FACTORED_SEGMENTS if k >= L), L)
    else:
        nlx, nlines, L = 0, 0, 1
    short = rect and any(len(c) < L for x, y in groups for c in x + y) or any(
        len(x) < nlx or len(x) + len(y) < nlines for x, y in groups)
    rows = factored_rows(nlines, pad + 1, L) or 1
    rs = factored_row_stride(pad + short, rows) if rect else pad
    nodes = np.full((ng, nlines, 3 * L + 1), -1, np.int64)
    mats = np.zeros((ng, nlines, L, 10))
    iu = np.triu_indices(nb)
    for g, (xs, ys) in enumerate(groups):
        for i, chain in enumerate(xs + [None] * (nlx - len(xs)) + ys):
            for s, (seg, mat) in enumerate(chain or []):
                nodes[g, i, 3 * s:3 * s + nb] = seg
                mats[g, i, s] = mat[iu]
    pos = np.zeros((ng, rs), np.int64)
    order = np.full((ng, rs), -1, np.int64)
    for g in range(ng):
        where = (_place_slots(nodes[g], pad, rs, rows) if rect
                 else np.arange(pad))
        order[g, where] = np.arange(pad)
        pos[g, :pad] = where
    free = np.argmax(order < 0, axis=1)  # a position no slot holds, where one is needed
    at = np.where(nodes >= 0, np.take_along_axis(pos, np.maximum(nodes, 0).reshape(ng, -1), 1)
                  .reshape(nodes.shape), free[:, None, None])
    el = np.take_along_axis(pos, np.maximum(factors.slots, 0).reshape(ng, -1), 1)
    el = np.where(live[:, :, None], el.reshape(ng, nel, nb2), -1)

    def dev(a, t):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=t, device=device)

    return FactoredS(dev(factors.D, dtype), dev(fac, dtype), dev(el, torch.int16),
                     dev(order, torch.int16), dev(at, torch.int16), dev(mats, dtype), nlx)


def _element_matrices(form: FactoredS) -> torch.Tensor:
    """(ngroups, nel, nb2, nb2): each element's stiffness K[i, j] (output
    node i, input node j; node (iy, ix) is nb iy + ix) from D and its
    factors by the general sum factorisation ``D^T (A ux + B uy)`` along
    rows plus ``D^T (B ux + C uy)`` along columns, applied to each unit
    vector."""
    ng, nel, nb2 = form.slots.shape
    nb = form.D.shape[0]
    D = form.D
    A, B, C = (form.factors[:, :, i].reshape(ng, nel, 1, nb, nb) for i in range(3))
    X = torch.eye(nb2, dtype=D.dtype, device=D.device).reshape(nb2, nb, nb)  # unit vector j
    ux = torch.einsum("qk,jlk->jlq", D, X)  # d/dxi at node (l, q)
    uy = torch.einsum("ql,jlk->jqk", D, X)  # d/deta at node (q, k)
    wx = A * ux + B * uy
    wy = B * ux + C * uy
    out = torch.einsum("qk,gejlq->gejlk", D, wx) + torch.einsum("ql,gejqk->gejlk", D, wy)
    return out.reshape(ng, nel, nb2, nb2).transpose(2, 3)


def _factored_apply(form: FactoredS, pad: int):
    """``p -> p @ S`` through the form: on rectangles as the factored kernel
    computes it, each grid line's product (its segments' matrices added
    into one) added into its nodes' slots, x lines first, so a slot sums
    its x product and then its y product; else each element's stiffness
    (``_element_matrices``) added into its nodes' slots, element by
    element.  ``p``'s rows run in ``ngroups`` equal runs, one per group."""
    ng, nel, nb2 = form.slots.shape
    nlines, _, L = form.shape
    nb = form.D.shape[0]
    order = form.order.long()
    trash = pad  # the row that takes a padded node's product
    if nlines:
        # each line's (3L + 1)-square matrix: its segments' added in order
        iu = torch.triu_indices(nb, nb)
        seg = torch.zeros((ng, nlines, L, nb, nb), dtype=form.mats.dtype,
                          device=form.mats.device)
        seg[..., iu[0], iu[1]] = form.mats
        seg[..., iu[1], iu[0]] = form.mats
        K = torch.zeros((ng, nlines, 3 * L + 1, 3 * L + 1), dtype=seg.dtype, device=seg.device)
        for s in range(L):
            K[:, :, 3 * s:3 * s + nb, 3 * s:3 * s + nb] += seg[:, :, s]
        src = order.gather(1, form.lines.long().reshape(ng, -1)).reshape(form.lines.shape)
        nodes = torch.where(src >= 0, src, trash)
    else:
        K = _element_matrices(form)
        at = form.slots.long()
        src = order.gather(1, at.clamp_min(0).reshape(ng, -1)).reshape(ng, nel, nb2)
        nodes = torch.where((at >= 0) & (src >= 0), src, trash)

    def apply_S(p):
        pg = p.reshape(ng, -1, pad)
        c = pg.shape[1]
        out = []
        for h in range(ng):
            pt = torch.cat([pg[h].t(), torch.zeros((1, c), dtype=p.dtype, device=p.device)])
            x = pt.index_select(0, nodes[h].reshape(-1)).reshape(*nodes[h].shape, c)
            # x lines come first: a slot's x product, then its y product
            y = torch.bmm(K[h], x).reshape(-1, c)
            z = torch.zeros((pad + 1, c), dtype=p.dtype, device=p.device)
            z = z.index_add_(0, nodes[h].reshape(-1), y)[:pad]
            out.append(z.t())
        return out[0] if ng == 1 else torch.stack(out).reshape(p.shape)

    return apply_S


def wave_cycle_plain(
    params, F: torch.Tensor, G: torch.Tensor, wh_maxit: int = WH_MAXIT,
    s_group_size: int | None = None, sparse: SparseS | None = None,
    tiles: TileS | None = None, split: bool = False, factored: FactoredS | None = None,
):
    """Plain PyTorch WaveHoltz cycle (the JAX package's ``_wave_cycle_xla``).

    ``params`` provides ``S``, ``Ha``, ``inv_mi``, ``tables`` (nt, 5) and the
    float scalars ``dt`` and ``K0``.  ``S`` is (pad, pad) shared, or a 3-D
    stack: with ``s_group_size`` rows run in groups of that many against one
    matrix each, without it every row has its own.  With ``sparse`` (the
    ``sparse_form`` of S) S is applied through that form's CSC arrays, with
    ``tiles`` (its ``tile_form``) through its non-zero 8 x 8 tiles, with
    ``factored`` (a ``factored_form`` of S's element factors) element by
    element as the factored kernel applies it, in place of the dense
    product.  ``split`` (with ``tiles``, float32 only) applies
    the CPU model of the tensor-core kernel's 3-pass TF32 split
    (``_tile_apply``), for the tests; no solver path passes it.  Returns
    the filtered (u, v), each shaped like ``F``.
    """
    S, Ha, mi = params.S, params.Ha, params.inv_mi
    dt = params.dt
    half_dt = 0.5 * dt
    rows = params.tables.tolist()  # fp32 values, exact as Python floats

    if S.dim() == 3 and s_group_size is not None:
        _check_groups(S.shape[0], s_group_size, F.shape[0])
    ngroups = 1 if S.dim() == 2 else S.shape[0]
    if split and tiles is None:
        raise ValueError("wave_cycle: the split model runs through a tile form (tiles=)")
    if factored is not None:
        if factored.slots.shape[0] != ngroups:
            raise ValueError(
                f"wave_cycle: factored form of {factored.slots.shape[0]} groups for S "
                f"{tuple(S.shape)}"
            )
        apply_S = _factored_apply(factored, S.shape[-1])
    elif tiles is not None:
        if tiles.ptr.shape[0] != ngroups:
            raise ValueError(
                f"wave_cycle: tile form of {tiles.ptr.shape[0]} groups for S {tuple(S.shape)}"
            )
        apply_S = _tile_apply(tiles, S.shape[-1], split)
    elif sparse is not None:
        if sparse.ptr.shape[0] != ngroups:
            raise ValueError(
                f"wave_cycle: sparse form of {sparse.ptr.shape[0]} groups for S {tuple(S.shape)}"
            )
        apply_S = _sparse_apply(sparse)
    elif S.dim() == 2:
        def apply_S(p):
            return p @ S
    elif s_group_size is not None:
        def apply_S(p):
            pg = p.reshape(S.shape[0], s_group_size, p.shape[1])
            return torch.einsum("gck,gki->gci", pg, S).reshape(p.shape)
    else:
        def apply_S(p):
            return torch.einsum("dk,dki->di", p, S)

    u = torch.zeros_like(F)
    v = torch.zeros_like(F)
    for _ in range(wh_maxit):
        p, q = u, v
        u, v = params.K0 * u, params.K0 * v
        for cs0, sn0, cs1, sn1, kt in rows:
            dq = torch.addcmul(apply_S(p), Ha, q, value=-1.0)
            dq = dq.add_(F, alpha=cs0).add_(G, alpha=sn0).mul_(mi)
            p_half = p.add(q, alpha=-half_dt)
            q_half = q.add(dq, alpha=half_dt)
            p = p.add(q_half, alpha=-dt)
            dq2 = torch.addcmul(apply_S(p_half), Ha, q_half, value=-1.0)
            dq2 = dq2.add_(F, alpha=cs1).add_(G, alpha=sn1).mul_(mi)
            q = q.add(dq2, alpha=dt)
            u = u.add(p, alpha=kt)
            v = v.add(q, alpha=kt)
    return u, v


def _check_groups(ngroups: int, s_group_size: int, ndom: int) -> None:
    if s_group_size < 1 or ngroups * s_group_size != ndom:
        raise ValueError(
            f"wave_cycle: {ngroups} stiffness groups x s_group_size={s_group_size} "
            f"!= {ndom} rows"
        )


def _find_nvcc() -> str:
    for home in (os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")):
        if home and (Path(home) / "bin" / "nvcc").is_file():
            return str(Path(home) / "bin" / "nvcc")
    found = shutil.which("nvcc") or (
        "/usr/local/cuda/bin/nvcc" if Path("/usr/local/cuda/bin/nvcc").is_file() else None
    )
    if found is None:
        raise RuntimeError("wave_cycle: nvcc not found (set CUDA_HOME) to build the kernel")
    return found


def build() -> dict[str, Path]:
    """Compile every kernel source into ``_build/`` unless a library built
    from the same source and flags is already there; returns the library
    path of each variant.  One ``nvcc`` per source, all started together.
    The compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    each library in a ``.log`` file."""
    outs, running = {}, []
    for variant, src in SOURCES.items():
        tag = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
        out = BUILD_DIR / f"lib{src.stem}_{tag}.so"
        outs[variant] = out
        if out.exists():
            continue
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"lib{src.stem}_{tag}.{os.getpid()}.tmp"
        proc = subprocess.Popen(
            [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
        )
        running.append((src, proc, tmp, out))
    failed = []
    for src, proc, tmp, out in running:
        try:
            stdout, stderr = proc.communicate(timeout=600)
        except subprocess.TimeoutExpired:
            proc.kill()
            stdout, stderr = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"{src.name} ({proc.returncode}):\n{stderr}")
            continue
        out.with_suffix(".log").write_text(stdout + stderr)
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("wave_cycle: nvcc failed for " + "\n".join(failed))
    return outs


@functools.cache
def _library(variant: str) -> ctypes.CDLL:
    """Load one variant's library and check its constants against the
    wrapper's."""
    lib = ctypes.CDLL(str(build()[variant]))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    def fn(name, argtypes, restype):
        f = getattr(lib, _ENTRY[variant] + name)
        f.argtypes, f.restype = argtypes, restype
        return f

    fn("error_string", [i32], ctypes.c_char_p)
    if variant == "factored":
        fn("launch", [ptr] * 3 + [i32] * 4 + [ptr] * 7 + [i32] * 5 + [f32, f32, i32, ptr], i32)
        fn("blocks_per_sm", [i32] * 4, i32)
        fn("registers", [i32] * 3, i32)
        smem = fn("shared_memory_bytes", [i32] * 2, ctypes.c_longlong)
        rows, pairs = fn("rows_per_block", [i32] * 3, i32), fn("pairs", [i32], i32)
        same = (fn("threads", [], i32)() == FACTORED_THREADS
                and smem(2, 176) == factored_shared_memory_bytes(2, 176)
                and all(pairs(L) == factored_pairs(L) for L in FACTORED_SEGMENTS)
                and all(rows(n, rs, L) == factored_rows(n, rs, L) for n in (1, 9, 26, 50, 65)
                        for rs in (176, 320, 640, 1600) for L in (3, 4, 8)))
        if not same:
            raise RuntimeError("wave_cycle: factored library constants disagree with the wrapper")
        return lib
    rows = fn("rows_per_block", [], i32)()
    if variant == "mma":
        fn("launch", [ptr] * 4 + [i32] + [ptr] * 7 + [i32] * 5 + [f32, f32, i32, ptr], i32)
        fn("blocks_per_sm", [i32] * 3 + [ptr], i32)
        smem = fn("shared_memory_bytes", [i32] * 2, ctypes.c_longlong)
        slots, warps = fn("slots", [i32], i32), fn("warps", [i32], i32)
        same = (fn("max_pad", [], i32)() == MMA_MAX_PAD and rows == MMA_ROWS_PER_BLOCK
                and smem(320, 489) == mma_shared_memory_bytes(320, 489)
                and all((slots(pad), warps(pad)) == mma_layout(pad)
                        for pad in range(TILE, MMA_MAX_PAD + 1, TILE)))
    elif variant == "sparse":
        fn("launch", [ptr] * 4 + [i32] + [ptr] * 7 + [i32] * 5 + [f32, f32, i32, ptr], i32)
        fn("registers", [i32, i32], i32)
        fn("per_row_launch", [ptr] * 4 + [i32] + [ptr] * 7 + [i32] * 4 + [f32, f32, i32, ptr],
           i32)
        fn("blocks_per_sm", [i32] * 4, i32)
        smem = fn("shared_memory_bytes", [i32] * 3, ctypes.c_longlong)
        same = (fn("max_pad", [], i32)() == SPARSE_MAX_PAD and rows == SPARSE_ROWS_PER_BLOCK
                and all(smem(r, 632, 10336) == sparse_shared_memory_bytes(632, 10336, r)
                        for r in (1, SPARSE_ROWS_PER_BLOCK)))
    else:
        fn("launch", [ptr] * 8 + [i32] * 5 + [f32, f32, i32, ptr], i32)
        smem = fn("shared_memory_bytes", [i32], ctypes.c_longlong)
        if variant == "resident":
            fn("max_shared_memory", [i32], i32)
            same = (fn("max_threads", [], i32)() == MAX_THREADS
                    and smem(176) == shared_memory_bytes(176))
        else:
            same = (fn("max_pad", [], i32)() == STREAMED_MAX_PAD
                    and smem(632) == streamed_shared_memory_bytes(632))
        same = same and rows == ROWS_PER_BLOCK
    if not same:
        raise RuntimeError(f"wave_cycle: {variant} library constants disagree with the wrapper")
    return lib


def _check_operands(params, F: torch.Tensor, G: torch.Tensor) -> None:
    ndom, pad = F.shape
    nt = params.tables.shape[0]
    expect = {
        "S": (params.S, (pad, pad) if params.S.dim() == 2 else (params.S.shape[0], pad, pad)),
        "F": (F, (ndom, pad)),
        "G": (G, (ndom, pad)),
        "Ha": (params.Ha, (ndom, pad)),
        "inv_mi": (params.inv_mi, (ndom, pad)),
        "tables": (params.tables, (nt, 5)),
    }
    for name, (t, shape) in expect.items():
        if t.device != F.device or t.dtype != torch.float32 or not t.is_contiguous():
            raise ValueError(
                f"wave_cycle: {name} must be a contiguous float32 tensor on {F.device}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(f"wave_cycle: {name} has shape {tuple(t.shape)}, expected {shape}")
        # the dense kernels read S, the streamed one every (rows, pad) operand, as float4
        if name != "tables" and t.data_ptr() % 16:
            raise ValueError(f"wave_cycle: {name} must be 16-byte aligned")
    if pad % 8:
        raise ValueError(f"wave_cycle: pad={pad} must be a multiple of 8")


def _check_form(form: SparseS | TileS | FactoredS, ngroups: int, pad: int,
                device: torch.device) -> None:
    """The arrays of a sparse, tile or factored form as its kernel reads them."""
    if isinstance(form, FactoredS):
        kind, (nlines, rs, L) = "factored", form.shape
        expect = {
            "order": (form.order, torch.int16, (ngroups, rs)),
            "lines": (form.lines, torch.int16, (ngroups, nlines, 3 * L + 1)),
            "mats": (form.mats, torch.float32, (ngroups, nlines, L, 10)),
        }
    elif isinstance(form, TileS):
        kind, (slots, warps), pairs = "tile", mma_layout(pad), form.pairs
        expect = {
            "val": (form.val, torch.float32, (ngroups, pairs, TILE * TILE)),
            "kt": (form.kt, torch.int16, (ngroups, pairs)),
            "it": (form.it, torch.int16, (ngroups, pairs)),
            "ptr": (form.ptr, torch.int32, (ngroups, warps * slots + 1)),
            "col": (form.col, torch.int16, (ngroups, warps * slots)),
        }
    else:
        kind, stride = "sparse", form.stride
        expect = {
            "ptr": (form.ptr, torch.int32, (ngroups, pad + 1)),
            "idx": (form.idx, torch.int16, (ngroups, stride)),
            "val": (form.val, torch.float32, (ngroups, stride)),
            "order": (form.order, torch.int16, (ngroups, pad)),
        }
    for name, (t, dtype, shape) in expect.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"wave_cycle: {kind} {name} must be a contiguous {dtype} tensor on {device}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(
                f"wave_cycle: {kind} {name} has shape {tuple(t.shape)}, expected {shape}"
            )


class K1(NamedTuple):
    """A K1 kernel and the form of S it reads: ``variant`` (one of
    ``VARIANTS``) and ``form``, the ``FactoredS`` of the factored kernel,
    the ``TileS`` of the tensor-core kernel, the ``SparseS`` of the sparse
    one, or None for a dense kernel, which reads S itself.  ``k1_kernel``
    builds it; ``wave_cycle(kernel=)`` runs it as it is."""

    variant: str
    form: FactoredS | TileS | SparseS | None

    def take(self, index: torch.Tensor) -> "K1":
        """This kernel on the groups ``index`` of its S (as ``S[index]``)."""
        return self if self.form is None else K1(self.variant, self.form.take(index))

    def repeat(self, reps: int) -> "K1":
        """This per-row kernel on a layout-(c) cycle of ``reps`` sources:
        its groups repeated ``reps`` times, source-major, as
        ``solvers/ddh.py::_rows`` repeats S."""
        if reps == 1 or self.form is None:
            return self
        groups = self.form.ptr.shape[0]
        return self.take(torch.arange(groups, device=self.form.ptr.device).repeat(reps))


def k1_kernel(S: torch.Tensor, index: torch.Tensor | None = None, per_row: bool = False, *,
              variant: str | None = None, factors: ElementFactors | None = None) -> K1:
    """The kernel that runs cycles on ``S`` ((pad, pad), or (ngroups, pad,
    pad) of which the cycles read the groups ``index``, None: all) on S's
    card, with the form of those groups it reads, built here and only for
    that kernel.  ``per_row``: a layout-(c) stack.  ``factors``: S's
    ``ElementFactors`` (the same groups as S), where the caller has them.

    The rule of ``kernel_variant``, applied once on S's pad, element
    factors, tiles (``tile_pairs``) and non-zeros and the card's shared
    memory per block: the factored kernel where it is given factors of
    degree-3 rectangles and its form fits, else the tensor-core kernel
    where ``mma_preferred`` holds and its form fits, else the sparse
    kernel where its form fits, else the resident one, else the streamed
    one.  ``variant`` forces a kernel instead, to
    hold the kernels against each other; it raises where that kernel does
    not take S (the factored one without ``factors``)."""
    if index is not None:
        S = S[index]
        factors = None if factors is None else factors.take(index)
    pad = S.shape[-1]
    limit = _shared_memory_limit(S.device.index)
    if variant == "factored" and factors is None:
        raise ValueError("wave_cycle: the factored kernel needs S's element factors (factors=)")
    if (factors is not None and not per_row and variant in (None, "factored")
            and factors.D.shape[0] == FACTORED_NB and factors.rectangles):
        form = factored_form(factors, pad, S.dtype, S.device)
        if kernel_variant(pad, limit, None, variant, per_row, factored=form.shape) == "factored":
            return K1("factored", form)
    if variant == "factored":
        kernel_variant(pad, limit, None, variant, per_row)  # raises: no form it takes
    if not per_row and pad % TILE == 0 and (
            variant == "mma" or variant is None and pad <= MMA_PREFERRED_MAX_PAD):
        if kernel_variant(pad, limit, None, variant, per_row, tile_pairs(S)) == "mma":
            return K1("mma", tile_form(S))
    form = sparse_form(S) if variant in (None, "sparse") and pad <= SPARSE_MAX_PAD else None
    chosen = kernel_variant(pad, limit, None if form is None else form.stride, variant, per_row)
    return K1(chosen, form if chosen == "sparse" else None)


def wave_cycle(
    params, F: torch.Tensor, G: torch.Tensor, wh_maxit: int = WH_MAXIT,
    s_group_size: int | None = None, *, kernel: K1 | None = None,
):
    """Run the WaveHoltz cycle; returns (u, v) shaped like ``F``.

    On the CPU this is ``wave_cycle_plain`` with the dense S; ``kernel`` is
    not read.  On a CUDA device it is one launch of ``kernel``, a ``K1``
    from ``k1_kernel`` for S (the caller's, built once and reused), or by
    default ``k1_kernel(params.S)`` here; nothing here decides again.  A
    3-D ``S`` with ``s_group_size`` is layout (b): the runs must be a
    multiple of ``ROWS_PER_BLOCK`` rows.  A 3-D ``S`` without it holds one
    matrix per row (layout (c)): the sparse kernel runs it in its per-row
    instance, each row once; a dense kernel takes each row
    ``ROWS_PER_BLOCK`` times in layout (b) and the result is read back once
    (``cycle_route``).  Launches are counted in ``k1.launches.<key>`` under
    the route's key (``ROUTE_KEYS``): ``"shared"`` (a), ``"grouped"`` (b,
    and (c) on a dense kernel) with a ``"factored_"``, ``"mma_"``,
    ``"sparse_"`` or ``"streamed_"`` prefix for those kernels, and ``"sparse_per_row"`` (c);
    ``k1.rows`` and ``k1.flop`` count the rows the kernel or the plain
    cycle runs (``_count_work``; a dense kernel's (c) counts its tiled
    rows).  Anything else raises; nothing falls back.
    """
    if F.device.type == "cpu":
        _count_work(params, F.shape[0], wh_maxit)
        return wave_cycle_plain(params, F, G, wh_maxit, s_group_size)
    if F.device.type != "cuda":
        raise ValueError(f"wave_cycle: unsupported device {F.device}")
    S = params.S
    ngroups = None if S.dim() == 2 else S.shape[0]
    _check_operands(params, F, G)
    ndom, pad = F.shape
    if kernel is None:
        kernel = k1_kernel(S, per_row=ngroups is not None and s_group_size is None)
    variant, form = kernel
    if form is not None:
        _check_form(form, ngroups or 1, pad, F.device)
    route = cycle_route(variant, ndom, ngroups, s_group_size)
    if route.tile > 1:
        r = route.tile
        tiled = params._replace(
            Ha=params.Ha.repeat_interleave(r, dim=0),
            inv_mi=params.inv_mi.repeat_interleave(r, dim=0),
        )
        u, v = wave_cycle(tiled, F.repeat_interleave(r, dim=0), G.repeat_interleave(r, dim=0),
                          wh_maxit, route.s_group_size, kernel=kernel)
        return u[::r], v[::r]
    _count_work(params, ndom, wh_maxit)
    lib = _library(variant)
    u = torch.empty_like(F)
    v = torch.empty_like(F)
    rest = (
        F.data_ptr(), G.data_ptr(), params.Ha.data_ptr(), params.inv_mi.data_ptr(),
        params.tables.data_ptr(), u.data_ptr(), v.data_ptr(),
        ndom, pad, params.tables.shape[0], wh_maxit,
    )
    tail = (params.dt, params.K0, F.device.index, torch.cuda.current_stream(F.device).cuda_stream)
    if variant == "factored":
        nlines, rs, L = form.shape
        head = (form.mats.data_ptr(), form.lines.data_ptr(), form.order.data_ptr(), nlines,
                form.nlx, L, rs)
    elif variant == "mma":
        head = (form.val.data_ptr(), form.kt.data_ptr(), form.ptr.data_ptr(),
                form.col.data_ptr(), form.pairs)
    elif variant == "sparse":
        head = (form.ptr.data_ptr(), form.idx.data_ptr(), form.val.data_ptr(),
                form.order.data_ptr(), form.stride)
    else:
        head = (S.data_ptr(),)
    if route.key == "sparse_per_row":
        err = lib.wave_cycle_sparse_per_row_launch(*head, *rest, *tail)
    else:
        err = getattr(lib, _ENTRY[variant] + "launch")(*head, *rest, route.s_group_size, *tail)
    if err:
        msg = getattr(lib, _ENTRY[variant] + "error_string")(err).decode()
        raise RuntimeError(f"wave_cycle: {variant} kernel launch failed: {msg}")
    count(LAUNCHES + route.key)
    return u, v


# nnz of each stiffness tensor a cycle has run on, read from the device once
_NNZ = WeakIdKeyDictionary()


def _count_work(params, rows: int, wh_maxit: int) -> None:
    """Count a cycle of ``rows`` rows in ``k1.rows`` and its useful work in
    ``k1.flop``: 2 * 2 * wh_maxit * nt FLOP per non-zero of each row's S
    (two stiffness products a leapfrog step, a multiply and an add each).
    The rows run in equal runs, one per matrix of S, so that sum is the
    rows per matrix times the non-zeros of all of S, read once per S tensor
    (a per-row S that ``solvers/ddh.py::_rows`` repeats for K > 1 sources is
    a new tensor, and read, at each cycle).  S is not changed in place."""
    S = params.S
    nnz = _NNZ.get(S)
    if nnz is None:
        nnz = _NNZ[S] = int(torch.count_nonzero(S))
    groups = 1 if S.dim() == 2 else S.shape[0]
    count("k1.rows", rows)
    count("k1.flop", 4 * wh_maxit * params.tables.shape[0] * (rows // groups) * nnz)


def _shared_memory_limit(dev: int) -> int:
    """Bytes of shared memory a block may use on cuda:``dev``."""
    limit = _library("resident").wave_cycle_max_shared_memory(dev)
    if limit < 0:
        raise RuntimeError(f"wave_cycle: cannot read the shared-memory limit of cuda:{dev}")
    return limit


def launch_counts() -> dict:
    """The kernel launches by route key (every key of ``ROUTE_KEYS``): the
    totals of the ``k1.launches.`` counters (``utils/spans.py``; its
    ``reset(LAUNCHES)`` sets them to 0)."""
    launched = totals(LAUNCHES)
    return {key: launched.get(key, 0) for key in ROUTE_KEYS}


def sparse_blocks_per_sm(pad: int, stride: int, per_row: bool, device: torch.device) -> int:
    """Blocks of the sparse kernel (its per-row instance with ``per_row``)
    that fit on one SM of the CUDA ``device`` at this pad and stride."""
    rows = 1 if per_row else SPARSE_ROWS_PER_BLOCK
    blocks = _library("sparse").wave_cycle_sparse_blocks_per_sm(rows, pad, stride, device.index)
    if blocks < 0:
        raise RuntimeError(f"wave_cycle: cannot read the sparse kernel's occupancy on {device}")
    return blocks


def kernel_occupancy(variant: str, pad: int, form, device: torch.device,
                     per_row: bool = False) -> dict:
    """Registers a thread, warps, rows and dynamic shared memory a block and
    blocks per SM of the ``"factored"`` kernel for the factored form
    ``form``, of the ``"mma"`` kernel for the tile form ``form`` or of the
    ``"sparse"`` one for the sparse form ``form`` (``per_row``: its per-row
    instance) at ``pad`` on the CUDA ``device``."""
    if variant == "factored":
        lib = _library("factored")
        nlines, rs, L = form.shape
        rows = factored_rows(nlines, rs, L)
        blocks = lib.wave_cycle_factored_blocks_per_sm(nlines, rs, L, device.index)
        out = {"registers": lib.wave_cycle_factored_registers(rows, L, device.index),
               "warps": FACTORED_THREADS // 32, "rows": rows,
               "shared_memory_bytes": factored_shared_memory_bytes(rows, rs)}
    elif variant == "mma":
        regs = ctypes.c_int(0)
        blocks = _library("mma").wave_cycle_mma_blocks_per_sm(pad, form.pairs, device.index,
                                                               ctypes.byref(regs))
        out = {"registers": regs.value, "warps": mma_layout(pad)[1],
               "shared_memory_bytes": mma_shared_memory_bytes(pad, form.pairs)}
    else:
        rows = 1 if per_row else SPARSE_ROWS_PER_BLOCK
        blocks = sparse_blocks_per_sm(pad, form.stride, per_row, device)
        out = {"registers": _library("sparse").wave_cycle_sparse_registers(rows, device.index),
               "warps": (pad + 31) // 32,
               "shared_memory_bytes": sparse_shared_memory_bytes(pad, form.stride, rows)}
    if blocks < 0 or out["registers"] <= 0:
        raise RuntimeError(f"wave_cycle: cannot read the {variant} kernel's occupancy on {device}")
    return {**out, "blocks_per_sm": blocks}

