"""The DDH WaveHoltz cycle: Hopper kernel wrappers and their plain PyTorch version.

Counterpart of ``cuddhelmholtz_tpu/ops/pallas/wave_cycle.py``.  ``wave_cycle``
runs ``wh_maxit`` WaveHoltz iterations of ``nt`` staggered-leapfrog steps on
every subdomain row with one launch of a hand-written CUDA kernel, in the
Pallas kernel's three stiffness layouts:

  (a) one shared (pad, pad) S;
  (b) an (ngroups, pad, pad) stack with rows in runs of ``s_group_size``;
  (c) one S per row (ndom, pad, pad): each row is tiled x8 onto (b), as the
      JAX package's solver does (its ``solvers/ddh.py::_wave_cycle``).

Three kernels serve every layout, chosen by shape and non-zero count
(``kernel_variant``): ``csrc/wave_cycle_sparse.cu`` applies S from its exact
non-zeros (``sparse_form``, a CSC of S) held in shared memory, the default
wherever that form fits; ``csrc/wave_cycle.cu`` keeps the dense S resident
in shared memory (pad <= 224 on an H100) and ``csrc/wave_cycle_streamed.cu``
streams it through shared memory in panels (pad up to 1024), the dense
kernels a caller can force.  For tensors on the CPU ``wave_cycle`` runs
``wave_cycle_plain``, the JAX package's ``_wave_cycle_xla`` loop as torch
ops; for a CUDA tensor it launches a kernel or raises.

All compute the stiffness product as ``P @ S`` (the Pallas kernel's
orientation); the JAX scan computes ``S P``.  They agree because the
assembled subdomain stiffness is symmetric (to round-off, for a per-domain
S on an unstructured mesh).

The kernels are compiled with ``nvcc`` from the package's sources at first
use into ``cuddhelmholtz_tpu_torch/_build/`` (one process per source, all
started together) and bound with ``ctypes`` to plain C entry points.
Nothing is built or loaded at import time.
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

import torch

WH_MAXIT = 5  # fixed-point WaveHoltz iterations per apply
# kRows of the dense kernels, and the unit of every run of rows sharing one S
# (checked when a library loads); the sparse kernel's kRows divides it
ROWS_PER_BLOCK = 8
SPARSE_ROWS_PER_BLOCK = 4  # kRows in csrc/wave_cycle_sparse.cu
SPARSE_MAX_PAD = 640  # csrc/wave_cycle_sparse.cu: one thread per column
MAX_THREADS = 512  # kMaxThreads in csrc/wave_cycle.cu: two threads per column
STREAMED_MAX_PAD = 1024  # csrc/wave_cycle_streamed.cu: pad / 2 threads, at most 512
VARIANTS = ("sparse", "resident", "streamed")  # in the order the default tries them

_PKG = Path(__file__).resolve().parents[2]
SOURCES = {
    "sparse": _PKG / "csrc" / "wave_cycle_sparse.cu",
    "resident": _PKG / "csrc" / "wave_cycle.cu",
    "streamed": _PKG / "csrc" / "wave_cycle_streamed.cu",
}
# prefix of each library's C entry points
_ENTRY = {
    "sparse": "wave_cycle_sparse_", "resident": "wave_cycle_", "streamed": "wave_cycle_streamed_",
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


def sparse_shared_memory_bytes(pad: int, stride: int) -> int:
    """Dynamic shared memory one block of the sparse kernel needs: two
    buffers of the stacked [p ; p_half] rows of its SPARSE_ROWS_PER_BLOCK
    subdomains, and one S's ``stride`` staged values (4 B) and row indices
    (2 B)."""
    return 4 * 4 * SPARSE_ROWS_PER_BLOCK * pad + 6 * stride


def kernel_variant(pad: int, limit: int, stride: int | None = None,
                   variant: str | None = None) -> str:
    """The kernel that runs a cycle at ``pad`` on a card that allows
    ``limit`` bytes of shared memory per block, for a sparse form of
    ``stride`` entries per group (``SparseS.stride``: the non-zeros as the
    kernel stages them, at least the nnz; None: no form).

    By default: ``"sparse"`` when the form and the row state fit (pad <=
    SPARSE_MAX_PAD and ``sparse_shared_memory_bytes`` <= limit), else
    ``"resident"`` when the dense S and the row state fit and pad <=
    MAX_THREADS / 2, else ``"streamed"`` (pad <= STREAMED_MAX_PAD).  The
    choice rests on these shapes alone.  ``variant`` names the kernel
    instead.  Raises when the chosen kernel does not take the shape."""
    fits = {
        "sparse": stride is not None and pad <= SPARSE_MAX_PAD
        and sparse_shared_memory_bytes(pad, stride) <= limit,
        "resident": 2 * pad <= MAX_THREADS and shared_memory_bytes(pad) <= limit,
        "streamed": pad <= STREAMED_MAX_PAD and streamed_shared_memory_bytes(pad) <= limit,
    }
    if variant is None:
        for name in VARIANTS:
            if fits[name]:
                return name
    elif variant not in fits:
        raise ValueError(f"wave_cycle: unknown variant {variant!r}; one of {VARIANTS}")
    elif fits[variant]:
        return variant
    need = {
        "sparse": None if stride is None else sparse_shared_memory_bytes(pad, stride),
        "resident": shared_memory_bytes(pad),
        "streamed": streamed_shared_memory_bytes(pad),
    }
    raise ValueError(
        f"wave_cycle: no kernel{'' if variant is None else ' ' + variant} takes pad={pad} "
        f"(sparse stride {stride}): bytes of shared memory per block {need}, the card "
        f"allows {limit} B; pad <= {SPARSE_MAX_PAD} (sparse), {MAX_THREADS // 2} "
        f"(resident), {STREAMED_MAX_PAD} (streamed)"
    )


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


def wave_cycle_plain(
    params, F: torch.Tensor, G: torch.Tensor, wh_maxit: int = WH_MAXIT,
    s_group_size: int | None = None, sparse: SparseS | None = None,
):
    """Plain PyTorch WaveHoltz cycle (the JAX package's ``_wave_cycle_xla``).

    ``params`` provides ``S``, ``Ha``, ``inv_mi``, ``tables`` (nt, 5) and the
    float scalars ``dt`` and ``K0``.  ``S`` is (pad, pad) shared, or a 3-D
    stack: with ``s_group_size`` rows run in groups of that many against one
    matrix each, without it every row has its own.  With ``sparse`` (the
    ``sparse_form`` of S) S is applied through that form's CSC arrays in
    place of the dense product.  Returns the filtered (u, v), each shaped
    like ``F``.
    """
    S, Ha, mi = params.S, params.Ha, params.inv_mi
    dt = params.dt
    half_dt = 0.5 * dt
    rows = params.tables.tolist()  # fp32 values, exact as Python floats

    if S.dim() == 3 and s_group_size is not None:
        _check_groups(S.shape[0], s_group_size, F.shape[0])
    if sparse is not None:
        if sparse.ptr.shape[0] != (1 if S.dim() == 2 else S.shape[0]):
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
    rows = fn("rows_per_block", [], i32)()
    if variant == "sparse":
        fn("launch", [ptr] * 4 + [i32] + [ptr] * 7 + [i32] * 5 + [f32, f32, i32, ptr], i32)
        smem = fn("shared_memory_bytes", [i32, i32], ctypes.c_longlong)
        same = (fn("max_pad", [], i32)() == SPARSE_MAX_PAD and rows == SPARSE_ROWS_PER_BLOCK
                and smem(632, 10336) == sparse_shared_memory_bytes(632, 10336))
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


def _check_form(form: SparseS, ngroups: int, pad: int, device: torch.device) -> None:
    stride = form.stride
    expect = {
        "ptr": (form.ptr, torch.int32, (ngroups, pad + 1)),
        "idx": (form.idx, torch.int16, (ngroups, stride)),
        "val": (form.val, torch.float32, (ngroups, stride)),
        "order": (form.order, torch.int16, (ngroups, pad)),
    }
    for name, (t, dtype, shape) in expect.items():
        if t.device != device or t.dtype != dtype or not t.is_contiguous():
            raise ValueError(
                f"wave_cycle: sparse {name} must be a contiguous {dtype} tensor on {device}, "
                f"got {t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
            )
        if tuple(t.shape) != shape:
            raise ValueError(
                f"wave_cycle: sparse {name} has shape {tuple(t.shape)}, expected {shape}"
            )


def wave_cycle(
    params, F: torch.Tensor, G: torch.Tensor, wh_maxit: int = WH_MAXIT,
    s_group_size: int | None = None, *, variant: str | None = None,
    sparse: SparseS | None = None,
):
    """Run the WaveHoltz cycle; returns (u, v) shaped like ``F``.

    On the CPU this is ``wave_cycle_plain`` with the dense S.  On a CUDA
    device it is one launch of the kernel ``kernel_variant`` names for the
    pad and the non-zeros of S: the sparse kernel wherever S's
    ``sparse_form`` fits in shared memory beside the row state (every
    configuration of the repo), else a dense one.  ``sparse`` is that form,
    prebuilt by the caller for its S (built here when it is None and the
    sparse kernel may run).  ``variant`` (``"sparse"``, ``"resident"``,
    ``"streamed"``) forces a kernel, to hold them against each other.
    Launches are counted in ``wave_cycle.launches`` under ``"shared"``
    (layout (a)) or ``"grouped"`` (layouts (b) and (c)), with a
    ``"sparse_"`` or ``"streamed_"`` prefix for those kernels.  A 3-D ``S``
    with ``s_group_size`` is layout (b): the runs must be a multiple of
    ``ROWS_PER_BLOCK`` rows.  A 3-D ``S`` without it holds one matrix per row
    (layout (c)): each row is repeated ``ROWS_PER_BLOCK`` times, run as layout
    (b) and read back once.  Anything else raises; nothing falls back.
    """
    if F.device.type == "cpu":
        return wave_cycle_plain(params, F, G, wh_maxit, s_group_size)
    if F.device.type != "cuda":
        raise ValueError(f"wave_cycle: unsupported device {F.device}")
    S = params.S
    if S.dim() == 3 and s_group_size is None:
        r = ROWS_PER_BLOCK
        tiled = params._replace(
            Ha=params.Ha.repeat_interleave(r, dim=0),
            inv_mi=params.inv_mi.repeat_interleave(r, dim=0),
        )
        u, v = wave_cycle(
            tiled, F.repeat_interleave(r, dim=0), G.repeat_interleave(r, dim=0), wh_maxit, r,
            variant=variant, sparse=sparse,
        )
        return u[::r], v[::r]
    if S.dim() == 2:
        if s_group_size is not None:
            raise ValueError("wave_cycle: s_group_size needs a 3-D stiffness stack")
        layout, gsize = "shared", 0
    else:
        _check_groups(S.shape[0], s_group_size, F.shape[0])
        if s_group_size % ROWS_PER_BLOCK:
            raise ValueError(
                f"wave_cycle: s_group_size={s_group_size} must be a multiple of "
                f"{ROWS_PER_BLOCK} (the rows of one block share one S)"
            )
        layout, gsize = "grouped", s_group_size
    _check_operands(params, F, G)
    ndom, pad = F.shape
    dev = F.device.index
    limit = _shared_memory_limit(dev)
    form = None
    if variant in (None, "sparse"):
        form = sparse_form(S) if sparse is None else sparse
        _check_form(form, 1 if S.dim() == 2 else S.shape[0], pad, F.device)
    variant = kernel_variant(pad, limit, None if form is None else form.stride, variant)
    lib = _library(variant)
    u = torch.empty_like(F)
    v = torch.empty_like(F)
    rest = (
        F.data_ptr(), G.data_ptr(), params.Ha.data_ptr(), params.inv_mi.data_ptr(),
        params.tables.data_ptr(), u.data_ptr(), v.data_ptr(),
        ndom, pad, params.tables.shape[0], wh_maxit, gsize, params.dt, params.K0, dev,
        torch.cuda.current_stream(F.device).cuda_stream,
    )
    if variant == "sparse":
        head = (form.ptr.data_ptr(), form.idx.data_ptr(), form.val.data_ptr(),
                form.order.data_ptr(), form.stride)
    else:
        head = (S.data_ptr(),)
    err = getattr(lib, _ENTRY[variant] + "launch")(*head, *rest)
    if err:
        msg = getattr(lib, _ENTRY[variant] + "error_string")(err).decode()
        raise RuntimeError(f"wave_cycle: {variant} kernel launch failed: {msg}")
    wave_cycle.launches[layout if variant == "resident" else f"{variant}_{layout}"] += 1
    return u, v


def _shared_memory_limit(dev: int) -> int:
    """Bytes of shared memory a block may use on cuda:``dev``."""
    limit = _library("resident").wave_cycle_max_shared_memory(dev)
    if limit < 0:
        raise RuntimeError(f"wave_cycle: cannot read the shared-memory limit of cuda:{dev}")
    return limit


def default_variant(pad: int, form: SparseS, device: torch.device) -> str:
    """The kernel ``wave_cycle`` runs by default at ``pad`` with the sparse
    form ``form`` on the CUDA ``device`` (``kernel_variant``)."""
    return kernel_variant(pad, _shared_memory_limit(device.index), form.stride)


def reset_launches() -> None:
    """Set every layout's launch count to 0."""
    for key in wave_cycle.launches:
        wave_cycle.launches[key] = 0


wave_cycle.launches = {
    "shared": 0, "grouped": 0, "streamed_shared": 0, "streamed_grouped": 0,
    "sparse_shared": 0, "sparse_grouped": 0,
}
