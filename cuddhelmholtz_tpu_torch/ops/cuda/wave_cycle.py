"""The DDH WaveHoltz cycle: Hopper kernel wrappers and their plain PyTorch version.

Counterpart of ``cuddhelmholtz_tpu/ops/pallas/wave_cycle.py``.  ``wave_cycle``
runs ``wh_maxit`` WaveHoltz iterations of ``nt`` staggered-leapfrog steps on
every subdomain row with one launch of a hand-written CUDA kernel, in the
Pallas kernel's three stiffness layouts:

  (a) one shared (pad, pad) S;
  (b) an (ngroups, pad, pad) stack with rows in runs of ``s_group_size``;
  (c) one S per row (ndom, pad, pad): each row is tiled x8 onto (b), as the
      JAX package's solver does (its ``solvers/ddh.py::_wave_cycle``).

Two kernels serve every layout, chosen by shape (``kernel_variant``):
``csrc/wave_cycle.cu`` keeps S resident in shared memory (pad <= 224 on an
H100), ``csrc/wave_cycle_streamed.cu`` streams it through shared memory in
panels (pad up to 1024).  For tensors on the CPU ``wave_cycle`` runs
``wave_cycle_plain``, the JAX package's ``_wave_cycle_xla`` loop as torch ops;
for a CUDA tensor it launches a kernel or raises.

Both compute the stiffness product as ``P @ S`` (the Pallas kernel's
orientation); the JAX scan computes ``S P``.  They agree because the
assembled subdomain stiffness is symmetric.

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

import torch

WH_MAXIT = 5  # fixed-point WaveHoltz iterations per apply
ROWS_PER_BLOCK = 8  # kRows in both kernels (checked when a library loads)
MAX_THREADS = 512  # kMaxThreads in csrc/wave_cycle.cu: two threads per column
STREAMED_MAX_PAD = 1024  # csrc/wave_cycle_streamed.cu: pad / 2 threads, at most 512

_PKG = Path(__file__).resolve().parents[2]
SOURCES = {
    "resident": _PKG / "csrc" / "wave_cycle.cu",
    "streamed": _PKG / "csrc" / "wave_cycle_streamed.cu",
}
# prefix of each library's C entry points
_ENTRY = {"resident": "wave_cycle_", "streamed": "wave_cycle_streamed_"}
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


def kernel_variant(pad: int, limit: int, streamed: bool = False) -> str:
    """The kernel that runs a cycle at ``pad`` on a card that allows
    ``limit`` bytes of shared memory per block: ``"resident"`` when S and the
    row state fit and pad <= MAX_THREADS / 2, else ``"streamed"`` (always
    with ``streamed=True``).  Raises when neither kernel takes the pad."""
    if not streamed and 2 * pad <= MAX_THREADS and shared_memory_bytes(pad) <= limit:
        return "resident"
    if pad <= STREAMED_MAX_PAD and streamed_shared_memory_bytes(pad) <= limit:
        return "streamed"
    raise ValueError(
        f"wave_cycle: pad={pad} exceeds the streamed kernel (pad <= {STREAMED_MAX_PAD}, "
        f"{streamed_shared_memory_bytes(pad)} B of shared memory per block; the card "
        f"allows {limit} B)"
    )


def wave_cycle_plain(
    params, F: torch.Tensor, G: torch.Tensor, wh_maxit: int = WH_MAXIT,
    s_group_size: int | None = None,
):
    """Plain PyTorch WaveHoltz cycle (the JAX package's ``_wave_cycle_xla``).

    ``params`` provides ``S``, ``Ha``, ``inv_mi``, ``tables`` (nt, 5) and the
    float scalars ``dt`` and ``K0``.  ``S`` is (pad, pad) shared, or a 3-D
    stack: with ``s_group_size`` rows run in groups of that many against one
    matrix each, without it every row has its own.  Returns the filtered
    (u, v), each shaped like ``F``.
    """
    S, Ha, mi = params.S, params.Ha, params.inv_mi
    dt = params.dt
    half_dt = 0.5 * dt
    rows = params.tables.tolist()  # fp32 values, exact as Python floats

    if S.dim() == 2:
        def apply_S(p):
            return p @ S
    elif s_group_size is not None:
        _check_groups(S.shape[0], s_group_size, F.shape[0])

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

    fn("launch", [ptr] * 8 + [i32] * 5 + [f32, f32, i32, ptr], i32)
    fn("error_string", [i32], ctypes.c_char_p)
    smem = fn("shared_memory_bytes", [i32], ctypes.c_longlong)
    rows = fn("rows_per_block", [], i32)()
    if variant == "resident":
        fn("max_shared_memory", [i32], i32)
        same = fn("max_threads", [], i32)() == MAX_THREADS and smem(176) == shared_memory_bytes(176)
    else:
        same = (fn("max_pad", [], i32)() == STREAMED_MAX_PAD
                and smem(632) == streamed_shared_memory_bytes(632))
    if not same or rows != ROWS_PER_BLOCK:
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
        # both kernels read S, the streamed one every (rows, pad) operand, as float4
        if name != "tables" and t.data_ptr() % 16:
            raise ValueError(f"wave_cycle: {name} must be 16-byte aligned")
    if pad % 8:
        raise ValueError(f"wave_cycle: pad={pad} must be a multiple of 8")


def wave_cycle(
    params, F: torch.Tensor, G: torch.Tensor, wh_maxit: int = WH_MAXIT,
    s_group_size: int | None = None, *, streamed: bool = False,
):
    """Run the WaveHoltz cycle; returns (u, v) shaped like ``F``.

    On the CPU this is ``wave_cycle_plain``.  On a CUDA device it is one
    launch of the kernel ``kernel_variant`` names for the pad (``streamed``
    forces the streamed kernel where the resident one also fits, to hold the
    two against each other), counted in ``wave_cycle.launches`` under
    ``"shared"`` (layout (a)) or ``"grouped"`` (layouts (b) and (c)), with a
    ``"streamed_"`` prefix for the streamed kernel.  A 3-D ``S`` with
    ``s_group_size`` is layout (b): the runs must be a multiple of
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
            streamed=streamed,
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
    limit = _library("resident").wave_cycle_max_shared_memory(dev)
    if limit < 0:
        raise RuntimeError(f"wave_cycle: cannot read the shared-memory limit of cuda:{dev}")
    variant = kernel_variant(pad, limit, streamed)
    lib = _library(variant)
    u = torch.empty_like(F)
    v = torch.empty_like(F)
    err = getattr(lib, _ENTRY[variant] + "launch")(
        S.data_ptr(), F.data_ptr(), G.data_ptr(), params.Ha.data_ptr(),
        params.inv_mi.data_ptr(), params.tables.data_ptr(), u.data_ptr(), v.data_ptr(),
        ndom, pad, params.tables.shape[0], wh_maxit, gsize, params.dt, params.K0, dev,
        torch.cuda.current_stream(F.device).cuda_stream,
    )
    if err:
        msg = getattr(lib, _ENTRY[variant] + "error_string")(err).decode()
        raise RuntimeError(f"wave_cycle: {variant} kernel launch failed: {msg}")
    wave_cycle.launches[layout if variant == "resident" else f"streamed_{layout}"] += 1
    return u, v


def reset_launches() -> None:
    """Set every layout's launch count to 0."""
    for key in wave_cycle.launches:
        wave_cycle.launches[key] = 0


wave_cycle.launches = {"shared": 0, "grouped": 0, "streamed_shared": 0, "streamed_grouped": 0}
