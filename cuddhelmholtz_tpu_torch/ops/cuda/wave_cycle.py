"""The DDH WaveHoltz cycle: Hopper kernel wrapper and its plain PyTorch version.

Counterpart of ``cuddhelmholtz_tpu/ops/pallas/wave_cycle.py``.  ``wave_cycle``
runs ``wh_maxit`` WaveHoltz iterations of ``nt`` staggered-leapfrog steps on
every subdomain row with one launch of the hand-written CUDA kernel in
``csrc/wave_cycle.cu``, in the Pallas kernel's three stiffness layouts:

  (a) one shared (pad, pad) S;
  (b) an (ngroups, pad, pad) stack with rows in runs of ``s_group_size``;
  (c) one S per row (ndom, pad, pad): each row is tiled x8 onto (b), as the
      JAX package's solver does (its ``solvers/ddh.py::_wave_cycle``).

For tensors on the CPU it runs ``wave_cycle_plain``, the JAX package's
``_wave_cycle_xla`` loop as torch ops; for a CUDA tensor it launches the
kernel or raises.

Both compute the stiffness product as ``P @ S`` (the Pallas kernel's
orientation); the JAX scan computes ``S P``.  They agree because the
assembled subdomain stiffness is symmetric.

The kernel is compiled with ``nvcc`` from the package's sources at first use
into ``cuddhelmholtz_tpu_torch/_build/`` and bound with ``ctypes`` to a plain
C entry point.  Nothing is built or loaded at import time.
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
ROWS_PER_BLOCK = 8  # kRows in csrc/wave_cycle.cu (checked when the library loads)
MAX_THREADS = 512  # kMaxThreads in csrc/wave_cycle.cu: two threads per column

_PKG = Path(__file__).resolve().parents[2]
SOURCE = _PKG / "csrc" / "wave_cycle.cu"
BUILD_DIR = _PKG / "_build"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)


def shared_memory_bytes(pad: int) -> int:
    """Dynamic shared memory one block needs: S, the stacked
    [p ; p - dt/2 q] rows of its ROWS_PER_BLOCK subdomains and the partial
    sums the two k-groups hand each other."""
    return 4 * (pad * pad + 2 * 2 * ROWS_PER_BLOCK * pad)


def check_shared_memory(pad: int, limit: int) -> None:
    """Raise when a block's S and row state exceed the card's per-block
    shared memory (streaming S through shared memory is not ported yet)."""
    need = shared_memory_bytes(pad)
    if need > limit:
        raise ValueError(
            f"wave_cycle: pad={pad} needs {need} B of shared memory per block "
            f"(S {4 * pad * pad} B + row state {need - 4 * pad * pad} B) but the "
            f"card allows {limit} B; a streamed-S kernel for large pads is not "
            "ported yet (ROADMAP queue 2, K1)"
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


def build() -> Path:
    """Compile ``csrc/wave_cycle.cu`` into ``_build/`` unless a library built
    from the same source and flags is already there; returns its path.  The
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside it
    in a ``.log`` file."""
    tag = hashlib.sha256(SOURCE.read_bytes() + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    out = BUILD_DIR / f"libwave_cycle_{tag}.so"
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = BUILD_DIR / f"libwave_cycle_{tag}.{os.getpid()}.tmp"
    proc = subprocess.run(
        [_find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCE)],
        capture_output=True, text=True, timeout=600,
    )
    if proc.returncode != 0:
        raise RuntimeError(f"wave_cycle: nvcc failed ({proc.returncode}):\n{proc.stderr}")
    out.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, out)
    return out


@functools.cache
def _library() -> ctypes.CDLL:
    lib = ctypes.CDLL(str(build()))
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.wave_cycle_launch.argtypes = [ptr] * 8 + [i32] * 5 + [f32, f32, i32, ptr]
    lib.wave_cycle_launch.restype = i32
    lib.wave_cycle_max_shared_memory.argtypes = [i32]
    lib.wave_cycle_max_shared_memory.restype = i32
    lib.wave_cycle_error_string.argtypes = [i32]
    lib.wave_cycle_error_string.restype = ctypes.c_char_p
    lib.wave_cycle_rows_per_block.restype = i32
    lib.wave_cycle_max_threads.restype = i32
    lib.wave_cycle_shared_memory_bytes.argtypes = [i32]
    lib.wave_cycle_shared_memory_bytes.restype = ctypes.c_longlong
    if (lib.wave_cycle_rows_per_block(), lib.wave_cycle_max_threads()) != (
        ROWS_PER_BLOCK, MAX_THREADS
    ) or lib.wave_cycle_shared_memory_bytes(176) != shared_memory_bytes(176):
        raise RuntimeError("wave_cycle: library constants disagree with the wrapper")
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
    if pad % 8 or 2 * pad > MAX_THREADS:
        raise ValueError(
            f"wave_cycle: pad={pad} must be a multiple of 8 and <= {MAX_THREADS // 2}"
        )
    if params.S.data_ptr() % 16:
        raise ValueError("wave_cycle: S must be 16-byte aligned")


def wave_cycle(
    params, F: torch.Tensor, G: torch.Tensor, wh_maxit: int = WH_MAXIT,
    s_group_size: int | None = None,
):
    """Run the WaveHoltz cycle; returns (u, v) shaped like ``F``.

    On the CPU this is ``wave_cycle_plain``.  On a CUDA device it is one
    launch of the Hopper kernel, counted in ``wave_cycle.launches`` under
    ``"shared"`` (layout (a)) or ``"grouped"`` (layouts (b) and (c)).  A 3-D
    ``S`` with ``s_group_size`` is layout (b): the runs must be a multiple of
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
            tiled, F.repeat_interleave(r, dim=0), G.repeat_interleave(r, dim=0), wh_maxit, r
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
    lib = _library()
    limit = lib.wave_cycle_max_shared_memory(dev)
    if limit < 0:
        raise RuntimeError(f"wave_cycle: cannot read the shared-memory limit of cuda:{dev}")
    check_shared_memory(pad, limit)
    u = torch.empty_like(F)
    v = torch.empty_like(F)
    err = lib.wave_cycle_launch(
        S.data_ptr(), F.data_ptr(), G.data_ptr(), params.Ha.data_ptr(),
        params.inv_mi.data_ptr(), params.tables.data_ptr(), u.data_ptr(), v.data_ptr(),
        ndom, pad, params.tables.shape[0], wh_maxit, gsize, params.dt, params.K0, dev,
        torch.cuda.current_stream(F.device).cuda_stream,
    )
    if err:
        raise RuntimeError(
            f"wave_cycle: kernel launch failed: {lib.wave_cycle_error_string(err).decode()}"
        )
    wave_cycle.launches[layout] += 1
    return u, v


def reset_launches() -> None:
    """Set every layout's launch count to 0."""
    for layout in wave_cycle.launches:
        wave_cycle.launches[layout] = 0


wave_cycle.launches = {"shared": 0, "grouped": 0}
