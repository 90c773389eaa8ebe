"""ctypes bindings for the native topology builds (``topology.cpp``).

Counterpart of ``cuddhelmholtz_tpu/native/__init__.py``, with the package's
own copy of the C++ source.  ``build_edges`` and ``h1_numbering`` produce
the same tables as the NumPy paths of ``mesh/mesh2d.py`` and
``spaces/h1.py``, bitwise; those call them first.

The library is compiled on first use with the host C++ compiler (``$CXX``,
else ``g++``) into ``cuddhelmholtz_tpu_torch/_build/``, named by a hash of
the source, the compiler and its flags.  The compiler writes a temporary
file that is then renamed into place, under a file lock, so concurrent
first uses (test workers, ranks) compile once and no process ever loads a
half-written library.  A failed build raises an error that names the
failure; nothing falls back silently.  ``CUDDH_NATIVE=0`` (read on every
call) makes both functions return None, so the callers take their NumPy
paths.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().with_name("topology.cpp")
BUILD_DIR = Path(__file__).resolve().parents[1] / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-Wall", "-shared")


def enabled() -> bool:
    """False when ``CUDDH_NATIVE=0`` asks for the NumPy paths."""
    return os.environ.get("CUDDH_NATIVE", "1") != "0"


def build(build_dir: Path | str | None = None) -> Path:
    """Compile ``topology.cpp`` into ``build_dir`` (``BUILD_DIR`` when None)
    unless a library of the same source, compiler and flags is already
    there; returns its path.  Raises ``RuntimeError`` with the compiler's
    output if the build fails."""
    build_dir = Path(BUILD_DIR if build_dir is None else build_dir)
    cxx = os.environ.get("CXX", "g++")
    tag = hashlib.sha256(
        SOURCE.read_bytes() + " ".join((cxx, *CXX_FLAGS)).encode()
    ).hexdigest()[:16]
    out = build_dir / f"libcuddh_topology_{tag}.so"
    if out.exists():
        return out
    build_dir.mkdir(parents=True, exist_ok=True)
    with open(build_dir / "topology.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes
        if out.exists():  # another process built it while this one waited
            return out
        tmp = build_dir / f"{out.name}.{os.getpid()}.tmp"
        try:
            proc = subprocess.run(
                [cxx, *CXX_FLAGS, "-o", str(tmp), str(SOURCE)],
                capture_output=True, text=True, timeout=300,
            )
        except (OSError, subprocess.TimeoutExpired) as e:
            raise RuntimeError(f"native: cannot run the C++ compiler {cxx!r}: {e}") from e
        if proc.returncode != 0 or not tmp.exists():
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"native: {cxx} failed to build {SOURCE.name} (exit {proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, out)
    return out


@functools.cache
def library(build_dir: Path | str | None = None) -> ctypes.CDLL:
    """The loaded library in ``build_dir`` (``BUILD_DIR`` when None; built
    first if needed), its entry points typed."""
    lib = ctypes.CDLL(str(build(build_dir)))
    i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
    i64, i32 = ctypes.c_int64, ctypes.c_int32
    lib.cuddh_build_edges.restype = i64
    lib.cuddh_build_edges.argtypes = [i64, i32p, i64, i32p, i32p, i32p, i32p]
    lib.cuddh_h1_numbering.restype = i64
    lib.cuddh_h1_numbering.argtypes = [i64, i32, i32p, i64, i64, i32p, i32p, i32p, i32p, i32p]
    return lib


def build_edges(elem_vertices: np.ndarray, nv: int):
    """Native edge build: (edge_vertices, edge_elements, edge_sides,
    edge_delta), or None when ``CUDDH_NATIVE=0``."""
    if not enabled():
        return None
    ev = np.ascontiguousarray(elem_vertices, dtype=np.int32)
    nel = len(ev)
    cap = 4 * nel
    edge_vertices = np.empty((cap, 2), np.int32)
    edge_elements = np.empty((cap, 2), np.int32)
    edge_sides = np.empty((cap, 2), np.int32)
    edge_delta = np.empty(cap, np.int32)
    ne = library().cuddh_build_edges(
        nel, ev, nv, edge_vertices, edge_elements, edge_sides, edge_delta
    )
    return (
        edge_vertices[:ne].copy(),
        edge_elements[:ne].copy(),
        edge_sides[:ne].copy(),
        edge_delta[:ne].copy(),
    )


def h1_numbering(elem_vertices, nv, edge_vertices, edge_elements, edge_sides, edge_delta, nb):
    """Native CG DOF numbering: (dofs (nel, nb, nb) int32, ndof), or None
    when ``CUDDH_NATIVE=0``."""
    if not enabled():
        return None
    ev = np.ascontiguousarray(elem_vertices, dtype=np.int32)
    nel = len(ev)
    dofs = np.empty((nel, nb, nb), np.int32)
    ndof = library().cuddh_h1_numbering(
        nel,
        nb,
        ev,
        nv,
        len(edge_vertices),
        np.ascontiguousarray(edge_vertices, np.int32),
        np.ascontiguousarray(edge_elements, np.int32),
        np.ascontiguousarray(edge_sides, np.int32),
        np.ascontiguousarray(edge_delta, np.int32),
        dofs,
    )
    return dofs, int(ndof)
