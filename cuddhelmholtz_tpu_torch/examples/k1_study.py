"""The K1 kernels against each other on the card, and what the tensor-core one's parts cost.

Run from the repository root on a machine with a CUDA card:
``python -m cuddhelmholtz_tpu_torch.examples.k1_study``.  Prints the card
(``nvidia-smi`` name and power limit), then one JSON line per case:

* ``"ladder"``: the factored kernel (``csrc/wave_cycle_factored.cu``, where
  the stiffness comes with the element factors of rectangles), the
  tensor-core kernel (``csrc/wave_cycle_mma.cu``, where its tile form fits)
  and the FFMA sparse kernel (``csrc/wave_cycle_sparse.cu``), each forced,
  timed in turns (k0, k1, k2, k2, k1, k0) with CUDA events over a ladder of
  row counts for four stiffness matrices: the flagship's shared S (pad
  176, layout (a), 7.2 non-zero 8 x 8 tiles per output tile), the shared S
  of 32-DOF blocks (pad 632, ``ddh_512_block32``'s shape, above every
  tensor-core instance), the unstructured square's 8 per-domain S (pad
  168, layout (b), 11 tiles in the largest group) and 8 of L3's 256 (pad
  320, two output tiles a warp); the last two have no factored form (B !=
  0).  Each kernel's time comes with its bound: the work on the exact
  non-zeros of S at the FP32 FMA peak (67 TFLOP/s), three TF32 passes of
  it at 495 TFLOP/s for the tensor-core kernel.  The rule of
  ``wave_cycle.kernel_variant`` (the factored kernel wherever its form
  fits, then ``wave_cycle.mma_preferred``: S's form and pad, not the rows)
  rests on these numbers; ``"default"`` is what it picks.
* ``"ablation"``: the tensor-core kernel built again from its source with
  ``-DWC_MMA_ABLATION=1..4`` (hi cut toward zero; one pass on the hi parts;
  one pass on the raw floats; the splits without the mma), timed in turns
  with the default build and the FFMA kernel at four shapes, with each
  build's largest error relative to the FFMA kernel's output.

Every case runs ``wh_maxit = 5`` iterations of the configuration's own
``nt`` on masked random (F, G) from a fixed seed.
"""

from __future__ import annotations

import ctypes
import json
import subprocess
import sys

import numpy as np
import torch

from ..config import DDH_512_BLOCK32 as bcfg
from ..config import DDH_STRUCTURED as cfg
from ..config import DDH_UNSTRUCTURED_SQUARE as ucfg
from ..mesh.io import load_unstructured_square
from ..mesh.mesh2d import Mesh2D
from ..mesh.refine import refine_quad_mesh
from ..ops.cuda import wave_cycle as wc
from ..ops.functional import linear_functional
from ..ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
from ..solvers.ddh import DDH
from ..spaces.ensemble import coordinate_bisection_labels
from ..spaces.h1 import H1Space
from ..utils.basis import Basis
from . import large_unstructured as lu
from .drivers import wave_speed_coeff

ABLATIONS = {1: "trunc", 2: "one_pass", 3: "no_split", 4: "no_mma"}
WH_MAXIT = 5
PEAK_FP32_FLOPS = 67e12  # H100 SXM, FFMA
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense tensor cores


def build_ablations() -> dict[str, ctypes.CDLL]:
    """Build the tensor-core source once per ablation (one nvcc each, all
    started together) into the wrapper's build directory."""
    nvcc, src = wc._find_nvcc(), wc.SOURCES["mma"]
    wc.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for n, name in ABLATIONS.items():
        out = wc.BUILD_DIR / f"lib{src.stem}_ablation{n}.so"
        procs[name] = (out, subprocess.Popen(
            [nvcc, *wc.NVCC_FLAGS, f"-DWC_MMA_ABLATION={n}", "-o", str(out), str(src)],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    libs = {}
    for name, (out, proc) in procs.items():
        _, err = proc.communicate(timeout=600)
        if proc.returncode:
            raise RuntimeError(f"k1_study: nvcc failed for {name}:\n{err}")
        lib = ctypes.CDLL(str(out))
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.wave_cycle_mma_launch.argtypes = [p] * 4 + [i] + [p] * 7 + [i] * 5 + [f, f, i, p]
        lib.wave_cycle_mma_launch.restype = i
        libs[name] = lib
    return libs


def _launch(lib, p, F, G, sgs, tiles):
    """One cycle on an ablation build (the wrapper's mma launch, by hand)."""
    u, v = torch.empty_like(F), torch.empty_like(F)
    err = lib.wave_cycle_mma_launch(
        tiles.val.data_ptr(), tiles.kt.data_ptr(), tiles.ptr.data_ptr(), tiles.col.data_ptr(),
        tiles.pairs, F.data_ptr(), G.data_ptr(), p.Ha.data_ptr(), p.inv_mi.data_ptr(),
        p.tables.data_ptr(), u.data_ptr(), v.data_ptr(), F.shape[0], F.shape[1],
        p.tables.shape[0], WH_MAXIT, sgs, p.dt, p.K0, F.device.index,
        torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"k1_study: ablation launch failed ({err})")
    return u, v


def _ms(fn, reps: int) -> float:
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel(a, b) -> float:
    return max(float((x - y).abs().max() / y.abs().max()) for x, y in zip(a, b))


def _case(params, mask, groups: int | None, rows: int, rng):
    """Params and (F, G) of ``rows`` rows: layout (a) (``groups`` None, the
    operator's rows repeated) or (b) (``groups`` runs of rows / groups)."""
    if groups is None:
        idx = torch.arange(rows, device=mask.device) % mask.shape[0]
        p = params._replace(Ha=params.Ha[idx].contiguous(), inv_mi=params.inv_mi[idx].contiguous())
        m = mask[idx]
        sgs = 0
    else:
        sgs = rows // groups
        p = params._replace(S=params.S[:groups].contiguous(),
                            Ha=params.Ha[:groups].repeat_interleave(sgs, 0),
                            inv_mi=params.inv_mi[:groups].repeat_interleave(sgs, 0))
        m = mask[:groups].repeat_interleave(sgs, 0)
    mm = m.cpu().numpy()
    F, G = (torch.from_numpy((rng.standard_normal(mm.shape) * mm).astype(np.float32)).to(m.device)
            for _ in range(2))
    return p, F, G, sgs


def _turns(runs: dict, reps: int) -> dict:
    """Mean ms of each run over the turns (r0, r1, ..., r1, r0)."""
    times = {k: [] for k in runs}
    for k in [*runs, *reversed(list(runs))]:
        times[k].append(_ms(runs[k], reps))
    return {k: sum(t) / len(t) for k, t in times.items()}


def _structured(c, dev) -> DDH:
    """The operator of the structured configuration ``c``."""
    fem = H1Space(Mesh2D.uniform_rect(c.nx, -1.0, 1.0, c.nx, -1.0, 1.0), Basis(c.deg + 1))
    a = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"),
                            linear_functional(fem, wave_speed_coeff)).numpy()
    return DDH(c.omega, a, fem, nx=c.nx, ny=c.nx, block_size=c.block_size, wh_maxit=WH_MAXIT,
               device=dev)


def _operators(dev):
    """(name, params, gmask, groups or None, element factors or None) of the
    four stiffness cases."""
    for name, c in (("flagship S (a), pad 176", cfg), ("32-DOF blocks' S (a), pad 632", bcfg)):
        ddh = _structured(c, dev)
        yield name, ddh.params, ddh.gmask, None, ddh.element_factors
        del ddh
    mesh = load_unstructured_square()
    labels, _ = coordinate_bisection_labels(mesh, ucfg.n_domains)
    ufem = H1Space(mesh, Basis(ucfg.deg + 1))
    ua = apply_diag_inv_mass(make_diag_inv_mass_op(ufem, device="cpu"),
                             linear_functional(ufem, wave_speed_coeff)).numpy()
    sq = DDH(ucfg.omega, ua, ufem, element_labels=labels, wh_maxit=WH_MAXIT, device=dev)
    yield "square's 8 S (b), pad 168", sq.params, sq.gmask, 8, None
    del sq
    lmesh = refine_quad_mesh(load_unstructured_square(), 3)
    lomega = 2 * np.pi / (5.0 * lu.median_h(lmesh))
    labels, _ = coordinate_bisection_labels(lmesh, 256)
    lfem = H1Space(lmesh, Basis(4))
    l3 = DDH(lomega, np.ones(lfem.ndof), lfem, element_labels=labels, wh_maxit=WH_MAXIT,
             device=dev)
    yield "L3's first 8 S (b), pad 320", l3.params, l3.gmask, 8, None


# rows of each case: one wave of the tensor-core kernel (<= 132 blocks on an
# H100 SXM) and past it; the square's 960 and 3,648 are its transfer and io
# probes, the flagship's 1,024 its direct cycle and 3,168 its transfer probe
# (5,472 the high-frequency probe's, 12,000 the nx 512 one's), pad 632's
# 12,480 ``ddh_512_block32``'s transfer probe
LADDER = {
    "flagship S (a), pad 176": (384, 512, 1024, 1056, 1064, 1536, 2048, 3168, 5472, 12000),
    "32-DOF blocks' S (a), pad 632": (1024, 12480),
    "square's 8 S (b), pad 168": (960, 1024, 1088, 2048, 3648, 12032),
    "L3's first 8 S (b), pad 320": (1024, 2048, 12288),
}
# (case, rows) of the ablations
ABLATE = {("flagship S (a), pad 176", 1024), ("flagship S (a), pad 176", 12000),
          ("square's 8 S (b), pad 168", 960), ("L3's first 8 S (b), pad 320", 12288)}


def main() -> int:
    if not torch.cuda.is_available():
        print("k1_study: needs a CUDA device", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    print(f"card: {smi}; {torch.cuda.get_device_properties(dev).multi_processor_count} SMs",
          flush=True)
    for v in wc.build():
        wc._library(v)
    libs = build_ablations()
    rng = np.random.default_rng(0)
    limit = wc._shared_memory_limit(dev.index)
    for name, params, gmask, groups, factors in _operators(dev):
        for rows in LADDER[name]:
            p, F, G, sgs = _case(params, gmask, groups, rows, rng)
            pad = p.S.shape[-1]
            kernels = {"sparse": wc.k1_kernel(p.S, variant="sparse")}
            if factors is not None:
                kernels["factored"] = wc.k1_kernel(p.S, variant="factored", factors=factors)
            if pad <= wc.MMA_MAX_PAD:
                kernels["mma"] = wc.k1_kernel(p.S, variant="mma")
            tiles = kernels["mma"].form if "mma" in kernels else None
            runs = {v: (lambda k=k: wc.wave_cycle(p, F, G, WH_MAXIT, sgs or None, kernel=k))
                    for v, k in kernels.items()}
            ablate = (name, rows) in ABLATE
            if ablate:
                runs.update({k: (lambda lib=lib: _launch(lib, p, F, G, sgs, tiles))
                             for k, lib in libs.items()})
            outs = {k: f() for k, f in runs.items()}
            reps = max(1, min(5, int(40_000 // rows)))
            ms = _turns(runs, reps)
            flop = 2.0 * 2 * WH_MAXIT * p.tables.shape[0] * (rows // (groups or 1)) * float(
                (p.S != 0).sum())
            bound = {v: 1e3 * flop * (3 / PEAK_TF32_FLOPS if v == "mma" else 1 / PEAK_FP32_FLOPS)
                     for v in kernels}
            fac = kernels.get("factored")
            rec = {
                "kind": "ablation" if ablate else "ladder", "case": name, "rows": rows,
                "nt": int(p.tables.shape[0]), "pairs": None if tiles is None else tiles.pairs,
                "ms": ms, "bound_ms": bound,
                "bound_pct": {v: 100 * bound[v] / ms[v] for v in kernels},
                "over_sparse": {v: ms[v] / ms["sparse"] for v in kernels if v != "sparse"},
                "rel_to_sparse": {k: _rel(o, outs["sparse"]) for k, o in outs.items()
                                  if k != "no_mma"},
                "default": wc.kernel_variant(pad, limit, kernels["sparse"].form.stride,
                                             pairs=None if tiles is None else tiles.pairs,
                                             factored=None if fac is None else fac.form.shape),
                "occupancy": {v: wc.kernel_occupancy(v, pad, k.form, dev)
                              for v, k in kernels.items()},
            }
            print(json.dumps(rec), flush=True)
            del outs, p, F, G
        del params, gmask
        torch.cuda.empty_cache()
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main())
