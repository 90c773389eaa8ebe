#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cuddhelmholtz_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX.  Phases, each raising on failure:

1. The card: ``nvidia-smi`` name and power limit; build the WaveHoltz kernel
   from ``cuddhelmholtz_tpu_torch/csrc/wave_cycle.cu`` with nvcc (timed).
2. Kernel vs plain at the flagship shape: one wave cycle of the
   ``ddh_structured`` DDH (1,024 subdomains, pad 176, nt 800) on masked random
   (F, G) through the kernel and through the plain PyTorch cycle; max error
   over max magnitude of u and v must be < 2e-4.  Times both per cycle with
   CUDA events.
3. The flagship solve ``run_ddh(nx=128, deg=3)`` on the direct path: it must
   succeed in <= 20 restarts, the kernel must have launched exactly
   ``num_matvec + 2`` times (every matvec, rhs and postprocess), and the
   lambda residual recomputed with the plain cycle must be <= 1.2e-4.

Output: diagnostics, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np


def _fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def _cuda_ms(fn, reps: int) -> float:
    """Mean milliseconds per call of ``fn`` on the current stream."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from cuddhelmholtz_tpu_torch.config import DDH_STRUCTURED as cfg
    from cuddhelmholtz_tpu_torch.examples.drivers import (
        point_sources,
        run_ddh,
        wave_speed_coeff,
    )
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
    from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
    from cuddhelmholtz_tpu_torch.ops.functional import linear_functional
    from cuddhelmholtz_tpu_torch.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
    from cuddhelmholtz_tpu_torch.solvers.ddh import DDH, ddh_action, ddh_rhs
    from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")

    # --- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    lib_path = wc.build()
    wc._library()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path.name}")
    print(lib_path.with_suffix(".log").read_text().strip())

    # --- 2. kernel vs plain at the flagship shape -------------------------------
    nx, deg = cfg.nx, cfg.deg
    omega = cfg.omega
    fem = H1Space(Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0), Basis(deg + 1))
    a_nodal = apply_diag_inv_mass(
        make_diag_inv_mass_op(fem), linear_functional(fem, wave_speed_coeff)
    ).numpy()
    t0 = time.perf_counter()
    ddh = DDH(omega, a_nodal, fem, nx=nx, ny=nx, block_size=cfg.block_size,
              wh_maxit=cfg.wh_maxit, device=dev)
    print(f"flagship DDH setup: {time.perf_counter() - t0:.2f} s; ndom={ddh.n_domains} "
          f"pad={ddh.pad} nt={ddh.nt} n_lambda={ddh.size} shared_S={ddh.shared_S}")
    p = ddh.params
    if p.S.dim() != 2:
        _fail("flagship stiffness is not shared")
    if float((p.S - p.S.T).abs().max()) > 1e-6 * float(p.S.abs().max()):
        _fail("flagship stiffness is not symmetric")
    rng = np.random.default_rng(0)
    gmask = ddh.gmask.cpu().numpy()
    F = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32)).to(dev)
    G = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32)).to(dev)

    u_k, v_k = wc.wave_cycle(p, F, G, ddh.wh_maxit)
    torch.cuda.synchronize()
    u_p, v_p = wc.wave_cycle_plain(p, F, G, ddh.wh_maxit)
    err_u, err_v = _rel_max(u_k, u_p), _rel_max(v_k, v_p)
    abs_err = max(float((u_k - u_p).abs().max()), float((v_k - v_p).abs().max()))
    if not (np.isfinite([err_u, err_v]).all() and err_u < 2e-4 and err_v < 2e-4):
        _fail(f"kernel disagrees with the plain cycle: rel u {err_u:.3e}, v {err_v:.3e}")
    if bool((u_k[ddh.gmask == 0] != 0).any()) or bool((v_k[ddh.gmask == 0] != 0).any()):
        _fail("kernel wrote non-zero values into padded slots")
    ms = _cuda_ms(lambda: wc.wave_cycle(p, F, G, ddh.wh_maxit), reps=5)
    plain_ms = _cuda_ms(lambda: wc.wave_cycle_plain(p, F, G, ddh.wh_maxit), reps=1)
    flop = 2 * 2 * ddh.wh_maxit * ddh.nt * ddh.n_domains * ddh.pad**2
    print(f"wave cycle: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms per cycle; "
          f"rel err u {err_u:.3e} v {err_v:.3e}, max abs err {abs_err:.3e}; "
          f"kernel {flop / ms / 1e9:.1f} TFLOP/s on padded shapes ({flop:.3e} FLOP)")

    # --- 3. the flagship solve, direct path ------------------------------------
    wc.wave_cycle.launches = 0
    res = run_ddh(nx=nx, deg=deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit, tol=cfg.gmres.tol,
                  wh_maxit=cfg.wh_maxit, block_size=cfg.block_size, transfer=False,
                  device=dev)
    launches = wc.wave_cycle.launches
    print(f"flagship solve: success={res.success} restarts={res.num_iter} "
          f"matvecs={res.num_matvec} launches={launches} solve {res.seconds:.3f} s "
          f"({1e3 * res.seconds / (res.num_matvec + 2):.3f} ms per cycle incl. GMRES) "
          f"setup {res.extra['setup_seconds']:.2f} s; residual history "
          f"{res.res_norm[0]:.6e} -> {res.res_norm[-1]:.6e} "
          f"(rel {res.res_norm[-1] / res.res_norm[0]:.3e})")
    if not res.success:
        _fail("flagship solve did not converge")
    if res.num_iter > 20:
        _fail(f"flagship solve took {res.num_iter} restarts (> 20)")
    if launches != res.num_matvec + 2:
        _fail(f"kernel launches {launches} != num_matvec + 2 = {res.num_matvec + 2}")
    U = res.solution
    if U.shape != (2 * res.extra["ndof"],) or not np.isfinite(U).all():
        _fail(f"solution has shape {U.shape} or non-finite values")

    sddh = res.extra["ddh"]
    lam = res.extra["lam"]
    b = helmholtz_rhs(sddh.space, lambda xy: point_sources(xy, omega)).to(dev)
    Y = ddh_rhs(sddh.params, b, sddh.g_ndof, sddh.n_lambda, cycle=wc.wave_cycle_plain)
    AX = ddh_action(sddh.params, lam, n_own=sddh.n_own, cycle=wc.wave_cycle_plain)
    resid = float(torch.linalg.vector_norm(Y - AX) / torch.linalg.vector_norm(Y))
    print(f"plain-cycle check: ||Y - A(x)|| / ||Y|| = {resid:.3e}")
    if not resid <= 1.2e-4:
        _fail(f"plain-cycle residual {resid:.3e} > 1.2e-4")

    print(json.dumps({"kernels": [{
        "name": "wave_cycle",
        "route": "cuda",
        "source": "cuddhelmholtz_tpu_torch/csrc/wave_cycle.cu",
        "replaces": "cuddhelmholtz_tpu/ops/pallas/wave_cycle.py:69",
        "launches": launches,
        "max_abs_err": abs_err,
        "ms": ms,
        "plain_ms": plain_ms,
    }]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
