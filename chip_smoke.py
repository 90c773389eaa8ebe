#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cuddhelmholtz_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX.  Phases, each raising on failure:

1. The card: ``nvidia-smi`` name and power limit; build the three WaveHoltz
   kernels from ``cuddhelmholtz_tpu_torch/csrc/`` with one nvcc each,
   started together (timed).
2. Kernels vs plain at the flagship shape: one wave cycle of the
   ``ddh_structured`` DDH (1,024 subdomains, pad 176, nt 800) on masked random
   (F, G) through the sparse kernel (the default), the resident and the
   streamed kernels (forced) and the plain PyTorch cycle.  Times each kernel
   in turns (sparse, dense, dense, sparse) with CUDA events, the plain cycle
   once, and the build of the sparse form.
3. The flagship solve ``run_ddh(nx=128, deg=3)`` on the direct path: it must
   succeed in <= 20 restarts, the sparse kernel must have launched exactly
   ``num_matvec + 2`` times (every matvec, rhs and postprocess) and no dense
   one, and the lambda residual recomputed with the plain cycle must be
   <= 1.2e-4.
4. The grouped-S layout (b), sparse against the plain cycle and the
   resident kernel, at the ``ddh_unstructured_square`` transfer-probe shape
   (S (8, 168, 168), 960 rows in runs of 120, nt 1,717), and the per-row
   layout (c) (each row tiled x8 onto (b)) at that DDH's own shape.
5. The flagship transfer solve ``run_ddh(nx=128, deg=3, transfer=True)``:
   prepare (transfer + io probes, layout (a)), then a solve that launches no
   kernel (checked by solving again on the prepared operator); <= 20
   restarts, matvecs within one restart of the JAX run's 366, plain-cycle
   lambda residual <= 1.2e-4.
6. ``run_config(ddh_unstructured_square)`` at full size: its probes run the
   sparse kernel in layout (b), the solve none; <= 100 restarts, matvecs
   within two restarts of the JAX run's 668, plain-cycle residual <= 1.2e-4.
7. ``run_config(ddh_512_block32)`` (nx 512, 4,096 subdomains of 625 DOFs,
   pad 632) on the transfer path: its probes run the sparse kernel in
   layout (a) (the dense S is 1.6 MB, its non-zeros 59 KB); restarts within
   one of the JAX run's 25, matvecs within one restart of 522, no kernel in
   a repeated solve, plain-cycle residual <= 1.2e-4.
8. Sparse and streamed layout (a) against the plain cycle on that DDH's
   transfer-probe rows (65 unique subdomains x 192 columns, pad 632, nt 800).
9. ``large_unstructured`` at ``--levels 3 --domains 256`` (7,616 elements,
   pad 320, one S per domain): probes run the sparse kernel in layout (b);
   restarts within one of the JAX run's 18, matvecs within one restart of
   373, the checks of phase 7.
10. Sparse and streamed layout (b) against the plain cycle on that DDH's
   transfer-probe rows (256 runs of 192 rows, pad 320, nt 1,283).
11. The streamed kernel forced at the flagship shape (pad 176) against the
   resident and sparse kernels of phase 2.
12. ``run_config(helmholtz_ddh_1e6)`` at full size (nx 128, the coupled
   system to 1e-6: fp64 refinement of fp32 FGMRES(20), one bounded DDH
   solve as right preconditioner P): success, <= 12 outer restarts (JAX on
   the TPU: 10), <= 6 refinement steps, not stagnated, and a true relative
   residual <= 1e-6 recomputed with the generic (non-kron) fp64 operator on
   the same data; the sparse kernel runs in ``prepare`` only (P launches
   none) and no dense kernel runs; P repeats bitwise on the same input and
   the first and the warm run take the same counts.  Prints solve, warm and
   prepare seconds and ms per P.
13. ``run_config(helmholtz_ddh_unstructured_1e6)``: the checks of phase 12
   with <= 8 restarts (JAX: 6), and a solution within 1e-5 of an fp64
   ``torch.linalg.solve`` of the dense coupled operator on the card.
14. ``run_config(poisson_structured)``: 14 restarts / 292 matvecs, relative
   residual <= 1e-6; ``run_config(helmholtz_unpreconditioned, maxit=10)``:
   9 / 1,810 and not successful (the pinned stagnation level).
15. The fp32 kron coupled matvec against the fp64 generic one at nx 128 on a
   seeded vector, within 1e-6 relative; both timed with CUDA events.
16. ``large_unstructured --levels 3 --domains 256 --composite`` through
   ``run_case`` (the CLI's per-case entry): the lambda-solve of phase 9 and
   the coupled 1e-6 solve on the same partition.  The ``composite`` record
   must succeed with a true fp64 relative residual <= 1e-6, <= 10 outer
   restarts (JAX on the TPU: 8) and <= 6 refinement steps; the run must
   launch only the sparse grouped kernel, exactly twice phase 9's count
   (the two prepares of one partition; P launches none).
17. ``run_config(ddh_high_frequency)`` at full size (nx 256, 4,096
   subdomains) on the transfer path: the probes launch only the sparse
   kernel in layout (a), a repeated solve none; <= 21 restarts (JAX on the
   TPU: 19 / 389), plain-cycle residual <= 1.2e-4; then the sparse kernel
   against the plain cycle on its transfer-probe rows.
18. ``run_config(ddh_multi_source_8)`` at full size (block GMRES(40), 8 ring
   sources, transfer path): success, restarts within one of JAX's 7, each
   source 1 + 41 restarts matvecs, every source's plain-cycle residual <=
   1.2e-4, a repeated solve launches no kernel.  Prints the warm seconds,
   sources/s, JAX's ``speedup_vs_sequential`` (8 timed flagship solves of
   the bench's headline mode against the warm block solve) and a
   matched-mode baseline: 8 warm single-source solves of the same sources
   with the block solve's GMRES options.
19. The direct multi-source path at nx 64 with 4 sources: ``method="block"``
   launches the sparse kernel exactly (block matvecs + 2) times, each over
   the 4 x 256 rows, in no more restarts than the slowest lock-step lane;
   ``method="vmap"`` gives each source the restarts and matvecs of a solo
   direct solve of it; then one 1,024-row launch against the plain cycle.
20. The CLI and the bench in subprocesses: ``python -m
   cuddhelmholtz_tpu_torch.examples.drivers poisson_structured`` prints one
   JSON line with 14 / 292; ``BENCH_SKIP_CONFIGS=1 python -m
   cuddhelmholtz_tpu_torch.bench`` prints its JSON line, the headline
   successful at 18 / 379 (+-1 restart, 1 + 21 per restart).
Phases 1-20 run with the DDH setup cache off (CUDDH_CACHE_DIR=""), their
subprocesses too.
21. The setup cache in a fresh temporary directory: the flagship transfer
   ``run_ddh`` twice, a miss that launches the sparse kernel twice (the
   transfer and io probes, as phase 5) and a hit that launches none, with
   bitwise the same T, io maps, counts, history and solution; then
   ``run_config(ddh_512_block32)`` cold and warm, prepare seconds against
   load seconds.
22. The patch io path against the gather path at the ``helmholtz_ddh_1e6``
   DDH of phase 12 (the grid numbering; its P took the patch path): rhs and
   postprocess within 1e-5 (fp32), both timed with CUDA events.
23. nx 512 / block 16 (16,384 subdomains, 1,701,896 lambda unknowns):
   ``run_ddh`` one level, <= 90 restarts (JAX on the TPU: 88 / 1,846), and
   two-level multiplicative on the iterative coarse space (4 directions, one
   subdomain per superdomain, coarse solve (20, 2, 3e-2): nc 294,912),
   <= 23 restarts (JAX: 21 / 438); each succeeds with a plain-cycle
   residual <= 1.2e-4, launches the sparse kernel in layout (a) only in
   ``prepare``, and a repeated solve launches none and repeats bitwise.
   Then the sparse kernel against the plain cycle on its probe rows.
24. ``large_unstructured --levels 3 --domains 256 --coarse multiplicative``
   through ``run_case``: success in <= 21 restarts (phase 9's JAX 18 + 3),
   only the sparse grouped kernel launched.
Every comparison holds a kernel within 2e-4 of the plain cycle relative to
the max of u and v, with padded slots exactly 0.  The main-path runs
(phases 3, 5, 6, 7, 9, 12, 13, 16, 17, 18, 19, 21, 23, 24) must launch the
sparse kernel and no dense one.

Every kernel count is set to 0 just before each main-path run and read just
after; the ``launches`` of a kernel in the JSON line is the sum over those
runs.  Comparisons run after the main-path runs and are not counted.
``bound_ms`` is the larger of the FP32 FMA work on the non-zeros of S
(2 products of the rows by the exact non-zeros per leapfrog step) over
67 TFLOP/s and the bytes read once (F, G, Ha, mi, tables and S's sparse
form) and written once (u, v) over 3.35 TB/s (H100 SXM peaks), the same
for the sparse and the dense kernels, which compute the same function; no
single PyTorch call computes a WaveHoltz cycle, so ``library_ms`` is null.

Output: diagnostics, then a ``{"kernels": [...]}`` JSON line, the
``nvidia-smi`` line, and last ``{"ok": true, "device": {...}}``.  Exits
non-zero, printing no result, when there is no CUDA device.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np


def _fail(msg: str) -> None:
    raise RuntimeError(f"chip_smoke: {msg}")


def _timed(fn, reps: int = 1):
    """(last result, mean CUDA-event milliseconds per call) of ``reps``
    calls of ``fn`` on the current stream."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end) / reps


def _rel_max(got, want) -> float:
    return float((got - want).abs().max() / want.abs().max().clamp_min(1e-30))


PEAK_FP32_FLOPS = 67e12  # H100 SXM, FP32 outside the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DENSE = ("shared", "grouped", "streamed_shared", "streamed_grouped")


def _cycle_flop(form, group_rows: int, nt: int, wh_maxit: int) -> float:
    """FLOP one cycle needs on the non-zeros of S: two products per step of
    ``group_rows`` rows by each group's exact non-zeros."""
    return 2.0 * 2 * wh_maxit * nt * group_rows * float(form.ptr[:, -1].double().sum())


def _cycle_bound(form, group_rows: int, rows: int, pad: int, nt: int,
                 wh_maxit: int) -> tuple[float, str]:
    """Least time of one cycle on these operands: the FMA work on the
    non-zeros of S against the FP32 peak, or the bytes read (F, G, Ha, mi,
    tables, and S's non-zeros with their column offsets and order) and
    written (u, v) once against the memory rate, whichever is larger."""
    ng = form.ptr.shape[0]
    form_bytes = 6.0 * float(form.ptr[:, -1].double().sum()) + ng * (4.0 * (pad + 1) + 2.0 * pad)
    nbytes = 4.0 * (6 * rows * pad + 5 * nt) + form_bytes
    t_ops = _cycle_flop(form, group_rows, nt, wh_maxit) / PEAK_FP32_FLOPS
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _compare(wc, p, F, G, wh_maxit, pad_mask, what, variants, reps=3, form=None, **kw):
    """Each kernel ``variants`` names against the plain cycle on the same
    inputs; raises on a relative error >= 2e-4 or non-zero padding.  Returns
    ({variant: (max abs err, ms)}, plain ms, {variant: (u, v)}).  The plain
    cycle is timed on its checked call; the kernels after their checked
    calls, in turns (v0, v1, ..., v1, v0), ``reps`` launches a turn, so
    each pair is compared on the card's state of the moment.  ``form`` is
    the sparse kernel's prebuilt sparse form."""
    import torch

    def run(v):
        return wc.wave_cycle(p, F, G, wh_maxit, variant=v, sparse=form if v == "sparse" else None,
                             **kw)

    outs = {v: run(v) for v in variants}
    torch.cuda.synchronize()
    (u_p, v_p), plain_ms = _timed(lambda: wc.wave_cycle_plain(p, F, G, wh_maxit, **kw))
    errs = {}
    for v, (u_k, v_k) in outs.items():
        err_u, err_v = _rel_max(u_k, u_p), _rel_max(v_k, v_p)
        errs[v] = max(float((u_k - u_p).abs().max()), float((v_k - v_p).abs().max()))
        if not (np.isfinite([err_u, err_v]).all() and err_u < 2e-4 and err_v < 2e-4):
            _fail(f"{what}: {v} kernel disagrees with the plain cycle: rel u {err_u:.3e}, "
                  f"v {err_v:.3e}")
        if bool((u_k[pad_mask] != 0).any()) or bool((v_k[pad_mask] != 0).any()):
            _fail(f"{what}: {v} kernel wrote non-zero values into padded slots")
        print(f"{what}: {v} rel err u {err_u:.3e} v {err_v:.3e}, max abs err {errs[v]:.3e}")
    del u_p, v_p
    times = {v: [] for v in variants}
    for v in [*variants, *reversed(variants)]:
        times[v].append(_timed(lambda: run(v), reps)[1])
    res = {v: (errs[v], sum(t) / len(t)) for v, t in times.items()}
    print(f"{what}: plain {plain_ms:.3f} ms; " + "; ".join(
        f"{v} {ms:.3f} ms (turns {', '.join(f'{t:.3f}' for t in times[v])})"
        for v, (_, ms) in res.items()))
    return res, plain_ms, outs


def _form_ms(wc, S):
    """(sparse form of S, CUDA-event ms of its build after one untimed build,
    which pays the first use of the torch ops)."""
    wc.sparse_form(S)
    return _timed(lambda: wc.sparse_form(S))


def _nnz(form) -> int:
    """The largest nnz over the form's groups."""
    return int(form.ptr[:, -1].max())


def _rates(what, flop_sparse, rows, pad, nt, wh_maxit, res, bound, by):
    """Print sparse and dense-equivalent TFLOP/s of each kernel."""
    flop_dense = 2.0 * 2 * wh_maxit * nt * rows * pad * pad
    print(f"{what}: bound {bound:.3f} ms ({by}); {flop_sparse:.3e} FLOP on the non-zeros, "
          f"{flop_dense:.3e} on the dense shape; " + "; ".join(
              f"{v} {flop_sparse / ms / 1e9:.2f} TFLOP/s sparse, "
              f"{flop_dense / ms / 1e9:.2f} dense-equivalent"
              for v, (_, ms) in res.items()))


def _only_sparse(launches, key, what):
    if launches[f"sparse_{key}"] == 0 or any(launches[k] for k in DENSE):
        _fail(f"{what}: want sparse layout-({'a' if key == 'shared' else 'b'}) launches and "
              f"no dense ones, got {launches}")


def _masked_normal(rng, mask, dev):
    import torch

    return torch.from_numpy((rng.standard_normal(mask.shape) * mask).astype(np.float32)).to(dev)


def _plain_residual(wc, ddh, b, lam):
    """||Y - A(x)|| / ||Y|| with rhs and action on the direct path through
    the plain cycle; for a (K, n) block of sources (one plain cycle over
    their K ndom rows) the list of each source's."""
    import torch

    from cuddhelmholtz_tpu_torch.solvers.ddh import ddh_action, ddh_rhs

    Y = ddh_rhs(ddh.params, b, ddh.g_ndof, ddh.n_lambda, wh_maxit=ddh.wh_maxit,
                cycle=wc.wave_cycle_plain)
    AX = ddh_action(ddh.params, lam, n_own=ddh.n_own, wh_maxit=ddh.wh_maxit,
                    cycle=wc.wave_cycle_plain)
    rel = torch.linalg.vector_norm(Y - AX, dim=-1) / torch.linalg.vector_norm(Y, dim=-1)
    return rel.tolist()


def _transfer_run(wc, run, what, max_restarts, jax_matvecs, matvec_slack, gm,
                  jax_restarts=None):
    """Drive one transfer-path run; check it and return (result, launches by
    kernel and layout during the run).  With ``jax_restarts`` the restarts
    must be within one of it."""
    import torch

    from cuddhelmholtz_tpu_torch.examples.drivers import point_sources
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs

    wc.reset_launches()
    res = run()
    launches = dict(wc.wave_cycle.launches)
    ddh = res.extra["ddh"]
    pre = res.extra["precompute"]
    omega = res.extra["omega"]
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, omega)).to(ddh.gmask.device)
    # the same solve again on the prepared operator: it must launch no kernel
    wc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2, _ = ddh.solver(gm.m, gm.maxit, gm.tol)(b)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    solve_launches = sum(wc.wave_cycle.launches.values())
    print(f"{what}: success={res.success} restarts={res.num_iter} matvecs={res.num_matvec} "
          f"solve {res.seconds:.3f} s (again: {warm_s:.3f} s, {out2.num_iter} restarts / "
          f"{out2.num_matvec} matvecs), io path {ddh.io_path}, "
          f"setup {res.extra['setup_seconds']:.2f} s; prepare: "
          f"transfer {pre['transfer_seconds']:.3f} s ({pre['transfer_rows']} rows, "
          f"{pre['transfer_layout']}), io {pre['io_seconds']:.3f} s ({pre['io_rows']} rows, "
          f"{pre['io_layout']}), nu={pre['transfer_nu']} of {res.extra['n_domains']} domains; "
          f"launches during run {launches}, during the repeated solve {solve_launches}; "
          f"residual history {res.res_norm[0]:.6e} -> {res.res_norm[-1]:.6e}")
    print(f"{what} precompute stats: {json.dumps(pre)}")
    if not res.success:
        _fail(f"{what}: solve did not converge")
    if res.num_iter > max_restarts:
        _fail(f"{what}: {res.num_iter} restarts (> {max_restarts})")
    if jax_restarts is not None and abs(res.num_iter - jax_restarts) > 1:
        _fail(f"{what}: {res.num_iter} restarts, JAX {jax_restarts} (+-1)")
    if abs(res.num_matvec - jax_matvecs) > matvec_slack:
        _fail(f"{what}: {res.num_matvec} matvecs, JAX {jax_matvecs} (+-{matvec_slack})")
    if solve_launches != 0:
        _fail(f"{what}: the repeated solve launched {solve_launches} kernels")
    if res.solution.shape != (2 * res.extra["ndof"],) or not np.isfinite(res.solution).all():
        _fail(f"{what}: solution has shape {res.solution.shape} or non-finite values")
    resid = _plain_residual(wc, ddh, b, res.extra["lam"])
    print(f"{what} plain-cycle check: ||Y - A(x)|| / ||Y|| = {resid:.3e}")
    if not resid <= 1.2 * gm.tol:
        _fail(f"{what}: plain-cycle residual {resid:.3e} > {1.2 * gm.tol:.2e}")
    return res, launches


def _cache_pair(wc, run, what, cache_dir):
    """Run ``run`` twice in the cache directory ``cache_dir``: a miss, then a
    hit that must launch no kernel and reproduce the first run bitwise (T,
    groups, io maps, counts, history, solution).  Returns (the cold result,
    its launches)."""
    import torch

    wc.reset_launches()
    cold = run()
    l_cold = dict(wc.wave_cycle.launches)
    wc.reset_launches()
    warm = run()
    n_warm = sum(wc.wave_cycle.launches.values())
    pc, pw = cold.extra["precompute"], warm.extra["precompute"]
    cd, wd = cold.extra["ddh"], warm.extra["ddh"]
    same = {
        "T": np.array_equal(cd._T_u, wd._T_u),
        "groups": np.array_equal(cd._T_groups, wd._T_groups),
        "io": all(torch.equal(getattr(cd.io, n), getattr(wd.io, n))
                  for n in ("Pu", "Pv", "R", "Pul", "Pvl")),
        "counts": (cold.num_iter, cold.num_matvec) == (warm.num_iter, warm.num_matvec),
        "history": np.array_equal(cold.res_norm, warm.res_norm),
        "solution": np.array_equal(cold.solution, warm.solution),
    }
    size = os.path.getsize(os.path.join(cache_dir, f"ddh_{cd.setup_cache_key()}.npz"))
    print(f"{what}: cold run (hit={pc['cache_hit']}) prepare "
          f"{pc['transfer_seconds'] + pc['io_seconds']:.3f} s (transfer "
          f"{pc['transfer_seconds']:.3f} s, io {pc['io_seconds']:.3f} s), launches {l_cold}, "
          f"solve {cold.seconds:.3f} s, {cold.num_iter} / {cold.num_matvec}; cache file "
          f"{size} B; warm run (hit={pw['cache_hit']}) load {pw['load_seconds']:.3f} s, "
          f"{n_warm} launches, solve {warm.seconds:.3f} s, {warm.num_iter} / "
          f"{warm.num_matvec}; setup {cold.extra['setup_seconds']:.3f} s against "
          f"{warm.extra['setup_seconds']:.3f} s; bitwise the same: {same}")
    if pc["cache_hit"] or not pw["cache_hit"]:
        _fail(f"{what}: want a miss then a hit, got {pc['cache_hit']}, {pw['cache_hit']}")
    if n_warm != 0:
        _fail(f"{what}: the cache hit launched {n_warm} kernels")
    if not all(same.values()):
        _fail(f"{what}: the hit does not reproduce the cold run: {same}")
    return cold, l_cold


def _level_run(wc, run, what, max_restarts, coarse, gm):
    """Drive one nx 512 run (one level, or two-level with ``coarse``) and
    check it: success within ``max_restarts``, the sparse layout-(a) kernel
    only (in ``prepare``: a repeated solve launches none and repeats the
    run bitwise) and the plain-cycle residual.  Returns (result, launches,
    seconds of the repeated solve)."""
    import torch

    from cuddhelmholtz_tpu_torch.examples.drivers import point_sources
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs

    wc.reset_launches()
    res = run()
    launches = dict(wc.wave_cycle.launches)
    ddh, pre = res.extra["ddh"], res.extra["precompute"]
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, res.extra["omega"]))
    b = b.to(ddh.gmask.device)
    solve = ddh.solver(gm.m, gm.maxit, gm.tol, coarse=coarse)
    wc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2, U2 = solve(b)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    again = sum(wc.wave_cycle.launches.values())
    bitwise = (torch.equal(out2.x, res.extra["lam"])
               and np.array_equal(out2.res_norm[: out2.n_hist].cpu().numpy(), res.res_norm)
               and np.array_equal(U2.cpu().numpy(), res.solution))
    resid = _plain_residual(wc, ddh, b, res.extra["lam"])
    print(f"{what}: success={res.success} restarts={res.num_iter} matvecs={res.num_matvec} "
          f"solve {res.seconds:.3f} s, repeated solve {again_s:.3f} s ({again} launches, "
          f"bitwise the same: {bitwise}); setup {res.extra['setup_seconds']:.3f} s (prepare "
          f"{pre['transfer_seconds'] + pre['io_seconds']:.3f} s: transfer "
          f"{pre['transfer_seconds']:.3f} s, {pre['transfer_rows']} rows, io "
          f"{pre['io_seconds']:.3f} s; nu={pre['transfer_nu']}; coarse build "
          f"{res.extra.get('coarse_seconds', 0.0):.3f} s); io path {ddh.io_path}; launches "
          f"{launches}; plain-cycle residual {resid:.3e}; history {res.res_norm[0]:.6e} -> "
          f"{res.res_norm[-1]:.6e}; peak memory {torch.cuda.max_memory_allocated()} B")
    if not res.success or res.num_iter > max_restarts:
        _fail(f"{what}: success={res.success}, {res.num_iter} restarts (> {max_restarts}?)")
    _only_sparse(launches, "shared", what)
    if again != 0 or not bitwise:
        _fail(f"{what}: the repeated solve launched {again} kernels or differs ({bitwise})")
    if not resid <= 1.2 * gm.tol:
        _fail(f"{what}: plain-cycle residual {resid:.3e} > {1.2 * gm.tol:.2e}")
    if res.solution.shape != (2 * res.extra["ndof"],) or not np.isfinite(res.solution).all():
        _fail(f"{what}: solution has shape {res.solution.shape} or non-finite values")
    return res, launches, again_s


def _ms_per_call(fn, device, reps: int = 5) -> float:
    """Host-clock milliseconds per call of ``fn`` after one warm-up call,
    synchronised on the card (for host-bound work of many launches)."""
    import torch

    fn()
    torch.cuda.synchronize(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize(device)
    return 1e3 * (time.perf_counter() - t0) / reps


def _composite_run(wc, run, what, max_restarts, fem, dev):
    """Drive one ``run_helmholtz_ddh`` run and check it: success, restarts,
    refinement steps, the sparse kernel only in ``prepare`` (P launches no
    kernel) and the true fp64 relative residual with the generic operator
    on ``fem`` (the space the solve ran on; the solution comes back in H1
    numbering and is mapped onto it).  Returns (result, launches during the
    run, and a dict of the generic fp64 operator ``op``, the rhs ``b``, the
    solution ``U`` on ``fem``, the face space ``fs``, the projected
    coefficients ``a2``, ``af`` and the ms per P ``p_ms``)."""
    import torch

    from cuddhelmholtz_tpu_torch.examples.drivers import point_sources, wave_speed_coeff
    from cuddhelmholtz_tpu_torch.models.helmholtz import (
        apply_helmholtz,
        helmholtz_rhs,
        make_helmholtz_op,
        project_coefficients,
    )
    from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space

    wc.reset_launches()
    res = run()
    launches = dict(wc.wave_cycle.launches)
    ex = res.extra
    pre = ex["precompute"]
    P = ex["precond"]
    n2 = 2 * ex["ndof"]
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(n2)).to(dev)
    wc.reset_launches()
    p_ms = _ms_per_call(lambda: P(v), dev)
    p_launches = sum(wc.wave_cycle.launches.values())
    p_repeats = [bool(torch.equal(P(v), P(v))) for _ in range(2)]
    first = ex["first_run"]
    same_hist = first["res_norm"] == list(res.res_norm)
    prepare_s = pre["transfer_seconds"] + pre["io_seconds"]
    print(f"{what}: success={res.success} restarts={res.num_iter} matvecs={res.num_matvec} "
          f"io path in P {ex['ddh'].io_path}, "
          f"refine_steps={ex['refine_steps']} stagnated={ex['stagnated']} "
          f"inner tols {ex['inner_tols']}; true residual history {list(res.res_norm)} "
          f"(rel {res.res_norm[-1] / res.res_norm[0]:.3e}); solve {res.seconds:.3f} s, warm "
          f"{ex['warm_seconds']:.3f} s, setup {ex['setup_seconds']:.3f} s (prepare "
          f"{prepare_s:.3f} s: transfer {pre['transfer_seconds']:.3f} s, io "
          f"{pre['io_seconds']:.3f} s, nu={pre['transfer_nu']}); P applied {ex['n_precond']} "
          f"times in the warm run, {p_ms:.3f} ms per P alone ({p_launches} launches), "
          f"{1e3 * ex['warm_seconds'] / ex['n_precond']:.3f} ms of warm solve per P; "
          f"launches during run {launches}; first run {first['num_iter']} / "
          f"{first['num_matvec']}, history bitwise as the warm run's: {same_hist}; P repeats "
          f"bitwise: {p_repeats}")
    if not res.success or ex["stagnated"]:
        _fail(f"{what}: success={res.success}, stagnated={ex['stagnated']}")
    if res.num_iter > max_restarts or ex["refine_steps"] > 6:
        _fail(f"{what}: {res.num_iter} restarts (> {max_restarts}) or "
              f"{ex['refine_steps']} refinement steps (> 6)")
    if p_launches != 0:
        _fail(f"{what}: P launched {p_launches} kernels")
    if not all(p_repeats) or (first["num_iter"], first["num_matvec"]) != (
            res.num_iter, res.num_matvec):
        _fail(f"{what}: P does not repeat bitwise ({p_repeats}) or the first run's counts "
              f"{first['num_iter']} / {first['num_matvec']} differ from the warm run's")
    if not np.isfinite(res.solution).all() or res.solution.shape != (n2,):
        _fail(f"{what}: solution has shape {res.solution.shape} or non-finite values")
    # the generic fp64 operator on the same data, on the space of the solve
    fs = FaceSpace(fem, fem.mesh.boundary_edges)
    a2, af = project_coefficients(fem, fs, wave_speed_coeff)
    op = make_helmholtz_op(ex["omega"], a2, af, fem, fs, kron=False, device=dev)
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, ex["omega"])).to(dev)
    nd = ex["ndof"]
    ref = H1Space(fem.mesh, fem.basis)
    r2f = np.zeros(nd, np.int64)  # H1 dof -> dof of fem at the same node
    r2f[ref.dofs.reshape(-1)] = fem.dofs.reshape(-1)
    U = np.zeros(n2)
    U[np.concatenate([r2f, nd + r2f])] = res.solution
    U = torch.from_numpy(U).to(dev)
    rel = float(torch.linalg.vector_norm(b - apply_helmholtz(op, U)) / torch.linalg.vector_norm(b))
    print(f"{what}: true relative residual with the generic fp64 operator {rel:.3e}")
    if not rel <= 1e-6:
        _fail(f"{what}: generic fp64 relative residual {rel:.3e} > 1e-6")
    return res, launches, dict(op=op, b=b, U=U, fs=fs, a2=a2, af=af, p_ms=p_ms)


def _subprocess_json(cmd: list[str], what: str, **env) -> dict:
    """Run ``cmd`` from the repository root (extra ``env`` variables set);
    it must exit 0 and print one JSON object as its last stdout line, which
    is returned."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run(cmd, capture_output=True, text=True, timeout=900, cwd=root,
                       env={**os.environ, **env})
    lines = p.stdout.strip().splitlines()
    if p.returncode != 0 or not lines:
        _fail(f"{what} exited {p.returncode}: {p.stdout[-2000:]} {p.stderr[-2000:]}")
    if len(lines) != 1:
        _fail(f"{what} printed {len(lines)} lines on stdout, want one JSON line")
    return json.loads(lines[0])


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1
    t_main = time.perf_counter()
    # phases 1-20 (and their subprocesses) run with the setup cache off:
    # phase 16 counts the probes of two prepares of one partition
    os.environ["CUDDH_CACHE_DIR"] = ""

    from cuddhelmholtz_tpu_torch.config import DDH_512_BLOCK32 as bcfg
    from cuddhelmholtz_tpu_torch.config import DDH_STRUCTURED as cfg
    from cuddhelmholtz_tpu_torch.config import DDH_UNSTRUCTURED_SQUARE as ucfg
    from cuddhelmholtz_tpu_torch.examples import large_unstructured as lu
    from cuddhelmholtz_tpu_torch.examples.drivers import (
        point_sources,
        run_config,
        run_ddh,
        wave_speed_coeff,
    )
    from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.mesh.refine import refine_quad_mesh
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
    from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc
    from cuddhelmholtz_tpu_torch.ops.functional import linear_functional
    from cuddhelmholtz_tpu_torch.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
    from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
    from cuddhelmholtz_tpu_torch.spaces.ensemble import coordinate_bisection_labels
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
    lib_paths = wc.build()
    for variant in lib_paths:
        wc._library(variant)
    print(f"build: {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(path.name for path in lib_paths.values())}")
    for path in lib_paths.values():
        print(path.with_suffix(".log").read_text().strip())

    # --- 2. kernels vs plain at the flagship shape ------------------------------
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
    form_a, form_ms_a = _form_ms(wc, p.S)
    nnz_a = _nnz(form_a)
    print(f"flagship sparse form: nnz {nnz_a} (dense {ddh.pad ** 2}), stride {form_a.stride}, "
          f"built in {form_ms_a:.3f} ms")
    rng = np.random.default_rng(0)
    gmask = ddh.gmask.cpu().numpy()
    F = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32)).to(dev)
    G = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32)).to(dev)

    res_a, plain_ms, uv_a = _compare(wc, p, F, G, ddh.wh_maxit, ddh.gmask == 0,
                                     "wave cycle (a), flagship", ("sparse", "resident"),
                                     form=form_a)
    bound_a, by_a = _cycle_bound(form_a, ddh.n_domains, ddh.n_domains, ddh.pad, ddh.nt,
                                 ddh.wh_maxit)
    _rates("wave cycle (a), flagship", _cycle_flop(form_a, ddh.n_domains, ddh.nt, ddh.wh_maxit),
           ddh.n_domains, ddh.pad, ddh.nt, ddh.wh_maxit, res_a, bound_a, by_a)
    shapes = {"sparse_shared": [], "sparse_grouped": []}
    shapes["sparse_shared"].append({
        "at": f"flagship, {ddh.n_domains} rows, pad {ddh.pad}, nt {ddh.nt}", "nnz": nnz_a,
        "stride": form_a.stride, "form_ms": form_ms_a, "ms": res_a["sparse"][1], "dense_ms": res_a["resident"][1],
        "dense": "resident", "plain_ms": plain_ms, "bound_ms": bound_a, "bound_by": by_a,
    })

    # --- 3. the flagship solve, direct path ------------------------------------
    wc.reset_launches()
    res = run_ddh(nx=nx, deg=deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit, tol=cfg.gmres.tol,
                  wh_maxit=cfg.wh_maxit, block_size=cfg.block_size, transfer=False,
                  device=dev)
    launches = dict(wc.wave_cycle.launches)
    print(f"flagship solve: success={res.success} restarts={res.num_iter} "
          f"matvecs={res.num_matvec} launches={launches} solve {res.seconds:.3f} s "
          f"({1e3 * res.seconds / (res.num_matvec + 2):.3f} ms per cycle incl. GMRES) "
          f"setup {res.extra['setup_seconds']:.2f} s (sparse form "
          f"{1e3 * res.extra['ddh'].sparse_seconds:.3f} ms); residual history "
          f"{res.res_norm[0]:.6e} -> {res.res_norm[-1]:.6e} "
          f"(rel {res.res_norm[-1] / res.res_norm[0]:.3e})")
    if not res.success:
        _fail("flagship solve did not converge")
    if res.num_iter > 20:
        _fail(f"flagship solve took {res.num_iter} restarts (> 20)")
    if launches != {**dict.fromkeys(launches, 0), "sparse_shared": res.num_matvec + 2}:
        _fail(f"kernel launches {launches}: want num_matvec + 2 = {res.num_matvec + 2} "
              "sparse layout-(a) launches and no other")
    U = res.solution
    if U.shape != (2 * res.extra["ndof"],) or not np.isfinite(U).all():
        _fail(f"solution has shape {U.shape} or non-finite values")
    sddh = res.extra["ddh"]
    b = helmholtz_rhs(sddh.space, lambda xy: point_sources(xy, omega)).to(dev)
    resid = _plain_residual(wc, sddh, b, res.extra["lam"])
    print(f"plain-cycle check: ||Y - A(x)|| / ||Y|| = {resid:.3e}")
    if not resid <= 1.2e-4:
        _fail(f"plain-cycle residual {resid:.3e} > 1.2e-4")
    del res, sddh
    total = dict(launches)

    # --- 4. layouts (b) and (c) at the unstructured-square shapes -------------
    mesh = load_unstructured_square()
    labels, _ = coordinate_bisection_labels(mesh, ucfg.n_domains)
    ufem = H1Space(mesh, Basis(ucfg.deg + 1))
    ua = apply_diag_inv_mass(
        make_diag_inv_mass_op(ufem), linear_functional(ufem, wave_speed_coeff)
    ).numpy()
    uddh = DDH(ucfg.omega, ua, ufem, element_labels=labels, wh_maxit=ucfg.wh_maxit,
               device=dev)
    up = uddh.params
    uidx, _, nu = uddh._domain_groups()
    c = 2 * uddh.fslot.shape[1]  # transfer probe columns per unique domain
    print(f"unstructured DDH: ndom={uddh.n_domains} nu={nu} pad={uddh.pad} pf={c // 2} "
          f"nt={uddh.nt} S {tuple(up.S.shape)}")
    if up.S.dim() != 3 or c % wc.ROWS_PER_BLOCK:
        _fail("unstructured stiffness is not per-domain or the probe runs are not 8-aligned")
    ui = torch.as_tensor(uidx, device=dev)
    gp = up._replace(S=up.S[ui].contiguous(), Ha=up.Ha[ui].repeat_interleave(c, 0),
                     inv_mi=up.inv_mi[ui].repeat_interleave(c, 0))
    form_b, form_ms_b = _form_ms(wc, gp.S)
    gmask = uddh.gmask[ui].repeat_interleave(c, 0)
    gm = gmask.cpu().numpy()
    Fb, Gb = _masked_normal(rng, gm, dev), _masked_normal(rng, gm, dev)
    what = f"wave cycle (b), {nu * c} rows in runs of {c}"
    res_b, plain_ms_b, _ = _compare(wc, gp, Fb, Gb, uddh.wh_maxit, gmask == 0, what,
                                    ("sparse", "resident"), form=form_b, s_group_size=c)
    bound_b, by_b = _cycle_bound(form_b, c, nu * c, uddh.pad, uddh.nt, uddh.wh_maxit)
    _rates(what, _cycle_flop(form_b, c, uddh.nt, uddh.wh_maxit), nu * c, uddh.pad, uddh.nt,
           uddh.wh_maxit, res_b, bound_b, by_b)
    shapes["sparse_grouped"].append({
        "at": f"unstructured transfer probe, {nu} runs of {c} rows, pad {uddh.pad}, "
              f"nt {uddh.nt}", "nnz": _nnz(form_b),
        "stride": form_b.stride, "form_ms": form_ms_b,
        "ms": res_b["sparse"][1], "dense_ms": res_b["resident"][1], "dense": "resident",
        "plain_ms": plain_ms_b, "bound_ms": bound_b, "bound_by": by_b,
    })
    um = uddh.gmask.cpu().numpy()
    Fc, Gc = _masked_normal(rng, um, dev), _masked_normal(rng, um, dev)
    what = f"wave cycle (c), {uddh.n_domains} rows tiled x{wc.ROWS_PER_BLOCK}"
    res_c, plain_ms_c, _ = _compare(wc, up, Fc, Gc, uddh.wh_maxit, uddh.gmask == 0, what,
                                    ("sparse", "resident"), form=uddh.S_sparse)
    bound_c, by_c = _cycle_bound(uddh.S_sparse, 1, uddh.n_domains, uddh.pad, uddh.nt,
                                 uddh.wh_maxit)
    print(f"{what}: bound {bound_c:.3f} ms ({by_c}) for the {uddh.n_domains} rows it computes")
    shapes["sparse_grouped"].append({
        "at": f"unstructured per-row (c), {uddh.n_domains} rows tiled x{wc.ROWS_PER_BLOCK}",
        "nnz": _nnz(uddh.S_sparse), "stride": uddh.S_sparse.stride,
        "form_ms": 1e3 * uddh.sparse_seconds,
        "ms": res_c["sparse"][1], "dense_ms": res_c["resident"][1], "dense": "resident",
        "plain_ms": plain_ms_c, "bound_ms": bound_c, "bound_by": by_c,
    })
    del uddh, gp, Fb, Gb

    # --- 5. the flagship transfer solve ----------------------------------------
    res5, launches = _transfer_run(
        wc, lambda: run_ddh(nx=nx, deg=deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit,
                            tol=cfg.gmres.tol, wh_maxit=cfg.wh_maxit,
                            block_size=cfg.block_size, transfer=True, device=dev),
        "flagship transfer solve", max_restarts=20, jax_matvecs=366,
        matvec_slack=cfg.gmres.m + 1, gm=cfg.gmres)
    _only_sparse(launches, "shared", "flagship transfer path")
    for k in total:
        total[k] += launches[k]
    counts5 = (res5.num_iter, res5.num_matvec)
    del res5

    # --- 6. the unstructured square at full size --------------------------------
    res6, launches = _transfer_run(
        wc, lambda: run_config(ucfg, device=dev), "unstructured transfer solve",
        max_restarts=100, jax_matvecs=668, matvec_slack=2 * (ucfg.gmres.m + 1),
        gm=ucfg.gmres)
    _only_sparse(launches, "grouped", "unstructured transfer path")
    for k in total:
        total[k] += launches[k]
    del res6

    # --- 7. ddh_512_block32, transfer path: probes run the sparse kernel ------
    res7, launches = _transfer_run(
        wc, lambda: run_config(bcfg, device=dev), "ddh_512_block32 transfer solve",
        max_restarts=bcfg.gmres.maxit, jax_matvecs=522, matvec_slack=bcfg.gmres.m + 1,
        gm=bcfg.gmres, jax_restarts=25)
    bddh = res7.extra["ddh"]
    if (bddh.pad, bddh.shared_S, bddh.n_domains) != (632, True, 4096):
        _fail(f"ddh_512_block32: pad {bddh.pad}, shared_S {bddh.shared_S}, "
              f"{bddh.n_domains} domains; want 632, True, 4096")
    _only_sparse(launches, "shared", "ddh_512_block32 probes")
    for k in total:
        total[k] += launches[k]

    # --- 8. sparse and streamed layout (a) vs plain on its transfer-probe rows
    uidx, _, nu = bddh._domain_groups()
    c = 2 * bddh._fslot_np.shape[1]
    ui = torch.as_tensor(uidx, device=dev)
    bp = bddh.params
    pa = bp._replace(Ha=bp.Ha[ui].repeat(c, 1), inv_mi=bp.inv_mi[ui].repeat(c, 1))
    form_sa, form_ms_sa = _form_ms(wc, pa.S)
    amask = bddh.gmask[ui].repeat(c, 1)
    am = amask.cpu().numpy()
    Fa, Ga = _masked_normal(rng, am, dev), _masked_normal(rng, am, dev)
    rows_sa, pad_sa, nt_sa = nu * c, bddh.pad, bddh.nt
    what = f"layout (a), ddh_512_block32 transfer probe ({nu} x {c} rows, pad {pad_sa})"
    res_sa, plain_ms_sa, _ = _compare(wc, pa, Fa, Ga, bddh.wh_maxit, amask == 0, what,
                                      ("sparse", "streamed"), reps=1, form=form_sa)
    bound_sa, by_sa = _cycle_bound(form_sa, rows_sa, rows_sa, pad_sa, nt_sa, bddh.wh_maxit)
    _rates(what, _cycle_flop(form_sa, rows_sa, nt_sa, bddh.wh_maxit), rows_sa, pad_sa, nt_sa,
           bddh.wh_maxit, res_sa, bound_sa, by_sa)
    shapes["sparse_shared"].append({
        "at": f"ddh_512_block32 transfer probe, {rows_sa} rows, pad {pad_sa}, nt {nt_sa}",
        "nnz": _nnz(form_sa), "stride": form_sa.stride, "form_ms": form_ms_sa, "ms": res_sa["sparse"][1],
        "dense_ms": res_sa["streamed"][1], "dense": "streamed", "plain_ms": plain_ms_sa,
        "bound_ms": bound_sa, "bound_by": by_sa,
    })
    del res7, bddh, bp, pa, Fa, Ga, amask
    torch.cuda.empty_cache()

    # --- 9. large_unstructured L3, 256 domains: grouped sparse probes ---------
    lmesh = refine_quad_mesh(load_unstructured_square(), 3)
    lomega = 2 * np.pi / (5.0 * lu.median_h(lmesh))
    res9, launches = _transfer_run(
        wc, lambda: lu.solve_case(lmesh, 256, 3, lomega, ucfg.gmres.tol, device=dev),
        "large_unstructured L3 transfer solve", max_restarts=ucfg.gmres.maxit,
        jax_matvecs=373, matvec_slack=ucfg.gmres.m + 1, gm=ucfg.gmres, jax_restarts=18)
    rec = lu.case_record("unstructured_L3", lmesh, res9)
    print(f"large_unstructured record: {json.dumps(rec)}")
    lddh = res9.extra["ddh"]
    pre = res9.extra["precompute"]
    if (lddh.pad, lddh.shared_S, pre["transfer_nu"], pre["transfer_layout"]) != (
            320, False, 256, "grouped"):
        _fail(f"L3: pad {lddh.pad}, shared_S {lddh.shared_S}, nu {pre['transfer_nu']}, "
              f"layout {pre['transfer_layout']}; want 320, False, 256, grouped")
    _only_sparse(launches, "grouped", "L3 probes")
    launches9 = dict(launches)
    for k in total:
        total[k] += launches[k]

    # --- 10. sparse and streamed layout (b) vs plain on its transfer-probe rows
    uidx, _, nu = lddh._domain_groups()
    c = 2 * lddh._fslot_np.shape[1]
    ui = torch.as_tensor(uidx, device=dev)
    lp = lddh.params
    pb = lp._replace(S=lp.S[ui].contiguous(), Ha=lp.Ha[ui].repeat_interleave(c, 0),
                     inv_mi=lp.inv_mi[ui].repeat_interleave(c, 0))
    form_sb, form_ms_sb = _form_ms(wc, pb.S)
    bmask = lddh.gmask[ui].repeat_interleave(c, 0)
    bm = bmask.cpu().numpy()
    Fb, Gb = _masked_normal(rng, bm, dev), _masked_normal(rng, bm, dev)
    rows_sb, pad_sb, nt_sb = nu * c, lddh.pad, lddh.nt
    what = f"layout (b), L3 transfer probe ({nu} runs of {c} rows, pad {pad_sb})"
    res_sb, plain_ms_sb, _ = _compare(wc, pb, Fb, Gb, lddh.wh_maxit, bmask == 0, what,
                                      ("sparse", "streamed"), reps=1, form=form_sb,
                                      s_group_size=c)
    bound_sb, by_sb = _cycle_bound(form_sb, c, rows_sb, pad_sb, nt_sb, lddh.wh_maxit)
    _rates(what, _cycle_flop(form_sb, c, nt_sb, lddh.wh_maxit), rows_sb, pad_sb, nt_sb,
           lddh.wh_maxit, res_sb, bound_sb, by_sb)
    shapes["sparse_grouped"].append({
        "at": f"L3 transfer probe, {nu} runs of {c} rows, pad {pad_sb}, nt {nt_sb}",
        "nnz": _nnz(form_sb), "stride": form_sb.stride, "form_ms": form_ms_sb, "ms": res_sb["sparse"][1],
        "dense_ms": res_sb["streamed"][1], "dense": "streamed", "plain_ms": plain_ms_sb,
        "bound_ms": bound_sb, "bound_by": by_sb,
    })
    del res9, lddh, lp, pb, Fb, Gb, bmask
    torch.cuda.empty_cache()

    # --- 11. streamed against resident and sparse at the flagship shape -------
    res_s176, _, uv_s = _compare(wc, p, F, G, ddh.wh_maxit, ddh.gmask == 0,
                                 "streamed (a) forced, flagship", ("sparse", "streamed"),
                                 form=form_a)
    u_s, v_s = uv_s["streamed"]
    for v in ("resident", "sparse"):
        err = max(_rel_max(u_s, uv_a[v][0]), _rel_max(v_s, uv_a[v][1]))
        print(f"streamed vs {v} at pad {ddh.pad}: rel err {err:.3e}")
        if not err < 2e-4:
            _fail(f"streamed and {v} kernels disagree at pad {ddh.pad}: {err:.3e}")

    # --- 12. the composite 1e-6 solve, structured (nx 128) ---------------------
    from cuddhelmholtz_tpu_torch.config import (
        HELMHOLTZ_DDH_1E6,
        HELMHOLTZ_DDH_UNSTRUCTURED_1E6,
        HELMHOLTZ_UNPRECONDITIONED,
        POISSON_STRUCTURED,
    )
    from cuddhelmholtz_tpu_torch.models.helmholtz import apply_helmholtz, make_helmholtz_op
    from cuddhelmholtz_tpu_torch.ops.structured import GridH1Space

    hcfg = HELMHOLTZ_DDH_1E6
    gfem = GridH1Space(Mesh2D.uniform_rect(hcfg.nx, -1.0, 1.0, hcfg.nx, -1.0, 1.0),
                       Basis(hcfg.deg + 1), hcfg.nx, hcfg.nx)
    res12, launches, c12 = _composite_run(
        wc, lambda: run_config(hcfg, device=dev), "helmholtz_ddh_1e6", 12, gfem, dev)
    _only_sparse(launches, "shared", "helmholtz_ddh_1e6 prepare")
    for k in total:
        total[k] += launches[k]
    # phase 22 holds its patch path to the gather path, in P too
    hddh12, P12, n12 = res12.extra["ddh"], res12.extra["precond"], 2 * res12.extra["ndof"]
    del res12

    # --- 13. the composite 1e-6 solve on the unstructured square ---------------
    res13, launches, c13 = _composite_run(
        wc, lambda: run_config(HELMHOLTZ_DDH_UNSTRUCTURED_1E6, device=dev),
        "helmholtz_ddh_unstructured_1e6", 8, ufem, dev)
    _only_sparse(launches, "grouped", "helmholtz_ddh_unstructured_1e6 prepare")
    for k in total:
        total[k] += launches[k]
    n2 = c13["U"].shape[0]
    t0 = time.perf_counter()
    eye = torch.eye(n2, dtype=torch.float64, device=dev)
    A = torch.stack([apply_helmholtz(c13["op"], eye[i]) for i in range(n2)], dim=1)
    x_direct = torch.linalg.solve(A, c13["b"])
    torch.cuda.synchronize()
    err = float(torch.linalg.vector_norm(c13["U"] - x_direct)
                / torch.linalg.vector_norm(x_direct))
    print(f"helmholtz_ddh_unstructured_1e6: dense operator {n2}x{n2}, fp64 direct solve "
          f"{time.perf_counter() - t0:.2f} s; solution within {err:.3e} of it")
    if not err < 1e-5:
        _fail(f"unstructured composite solution {err:.3e} from the dense direct solve (>= 1e-5)")
    del res13, A, eye

    # --- 14. Poisson and the unpreconditioned Helmholtz solve --------------------
    res = run_config(POISSON_STRUCTURED, device=dev)
    rel = float(res.res_norm[-1] / res.res_norm[0])
    print(f"poisson_structured: success={res.success} restarts={res.num_iter} "
          f"matvecs={res.num_matvec} rel {rel:.3e}, {res.seconds:.3f} s")
    if (res.num_iter, res.num_matvec) != (14, 292) or not (res.success and rel <= 1e-6):
        _fail(f"poisson_structured: {res.num_iter} / {res.num_matvec}, rel {rel:.3e}; "
              "want 14 / 292 and <= 1e-6")
    res = run_config(HELMHOLTZ_UNPRECONDITIONED, maxit=10, device=dev)
    rel = float(res.res_norm[-1] / res.res_norm[0])
    print(f"helmholtz_unpreconditioned (maxit 10): success={res.success} "
          f"restarts={res.num_iter} matvecs={res.num_matvec} rel {rel:.6f}, {res.seconds:.3f} s "
          f"({1e3 * res.seconds / res.num_matvec:.3f} ms per matvec incl. GMRES(200))")
    if (res.num_iter, res.num_matvec, res.success) != (9, 1810, False):
        _fail(f"helmholtz_unpreconditioned: {res.num_iter} / {res.num_matvec}, "
              f"success={res.success}; want 9 / 1810, not successful")

    # --- 15. fp32 kron against fp64 generic coupled matvec at nx 128 -----------
    op64 = c12["op"]
    op32 = make_helmholtz_op(hcfg.omega, c12["a2"].astype(np.float32),
                             c12["af"].astype(np.float32), gfem, c12["fs"],
                             dtype=torch.float32, device=dev)
    x64 = torch.from_numpy(np.random.default_rng(15).standard_normal(2 * gfem.ndof)).to(dev)
    x32 = x64.to(torch.float32)
    y64 = apply_helmholtz(op64, x64)
    y32 = apply_helmholtz(op32, x32)
    err = float(torch.linalg.vector_norm(y32.double() - y64) / torch.linalg.vector_norm(y64))
    mv_ms = {}
    for name in ("kron32", "generic64", "generic64", "kron32"):
        fn = (lambda: apply_helmholtz(op32, x32)) if name == "kron32" else (
            lambda: apply_helmholtz(op64, x64))
        mv_ms.setdefault(name, []).append(_timed(fn, 50)[1])
    print(f"coupled matvec at nx {hcfg.nx} ({2 * gfem.ndof} unknowns): fp32 kron vs fp64 generic "
          f"rel err {err:.3e}; fp32 kron {sum(mv_ms['kron32']) / 2:.4f} ms (turns "
          f"{mv_ms['kron32']}), fp64 generic {sum(mv_ms['generic64']) / 2:.4f} ms (turns "
          f"{mv_ms['generic64']}); ms per P: structured {c12['p_ms']:.3f}, unstructured "
          f"{c13['p_ms']:.3f}")
    if not err <= 1e-6:
        _fail(f"fp32 kron coupled matvec {err:.3e} from the fp64 generic one (> 1e-6)")
    del op32, op64, c12, c13

    # --- 16. large_unstructured L3 --composite ---------------------------------
    wc.reset_launches()
    rec = lu.run_case("unstructured_L3", lmesh, 256, 3, lomega, ucfg.gmres.tol,
                      composite=True, device=dev)
    launches = dict(wc.wave_cycle.launches)
    comp = rec["composite"]
    print(f"large_unstructured L3 --composite: lambda-solve {rec['restarts']} / "
          f"{rec['matvecs']} in {rec['solve_seconds']:.3f} s (prepare "
          f"{rec['prepare_seconds']:.3f} s); composite {comp}; launches {launches}")
    _only_sparse(launches, "grouped", "L3 --composite")
    if launches["sparse_grouped"] != 2 * launches9["sparse_grouped"]:
        _fail(f"L3 --composite launched {launches['sparse_grouped']} sparse kernels; want "
              f"twice phase 9's {launches9['sparse_grouped']} (two prepares, none in P)")
    if not (comp["success"] and comp["final_rel_res"] <= 1e-6 and comp["iters"] <= 10
            and comp["refine_steps"] <= 6):
        _fail(f"L3 --composite: {comp}; want success, rel <= 1e-6, <= 10 restarts and "
              "<= 6 refinement steps")
    for k in total:
        total[k] += launches[k]

    # --- 17. ddh_high_frequency at full size, transfer path ---------------------
    from cuddhelmholtz_tpu_torch.config import DDH_HIGH_FREQUENCY as hfcfg
    from cuddhelmholtz_tpu_torch.config import DDH_MULTI_SOURCE_8 as mcfg

    t17 = time.perf_counter()
    res17, launches = _transfer_run(
        wc, lambda: run_config(hfcfg, device=dev), "ddh_high_frequency transfer solve",
        max_restarts=21, jax_matvecs=389, matvec_slack=2 * (hfcfg.gmres.m + 1), gm=hfcfg.gmres)
    hddh = res17.extra["ddh"]
    io_bytes = sum(t.numel() * t.element_size() for t in hddh.io[:5])
    pre = res17.extra["precompute"]
    print(f"ddh_high_frequency: {hddh.n_domains} domains, pad {hddh.pad}, nt {hddh.nt}, "
          f"nu {pre['transfer_nu']}; prepare {pre['transfer_seconds'] + pre['io_seconds']:.3f} s, "
          f"solve {res17.seconds:.3f} s; io maps {io_bytes} B")
    if (hddh.n_domains, hddh.shared_S) != (4096, True):
        _fail(f"ddh_high_frequency: {hddh.n_domains} domains, shared_S {hddh.shared_S}")
    _only_sparse(launches, "shared", "ddh_high_frequency probes")
    for k in total:
        total[k] += launches[k]
    uidx, _, nu = hddh._domain_groups()
    c = 2 * hddh._fslot_np.shape[1]
    ui = torch.as_tensor(uidx, device=dev)
    hp = hddh.params
    ph = hp._replace(Ha=hp.Ha[ui].repeat(c, 1), inv_mi=hp.inv_mi[ui].repeat(c, 1))
    hmask = hddh.gmask[ui].repeat(c, 1)
    hm = hmask.cpu().numpy()
    Fh, Gh = _masked_normal(rng, hm, dev), _masked_normal(rng, hm, dev)
    rows_h = nu * c
    what = f"layout (a), ddh_high_frequency transfer probe ({nu} x {c} rows, pad {hddh.pad})"
    res_h, plain_ms_h, _ = _compare(wc, ph, Fh, Gh, hddh.wh_maxit, hmask == 0, what,
                                    ("sparse",), reps=1, form=hddh.S_sparse)
    bound_h, by_h = _cycle_bound(hddh.S_sparse, rows_h, rows_h, hddh.pad, hddh.nt,
                                 hddh.wh_maxit)
    _rates(what, _cycle_flop(hddh.S_sparse, rows_h, hddh.nt, hddh.wh_maxit), rows_h, hddh.pad,
           hddh.nt, hddh.wh_maxit, res_h, bound_h, by_h)
    shapes["sparse_shared"].append({
        "at": f"ddh_high_frequency transfer probe, {rows_h} rows, pad {hddh.pad}, nt {hddh.nt}",
        "nnz": _nnz(hddh.S_sparse), "stride": hddh.S_sparse.stride,
        "form_ms": 1e3 * hddh.sparse_seconds, "ms": res_h["sparse"][1], "plain_ms": plain_ms_h,
        "bound_ms": bound_h, "bound_by": by_h,
    })
    del res17, hddh, hp, ph, Fh, Gh, hmask
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t17:.1f} s")

    # --- 18. ddh_multi_source_8 at full size: block GMRES(40), 8 sources --------
    from cuddhelmholtz_tpu_torch.bench import HEADLINE_GMRES

    t18 = time.perf_counter()
    wc.reset_launches()
    res18 = run_config(mcfg, device=dev)
    launches = dict(wc.wave_cycle.launches)
    mddh = res18.extra["ddh"]
    bs = res18.extra["rhs"]
    K, gm18 = res18.extra["n_sources"], mcfg.gmres
    block_opts = {"reorth": False}
    wc.reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out18, _ = mddh.solver(gm18.m, gm18.maxit, gm18.tol, gmres_opts=block_opts, block=True)(bs)
    torch.cuda.synchronize()
    warm18 = time.perf_counter() - t0
    again = sum(wc.wave_cycle.launches.values())
    # matched mode: the same sources one at a time, the block solve's GMRES options
    solo = mddh.solver(gm18.m, gm18.maxit, gm18.tol, gmres_opts=block_opts)
    solo(bs[0])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    solo_counts = [(o.num_iter, o.num_matvec) for o in (solo(bs[k])[0] for k in range(K))]
    torch.cuda.synchronize()
    seq18 = time.perf_counter() - t0
    # JAX's speedup_vs_sequential: K of the bench headline's timed solves
    b_flag = helmholtz_rhs(mddh.space, lambda xy: point_sources(xy, mcfg.omega),
                           dtype=torch.float32).to(dev)
    head = mddh.solver(20, 100, 1e-4, gmres_opts=HEADLINE_GMRES)
    head(b_flag)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    hout, _ = head(b_flag * (1.0 + 1e-6))
    torch.cuda.synchronize()
    head_s = time.perf_counter() - t0
    per = res18.extra["per_source_matvecs"]
    pre = res18.extra["precompute"]
    print(f"ddh_multi_source_8: success={res18.success} restarts={res18.num_iter} per-source "
          f"matvecs {per}; solve {res18.seconds:.3f} s, warm {warm18:.3f} s ({K / warm18:.2f} "
          f"sources/s), prepare {pre['transfer_seconds'] + pre['io_seconds']:.3f} s; launches "
          f"during run {launches}, during the repeated solve {again}; matched-mode sequential: "
          f"{K} solves in {seq18:.3f} s ({seq18 / warm18:.2f}x the block solve), counts "
          f"{solo_counts}; headline-mode flagship solve {head_s:.3f} s ({hout.num_iter} / "
          f"{hout.num_matvec}): speedup_vs_sequential {K * head_s / warm18:.2f}")
    if not res18.success or abs(res18.num_iter - 7) > 1:
        _fail(f"ddh_multi_source_8: success={res18.success}, {res18.num_iter} restarts "
              "(JAX 7 +-1)")
    if per != [1 + (gm18.m + 1) * res18.num_iter] * K:
        _fail(f"ddh_multi_source_8: per-source matvecs {per}, want 1 + 41 x restarts")
    if again != 0:
        _fail(f"ddh_multi_source_8: the repeated solve launched {again} kernels")
    _only_sparse(launches, "shared", "ddh_multi_source_8 probes")
    for k in total:
        total[k] += launches[k]
    Us = res18.solution
    if Us.shape != (K, 2 * res18.extra["ndof"]) or not np.isfinite(Us).all():
        _fail(f"ddh_multi_source_8: solutions of shape {Us.shape} or non-finite values")
    lam18 = res18.extra["lam"]
    resids = _plain_residual(wc, mddh, bs, lam18)
    print(f"ddh_multi_source_8 plain-cycle check per source: {[f'{r:.3e}' for r in resids]}")
    if not max(resids) <= 1.2 * gm18.tol:
        _fail(f"ddh_multi_source_8: plain-cycle residuals {resids} (> {1.2 * gm18.tol:.2e})")
    del res18, mddh, bs, lam18, solo, head
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t18:.1f} s")

    # --- 19. the direct multi-source path at nx 64, 4 sources ------------------
    from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh_multi_source
    from cuddhelmholtz_tpu_torch.solvers.ddh import _rows

    t19 = time.perf_counter()
    small = dict(nx=64, n_sources=4, m=20, maxit=100, tol=1e-4, transfer=False, device=dev)
    wc.reset_launches()
    rb = run_ddh_multi_source(method="block", **small)
    lb = dict(wc.wave_cycle.launches)
    wc.reset_launches()
    rv = run_ddh_multi_source(method="vmap", **small)
    lv = dict(wc.wave_cycle.launches)
    vddh, vbs, K19 = rv.extra["ddh"], rv.extra["rhs"], rv.extra["n_sources"]
    solo = vddh.solver(small["m"], small["maxit"], small["tol"])
    solo_counts = [(o.num_iter, o.num_matvec) for o in (solo(vbs[k])[0] for k in range(K19))]
    block_mv = rb.num_matvec  # block operator calls: one per source's matvec
    print(f"direct multi-source (nx 64, {K19} sources, {vddh.n_domains} domains): block "
          f"{rb.num_iter} restarts / {block_mv} matvecs per source, {rb.seconds:.3f} s, "
          f"launches {lb}; vmap restarts {rv.extra['per_source_restarts']} matvecs "
          f"{rv.extra['per_source_matvecs']}, {rv.seconds:.3f} s, launches {lv}; solo "
          f"direct solves {solo_counts}")
    if not (rb.success and rv.success):
        _fail("direct multi-source: a solve did not converge")
    if lb != {**dict.fromkeys(lb, 0), "sparse_shared": block_mv + 2}:
        _fail(f"direct multi-source block: launches {lb}, want {block_mv + 2} sparse layout-(a) "
              "launches (one per block matvec, rhs and postprocess) and no other")
    if rb.num_iter > max(rv.extra["per_source_restarts"]):
        _fail(f"direct multi-source: block took {rb.num_iter} restarts, more than the slowest "
              f"lock-step lane's {max(rv.extra['per_source_restarts'])}")
    if solo_counts != list(zip(rv.extra["per_source_restarts"], rv.extra["per_source_matvecs"])):
        _fail(f"direct multi-source vmap: lanes {rv.extra['per_source_restarts']} / "
              f"{rv.extra['per_source_matvecs']}, solo solves {solo_counts}")
    _only_sparse(lv, "shared", "direct multi-source vmap")
    for k in total:
        total[k] += lb[k] + lv[k]
    pk = _rows(vddh.params, K19)
    kmask = vddh.gmask.repeat(K19, 1)
    km = kmask.cpu().numpy()
    Fk, Gk = _masked_normal(rng, km, dev), _masked_normal(rng, km, dev)
    rows_k = K19 * vddh.n_domains
    what = f"layout (a), direct multi-source block matvec ({K19} x {vddh.n_domains} rows)"
    res_k, plain_ms_k, _ = _compare(wc, pk, Fk, Gk, vddh.wh_maxit, kmask == 0, what,
                                    ("sparse",), form=vddh.S_sparse)
    bound_k, by_k = _cycle_bound(vddh.S_sparse, rows_k, rows_k, vddh.pad, vddh.nt,
                                 vddh.wh_maxit)
    _rates(what, _cycle_flop(vddh.S_sparse, rows_k, vddh.nt, vddh.wh_maxit), rows_k, vddh.pad,
           vddh.nt, vddh.wh_maxit, res_k, bound_k, by_k)
    shapes["sparse_shared"].append({
        "at": f"direct multi-source matvec, {K19} x {vddh.n_domains} rows, pad {vddh.pad}, "
              f"nt {vddh.nt}", "nnz": _nnz(vddh.S_sparse), "stride": vddh.S_sparse.stride,
        "form_ms": 1e3 * vddh.sparse_seconds, "ms": res_k["sparse"][1], "plain_ms": plain_ms_k,
        "bound_ms": bound_k, "bound_by": by_k,
    })
    del rb, rv, vddh, vbs, solo, pk, Fk, Gk
    torch.cuda.empty_cache()
    print(f"phase 19: {time.perf_counter() - t19:.1f} s")

    # --- 20. the CLI and the bench in subprocesses -----------------------------
    t20 = time.perf_counter()
    cli = _subprocess_json([sys.executable, "-m", "cuddhelmholtz_tpu_torch.examples.drivers",
                            "poisson_structured"], "drivers CLI")
    print(f"drivers CLI: {json.dumps(cli)}")
    if (cli["config"], cli["success"], cli["iters"], cli["matvecs"]) != (
            "poisson_structured", True, 14, 292):
        _fail(f"drivers CLI: {cli}; want poisson_structured successful at 14 / 292")
    rec = _subprocess_json([sys.executable, "-m", "cuddhelmholtz_tpu_torch.bench"], "bench",
                           BENCH_SKIP_CONFIGS="1")
    ex = rec["extras"]
    print(f"bench (no config rows): headline {ex['gmres_restarts']} / {ex['gmres_matvecs']} in "
          f"{rec['solve_seconds']:.4f} s, value {rec['value']:.4e} nnz/s; executed wave-cycle "
          f"action {ex['wave_cycle_ms_per_apply']:.3f} ms; kron stiffness apply "
          f"{ex['stiffness_apply_us']:.2f} us; device {ex['device']}")
    r = ex["gmres_restarts"]
    if abs(r - 18) > 1 or ex["gmres_matvecs"] != 1 + 21 * r:
        _fail(f"bench headline {r} / {ex['gmres_matvecs']}; want 18 / 379 (+-1 restart)")
    print(f"phase 20: {time.perf_counter() - t20:.1f} s")

    # --- 21. the setup cache: a miss, then a hit, in a fresh directory --------
    t21 = time.perf_counter()
    cache_dir = tempfile.mkdtemp(prefix="ddh_cache_")
    os.environ["CUDDH_CACHE_DIR"] = cache_dir
    try:
        cold, launches = _cache_pair(
            wc, lambda: run_ddh(nx=nx, deg=deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit,
                                tol=cfg.gmres.tol, wh_maxit=cfg.wh_maxit,
                                block_size=cfg.block_size, transfer=True, device=dev),
            "setup cache, flagship transfer solve", cache_dir)
        if launches != {**dict.fromkeys(launches, 0), "sparse_shared": 2}:
            _fail(f"setup cache: the cold flagship run launched {launches}; want the two "
                  "sparse layout-(a) probes of phase 5")
        if (cold.num_iter, cold.num_matvec) != counts5:
            _fail(f"setup cache: {cold.num_iter} / {cold.num_matvec}, phase 5 {counts5}")
        for k in total:
            total[k] += launches[k]
        del cold
        cold, launches = _cache_pair(wc, lambda: run_config(bcfg, device=dev),
                                     "setup cache, ddh_512_block32", cache_dir)
        _only_sparse(launches, "shared", "setup cache, ddh_512_block32 cold run")
        for k in total:
            total[k] += launches[k]
        del cold
    finally:
        shutil.rmtree(cache_dir, ignore_errors=True)
        os.environ["CUDDH_CACHE_DIR"] = ""
    torch.cuda.empty_cache()
    print(f"phase 21: {time.perf_counter() - t21:.1f} s")

    # --- 22. patch against gather io at the helmholtz_ddh_1e6 DDH -------------
    from cuddhelmholtz_tpu_torch.solvers.ddh import (
        ddh_postprocess_io,
        ddh_postprocess_io_patch,
        ddh_rhs_io,
        ddh_rhs_io_patch,
    )

    t22 = time.perf_counter()
    pio, pshape = hddh12.patch_io()
    if pio is None or hddh12.io_path != "patch":
        _fail("helmholtz_ddh_1e6: the grid-numbered DDH has no patch io path")
    hp, hio, hg = hddh12.params, hddh12.io, hddh12.g_ndof
    rng22 = np.random.default_rng(22)
    f22 = torch.from_numpy(rng22.standard_normal(2 * hg).astype(np.float32)).to(dev)
    l22 = torch.from_numpy(rng22.standard_normal(hddh12.size).astype(np.float32)).to(dev)
    io_fns = {
        "rhs gather": lambda: ddh_rhs_io(hp, hio, f22, hg, hddh12.n_lambda),
        "rhs patch": lambda: ddh_rhs_io_patch(hp, hio, pio, f22, hg, hddh12.n_lambda, pshape),
        "postprocess gather": lambda: ddh_postprocess_io(hp, hio, l22, f22, hg, hddh12.n_own),
        "postprocess patch": lambda: ddh_postprocess_io_patch(hp, hio, pio, l22, f22, hg,
                                                              hddh12.n_own, pshape),
    }
    io_out = {k: fn() for k, fn in io_fns.items()}
    io_err = {k: _rel_max(io_out[f"{k} patch"], io_out[f"{k} gather"])
              for k in ("rhs", "postprocess")}
    io_ms = {}
    for k in [*io_fns, *reversed(io_fns)]:
        io_ms.setdefault(k, []).append(_timed(io_fns[k], 50)[1])
    print(f"patch io at helmholtz_ddh_1e6 (window {pshape}): rel err patch vs gather {io_err}; "
          "CUDA-event ms per call (turns): " + "; ".join(
              f"{k} {sum(t) / len(t):.4f} ({', '.join(f'{x:.4f}' for x in t)})"
              for k, t in io_ms.items()))
    if not all(e <= 1e-5 for e in io_err.values()):
        _fail(f"patch io disagrees with the gather path: {io_err}")
    # the composite's P on each path, in turns (the gather path forced by
    # withholding the patch tables)
    v22 = torch.from_numpy(np.random.default_rng(3).standard_normal(n12)).to(dev)
    p_ms = {}
    for path in ("patch", "gather", "gather", "patch"):
        hddh12._patch = (None, None) if path == "gather" else (pio, pshape)
        p_ms.setdefault(path, []).append(_ms_per_call(lambda: P12(v22), dev))
    hddh12._patch = (pio, pshape)
    print(f"helmholtz_ddh_1e6 P: host-clock ms per P with patch io {p_ms['patch']}, with "
          f"gather io {p_ms['gather']}")
    del hddh12, P12, hp, hio, pio, io_out, io_fns
    torch.cuda.empty_cache()
    print(f"phase 22: {time.perf_counter() - t22:.1f} s")

    # --- 23. nx 512 / block 16: one level, then two-level multiplicative -----
    from cuddhelmholtz_tpu_torch.config import GmresConfig

    t23 = time.perf_counter()
    gm23 = GmresConfig(m=20, maxit=200, tol=1e-4)
    kw23 = dict(nx=512, deg=3, block_size=16, transfer=True, m=gm23.m, maxit=gm23.maxit,
                tol=gm23.tol, device=dev)
    two23 = dict(coarse="multiplicative", coarse_method="iterative", coarse_n_dir=4,
                 coarse_domains_per_super=1, coarse_solve=(20, 2, 3e-2))
    torch.cuda.reset_peak_memory_stats()
    res23, launches, again1 = _level_run(wc, lambda: run_ddh(**kw23),
                                         "nx 512 / block 16, one level", 90, None, gm23)
    one23 = (res23.num_iter, res23.num_matvec, res23.seconds, again1)
    if (res23.extra["n_domains"], res23.extra["n_lambda"]) != (16384, 1701896):
        _fail(f"nx 512 / block 16: {res23.extra['n_domains']} domains, "
              f"{res23.extra['n_lambda']} unknowns")
    for k in total:
        total[k] += launches[k]
    del res23
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    res23, launches, again2 = _level_run(wc, lambda: run_ddh(**kw23, **two23),
                                         "nx 512 / block 16, two-level multiplicative", 23,
                                         "multiplicative", gm23)
    for k in total:
        total[k] += launches[k]
    cddh = res23.extra["ddh"]
    nc23 = 2 * cddh.coarse_space.members.shape[0] * cddh.coarse_space.V.shape[2]
    print(f"nx 512 / block 16: nc {nc23}, coarse build {res23.extra['coarse_seconds']:.3f} s; "
          f"one level {one23[0]} / {one23[1]} in {one23[2]:.3f} s (again {one23[3]:.3f} s), "
          f"two-level {res23.num_iter} / {res23.num_matvec} in {res23.seconds:.3f} s (again "
          f"{again2:.3f} s)")
    if nc23 != 294912:
        _fail(f"nx 512 / block 16: nc {nc23}, want 294912")
    uidx, _, nu = cddh._domain_groups()
    c = 2 * cddh._fslot_np.shape[1]
    ui = torch.as_tensor(uidx, device=dev)
    cp = cddh.params
    p23 = cp._replace(Ha=cp.Ha[ui].repeat(c, 1), inv_mi=cp.inv_mi[ui].repeat(c, 1))
    m23 = cddh.gmask[ui].repeat(c, 1)
    mm = m23.cpu().numpy()
    F23, G23 = _masked_normal(rng, mm, dev), _masked_normal(rng, mm, dev)
    rows_23 = nu * c
    what = f"layout (a), nx 512 / block 16 transfer probe ({nu} x {c} rows, pad {cddh.pad})"
    res_23, plain_ms_23, _ = _compare(wc, p23, F23, G23, cddh.wh_maxit, m23 == 0, what,
                                      ("sparse",), reps=1, form=cddh.S_sparse)
    bound_23, by_23 = _cycle_bound(cddh.S_sparse, rows_23, rows_23, cddh.pad, cddh.nt,
                                   cddh.wh_maxit)
    _rates(what, _cycle_flop(cddh.S_sparse, rows_23, cddh.nt, cddh.wh_maxit), rows_23,
           cddh.pad, cddh.nt, cddh.wh_maxit, res_23, bound_23, by_23)
    shapes["sparse_shared"].append({
        "at": f"nx 512 / block 16 transfer probe, {rows_23} rows, pad {cddh.pad}, "
              f"nt {cddh.nt}", "nnz": _nnz(cddh.S_sparse), "stride": cddh.S_sparse.stride,
        "form_ms": 1e3 * cddh.sparse_seconds, "ms": res_23["sparse"][1],
        "plain_ms": plain_ms_23, "bound_ms": bound_23, "bound_by": by_23,
    })
    del res23, cddh, cp, p23, F23, G23, m23
    torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t23:.1f} s")

    # --- 24. large_unstructured L3 --coarse multiplicative ---------------------
    t24 = time.perf_counter()
    wc.reset_launches()
    rec = lu.run_case("unstructured_L3_coarse_mult", lmesh, 256, 3, lomega, ucfg.gmres.tol,
                      coarse="multiplicative", device=dev)
    launches = dict(wc.wave_cycle.launches)
    print(f"large_unstructured L3 --coarse multiplicative: {json.dumps(rec)}; launches {launches}")
    _only_sparse(launches, "grouped", "L3 --coarse")
    if not rec["success"] or rec["restarts"] > 21 or "coarse" not in rec:
        _fail(f"L3 --coarse: success={rec['success']}, {rec['restarts']} restarts (> 21?)")
    for k in total:
        total[k] += launches[k]
    print(f"phase 24: {time.perf_counter() - t24:.1f} s")
    print(f"phases 1-24: {time.perf_counter() - t_main:.1f} s")
    print(f"kernel launches over the main-path runs: {total}")
    for row in (r for rows in shapes.values() for r in rows):
        dense = (f" against {row['dense']} {row['dense_ms']:.3f} ms "
                 f"({row['dense_ms'] / row['ms']:.2f}x)" if "dense" in row else "")
        print(f"sparse kernel at {row['at']}: {row['ms']:.3f} ms{dense}, plain "
              f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it), nnz {row['nnz']} (stride "
              f"{row['stride']}), form {row['form_ms']:.3f} ms")

    def entry(name, source, line, key, err, kms, pms, bound, by, **extra):
        return {
            "name": name, "route": "cuda", "source": f"cuddhelmholtz_tpu_torch/csrc/{source}",
            "replaces": f"cuddhelmholtz_tpu/ops/pallas/wave_cycle.py:{line}",
            "launches": total[key], "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by, "library_ms": None, **extra,
        }

    print(json.dumps({"kernels": [
        entry("wave_cycle sparse (a) shared S", "wave_cycle_sparse.cu", 69, "sparse_shared",
              max(res_a["sparse"][0], res_sa["sparse"][0], res_s176["sparse"][0],
                  res_h["sparse"][0], res_k["sparse"][0], res_23["sparse"][0]),
              res_a["sparse"][1], plain_ms, bound_a, by_a, nnz=nnz_a, stride=form_a.stride, form_ms=form_ms_a,
              shapes=shapes["sparse_shared"]),
        entry("wave_cycle sparse (b) grouped S", "wave_cycle_sparse.cu", 201, "sparse_grouped",
              max(res_b["sparse"][0], res_c["sparse"][0], res_sb["sparse"][0]),
              res_sb["sparse"][1], plain_ms_sb, bound_sb, by_sb, nnz=_nnz(form_sb),
              stride=form_sb.stride, form_ms=form_ms_sb, shapes=shapes["sparse_grouped"]),
        entry("wave_cycle (a) shared S", "wave_cycle.cu", 69, "shared", res_a["resident"][0],
              res_a["resident"][1], plain_ms, bound_a, by_a),
        entry("wave_cycle (b) grouped S", "wave_cycle.cu", 201, "grouped",
              max(res_b["resident"][0], res_c["resident"][0]), res_b["resident"][1],
              plain_ms_b, bound_b, by_b),
        entry("wave_cycle streamed (a) shared S", "wave_cycle_streamed.cu", 69,
              "streamed_shared", max(res_sa["streamed"][0], res_s176["streamed"][0]),
              res_sa["streamed"][1], plain_ms_sa, bound_sa, by_sa),
        entry("wave_cycle streamed (b) grouped S", "wave_cycle_streamed.cu", 201,
              "streamed_grouped", res_sb["streamed"][0], res_sb["streamed"][1], plain_ms_sb,
              bound_sb, by_sb),
    ]}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
