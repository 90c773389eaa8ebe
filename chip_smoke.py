#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``cuddhelmholtz_tpu_torch``) on one NVIDIA GPU.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
It imports nothing of JAX.  Phases, each raising on failure:

1. The card: ``nvidia-smi`` name and power limit; build the four WaveHoltz
   kernels from ``cuddhelmholtz_tpu_torch/csrc/`` with one nvcc each,
   started together (timed).
2. Kernels vs plain at the flagship shape: one wave cycle of the
   ``ddh_structured`` DDH (1,024 subdomains, pad 176, nt 800) on masked random
   (F, G) through the tensor-core kernel, the sparse (FFMA) kernel, the
   resident kernel and the plain PyTorch cycle.  Times each kernel in turns
   (mma, sparse, resident, resident, sparse, mma) with CUDA events, the
   plain cycle once, and the builds of the sparse and tile forms; then the
   tensor-core and sparse kernels on the flagship's S at 384 rows (the FWI
   transfer-probe shape, fewer blocks than SMs).
3. The flagship solve ``run_ddh(nx=128, deg=3)`` on the direct path: it must
   succeed in <= 20 restarts, the default kernel (``_k1``: the tensor-core
   one wherever its tile form fits) must have launched exactly
   ``num_matvec + 2`` times (every matvec, rhs and postprocess) and no other
   one, and the lambda residual recomputed with the plain cycle must be
   <= 1.2e-4.
4. The grouped-S layout (b), tensor-core and sparse against the plain cycle
   and the resident kernel, at the ``ddh_unstructured_square`` transfer-probe shape
   (S (8, 168, 168), 960 rows in runs of 120, nt 1,717) and, tensor-core
   and sparse, at its io-probe shape (3,648 rows in runs of 456), and the per-row
   layout (c) at that DDH's own shape: the sparse kernel's per-row instance
   (each row once) against the plain cycle, the resident kernel (rows tiled
   x8) and the sparse kernel on the rows tiled x8 onto (b), the route of the
   JAX solver and of the port before the per-row instance (timed in turns;
   the per-row outputs must equal the tiled ones bitwise: the same sums in
   the same order).
5. The flagship transfer solve ``run_ddh(nx=128, deg=3, transfer=True)``:
   prepare (transfer + io probes, layout (a)), then a solve that launches no
   kernel (checked by solving again on the prepared operator); <= 20
   restarts, matvecs within one restart of the JAX run's 366, plain-cycle
   lambda residual <= 1.2e-4.
6. ``run_config(ddh_unstructured_square)`` at full size: its probes run the
   default kernel in layout (b), the solve none; <= 100 restarts, matvecs
   within two restarts of the JAX run's 668, plain-cycle residual <= 1.2e-4.
7. ``run_config(ddh_512_block32)`` (nx 512, 4,096 subdomains of 625 DOFs,
   pad 632) on the transfer path: its probes run the sparse kernel in
   layout (a) (the dense S is 1.6 MB, its non-zeros 59 KB; its 8 x 8 tiles
   do not fit beside the rows, so not the tensor-core one); restarts within
   one of the JAX run's 25, matvecs within one restart of 522, no kernel in
   a repeated solve, plain-cycle residual <= 1.2e-4.
8. Sparse and streamed layout (a) against the plain cycle on that DDH's
   transfer-probe rows (65 unique subdomains x 192 columns, pad 632, nt 800).
9. ``large_unstructured`` at ``--levels 3 --domains 256`` (7,616 elements,
   pad 320, one S per domain): probes run the default kernel in layout (b);
   restarts within one of the JAX run's 18, matvecs within one restart of
   373, the checks of phase 7.
10. Tensor-core, sparse and streamed layout (b) against the plain cycle on that DDH's
   transfer-probe rows (256 runs of 192 rows, pad 320, nt 1,283).
11. The streamed kernel forced at the flagship shape (pad 176) against the
   tensor-core, resident and sparse kernels of phase 2.
12. ``run_config(helmholtz_ddh_1e6)`` at full size (nx 128, the coupled
   system to 1e-6: fp64 refinement of fp32 FGMRES(20), one bounded DDH
   solve as right preconditioner P): success, <= 12 outer restarts (JAX on
   the TPU: 10), <= 6 refinement steps, not stagnated, and a true relative
   residual <= 1e-6 recomputed with the generic (non-kron) fp64 operator on
   the same data; the default kernel runs in ``prepare`` only (P launches
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
   TPU: 19 / 389), plain-cycle residual <= 1.2e-4; then the tensor-core and
   sparse kernels against the plain cycle on its transfer-probe rows.
18. ``run_config(ddh_multi_source_8)`` at full size (block GMRES(40), 8 ring
   sources, transfer path): success, restarts within one of JAX's 7, each
   source 1 + 41 restarts matvecs, every source's plain-cycle residual <=
   1.2e-4, a repeated solve launches no kernel.  Prints the warm seconds,
   sources/s, JAX's ``speedup_vs_sequential`` (8 timed flagship solves of
   the bench's headline mode against the warm block solve) and a
   matched-mode baseline: 8 warm single-source solves of the same sources
   with the block solve's GMRES options.
19. The direct multi-source path at nx 64 with 4 sources: ``method="block"``
   launches the default kernel exactly (block matvecs + 2) times, each over
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
   ``run_ddh`` twice, a miss that launches the default kernel twice (the
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
   residual <= 1.2e-4, launches the default kernel in layout (a) only in
   ``prepare``, and a repeated solve launches none and repeats bitwise.
   Then the tensor-core and sparse kernels against the plain cycle on its
   probe rows.
24. ``large_unstructured --levels 3 --domains 256 --coarse multiplicative``
   through ``run_case``: success in <= 21 restarts (phase 9's JAX 18 + 3),
   only the sparse grouped kernel launched.
25. A wave-speed inversion at the flagship problem (``_fwi_run``: nx 128,
   deg 3, 296,450 coupled unknowns, the true model the nodal wave speed of
   ``run_helmholtz_ddh``, receivers at the boundary face DOFs of u and v,
   start model a0 = 1): every solve of the inversion through
   ``ddh_solve_hook(m=20, maxit=100, tol=1e-8)`` with its DDH frozen at a0
   (1,024 subdomains, ``prepare(want_io=True)``): the misfit gradient at a0
   twice (bitwise the same), a central difference along a smooth unit
   direction (within 1e-3 of g.v) and ``invert_wavespeed(steps=2)`` (the
   loss falls).  The observed data come from the same hook on a DDH frozen
   at the true model; the hook frozen at a0 stalls on that operator, which
   is recorded at maxit 10.  Each checked solve succeeds with a true fp64
   relative residual <= 1e-8 recomputed with the template's operator; K1
   launches four times, the probes of the two ``prepare``s (the default
   kernel in layout (a)), and never in a solve.
26. The host-loop solvers at nx 128 (``_host_loop_run``):
   ``run_helmholtz(maxit=10, max_seconds=3600, verbose=2)`` gives phase 14's
   9 / 1,810 and history bitwise with 10 restart times;
   ``run_helmholtz(maxit=10_000, max_seconds=5)`` stops at the first restart
   that ends past 5 s; LGMRES(200, 3) with maxit 10 beside GMRES(203) at the
   same matvec count (recorded).
27. ``python -m cuddhelmholtz_tpu_torch.examples.sweep --transfer 32 64 128``
   and ``partition_study --nx 32`` in subprocesses (``_studies_run``):
   every record succeeds, the sweep's nx 128 record takes phase 5's counts;
   their kernel launches are read at each subprocess's end.
28. ``large_unstructured`` L4 (``_l4_run``: 4x refined square, 30,464
   elements, 1,024 domains, pad 320, omega 107.656 as JAX): ``Mesh2D`` +
   ``H1Space`` timed with the native topology and with ``CUDDH_NATIVE=0``
   (the same tables); its io maps exceed the 1 GiB cap, so the solve runs
   rhs and postprocess as wave cycles: restarts within one of JAX's 18 and
   <= 20, the default kernel grouped for the probes and 2 sparse per-row
   launches for rhs and postprocess, a repeated solve launches exactly 2 per-row and
   repeats bitwise, plain-cycle residual <= 1.2e-4, peak memory; then the
   kernel against the plain cycle in layout (c) (the rhs's 1,024 rows, per
   row and tiled x8 as in phase 4) and layout (b) (64 probe runs, the
   tensor-core and sparse kernels).  Then
   the L3 ``--control`` case (a jittered 87x87 grid, 256 domains, L3's
   omega) through ``_transfer_run``: within one restart of JAX's 28 / 572.
29. ``examples/sharded_solve.py`` in one process per visible card (NCCL,
   ``spawn_processes``): ``ShardedDDH``'s direct action, rhs and
   postprocess within 2e-4 of ``DDH``'s, the flagship transfer solve
   through the sharded rolled action within one restart of 18 / 366,
   bitwise on repeat, plain-cycle residual <= 1.2e-4; every rank's K1
   launches in ``ShardedDDH``'s calls alone (the default kernel in layout (a) only: 3 in
   the direct comparison, 4 in the two solves) are read from the record.
30. The flagship transfer solve with ``DDH(rhs_split="mass")`` (plain-cycle
   residual <= 1.2e-4, two probe launches) and ``run_ddh`` with
   ``CUDDH_DEBUG=1`` (phase 5's counts, every check of ``_transfer_run``).
31. ``run_ddh_multi_source(shard_sources=True)`` at ``ddh_multi_source_8``
   under a one-rank NCCL group: the restarts, per-source matvecs and
   solution of phase 18's replicated solve (within 1e-5).
32. The bench's ``scaling`` key from phase 20 (NCCL records at every world
   size the cards give), and ``python -m
   cuddhelmholtz_tpu_torch.examples.scaling`` at nx 128 with and without
   ``--transfer``; the direct rows launch K1 once per sharded matvec.
33. The factored kernel (layout (a) on rectangles: the flagship's S at
   384, 1,024, 5,472 and 12,000 rows and at 4 x 256, pad 632's at 12,480)
   and the tensor-core kernel against the sparse (FFMA) one at every (a)
   and (b) shape the comparisons of phases 2, 4, 8, 10, 17, 19, 23 and 28
   ran, timed in turns in those phases: their ms, the kernel the default
   picks there, the plain ms, each kernel's bound (FP32 FMA on the
   non-zeros; the tensor-core one's three TF32 passes and the route's own
   tile work), and each kernel's registers, warps, shared memory and
   blocks per SM there.  The tensor-core shapes lie on both sides of its
   rule (``mma_preferred``: S's tiles and pad): the square's S at 960 and
   3,648 rows, the flagship's at 384, 1,024, 5,472 and 12,000.  (At pad
   632 the tile form does not fit; the (b) shapes have no factored form.)
34. (Run right after phase 5, on its operator.)  The transfer apply
   replayed as a CUDA graph (``_graph_phase``): ``DDH.action`` bit for bit
   the eager ``ddh_action_transfer_rolled`` called directly at K = 1 and
   K = 8, one capture for the new K = 8 shape and none in what follows;
   the lambda-solve with phase 5's restarts and matvecs and bitwise the
   solve on the eager apply; ``DDHPreconditioner`` on that operator
   bitwise on repeat and bitwise P on the eager apply; then the host
   microseconds of an apply, eager and graphed, timed in turns, and the
   same inside a ``torch.profiler`` recording of the device.
35. (Right after phase 34, on phase 5's operator.)  The GMRES restart's
   per-step bookkeeping replayed as CUDA graphs (``_step_graph_phase``):
   the lambda-solve with graphed and with eager steps, phase 5's counts on
   both, x and history bitwise, no capture and no eager step on the graphed
   path; host ms per step of both in turns and CUDA-event ms of one step's
   bookkeeping (a replay against the eager step); ``helmholtz_ddh_1e6`` on
   both paths (11 / 235); on its DDH the benchmark's float64 FGMRES(20) to
   1e-6 through ``ddh_solve_hook``, bitwise on both paths, with its ms per
   step.  ``python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.phase_35())'``
   runs phases 1, 5, 34 and 35 alone.
Every comparison holds a kernel within 2e-4 of the plain cycle relative to
the max of u and v, with padded slots exactly 0, the factored and
tensor-core kernels within 2e-4 of the sparse one and bitwise on a
repeat.  The main-path runs (phases 3, 5, 6, 7, 9, 12, 13, 16, 17, 18, 19,
21, 23, 24, 25, 27-32) must launch the kernel the dispatch picks for their
shape in each layout (``_k1``: ``factored_shared`` on rectangles,
``mma_shared`` / ``mma_grouped`` where the tile form fits and the rule of
``kernel_variant`` picks it, ``sparse_*`` elsewhere, ``sparse_per_row``
for (c)) and no other and no dense one, and every key those checks asked
for must have launched over them.

Every kernel count is set to 0 just before each main-path run and read just
after; the ``launches`` of a kernel in the JSON line is the sum over those
runs.  Comparisons run after the main-path runs and are not counted.
``bound_ms`` is the larger of the work on the non-zeros of S (2 products
of the rows by the exact non-zeros per leapfrog step) over the card's peak
for the kernel's arithmetic and the bytes read once (F, G, Ha, mi, tables
and S's form) and written once (u, v) over 3.35 TB/s (H100 SXM peaks):
FP32 FMA at 67 TFLOP/s for the FFMA and dense kernels; three TF32 passes
of that work at 495 TFLOP/s for the tensor-core kernel, whose rows add an
informational ``tile_work_ms``: every MAC of its 8 x 8 tiles, zeros
inside a tile included, three passes per 8-row block and step, at 495
TFLOP/s (the route's own work, not a bound on the function).  No single
PyTorch call computes a WaveHoltz cycle, so ``library_ms`` is null.

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


def _reset_launches() -> None:
    """Set the kernel launch counters (``k1.launches.*``) to 0."""
    from cuddhelmholtz_tpu_torch.ops.cuda.wave_cycle import LAUNCHES
    from cuddhelmholtz_tpu_torch.utils import spans

    spans.reset(LAUNCHES)


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
PEAK_TF32_FLOPS = 495e12  # H100 SXM, TF32 on the tensor cores, dense
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
DENSE = ("shared", "grouped", "streamed_shared", "streamed_grouped")
REQUIRED: set = set()  # the launch keys the main-path checks asked for


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


def _mma_bound(tiles, group_rows: int, rows: int, pad: int, nt: int,
               wh_maxit: int) -> tuple[float, str]:
    """Least time of one cycle on the tensor cores: the products on the
    exact non-zeros of S (``_cycle_flop``'s work, counted from the tiles'
    non-zero values) done three times, the three TF32 passes of the split,
    at the TF32 tensor peak; or the bytes read (F, G, Ha, mi, tables, the
    tile form's live tiles with their k-tile offsets and each group's slot
    table) and written (u, v) once against the memory rate, whichever is
    larger."""
    ng, nslot = tiles.ptr.shape[0], tiles.ptr.shape[1] - 1
    nnz = float((tiles.val != 0).sum())
    t_ops = 3 * 2.0 * 2 * wh_maxit * nt * group_rows * nnz / PEAK_TF32_FLOPS
    live = float(tiles.ptr[:, -1].double().sum())
    nbytes = (4.0 * (6 * rows * pad + 5 * nt) + 258.0 * live
              + ng * (4.0 * (nslot + 1) + 2.0 * nslot))
    t_bytes = nbytes / PEAK_BYTES
    return 1e3 * max(t_ops, t_bytes), "operations" if t_ops >= t_bytes else "bytes"


def _tile_work(tiles, group_rows: int, nt: int, wh_maxit: int) -> float:
    """The time (ms) of the tensor-core route's own work at the TF32 peak,
    informational and not a bound on the function: every MAC of each 8-row
    block's 16 x 8 x 8 products over the non-zero tiles, the zeros inside a
    tile included, three passes per tile and step."""
    blocks = -(-group_rows // 8)
    macs = 3 * 16 * 64 * blocks * float(tiles.ptr[:, -1].double().sum()) * nt * wh_maxit
    return 1e3 * 2 * macs / PEAK_TF32_FLOPS


def _compare(wc, p, F, G, wh_maxit, pad_mask, what, variants, reps=3, form=None, tiles=None,
             factored=None, **kw):
    """Each kernel ``variants`` names against the plain cycle on the same
    inputs; raises on a relative error >= 2e-4 or non-zero padding.  Returns
    ({variant: (max abs err, ms)}, plain ms, {variant: (u, v)}).  The plain
    cycle is timed on its checked call; the kernels after their checked
    calls, in turns (v0, v1, ..., v1, v0), ``reps`` launches a turn, so
    each pair is compared on the card's state of the moment.  ``form``,
    ``tiles`` and ``factored`` are the sparse, tensor-core and factored
    kernels' prebuilt forms (None: ``k1_kernel`` builds the first two,
    before the runs; the factored one needs its form); the tensor-core and
    factored kernels are also held to the sparse one (2e-4) and must
    repeat bitwise.  ``"sparse_tiled"`` runs a per-row stack on the sparse kernel
    with each row tiled x8 onto layout (b), as the JAX solver does (and
    the port did before its per-row instance), and reads every 8th row
    back."""
    import torch

    given = {"sparse": form, "mma": tiles, "factored": factored}
    per_row = p.S.dim() == 3 and kw.get("s_group_size") is None

    def kernel(v):
        if given.get(v) is not None:
            return wc.K1(v, given[v])
        return wc.k1_kernel(p.S, per_row=per_row, variant=v)

    kernels = {v: kernel("sparse" if v == "sparse_tiled" else v) for v in variants}

    def run(v):
        if v == "sparse_tiled":
            r = wc.ROWS_PER_BLOCK
            tiled = p._replace(Ha=p.Ha.repeat_interleave(r, 0),
                               inv_mi=p.inv_mi.repeat_interleave(r, 0))
            u, v = wc.wave_cycle(tiled, F.repeat_interleave(r, 0), G.repeat_interleave(r, 0),
                                 wh_maxit, r, kernel=kernels[v])
            return u[::r], v[::r]
        return wc.wave_cycle(p, F, G, wh_maxit, kernel=kernels[v], **kw)

    outs = {v: run(v) for v in variants}
    torch.cuda.synchronize()
    for k in ("mma", "factored"):
        if k not in outs:
            continue
        again = run(k)
        if not all(torch.equal(a, b) for a, b in zip(again, outs[k])):
            _fail(f"{what}: the {k} kernel does not repeat bitwise")
        if "sparse" in outs:
            err = max(_rel_max(a, b) for a, b in zip(outs[k], outs["sparse"]))
            print(f"{what}: {k} against sparse rel err {err:.3e}; {k} repeats bitwise")
            if not err < 2e-4:
                _fail(f"{what}: the {k} and sparse kernels disagree: {err:.3e}")
        del again
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


def _tiles_ms(wc, S):
    """(tile form of S, CUDA-event ms of its build after one untimed build)."""
    wc.tile_form(S)
    return _timed(lambda: wc.tile_form(S))


def _depth(tiles) -> int:
    """The most pairs any warp slot of the tile form walks a step."""
    return int(tiles.ptr.diff(dim=1).max())


def _add_shape(wc, dev, shapes, layout, at, res, plain_ms, bound, pad, nt, wh_maxit, *,
               form=None, form_ms=None, tiles=None, tiles_ms=None, group_rows=None,
               dense=None, factored=None):
    """Append a ``shapes`` row for each K1 kernel ``res`` holds
    (``"factored"``, ``"mma"``, ``"sparse"``) at one shape of layout
    ``layout`` (``"shared"``, ``"grouped"``): its ms, the plain ms, the
    kernel the default picks there and its bound (``bound``, the FP32 one
    on the non-zeros, for the FFMA and factored kernels; ``_mma_bound`` for
    the tensor-core one, with the informational ``_tile_work`` of
    ``group_rows`` rows a matrix), with the other kernels' ms from the same
    turns; prints each kernel's registers, shared memory and blocks per SM
    there."""
    limit = wc._shared_memory_limit(dev.index)
    default = wc.kernel_variant(pad, limit, form.stride if form is not None else None,
                                pairs=tiles.pairs if tiles is not None else None,
                                factored=factored.shape if factored is not None else None)
    forms = {"factored": factored, "mma": tiles, "sparse": form}
    occ = {}
    for k in ("factored", "mma", "sparse"):
        if k not in res:
            continue
        occ[k] = wc.kernel_occupancy(k, pad, forms[k], dev)
        b = bound
        if k == "mma":
            rows = group_rows * tiles.ptr.shape[0]
            b = _mma_bound(tiles, group_rows, rows, pad, nt, wh_maxit)
        row = {"at": at, "ms": res[k][1], "plain_ms": plain_ms, "bound_ms": b[0],
               "bound_by": b[1], "occupancy": occ[k], "default": default,
               **{f"{o}_ms": res[o][1] for o in ("factored", "mma", "sparse")
                  if o != k and o in res}}
        if k == "mma":
            row.update(pairs=tiles.pairs, depth=_depth(tiles), tiles_ms=tiles_ms,
                       tile_work_ms=_tile_work(tiles, group_rows, nt, wh_maxit))
        elif k == "factored":
            row.update(shape=list(factored.shape))
        else:
            row.update(nnz=_nnz(form), stride=form.stride, form_ms=form_ms)
        if dense is not None:
            row.update(dense_ms=res[dense][1], dense=dense)
        shapes[f"{k}_{layout}"].append(row)
    print(f"{at}: registers, dynamic shared memory and blocks per SM {json.dumps(occ)}")


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


def _k1(ddh) -> str:
    """The kernel the DDH's probes (and a shared S's cycles) run in layouts
    (a) and (b), ``DDH.k1_probe``: ``"factored"`` on rectangles (from the
    operator's element factors, where its form fits), ``"mma"`` where
    ``mma_preferred`` holds, else ``"sparse"``."""
    return ddh.k1_probe.variant


K1_KERNELS = ("factored", "mma", "sparse")  # the kernels the default may pick


def _only_k1(launches, key, what, want):
    """Fails unless the run launched ``want``'s kernel (one of
    ``K1_KERNELS``) in layout ``key``, no other of them there, and no dense
    kernel; records the key for the final check that every kernel the
    main paths ask for ran.  ``want`` None (a subprocess's several DDHs,
    whose forms this process cannot see) takes any of them."""
    layout = {"shared": "a", "grouped": "b", "per_row": "c"}[key]
    launched = {k: launches.get(f"{k}_{key}", 0) for k in K1_KERNELS}
    if want is None:
        if not any(launched.values()) or any(launches[k] for k in DENSE):
            _fail(f"{what}: want K1 layout-({layout}) launches and no dense ones, got "
                  f"{launches}")
        return
    others = [k for k in K1_KERNELS if k != want]
    if (launched[want] == 0 or any(launched[k] for k in others)
            or any(launches[k] for k in DENSE)):
        _fail(f"{what}: want {want} layout-({layout}) launches, none of {others} there and no "
              f"dense ones, got {launches}")
    REQUIRED.add(f"{want}_{key}")


def _per_row_vs_tiled(what, outs, res):
    """Print the per-row instance against the x8-tiled route on the same
    inputs: bitwise equality and the time ratio.  Returns whether equal."""
    import torch

    same = all(torch.equal(a, b) for a, b in zip(outs["sparse"], outs["sparse_tiled"]))
    print(f"{what}: per-row {res['sparse'][1]:.3f} ms, tiled x8 {res['sparse_tiled'][1]:.3f} ms "
          f"({res['sparse_tiled'][1] / res['sparse'][1]:.2f}x); outputs bitwise equal: {same}")
    return same


def _per_row_row(wc, dev, what, outs, res, form, pad, at, form_ms, plain_ms, bound,
                 dense=None) -> dict:
    """The ``shapes`` row of a layout-(c) comparison (``_compare`` with
    ``"sparse"`` and ``"sparse_tiled"``): fails unless the per-row instance
    gives the tiled route's outputs bitwise; prints each instance's blocks
    per SM at this shape."""
    if not _per_row_vs_tiled(what, outs, res):
        _fail(f"{what}: the per-row instance differs from the x8-tiled route")
    occ = {k: wc.sparse_blocks_per_sm(pad, form.stride, k == "per_row", dev)
           for k in ("per_row", "grouped")}
    print(f"{what}: blocks per SM, per-row instance {occ['per_row']} x {(pad + 31) // 32} "
          f"warps, {wc.SPARSE_ROWS_PER_BLOCK}-row instance {occ['grouped']}")
    row = {"at": at, "nnz": _nnz(form), "stride": form.stride, "form_ms": form_ms,
           "ms": res["sparse"][1], "tiled_ms": res["sparse_tiled"][1], "plain_ms": plain_ms,
           "bound_ms": bound[0], "bound_by": bound[1], "blocks_per_sm": occ}
    if dense is not None:
        row.update(dense_ms=dense, dense="resident (tiled x8)")
    return row


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

    _reset_launches()
    res = run()
    launches = wc.launch_counts()
    ddh = res.extra["ddh"]
    pre = res.extra["precompute"]
    omega = res.extra["omega"]
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, omega)).to(ddh.gmask.device)
    # the same solve again on the prepared operator: it must launch no kernel
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2, _ = ddh.solver(gm.m, gm.maxit, gm.tol)(b)
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    solve_launches = sum(wc.launch_counts().values())
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


def _graph_phase(dev, ddh, counts5, gm) -> None:
    """Phase 34 on the prepared flagship transfer DDH ``ddh`` of phase 5
    (whose solves captured the K = 1 apply): the graphed apply against the
    eager one, the lambda-solve against ``counts5`` and the eager solve, P
    against P on the eager apply, and the host microseconds of an apply in
    turns, without and with the profiler."""
    import torch

    from cuddhelmholtz_tpu_torch.examples.drivers import point_sources
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
    from cuddhelmholtz_tpu_torch.solvers.ddh import DDHPreconditioner, ddh_action_transfer_rolled
    from cuddhelmholtz_tpu_torch.solvers.gmres import gmres
    from cuddhelmholtz_tpu_torch.utils import spans

    t34 = time.perf_counter()
    if ddh.route is None:
        _fail("phase 34: the flagship transfer DDH has no roll route")

    def eager(lam):
        return ddh_action_transfer_rolled(ddh.params, ddh.route, lam, ddh.n_own)

    rng = np.random.default_rng(34)

    def lam_of(K):
        shape = (ddh.size,) if K == 1 else (K, ddh.size)
        return torch.from_numpy(rng.standard_normal(shape).astype(np.float32)).to(dev)

    spans.reset("ddh.action.")
    for K in (1, 8):
        lam = lam_of(K)
        got = [ddh.action(lam) for _ in range(2)]
        want = eager(lam)
        if not all(torch.equal(g, want) for g in got):
            err = max(float((g - want).abs().max()) for g in got)
            _fail(f"phase 34: graphed apply at K = {K} differs from the eager one by {err:.3e}")
    captured = spans.totals("ddh.action.")
    if captured != {"captures": 1, "graphed": 4}:
        _fail(f"phase 34: counters {captured}; want one capture (K = 8) and 4 replays")

    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, ddh.omega)).to(dev)
    out, _ = ddh.solver(gm.m, gm.maxit, gm.tol)(b)
    ref = gmres(eager, ddh.rhs(b), m=gm.m, maxit=gm.maxit, tol=gm.tol)
    P = DDHPreconditioner(ddh)
    v = torch.from_numpy(rng.standard_normal(2 * ddh.g_ndof)).to(dev)
    p1, p2 = P(v), P(v)
    v32 = v.to(torch.float32)
    inner = gmres(eager, ddh.rhs(v32), m=P.inner_m, maxit=P.inner_maxit, tol=0.0)
    p_eager = ddh.postprocess(inner.x, v32).to(v.dtype)
    counts = spans.totals("ddh.action.")
    print(f"phase 34: graphed apply bitwise the eager one at K = 1 and 8; lambda-solve "
          f"{out.num_iter} / {out.num_matvec} (phase 5 {counts5}, eager {ref.num_iter} / "
          f"{ref.num_matvec}), x bitwise the eager solve's: {torch.equal(out.x, ref.x)}; P "
          f"repeats bitwise: {torch.equal(p1, p2)}, bitwise P on the eager apply: "
          f"{torch.equal(p1, p_eager)}; counters {counts}")
    if (out.num_iter, out.num_matvec) != counts5 or (ref.num_iter, ref.num_matvec) != counts5:
        _fail(f"phase 34: lambda-solve {out.num_iter} / {out.num_matvec}, eager "
              f"{ref.num_iter} / {ref.num_matvec}; want phase 5's {counts5}")
    if not torch.equal(out.x, ref.x):
        _fail("phase 34: the graphed lambda-solve is not bitwise the eager one")
    if not (torch.equal(p1, p2) and torch.equal(p1, p_eager)):
        _fail("phase 34: P does not repeat bitwise or differs from P on the eager apply")
    if counts.get("captures") != 1 or counts.get("eager", 0):
        _fail(f"phase 34: counters {counts}; want no capture after the K = 8 one, no eager")

    lam = lam_of(1)

    def host_us(fn, reps=300):
        """(enqueue us, us to the device's end) per call of ``fn(lam)``."""
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        for _ in range(reps):
            fn(lam)
        t1 = time.perf_counter()
        torch.cuda.synchronize(dev)
        return 1e6 * (t1 - t0) / reps, 1e6 * (time.perf_counter() - t0) / reps

    host_us(eager, 20)
    host_us(ddh.action, 20)
    turns = [("eager", host_us(eager)), ("graphed", host_us(ddh.action)),
             ("graphed", host_us(ddh.action)), ("eager", host_us(eager))]
    _, dev_eager_ms = _timed(lambda: eager(lam), 300)
    _, dev_graph_ms = _timed(lambda: ddh.action(lam), 300)
    # the same turns inside a profiler recording of the device, as the
    # benchmark's traced windows run
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]):
        traced = [("eager", host_us(eager, 100)), ("graphed", host_us(ddh.action, 100)),
                  ("graphed", host_us(ddh.action, 100)), ("eager", host_us(eager, 100))]
    print("phase 34: host us per K = 1 apply in turns (enqueue, to the device's end): "
          + "; ".join(f"{n} {e:.1f}, {d:.1f}" for n, (e, d) in turns)
          + "; under the profiler: "
          + "; ".join(f"{n} {e:.1f}, {d:.1f}" for n, (e, d) in traced)
          + f"; CUDA-event ms per apply over 300: eager {dev_eager_ms:.4f}, graphed "
          f"{dev_graph_ms:.4f}; {time.perf_counter() - t34:.1f} s")



def _eager_steps():
    """A context in which every GMRES restart runs its steps eagerly (the
    step graphs' cache hands out no workspace)."""
    import contextlib

    from cuddhelmholtz_tpu_torch.solvers import gmres as gmres_mod

    @contextlib.contextmanager
    def ctx():
        take = gmres_mod._workspace
        gmres_mod._workspace = lambda r, m, reorth: None
        try:
            yield
        finally:
            gmres_mod._workspace = take

    return ctx()


def _step_graph_phase(dev, ddh, counts5, gm) -> None:
    """Phase 35 on the prepared flagship transfer DDH ``ddh`` of phase 5
    (whose solves captured the λ key's step graphs): the λ-solve with graphed
    and with eager steps (phase 5's counts, x bitwise), host ms per step of
    both in turns, CUDA-event device ms of one step's bookkeeping (a replay
    against the eager step); then the composite: ``helmholtz_ddh_1e6``
    (11 / 235 on both paths) and, on its DDH, the benchmark's float64
    FGMRES(20) to 1e-6 through ``ddh_solve_hook`` (bitwise on both paths)."""
    import torch

    from cuddhelmholtz_tpu_torch.config import HELMHOLTZ_DDH_1E6 as hcfg
    from cuddhelmholtz_tpu_torch.examples.drivers import (
        point_sources,
        run_config,
        wave_speed_coeff,
    )
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.models.helmholtz import (
        apply_helmholtz,
        helmholtz_rhs,
        make_helmholtz_op,
        project_coefficients,
    )
    from cuddhelmholtz_tpu_torch.models.inverse import ddh_solve_hook
    from cuddhelmholtz_tpu_torch.ops.structured import GridH1Space
    from cuddhelmholtz_tpu_torch.solvers import gmres as gmres_mod
    from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace
    from cuddhelmholtz_tpu_torch.utils import spans
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    t35 = time.perf_counter()
    step = "gmres.step."
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, ddh.omega)).to(dev)
    y = ddh.rhs(b)

    def lam_solve():
        return gmres_mod.gmres(ddh.action, y, m=gm.m, maxit=gm.maxit, tol=gm.tol)

    def host_ms(eager: bool):
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if eager:
            with _eager_steps():
                out = lam_solve()
        else:
            out = lam_solve()
        torch.cuda.synchronize(dev)
        return out, 1e3 * (time.perf_counter() - t0)

    # the λ key's captures: a first solve on a fresh cache against the next
    cached = dict(gmres_mod._WORKSPACES)
    gmres_mod._WORKSPACES.clear()
    spans.reset(step)
    _, first_ms = host_ms(False)
    captures = spans.total(step + "captures")
    _, next_ms = host_ms(False)
    gmres_mod._WORKSPACES.clear()
    gmres_mod._WORKSPACES.update(cached)
    print(f"phase 35: a first lambda-solve on an empty cache {first_ms:.1f} ms with {captures} "
          f"captures, the next {next_ms:.1f} ms: {(first_ms - next_ms) / captures:.2f} ms a capture")
    spans.reset(step)
    graphed, _ = host_ms(False)
    got = spans.totals(step)
    eager, _ = host_ms(True)
    steps = graphed.num_matvec - 1 - graphed.num_iter
    same = (torch.equal(graphed.x, eager.x)
            and torch.equal(graphed.res_norm[: graphed.n_hist], eager.res_norm[: eager.n_hist]))
    print(f"phase 35: lambda-solve graphed {graphed.num_iter} / {graphed.num_matvec}, eager "
          f"{eager.num_iter} / {eager.num_matvec} (phase 5 {counts5}); x and history bitwise: "
          f"{same}; counters of the graphed solve {got}")
    if (graphed.num_iter, graphed.num_matvec) != counts5 or (
            eager.num_iter, eager.num_matvec) != counts5:
        _fail(f"phase 35: counts {graphed.num_iter} / {graphed.num_matvec} graphed, "
              f"{eager.num_iter} / {eager.num_matvec} eager; want phase 5's {counts5}")
    if not same:
        err = float((graphed.x - eager.x).abs().max() / eager.x.abs().max())
        _fail(f"phase 35: the graphed lambda-solve is not bitwise the eager one (x {err:.3e})")
    if got != {"graphed": steps}:
        _fail(f"phase 35: counters {got}; want {steps} replays, no capture, no eager step")
    turns = [(name, host_ms(name == "eager")[1] / steps)
             for name in ("graphed", "eager", "eager", "graphed")]
    # one step's bookkeeping on the device: replays of the captured step
    # against the eager step on copies of the same state
    (ws,) = [w for (n, m, dt, _, reorth), w in gmres_mod._WORKSPACES.items()
             if (n, m, dt, reorth) == (y.shape[0], gm.m, y.dtype, True)]
    k = gm.m // 2
    state = [t.clone() for t in ws.state()]
    w = ws.w.clone()
    _, replay_ms = _timed(lambda: ws.graphs[k].replay(), 300)
    _, eager_ms = _timed(lambda: gmres_mod._arnoldi_givens(*state, w, k, True), 300)
    print("phase 35: host ms per lambda step in turns (untraced, matvec included): "
          + "; ".join(f"{n} {t:.4f}" for n, t in turns)
          + f"; step {k}'s bookkeeping, CUDA-event ms over 300: replay {replay_ms:.4f}, eager "
          f"{eager_ms:.4f}; step graphs kept: {sum(g is not None for g in ws.graphs)} of "
          f"{gm.m}")

    # the composite, graphed and eager: counts and solution
    spans.reset(step)
    res = run_config(hcfg, device=dev, measure_warm=False)
    got = spans.totals(step)
    with _eager_steps():
        res_e = run_config(hcfg, device=dev, measure_warm=False)
    counts = (res.num_iter, res.num_matvec)
    print(f"phase 35: helmholtz_ddh_1e6 graphed {counts} in {res.seconds:.3f} s, eager "
          f"{(res_e.num_iter, res_e.num_matvec)} in {res_e.seconds:.3f} s; solution bitwise: "
          f"{np.array_equal(res.solution, res_e.solution)}; counters of the graphed run {got}")
    if counts != (11, 235) or (res_e.num_iter, res_e.num_matvec) != (11, 235):
        _fail(f"phase 35: helmholtz_ddh_1e6 {counts} graphed, "
              f"{(res_e.num_iter, res_e.num_matvec)} eager; want (11, 235)")
    if not got.get("graphed"):
        _fail(f"phase 35: helmholtz_ddh_1e6 replayed no step graph ({got})")

    # the benchmark's composite solve on that DDH: standard float64 FGMRES(20)
    hddh = res.extra["ddh"]
    nx = hcfg.nx
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = GridH1Space(mesh, Basis(hcfg.deg + 1), nx, nx)
    fs = FaceSpace(fem, mesh.boundary_edges)
    a2, af = project_coefficients(fem, fs, wave_speed_coeff)
    op = make_helmholtz_op(res.extra["omega"], a2, af, fem, fs, dtype=torch.float64, device=dev)
    hb = helmholtz_rhs(fem, lambda xy: point_sources(xy, res.extra["omega"])).to(dev)

    def composite(eager: bool):
        hook = ddh_solve_hook(hddh, m=hcfg.gmres.m, maxit=hcfg.gmres.maxit, tol=hcfg.gmres.tol)
        spans.reset(step)
        torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        if eager:
            with _eager_steps():
                x = hook(lambda U: apply_helmholtz(op, U), hb)
        else:
            x = hook(lambda U: apply_helmholtz(op, U), hb)
        torch.cuda.synchronize(dev)
        return x, hook, time.perf_counter() - t0, spans.totals(step)

    xg, hg, sg, cg = composite(False)
    xe, he, se, ce = composite(True)
    rg, re_ = hg.results[-1], he.results[-1]
    same = torch.equal(xg, xe) and torch.equal(rg.res_norm[: rg.n_hist],
                                               re_.res_norm[: re_.n_hist])
    rel = float(torch.linalg.vector_norm(hb - apply_helmholtz(op, xg))
                / torch.linalg.vector_norm(hb))
    print(f"phase 35: composite FGMRES(20) to 1e-6 through ddh_solve_hook: graphed "
          f"{rg.num_iter} / {rg.num_matvec}, {hg.precond.calls} P, {sg:.3f} s "
          f"({1e3 * sg / hg.precond.calls:.2f} ms a step, counters {cg}); eager "
          f"{re_.num_iter} / {re_.num_matvec}, {he.precond.calls} P, {se:.3f} s "
          f"({1e3 * se / he.precond.calls:.2f} ms a step, counters {ce}); x and history "
          f"bitwise: {same}; relative residual {rel:.3e}; {time.perf_counter() - t35:.1f} s")
    if (rg.num_iter, rg.num_matvec, hg.precond.calls) != (
            re_.num_iter, re_.num_matvec, he.precond.calls) or not same:
        _fail("phase 35: the graphed composite solve is not the eager one")
    if ce.get("graphed") or cg.get("eager") or not rel <= 1.2e-6:
        _fail(f"phase 35: counters graphed {cg}, eager {ce}; residual {rel:.3e}")


def phase_35() -> int:
    """Phases 1 (the build), 5 (the flagship transfer solve), 34 and 35
    alone: ``python3 -c 'import chip_smoke, sys; sys.exit(chip_smoke.phase_35())'``."""
    import torch

    from cuddhelmholtz_tpu_torch.config import DDH_STRUCTURED as cfg
    from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh
    from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc

    os.environ["CUDDH_CACHE_DIR"] = ""
    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(f"card: {smi}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    for variant in wc.build():
        wc._library(variant)
    res5 = run_ddh(nx=cfg.nx, deg=cfg.deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit,
                   tol=cfg.gmres.tol, wh_maxit=cfg.wh_maxit, block_size=cfg.block_size,
                   transfer=True, device=dev)
    print(f"phase 5: {res5.num_iter} / {res5.num_matvec}, solve {res5.seconds:.3f} s")
    counts5 = (res5.num_iter, res5.num_matvec)
    _graph_phase(dev, res5.extra["ddh"], counts5, cfg.gmres)
    _step_graph_phase(dev, res5.extra["ddh"], counts5, cfg.gmres)
    print(smi)
    return 0

def _cache_pair(wc, run, what, cache_dir):
    """Run ``run`` twice in the cache directory ``cache_dir``: a miss, then a
    hit that must launch no kernel and reproduce the first run bitwise (T,
    groups, io maps, counts, history, solution).  Returns (the cold result,
    its launches)."""
    import torch

    _reset_launches()
    cold = run()
    l_cold = wc.launch_counts()
    _reset_launches()
    warm = run()
    n_warm = sum(wc.launch_counts().values())
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

    _reset_launches()
    res = run()
    launches = wc.launch_counts()
    ddh, pre = res.extra["ddh"], res.extra["precompute"]
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, res.extra["omega"]))
    b = b.to(ddh.gmask.device)
    solve = ddh.solver(gm.m, gm.maxit, gm.tol, coarse=coarse)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2, U2 = solve(b)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    again = sum(wc.launch_counts().values())
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
    _only_k1(launches, "shared", what, _k1(ddh))
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

    _reset_launches()
    res = run()
    launches = wc.launch_counts()
    ex = res.extra
    pre = ex["precompute"]
    P = ex["precond"]
    n2 = 2 * ex["ndof"]
    v = torch.from_numpy(np.random.default_rng(3).standard_normal(n2)).to(dev)
    _reset_launches()
    p_ms = _ms_per_call(lambda: P(v), dev)
    p_launches = sum(wc.launch_counts().values())
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


FWI_EPS = 1e-3  # central-difference step along the unit direction v
FWI_STEP = 1e-2  # descent step: the largest nodal change of a, relative to a0 = 1


def _fwi_run(wc, dev, nx: int = 128, deg: int = 3) -> tuple[dict, dict]:
    """Phase 25: a wave-speed inversion at the flagship problem (nx 128,
    deg 3, omega 2 pi nx / 10, the point sources, the true model the nodal
    ``wave_speed_coeff``, receivers at the boundary face DOFs of u and v,
    start model a0 = 1).

    Every solve of the inversion runs through ``ddh_solve_hook(m=20,
    maxit=100, tol=1e-8)`` with its DDH frozen at a0: the misfit and its
    gradient at a0 twice (bitwise the same), a central difference at a0
    along a seeded smooth unit direction v (``FWI_EPS``), then
    ``invert_wavespeed(steps=2)`` at ``step_size = FWI_STEP / max|g(a0)|``.
    The observed data are solved through the same hook on a DDH frozen at
    the true model: a DDH frozen at a0 stalls on the true model's operator
    (its disc has a = 0.2, one fifth of P's), which the run records with
    ``maxit=10`` (``stalled``: restarts and relative history).  Each solve
    of the hooks at maxit 100 must succeed with a true fp64 relative
    residual <= 1e-8, recomputed with the template's operator (checked as
    it ends).  Returns
    (summary, launches of the run): K1 runs only in the two ``prepare``s,
    two probes each."""
    import torch

    from cuddhelmholtz_tpu_torch.examples.drivers import point_sources, wave_speed_coeff
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs, make_helmholtz_template
    from cuddhelmholtz_tpu_torch.models.inverse import (
        ddh_solve_hook,
        invert_wavespeed,
        misfit,
        solve_helmholtz_diff,
    )
    from cuddhelmholtz_tpu_torch.ops.functional import linear_functional
    from cuddhelmholtz_tpu_torch.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
    from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
    from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace, H1Space
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = H1Space(mesh, Basis(deg + 1))
    fs = FaceSpace(fem, mesh.boundary_edges)
    n = fem.ndof
    a_true = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"),
                                 linear_functional(fem, wave_speed_coeff)).numpy()
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega)).to(dev)
    obs_idx = torch.as_tensor(np.concatenate([fs.proj, n + fs.proj]), device=dev)
    a0 = torch.ones(n, dtype=torch.float64, device=dev)
    x, y = (fem.coords[:, 0] + 1) / 2, (fem.coords[:, 1] + 1) / 2
    c = np.random.default_rng(25).standard_normal((3, 3))
    v = sum(c[k, j] * np.sin((k + 1) * np.pi * x) * np.sin((j + 1) * np.pi * y)
            for k in range(3) for j in range(3))
    v = torch.as_tensor(v / np.linalg.norm(v), device=dev)
    tmpl = make_helmholtz_template(fem, fs, device=dev)

    _reset_launches()
    t0 = time.perf_counter()
    ddh = DDH(omega, np.ones(n), fem, nx=nx, ny=nx, device=dev)
    pstats = ddh.prepare(cache_dir="", want_io=True)
    sync()
    setup_s = time.perf_counter() - t0
    ddh_true = DDH(omega, a_true, fem, nx=nx, ny=nx, device=dev)
    ddh_true.prepare(cache_dir="", want_io=True)
    solves = []

    def hooked(hook, required=True):
        """``hook``, recording (and printing) each solve's restarts, P
        applies, seconds and true fp64 relative residual with the
        template's operator ``mv``; a ``required`` solve must succeed in
        <= 100 restarts with that residual <= 1e-8."""
        def solve(mv, rhs):
            calls, t = hook.precond.calls, time.perf_counter()
            xs = hook(mv, rhs)
            sync()
            out = hook.results[-1]
            bn = torch.linalg.vector_norm(rhs)
            solves.append({
                "what": "", "restarts": out.num_iter, "matvecs": out.num_matvec,
                "p": hook.precond.calls - calls, "seconds": time.perf_counter() - t,
                "rel": float(torch.linalg.vector_norm(rhs - mv(xs)) / bn),
                "success": out.success,
                "history": (out.res_norm[: out.n_hist] / bn).tolist()})
            e = solves[-1]
            print(f"fwi solve {len(solves)}: {e['restarts']} restarts / {e['matvecs']} "
                  f"matvecs, {e['p']} P, {e['seconds']:.2f} s, rel {e['rel']:.3e}", flush=True)
            if required and not (e["success"] and e["restarts"] <= 100 and e["rel"] <= 1e-8):
                _fail(f"fwi solve {len(solves)}: success={e['success']} in {e['restarts']} "
                      f"restarts, true relative residual {e['rel']:.3e}; want success, "
                      f"<= 100, <= 1e-8; relative history {e['history']}")
            return xs

        return solve

    hook = ddh_solve_hook(ddh, m=20, maxit=100, tol=1e-8)
    kw = {"solve": hooked(hook)}
    a_true_t = torch.as_tensor(a_true, device=dev)
    with torch.no_grad():
        observed = solve_helmholtz_diff(
            tmpl, omega, a_true_t, b,
            solve=hooked(ddh_solve_hook(ddh_true, m=20, maxit=100, tol=1e-8)))[obs_idx]
        solves[-1]["what"] = "observed data (P frozen at the true model)"
        solve_helmholtz_diff(tmpl, omega, a_true_t, b,
                             solve=hooked(ddh_solve_hook(ddh, m=20, maxit=10, tol=1e-8),
                                          required=False))
        stalled = solves.pop()
        stalled["what"] = "true model, P frozen at a0, maxit 10 (recorded)"

    def value_grad(a, what):
        a = a.detach().requires_grad_()
        sync()
        t = time.perf_counter()
        val = misfit(tmpl, omega, a, b, observed, obs_idx, **kw)
        (g,) = torch.autograd.grad(val, a)
        sync()
        solves[-2]["what"], solves[-1]["what"] = f"{what} forward", f"{what} adjoint"
        return float(val.detach()), g, time.perf_counter() - t

    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    f0, g1, vg1 = value_grad(a0, "gradient 1 at a0")
    _, g2, vg2 = value_grad(a0, "gradient 2 at a0")
    peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else None
    with torch.no_grad():
        fp = float(misfit(tmpl, omega, a0 + FWI_EPS * v, b, observed, obs_idx, **kw))
        solves[-1]["what"] = "f(a0 + eps v)"
        fm = float(misfit(tmpl, omega, a0 - FWI_EPS * v, b, observed, obs_idx, **kw))
        solves[-1]["what"] = "f(a0 - eps v)"
    fd = (fp - fm) / (2 * FWI_EPS)
    ad = float(g1 @ v)
    step = FWI_STEP / float(g1.abs().max())
    n0 = len(solves)
    t = time.perf_counter()
    a2, hist = invert_wavespeed(fem, fs, omega, b, observed, a0, obs_idx=obs_idx, steps=2,
                                step_size=step, solve_kwargs=kw, device=dev)
    inv_s = time.perf_counter() - t
    for i, entry in enumerate(solves[n0:]):
        entry["what"] = f"invert step {i // 2 + 1} {('forward', 'adjoint')[i % 2]}"
    launches = wc.launch_counts()
    hist = hist.cpu().numpy()
    summary = {
        "nx": nx, "ndof": n, "unknowns": 2 * n, "omega": omega, "n_domains": ddh.n_domains,
        "setup_seconds": setup_s, "prepare": pstats, "loss": hist.tolist(), "f0": f0,
        "step_size": step, "directional": ad, "central_difference": fd,
        "fd_rel": abs(ad - fd) / abs(fd), "grad_repeats_bitwise": torch.equal(g1, g2),
        "grad_finite": bool(torch.isfinite(g1).all()), "grad_inf_norm": float(g1.abs().max()),
        "value_grad_seconds": [vg1, vg2], "invert_seconds": inv_s,
        "a_finite": bool(torch.isfinite(a2).all()), "peak_memory_bytes": peak,
        "hist0_is_f0": float(hist[0]) == f0, "solves": solves, "stalled": stalled,
        "ms_per_p": 1e3 * sum(e["seconds"] for e in solves) / sum(e["p"] for e in solves),
    }
    if not hist[1] < hist[0]:
        _fail(f"fwi: the loss did not fall: {hist.tolist()}")
    if not (summary["grad_finite"] and summary["a_finite"]):
        _fail("fwi: non-finite gradient or model")
    if not summary["fd_rel"] <= 1e-3:
        _fail(f"fwi: g.v = {ad:.9e} against the central difference {fd:.9e} "
              f"(rel {summary['fd_rel']:.2e} > 1e-3)")
    if not summary["grad_repeats_bitwise"]:
        _fail("fwi: two gradient evaluations at a0 differ")
    return summary, launches


def _host_loop_run(dev, res14, nx: int = 128) -> dict:
    """Phase 26: the host-loop solvers on ``helmholtz_unpreconditioned``'s
    problem (nx 128, fp32, GMRES(200) to 1e-6).  ``run_helmholtz(maxit=10,
    max_seconds=3600, verbose=2)`` runs ``gmres_host`` and must give phase
    14's counts and history (``res14``) bitwise, with 10 per-restart times;
    ``run_helmholtz(maxit=10_000, max_seconds=5)`` must stop at the first
    restart that ends past 5 s.  Then LGMRES(200, 3) with maxit 10 on the
    same operator, beside GMRES(203) at the same matvec count (recorded,
    nothing required)."""
    import torch

    from cuddhelmholtz_tpu_torch.examples.drivers import (
        point_sources,
        run_helmholtz,
        wave_speed_coeff,
    )
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.models.helmholtz import (
        apply_helmholtz,
        helmholtz_rhs,
        make_helmholtz_op,
        project_coefficients,
    )
    from cuddhelmholtz_tpu_torch.ops.structured import GridH1Space
    from cuddhelmholtz_tpu_torch.solvers.gmres import gmres, lgmres
    from cuddhelmholtz_tpu_torch.spaces.h1 import FaceSpace
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    out = {}
    kw = dict(nx=nx, dtype=torch.float32, device=dev)
    host = run_helmholtz(maxit=10, max_seconds=3600, verbose=2, **kw)
    times = host.extra["times"]
    out["host"] = {"restarts": host.num_iter, "matvecs": host.num_matvec,
                   "seconds": host.seconds, "times": times,
                   "rel": float(host.res_norm[-1] / host.res_norm[0])}
    if ((host.num_iter, host.num_matvec, host.success) != (res14.num_iter, res14.num_matvec,
                                                            res14.success)
            or not np.array_equal(host.res_norm, res14.res_norm) or len(times) != 10):
        _fail(f"run_helmholtz(max_seconds=3600, verbose=2): {host.num_iter} / "
              f"{host.num_matvec}, {len(times)} times; want phase 14's {res14.num_iter} / "
              f"{res14.num_matvec} and history bitwise, 10 times")
    clock = run_helmholtz(maxit=10_000, max_seconds=5, **kw)
    times = clock.extra["times"]
    out["clock"] = {"restarts": clock.num_iter, "matvecs": clock.num_matvec,
                    "seconds": clock.seconds, "last_times": times[-3:],
                    "rel": float(clock.res_norm[-1] / clock.res_norm[0])}
    if not (times[-1] > 5 >= times[-2]) or clock.success:
        _fail(f"run_helmholtz(max_seconds=5): times end {times[-3:]}, success "
              f"{clock.success}; want the first restart past 5 s to end the solve")

    omega = 2 * np.pi * nx / 10
    mesh = Mesh2D.uniform_rect(nx, -1.0, 1.0, nx, -1.0, 1.0)
    fem = GridH1Space(mesh, Basis(4), nx, nx)
    fs = FaceSpace(fem, mesh.boundary_edges)
    a2, af = project_coefficients(fem, fs, wave_speed_coeff, dtype=torch.float32)
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, omega), dtype=torch.float32).to(dev)
    op = make_helmholtz_op(omega, a2, af, fem, fs, dtype=torch.float32, device=dev)

    def matvec(U):
        return apply_helmholtz(op, U)

    for name, solve in (("lgmres(m=200, k=3)", lambda: lgmres(matvec, b, m=200, k=3, maxit=10,
                                                                 tol=1e-6)),
                        ("gmres(m=203)", lambda: gmres(matvec, b, m=203, maxit=10, tol=1e-6))):
        torch.cuda.synchronize(dev)
        t = time.perf_counter()
        res = solve()
        torch.cuda.synchronize(dev)
        hist = res.res_norm[: res.n_hist].cpu().numpy()
        out[name] = {"restarts": res.num_iter, "matvecs": res.num_matvec,
                     "seconds": time.perf_counter() - t, "rel": float(hist[-1] / hist[0])}
    return out


def _studies_run(counts5) -> tuple[dict, dict]:
    """Phase 27: ``python -m cuddhelmholtz_tpu_torch.examples.sweep
    --transfer 32 64 128`` (every record successful, nx 128 at the flagship
    transfer solve's counts ``counts5``) and ``partition_study --nx 32``
    (every case successful), each in a subprocess.  Returns the records and
    the two runs' kernel launches."""
    lines, launches = _module_run("cuddhelmholtz_tpu_torch.examples.sweep",
                                  ["--transfer", "32", "64", "128"], "sweep")
    sweep = json.loads(lines[-1])
    if [r["nx"] for r in sweep] != [32, 64, 128] or not all(r["success"] for r in sweep):
        _fail(f"sweep: {lines[-1][:2000]}")
    if (sweep[2]["iters"], sweep[2]["matvecs"]) != counts5:
        _fail(f"sweep nx 128: {sweep[2]['iters']} / {sweep[2]['matvecs']}; want phase 5's "
              f"{counts5}")
    lines, more = _module_run("cuddhelmholtz_tpu_torch.examples.partition_study",
                              ["--nx", "32"], "partition study")
    cases = [json.loads(ln) for ln in lines if ln.startswith("{")]
    if len(cases) != 5 or not all(c["success"] for c in cases):
        _fail(f"partition study: {len(cases)} cases, successes {[c['success'] for c in cases]}")
    return {"sweep": sweep, "partition": cases}, {k: launches[k] + more[k] for k in launches}


def _module_run(module: str, args: list[str], what: str) -> tuple[list[str], dict]:
    """Run ``python -m module args`` from the repository root as ``-m``
    does (``runpy``), in a fresh process whose kernel counts start at 0; it
    must exit 0.  Returns its stdout lines and the kernel launches it made
    (read at its end)."""
    code = "\n".join([
        "import json, runpy, sys",
        "from cuddhelmholtz_tpu_torch.ops.cuda import wave_cycle as wc",
        f"sys.argv = [{module!r}] + sys.argv[1:]",
        "try:",
        f"    runpy.run_module({module!r}, run_name='__main__', alter_sys=True)",
        "except SystemExit as e:",
        "    if e.code not in (0, None):",
        "        raise",
        "print('LAUNCHES ' + json.dumps(wc.launch_counts()), file=sys.stderr)",
    ])
    root = os.path.dirname(os.path.abspath(__file__))
    p = subprocess.run([sys.executable, "-c", code, *args], capture_output=True, text=True,
                       timeout=900, cwd=root)
    tail = [ln for ln in p.stderr.splitlines() if ln.startswith("LAUNCHES ")]
    if p.returncode != 0 or not tail:
        _fail(f"{what} exited {p.returncode}: {p.stdout[-2000:]} {p.stderr[-2000:]}")
    return p.stdout.splitlines(), json.loads(tail[-1][len("LAUNCHES "):])


def _phases_25_to_27(wc, dev, res14, counts5, total, k1) -> None:
    """Phases 25-27 (``_fwi_run``, ``_host_loop_run``, ``_studies_run``),
    with their prints and launch checks; their launches are added to
    ``total``.  ``res14`` is phase 14's ``helmholtz_unpreconditioned``
    result, ``counts5`` phase 5's flagship transfer counts, ``k1`` the
    kernel the flagship's pad-176 cycles run by default (``_k1``)."""
    # --- 25. wave-speed inversion at the flagship problem ------------------------
    t25 = time.perf_counter()
    fwi, launches = _fwi_run(wc, dev)
    print(f"fwi: nx {fwi['nx']}, {fwi['unknowns']} unknowns, {fwi['n_domains']} subdomains; "
          f"prepare {json.dumps(fwi['prepare'])}, setup {fwi['setup_seconds']:.2f} s; "
          f"launches {launches}")
    for e in fwi["solves"] + [fwi["stalled"]]:
        print(f"fwi solve, {e['what']}: {e['restarts']} restarts / {e['matvecs']} matvecs, "
              f"{e['p']} P, {e['seconds']:.2f} s, true relative residual {e['rel']:.3e}")
    print(f"fwi: relative history of the stalled solve: "
          f"{[float(f'{h:.4e}') for h in fwi['stalled']['history']]}")
    print(f"fwi: loss {fwi['loss']} at step_size {fwi['step_size']:.6e} (FWI_STEP "
          f"{FWI_STEP} / max|g| {fwi['grad_inf_norm']:.6e}); g.v {fwi['directional']:.12e}, "
          f"central difference {fwi['central_difference']:.12e} (rel {fwi['fd_rel']:.2e}); "
          f"gradient repeats bitwise {fwi['grad_repeats_bitwise']}; invert hist[0] == f(a0) "
          f"{fwi['hist0_is_f0']}")
    print(f"fwi: value and gradient {fwi['value_grad_seconds'][0]:.2f} s and "
          f"{fwi['value_grad_seconds'][1]:.2f} s, invert_wavespeed(steps=2) "
          f"{fwi['invert_seconds']:.2f} s, {fwi['ms_per_p']:.2f} ms per P (solve wall), "
          f"peak device memory {fwi['peak_memory_bytes'] / 1e9:.3f} GB")
    if launches != {**dict.fromkeys(launches, 0), f"{k1}_shared": 4}:
        _fail(f"fwi: launches {launches}; want the {k1} layout-(a) probes of the two "
              "prepares, two each")
    for k in total:
        total[k] += launches[k]
    print(f"phase 25: {time.perf_counter() - t25:.1f} s")

    # --- 26. the host-loop solvers at nx 128 -------------------------------------
    t26 = time.perf_counter()
    hl = _host_loop_run(dev, res14)
    print(f"run_helmholtz(maxit=10, max_seconds=3600, verbose=2): {hl['host']['restarts']} / "
          f"{hl['host']['matvecs']} bitwise phase 14's, {hl['host']['seconds']:.2f} s, times "
          f"{[round(t, 3) for t in hl['host']['times']]}")
    c = hl["clock"]
    print(f"run_helmholtz(maxit=10000, max_seconds=5): stopped after {c['restarts']} restarts "
          f"/ {c['matvecs']} matvecs, times end {c['last_times']}, rel {c['rel']:.6f}")
    for name in ("lgmres(m=200, k=3)", "gmres(m=203)"):
        r = hl[name]
        print(f"{name}, maxit 10: {r['restarts']} / {r['matvecs']}, final relative residual "
              f"{r['rel']:.6e}, {r['seconds']:.2f} s")
    print(f"phase 26: {time.perf_counter() - t26:.1f} s")

    # --- 27. the sweep and the partition study in subprocesses -------------------
    t27 = time.perf_counter()
    st, launches = _studies_run(counts5)
    jax_tpu = {32: (10, 197), 64: (12, 247), 128: (18, 363)}
    for r in st["sweep"]:
        print(f"sweep nx {r['nx']}: {r['iters']} / {r['matvecs']} (JAX on the TPU, older code: "
              f"{jax_tpu[r['nx']][0]} / {jax_tpu[r['nx']][1]}), solve {r['seconds']:.3f} s, "
              f"setup {r['setup_seconds']:.2f} s, rel {r['final_rel_res']:.3e}")
    for r in st["partition"]:
        print(f"partition study: {json.dumps(r)}")
    print(f"studies launches {launches}")
    _only_k1(launches, "shared", "studies (the sweep's probes)", k1)
    _only_k1(launches, "grouped", "studies (the partition study's probes)", None)
    for k in total:
        total[k] += launches[k]
    print(f"phase 27: {time.perf_counter() - t27:.1f} s")


L4_DOMAINS = 1024
L4_OMEGA_JAX = 107.656  # docs/artifacts/large_unstructured_L4.json (rounded there)
L4_PROBE_RUNS = 64  # probe runs of L4's layout-(b) comparison (of 1,024)


def _topology_seconds(mesh) -> dict:
    """Seconds of ``Mesh2D`` + ``H1Space(Basis(4))`` on ``mesh``'s arrays with
    the native topology and with ``CUDDH_NATIVE=0``; both must give the same
    tables.  The library's build (first use) is timed apart."""
    from cuddhelmholtz_tpu_torch import native
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    t0 = time.perf_counter()
    native.library()
    out = {"build_seconds": time.perf_counter() - t0}
    tables = {}
    try:
        for flag in ("1", "0"):
            os.environ["CUDDH_NATIVE"] = flag
            t0 = time.perf_counter()
            m = Mesh2D(mesh.vertices, mesh.elem_vertices)
            f = H1Space(m, Basis(4))
            out["native" if flag == "1" else "numpy"] = time.perf_counter() - t0
            tables[flag] = (m.edge_vertices, m.edge_elements, m.edge_sides, m.edge_delta,
                            f.dofs)
    finally:
        os.environ["CUDDH_NATIVE"] = "1"
    if not all(np.array_equal(a, b) for a, b in zip(tables["1"], tables["0"])):
        _fail("native topology: the native and NumPy tables differ")
    return out


def _l4_run(wc, dev, rng, shapes) -> tuple[dict, dict, dict]:
    """Phase 28, L4: ``large_unstructured --levels 4 --domains 1024`` through
    ``solve_case``.  Its io maps exceed ``precompute_io_maps``'s 1 GiB cap, so
    rhs and postprocess run wave cycles (layout (c)): the run launches the
    sparse grouped kernel for the probes and twice per solve.  Then the
    kernel against the plain cycle: layout (c) on the rhs's 1,024 rows and
    layout (b) on ``L4_PROBE_RUNS`` runs of probe rows, at the port's pad
    320 (the JAX package pads the same 319 DOFs to 384).  Returns
    (record, launches, {variant: (err, ms)} of both comparisons)."""
    import torch

    from cuddhelmholtz_tpu_torch.examples import large_unstructured as lu
    from cuddhelmholtz_tpu_torch.examples.drivers import point_sources
    from cuddhelmholtz_tpu_torch.mesh.io import load_unstructured_square
    from cuddhelmholtz_tpu_torch.mesh.refine import refine_quad_mesh
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs

    t0 = time.perf_counter()
    l4 = refine_quad_mesh(load_unstructured_square(), 4)
    refine_s = time.perf_counter() - t0
    topo = _topology_seconds(l4)
    omega = 2 * np.pi / (5.0 * lu.median_h(l4))
    print(f"L4 mesh: {l4.n_elem} elements, refined in {refine_s:.2f} s; omega {omega:.6f} "
          f"(JAX {L4_OMEGA_JAX}); Mesh2D + H1Space: native {topo['native']:.3f} s, NumPy "
          f"(CUDDH_NATIVE=0) {topo['numpy']:.3f} s, library build {topo['build_seconds']:.3f} s")
    if abs(omega - L4_OMEGA_JAX) > 1e-3:
        _fail(f"L4: omega {omega}, JAX {L4_OMEGA_JAX}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _reset_launches()
    res = lu.solve_case(l4, L4_DOMAINS, 3, omega, 1e-4, device=dev)
    launches = wc.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    rec = lu.case_record("unstructured_L4", l4, res)
    rec.update(topology_seconds=topo, peak_memory_bytes=peak)
    ddh = res.extra["ddh"]
    b = helmholtz_rhs(ddh.space, lambda xy: point_sources(xy, omega)).to(dev)
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out2, U2 = ddh.solver(20, 100, 1e-4)(b)
    torch.cuda.synchronize()
    again_s = time.perf_counter() - t0
    again = wc.launch_counts()
    bitwise = (torch.equal(out2.x, res.extra["lam"])
               and np.array_equal(U2.cpu().numpy(), res.solution))
    resid = _plain_residual(wc, ddh, b, res.extra["lam"])
    print(f"large_unstructured L4 record: {json.dumps(rec)}")
    print(f"L4: io path {ddh.io_path}; launches during the run {launches}; repeated solve "
          f"{again_s:.3f} s, launches {again}, bitwise {bitwise}; plain-cycle residual "
          f"{resid:.3e}; peak device memory {peak / 1e9:.3f} GB")
    # 319 DOFs at most per subdomain: the port pads to 320, the JAX package to 384
    if (rec["pad"], rec["shared_S"], rec["nt"], rec["n_domains"]) != (320, False, 1283, 1024):
        _fail(f"L4: pad {rec['pad']}, shared_S {rec['shared_S']}, nt {rec['nt']}, "
              f"{rec['n_domains']} domains; want 320, False, 1283, 1024")
    if ddh.io_path != "cycle" or res.extra["precompute"]["transfer_layout"] != "grouped":
        _fail(f"L4: io path {ddh.io_path}, probes {res.extra['precompute']}; want the "
              "cycle io path and grouped probes")
    if not res.success or res.num_iter > 20 or abs(res.num_iter - 18) > 1:
        _fail(f"L4: success={res.success}, {res.num_iter} restarts; want <= 20 and JAX's "
              "18 +-1")
    _only_k1(launches, "grouped", "L4", _k1(ddh))
    _only_k1(launches, "per_row", "L4 rhs/postprocess", "sparse")
    if again != {**dict.fromkeys(again, 0), "sparse_per_row": 2} or not bitwise:
        _fail(f"L4: the repeated solve launched {again} (want 2 per-row: rhs, postprocess) "
              f"or differs ({bitwise})")
    if not resid <= 1.2e-4:
        _fail(f"L4: plain-cycle residual {resid:.3e} > 1.2e-4")

    # the kernel against the plain cycle at pad 320
    p = ddh.params
    gm = ddh.gmask.cpu().numpy()
    Fc, Gc = _masked_normal(rng, gm, dev), _masked_normal(rng, gm, dev)
    what = f"L4 layout (c), {ddh.n_domains} rows, pad {ddh.pad}"
    res_c, plain_c, outs_c = _compare(wc, p, Fc, Gc, ddh.wh_maxit, ddh.gmask == 0, what,
                                      ("sparse", "sparse_tiled"), reps=1, form=ddh.k1.form)
    bound_c, by_c = _cycle_bound(ddh.k1.form, 1, ddh.n_domains, ddh.pad, ddh.nt, ddh.wh_maxit)
    print(f"{what}: bound {bound_c:.3f} ms ({by_c}) for the rows it computes")
    row_c = _per_row_row(
        wc, dev, what, outs_c, res_c, ddh.k1.form, ddh.pad,
        at=f"L4 rhs/postprocess (c), {ddh.n_domains} rows, pad {ddh.pad}, nt {ddh.nt}",
        form_ms=1e3 * ddh.k1_seconds, plain_ms=plain_c, bound=(bound_c, by_c))
    del outs_c
    uidx, _, nu = ddh._domain_groups()
    c = 2 * ddh._fslot_np.shape[1]
    c8 = -(-c // wc.ROWS_PER_BLOCK) * wc.ROWS_PER_BLOCK
    ui = torch.as_tensor(uidx[:L4_PROBE_RUNS], device=dev)
    pb = p._replace(S=p.S[ui].contiguous(), Ha=p.Ha[ui].repeat_interleave(c8, 0),
                    inv_mi=p.inv_mi[ui].repeat_interleave(c8, 0))
    form_b, form_ms_b = _form_ms(wc, pb.S)
    tiles_b, tiles_ms_b = _tiles_ms(wc, pb.S)
    bmask = ddh.gmask[ui].repeat_interleave(c8, 0)
    bm = bmask.cpu().numpy()
    Fb, Gb = _masked_normal(rng, bm, dev), _masked_normal(rng, bm, dev)
    rows_b = len(ui) * c8
    what = f"L4 layout (b), {len(ui)} probe runs of {c8} rows, pad {ddh.pad}"
    res_b, plain_b, _ = _compare(wc, pb, Fb, Gb, ddh.wh_maxit, bmask == 0, what,
                                 ("mma", "sparse"), reps=1, form=form_b, tiles=tiles_b,
                                 s_group_size=c8)
    bound_b, by_b = _cycle_bound(form_b, c8, rows_b, ddh.pad, ddh.nt, ddh.wh_maxit)
    _rates(what, _cycle_flop(form_b, c8, ddh.nt, ddh.wh_maxit), rows_b, ddh.pad, ddh.nt,
           ddh.wh_maxit, res_b, bound_b, by_b)
    _add_shape(wc, dev, shapes, "grouped",
               f"L4 transfer probe, {len(ui)} of {nu} runs of {c8} rows, pad {ddh.pad}, "
               f"nt {ddh.nt}", res_b, plain_b, (bound_b, by_b), ddh.pad, ddh.nt, ddh.wh_maxit,
               form=form_b, form_ms=form_ms_b, tiles=tiles_b, tiles_ms=tiles_ms_b,
               group_rows=c8)
    shapes["sparse_per_row"].append(row_c)
    rec["k1_ms_per_cycle"] = {"probe_b_mma": res_b["mma"][1], "probe_b": res_b["sparse"][1],
                              "probe_b_bound": bound_b, "rhs_c": res_c["sparse"][1],
                              "rhs_c_tiled": res_c["sparse_tiled"][1], "rhs_c_bound": bound_c}
    return rec, launches, {"b": res_b["sparse"], "b_mma": res_b["mma"], "c": res_c["sparse"],
                           "c_plain_ms": plain_c, "c_bound": (bound_c, by_c)}


def _phases_28_to_32(wc, dev, rng, counts5, ms18, bench20, lomega, total, shapes, k1) -> dict:
    """Phases 28-32; their launches are added to ``total`` and the
    comparisons' (max abs error, ms) returned.  ``counts5`` is phase 5's
    flagship transfer counts, ``ms18`` phase 18's multi-source result
    (solution, restarts, per-source matvecs), ``bench20`` phase 20's bench
    record, ``lomega`` phase 9's L3 omega, ``k1`` the kernel the flagship's
    cycles run by default."""
    import torch
    import torch.distributed as dist

    from cuddhelmholtz_tpu_torch.config import DDH_MULTI_SOURCE_8 as mcfg
    from cuddhelmholtz_tpu_torch.config import DDH_STRUCTURED as cfg
    from cuddhelmholtz_tpu_torch.config import DDH_UNSTRUCTURED_SQUARE as ucfg
    from cuddhelmholtz_tpu_torch.examples import large_unstructured as lu
    from cuddhelmholtz_tpu_torch.examples import sharded_solve
    from cuddhelmholtz_tpu_torch.examples.drivers import (
        point_sources,
        run_ddh,
        run_ddh_multi_source,
        wave_speed_coeff,
    )
    from cuddhelmholtz_tpu_torch.mesh.mesh2d import Mesh2D
    from cuddhelmholtz_tpu_torch.mesh.refine import jittered_grid
    from cuddhelmholtz_tpu_torch.models.helmholtz import helmholtz_rhs
    from cuddhelmholtz_tpu_torch.ops.functional import linear_functional
    from cuddhelmholtz_tpu_torch.ops.mass import apply_diag_inv_mass, make_diag_inv_mass_op
    from cuddhelmholtz_tpu_torch.parallel import initialize_from_env, spawn_processes
    from cuddhelmholtz_tpu_torch.solvers.ddh import DDH
    from cuddhelmholtz_tpu_torch.spaces.h1 import H1Space
    from cuddhelmholtz_tpu_torch.utils.basis import Basis

    # --- 28. L4 at 1,024 domains and the L3 jittered control ----------------------
    t28 = time.perf_counter()
    rec4, launches, cmp4 = _l4_run(wc, dev, rng, shapes)
    for k in total:
        total[k] += launches[k]
    torch.cuda.empty_cache()
    nxj = int(round(np.sqrt(7616)))  # the L3 mesh's elements, as large_unstructured --control
    ctrl = jittered_grid(nxj, nxj, amount=0.25, seed=1)
    res, launches = _transfer_run(
        wc, lambda: lu.solve_case(ctrl, 256, 3, lomega, ucfg.gmres.tol, device=dev),
        f"large_unstructured L3 --control (jittered {nxj}x{nxj})",
        max_restarts=ucfg.gmres.maxit, jax_matvecs=572, matvec_slack=ucfg.gmres.m + 1,
        gm=ucfg.gmres, jax_restarts=28)
    print(f"large_unstructured control record: "
          f"{json.dumps(lu.case_record(f'jittered_{nxj}x{nxj}', ctrl, res))}")
    _only_k1(launches, "grouped", "L3 --control probes", _k1(res.extra["ddh"]))
    for k in total:
        total[k] += launches[k]
    del res
    torch.cuda.empty_cache()
    print(f"phase 28: {time.perf_counter() - t28:.1f} s")

    # --- 29. ShardedDDH at the flagship, NCCL, every visible card ------------------
    t29 = time.perf_counter()
    world = torch.cuda.device_count()
    outs = spawn_processes(sharded_solve.__file__, 1, world, "--nx", str(cfg.nx),
                           timeout=600.0, device="cuda")
    for rank, (rc, text) in enumerate(outs):
        if rc != 0:
            _fail(f"sharded solve: rank {rank} exited {rc}: {text[-3000:]}")
    sh = json.loads(outs[0][1].strip().splitlines()[-1])
    print(f"sharded solve (ShardedDDH, {sh['backend']}, world {sh['world']}): {json.dumps(sh)}")
    if (sh["backend"], sh["world"], sh["rolled"]) != ("nccl", world, True):
        _fail(f"sharded solve: backend {sh['backend']}, world {sh['world']}, rolled "
              f"{sh['rolled']}; want nccl, {world}, True")
    if max(sh["rel_action"], sh["rel_rhs"], sh["rel_postprocess"]) > 2e-4:
        _fail(f"sharded solve: action / rhs / postprocess rel {sh['rel_action']:.3e} / "
              f"{sh['rel_rhs']:.3e} / {sh['rel_postprocess']:.3e} (> 2e-4)")
    if not sh["success"] or abs(sh["restarts"] - 18) > 1 or abs(sh["matvecs"] - 366) > 21:
        _fail(f"sharded solve: success={sh['success']}, {sh['restarts']} / {sh['matvecs']}; "
              "want JAX's 18 / 366 (+-1 restart)")
    if not sh["bitwise"] or not sh["plain_residual"] <= 1.2e-4 or not sh["solution_finite"]:
        _fail(f"sharded solve: bitwise {sh['bitwise']}, plain-cycle residual "
              f"{sh['plain_residual']:.3e}, finite {sh['solution_finite']}")
    # ShardedDDH's own launches on every rank: one each for the direct action,
    # rhs and postprocess, then rhs and postprocess in each of the two solves
    if sh["launches_direct"] != [{f"{k1}_shared": 3}] * world or \
            sh["launches_solves"] != [{f"{k1}_shared": 4}] * world:
        _fail(f"sharded solve: ShardedDDH launched {sh['launches_direct']} (direct) and "
              f"{sh['launches_solves']} (two solves) per rank; want {k1} layout (a) only, "
              "3 and 4 on every rank")
    for k, v in (*sh["launches_direct"][0].items(), *sh["launches_solves"][0].items()):
        total[k] += v
    print(f"phase 29: {time.perf_counter() - t29:.1f} s")

    # --- 30. the flagship transfer solve: rhs_split="mass", then CUDDH_DEBUG=1 -------
    t30 = time.perf_counter()
    fem = H1Space(Mesh2D.uniform_rect(cfg.nx, -1.0, 1.0, cfg.nx, -1.0, 1.0), Basis(cfg.deg + 1))
    a_nodal = apply_diag_inv_mass(make_diag_inv_mass_op(fem, device="cpu"),
                                  linear_functional(fem, wave_speed_coeff)).numpy()
    b = helmholtz_rhs(fem, lambda xy: point_sources(xy, cfg.omega)).to(dev)
    _reset_launches()
    mddh = DDH(cfg.omega, a_nodal, fem, nx=cfg.nx, ny=cfg.nx, rhs_split="mass", device=dev)
    mddh.prepare(cache_dir="")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out, U = mddh.solver(cfg.gmres.m, cfg.gmres.maxit, cfg.gmres.tol)(b)
    torch.cuda.synchronize()
    mass_s = time.perf_counter() - t0
    launches = wc.launch_counts()
    resid = _plain_residual(wc, mddh, b, out.x)
    print(f"flagship transfer solve, rhs_split='mass': success={out.success} "
          f"{out.num_iter} / {out.num_matvec} (the full split: {counts5}), solve {mass_s:.3f} s, "
          f"plain-cycle residual {resid:.3e}, launches {launches}")
    if not out.success or not resid <= 1.2e-4 or not bool(torch.isfinite(U).all()):
        _fail(f"rhs_split='mass': success={out.success}, plain-cycle residual {resid:.3e}")
    if launches != {**dict.fromkeys(launches, 0), f"{k1}_shared": 2}:
        _fail(f"rhs_split='mass': launches {launches}; want the two {k1} layout-(a) probes")
    for k in total:
        total[k] += launches[k]
    del mddh
    os.environ["CUDDH_DEBUG"] = "1"
    try:
        res, launches = _transfer_run(
            wc, lambda: run_ddh(nx=cfg.nx, deg=cfg.deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit,
                                tol=cfg.gmres.tol, wh_maxit=cfg.wh_maxit,
                                block_size=cfg.block_size, transfer=True, device=dev),
            "flagship transfer solve, CUDDH_DEBUG=1", max_restarts=20, jax_matvecs=366,
            matvec_slack=cfg.gmres.m + 1, gm=cfg.gmres)
    finally:
        del os.environ["CUDDH_DEBUG"]
    if (res.num_iter, res.num_matvec) != counts5:
        _fail(f"CUDDH_DEBUG=1: {res.num_iter} / {res.num_matvec}; want phase 5's {counts5}")
    _only_k1(launches, "shared", "CUDDH_DEBUG=1 flagship", _k1(res.extra["ddh"]))
    for k in total:
        total[k] += launches[k]
    del res
    print(f"phase 30: {time.perf_counter() - t30:.1f} s")

    # --- 31. shard_sources=True on the card, against phase 18's replicated solve ---
    t31 = time.perf_counter()
    rdv = tempfile.mkdtemp(prefix="cuddh_rdv_")
    initialize_from_env(f"file://{rdv}/store", 1, 0, device="cuda")
    try:
        _reset_launches()
        g = mcfg.gmres
        res = run_ddh_multi_source(nx=mcfg.nx, deg=mcfg.deg, m=g.m, maxit=g.maxit, tol=g.tol,
                                   n_sources=mcfg.n_sources, transfer=mcfg.transfer,
                                   shard_sources=True, device=dev)
        launches = wc.launch_counts()
    finally:
        dist.destroy_process_group()
        shutil.rmtree(rdv, ignore_errors=True)
    d = np.linalg.norm(res.solution - ms18["solution"]) / np.linalg.norm(ms18["solution"])
    same = np.array_equal(res.solution, ms18["solution"])
    print(f"shard_sources=True (nccl, world 1, {res.extra['n_shard']} shard): "
          f"{res.num_iter} restarts, per-source matvecs {res.extra['per_source_matvecs']}; "
          f"solution rel {d:.3e} to phase 18's (bitwise {same}), launches {launches}")
    if (res.extra["n_shard"], res.num_iter, res.extra["per_source_matvecs"]) != (
            1, ms18["restarts"], ms18["per"]) or not d <= 1e-5:
        _fail(f"shard_sources: {res.extra['n_shard']} shards, {res.num_iter} restarts, "
              f"{res.extra['per_source_matvecs']}, rel {d:.3e}; want phase 18's "
              f"{ms18['restarts']}, {ms18['per']} within 1e-5")
    _only_k1(launches, "shared", "shard_sources probes", _k1(res.extra["ddh"]))
    for k in total:
        total[k] += launches[k]
    del res
    print(f"phase 31: {time.perf_counter() - t31:.1f} s")

    # --- 32. the bench's scaling key (phase 20), and the scaling CLI at nx 128 ------
    t32 = time.perf_counter()
    sc = bench20["extras"]["scaling"]
    print(f"bench scaling key: {json.dumps(sc)}")
    sizes = [2 ** i for i in range(world.bit_length()) if 2 ** i <= world]
    if "error" in sc or sc["backend"] != "nccl" or sc["devices"] != sizes or not all(
            r["finite"] and r["transfer"] for r in sc["records"]):
        _fail(f"bench scaling key: {sc}; want nccl records at world sizes {sizes}")
    for args in (["--transfer", str(cfg.nx)], [str(cfg.nx)]):
        lines, _ = _module_run("cuddhelmholtz_tpu_torch.examples.scaling", args,
                               f"scaling {' '.join(args)}")
        recs = json.loads(lines[-1])
        for r in recs:
            print(f"scaling {' '.join(args)}: {json.dumps(r)}")
        r0 = recs[0]
        if ([r["devices"] for r in recs] != sizes or r0["backend"] != "nccl"
                or r0["nx"] != cfg.nx or r0["n_domains"] != 1024 or not r0["finite"]):
            _fail(f"scaling {args}: {recs}")
        if "--transfer" not in args and r0["launches"] != {f"{k1}_shared": 4}:
            _fail(f"scaling {args}: rank 0 launched {r0['launches']}; want 4 {k1} (a) "
                  "(a warm-up and 3 timed sharded matvecs)")
        for k, v in r0["launches"].items():
            total[k] += v
    print(f"phase 32: {time.perf_counter() - t32:.1f} s")
    return cmp4


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
        make_diag_inv_mass_op(fem, device="cpu"), linear_functional(fem, wave_speed_coeff)
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
    tiles_a, tiles_ms_a = _tiles_ms(wc, p.S)
    nnz_a = _nnz(form_a)
    k1 = _k1(ddh)
    print(f"flagship sparse form: nnz {nnz_a} (dense {ddh.pad ** 2}), stride {form_a.stride}, "
          f"built in {form_ms_a:.3f} ms; tile form: {tiles_a.pairs} of "
          f"{(ddh.pad // 8) ** 2} 8 x 8 tiles, at most {_depth(tiles_a)} a slot, built in "
          f"{tiles_ms_a:.3f} ms; default kernel {k1}")
    rng = np.random.default_rng(0)
    gmask = ddh.gmask.cpu().numpy()
    F = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32)).to(dev)
    G = torch.from_numpy((rng.standard_normal(gmask.shape) * gmask).astype(np.float32)).to(dev)

    fac_a = ddh.k1.form if k1 == "factored" else None
    variants_a = ("factored",) * (fac_a is not None) + ("mma", "sparse")
    res_a, plain_ms, uv_a = _compare(wc, p, F, G, ddh.wh_maxit, ddh.gmask == 0,
                                     "wave cycle (a), flagship", (*variants_a, "resident"),
                                     form=form_a, tiles=tiles_a, factored=fac_a)
    bound_a, by_a = _cycle_bound(form_a, ddh.n_domains, ddh.n_domains, ddh.pad, ddh.nt,
                                 ddh.wh_maxit)
    _rates("wave cycle (a), flagship", _cycle_flop(form_a, ddh.n_domains, ddh.nt, ddh.wh_maxit),
           ddh.n_domains, ddh.pad, ddh.nt, ddh.wh_maxit, res_a, bound_a, by_a)
    shapes = {k: [] for k in ("factored_shared", "mma_shared", "mma_grouped", "sparse_shared",
                              "sparse_grouped", "sparse_per_row")}
    _add_shape(wc, dev, shapes, "shared",
               f"flagship, {ddh.n_domains} rows, pad {ddh.pad}, nt {ddh.nt}", res_a, plain_ms,
               (bound_a, by_a), ddh.pad, ddh.nt, ddh.wh_maxit, form=form_a,
               form_ms=form_ms_a, tiles=tiles_a, tiles_ms=tiles_ms_a, group_rows=ddh.n_domains,
               dense="resident", factored=fac_a)
    # the flagship's S on 384 rows (the FWI's transfer-probe shape: 48 blocks of
    # the tensor-core kernel, fewer than the SMs): few rows on the sparse side
    # of the rule, as the 12,000-row probe of phase 23 is many
    r384 = torch.arange(384, device=dev) % ddh.n_domains
    p384 = p._replace(Ha=p.Ha[r384].contiguous(), inv_mi=p.inv_mi[r384].contiguous())
    m384 = ddh.gmask[r384]
    F384, G384 = (_masked_normal(rng, m384.cpu().numpy(), dev) for _ in range(2))
    what = "wave cycle (a), flagship S on 384 rows"
    res_384, plain_ms_384, _ = _compare(wc, p384, F384, G384, ddh.wh_maxit, m384 == 0, what,
                                        variants_a, form=form_a, tiles=tiles_a, factored=fac_a)
    _add_shape(wc, dev, shapes, "shared",
               f"flagship S on 384 rows (the FWI transfer probe), pad {ddh.pad}, nt {ddh.nt}",
               res_384, plain_ms_384,
               _cycle_bound(form_a, 384, 384, ddh.pad, ddh.nt, ddh.wh_maxit), ddh.pad, ddh.nt,
               ddh.wh_maxit, form=form_a, form_ms=form_ms_a, tiles=tiles_a,
               tiles_ms=tiles_ms_a, group_rows=384, factored=fac_a)
    del p384, F384, G384, m384

    # --- 3. the flagship solve, direct path ------------------------------------
    _reset_launches()
    res = run_ddh(nx=nx, deg=deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit, tol=cfg.gmres.tol,
                  wh_maxit=cfg.wh_maxit, block_size=cfg.block_size, transfer=False,
                  device=dev)
    launches = wc.launch_counts()
    print(f"flagship solve: success={res.success} restarts={res.num_iter} "
          f"matvecs={res.num_matvec} launches={launches} solve {res.seconds:.3f} s "
          f"({1e3 * res.seconds / (res.num_matvec + 2):.3f} ms per cycle incl. GMRES) "
          f"setup {res.extra['setup_seconds']:.2f} s (K1 kernel and its form "
          f"{1e3 * res.extra['ddh'].k1_seconds:.3f} ms); residual history "
          f"{res.res_norm[0]:.6e} -> {res.res_norm[-1]:.6e} "
          f"(rel {res.res_norm[-1] / res.res_norm[0]:.3e})")
    if not res.success:
        _fail("flagship solve did not converge")
    if res.num_iter > 20:
        _fail(f"flagship solve took {res.num_iter} restarts (> 20)")
    if launches != {**dict.fromkeys(launches, 0), f"{k1}_shared": res.num_matvec + 2}:
        _fail(f"kernel launches {launches}: want num_matvec + 2 = {res.num_matvec + 2} "
              f"{k1} layout-(a) launches and no other")
    REQUIRED.add(f"{k1}_shared")
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
        make_diag_inv_mass_op(ufem, device="cpu"), linear_functional(ufem, wave_speed_coeff)
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
    tiles_b, tiles_ms_b = _tiles_ms(wc, gp.S)
    gmask = uddh.gmask[ui].repeat_interleave(c, 0)
    gm = gmask.cpu().numpy()
    Fb, Gb = _masked_normal(rng, gm, dev), _masked_normal(rng, gm, dev)
    what = f"wave cycle (b), {nu * c} rows in runs of {c}"
    res_b, plain_ms_b, _ = _compare(wc, gp, Fb, Gb, uddh.wh_maxit, gmask == 0, what,
                                    ("mma", "sparse", "resident"), form=form_b, tiles=tiles_b,
                                    s_group_size=c)
    bound_b, by_b = _cycle_bound(form_b, c, nu * c, uddh.pad, uddh.nt, uddh.wh_maxit)
    _rates(what, _cycle_flop(form_b, c, uddh.nt, uddh.wh_maxit), nu * c, uddh.pad, uddh.nt,
           uddh.wh_maxit, res_b, bound_b, by_b)
    _add_shape(wc, dev, shapes, "grouped",
               f"unstructured transfer probe, {nu} runs of {c} rows, pad {uddh.pad}, "
               f"nt {uddh.nt}", res_b, plain_ms_b, (bound_b, by_b), uddh.pad, uddh.nt,
               uddh.wh_maxit, form=form_b, form_ms=form_ms_b, tiles=tiles_b,
               tiles_ms=tiles_ms_b, group_rows=c, dense="resident")
    # the io-probe shape (runs of 2 pad + 2 pf = 456 rows, 456 blocks of the
    # tensor-core kernel, past one wave): many rows on the dense side of the rule
    c_io = 2 * uddh.pad + c
    gio = gp._replace(Ha=up.Ha[ui].repeat_interleave(c_io, 0),
                      inv_mi=up.inv_mi[ui].repeat_interleave(c_io, 0))
    iomask = uddh.gmask[ui].repeat_interleave(c_io, 0)
    Fi, Gi = (_masked_normal(rng, iomask.cpu().numpy(), dev) for _ in range(2))
    what = f"wave cycle (b), {nu * c_io} rows in runs of {c_io}"
    res_io, plain_ms_io, _ = _compare(wc, gio, Fi, Gi, uddh.wh_maxit, iomask == 0, what,
                                      ("mma", "sparse"), reps=1, form=form_b, tiles=tiles_b,
                                      s_group_size=c_io)
    _add_shape(wc, dev, shapes, "grouped",
               f"unstructured io probe, {nu} runs of {c_io} rows, pad {uddh.pad}, "
               f"nt {uddh.nt}", res_io, plain_ms_io,
               _cycle_bound(form_b, c_io, nu * c_io, uddh.pad, uddh.nt, uddh.wh_maxit),
               uddh.pad, uddh.nt, uddh.wh_maxit, form=form_b, form_ms=form_ms_b,
               tiles=tiles_b, tiles_ms=tiles_ms_b, group_rows=c_io)
    del gio, Fi, Gi, iomask
    um = uddh.gmask.cpu().numpy()
    Fc, Gc = _masked_normal(rng, um, dev), _masked_normal(rng, um, dev)
    what = f"wave cycle (c), {uddh.n_domains} rows, one S each"
    res_c, plain_ms_c, outs_c = _compare(wc, up, Fc, Gc, uddh.wh_maxit, uddh.gmask == 0, what,
                                         ("sparse", "sparse_tiled", "resident"),
                                         form=uddh.k1.form)
    bound_c, by_c = _cycle_bound(uddh.k1.form, 1, uddh.n_domains, uddh.pad, uddh.nt,
                                 uddh.wh_maxit)
    print(f"{what}: bound {bound_c:.3f} ms ({by_c}) for the {uddh.n_domains} rows it computes")
    shapes["sparse_per_row"].append(_per_row_row(
        wc, dev, what, outs_c, res_c, uddh.k1.form, uddh.pad,
        at=f"unstructured per-row (c), {uddh.n_domains} rows, pad {uddh.pad}, nt {uddh.nt}",
        form_ms=1e3 * uddh.k1_seconds, plain_ms=plain_ms_c, bound=(bound_c, by_c),
        dense=res_c["resident"][1]))
    del uddh, gp, Fb, Gb

    # --- 5. the flagship transfer solve ----------------------------------------
    res5, launches = _transfer_run(
        wc, lambda: run_ddh(nx=nx, deg=deg, m=cfg.gmres.m, maxit=cfg.gmres.maxit,
                            tol=cfg.gmres.tol, wh_maxit=cfg.wh_maxit,
                            block_size=cfg.block_size, transfer=True, device=dev),
        "flagship transfer solve", max_restarts=20, jax_matvecs=366,
        matvec_slack=cfg.gmres.m + 1, gm=cfg.gmres)
    _only_k1(launches, "shared", "flagship transfer path", k1)
    for k in total:
        total[k] += launches[k]
    counts5 = (res5.num_iter, res5.num_matvec)
    _graph_phase(dev, res5.extra["ddh"], counts5, cfg.gmres)
    _step_graph_phase(dev, res5.extra["ddh"], counts5, cfg.gmres)
    del res5

    # --- 6. the unstructured square at full size --------------------------------
    res6, launches = _transfer_run(
        wc, lambda: run_config(ucfg, device=dev), "unstructured transfer solve",
        max_restarts=100, jax_matvecs=668, matvec_slack=2 * (ucfg.gmres.m + 1),
        gm=ucfg.gmres)
    _only_k1(launches, "grouped", "unstructured transfer path", _k1(res6.extra["ddh"]))
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
    _only_k1(launches, "shared", "ddh_512_block32 probes", _k1(bddh))
    for k in total:
        total[k] += launches[k]

    # --- 8. sparse and streamed layout (a) vs plain on its transfer-probe rows
    uidx, _, nu = bddh._domain_groups()
    c = 2 * bddh._fslot_np.shape[1]
    ui = torch.as_tensor(uidx, device=dev)
    bp = bddh.params
    pa = bp._replace(Ha=bp.Ha[ui].repeat(c, 1), inv_mi=bp.inv_mi[ui].repeat(c, 1))
    form_sa, form_ms_sa = _form_ms(wc, pa.S)
    tiles_sa = wc.tile_form(pa.S)
    print(f"ddh_512_block32: the tensor-core kernel does not take pad {bddh.pad} (at most "
          f"{wc.MMA_MAX_PAD}): {tiles_sa.pairs} 8 x 8 tiles would need "
          f"{wc.mma_shared_memory_bytes(bddh.pad, tiles_sa.pairs)} B of shared memory a block "
          f"(the card allows {wc._shared_memory_limit(dev.index)} B); the sparse kernel runs")
    amask = bddh.gmask[ui].repeat(c, 1)
    am = amask.cpu().numpy()
    Fa, Ga = _masked_normal(rng, am, dev), _masked_normal(rng, am, dev)
    rows_sa, pad_sa, nt_sa = nu * c, bddh.pad, bddh.nt
    what = f"layout (a), ddh_512_block32 transfer probe ({nu} x {c} rows, pad {pad_sa})"
    fac_sa = bddh.k1.form if bddh.k1.variant == "factored" else None
    res_sa, plain_ms_sa, _ = _compare(wc, pa, Fa, Ga, bddh.wh_maxit, amask == 0, what,
                                      ("factored",) * (fac_sa is not None) + ("sparse", "streamed"),
                                      reps=1, form=form_sa, factored=fac_sa)
    bound_sa, by_sa = _cycle_bound(form_sa, rows_sa, rows_sa, pad_sa, nt_sa, bddh.wh_maxit)
    _rates(what, _cycle_flop(form_sa, rows_sa, nt_sa, bddh.wh_maxit), rows_sa, pad_sa, nt_sa,
           bddh.wh_maxit, res_sa, bound_sa, by_sa)
    _add_shape(wc, dev, shapes, "shared",
               f"ddh_512_block32 transfer probe, {rows_sa} rows, pad {pad_sa}, nt {nt_sa}",
               res_sa, plain_ms_sa, (bound_sa, by_sa), pad_sa, nt_sa, bddh.wh_maxit,
               form=form_sa, form_ms=form_ms_sa, dense="streamed", factored=fac_sa)
    shapes["sparse_shared"][-1]["mma_pairs"] = tiles_sa.pairs
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
    k1_l3 = _k1(lddh)
    _only_k1(launches, "grouped", "L3 probes", k1_l3)
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
    tiles_sb, tiles_ms_sb = _tiles_ms(wc, pb.S)
    bmask = lddh.gmask[ui].repeat_interleave(c, 0)
    bm = bmask.cpu().numpy()
    Fb, Gb = _masked_normal(rng, bm, dev), _masked_normal(rng, bm, dev)
    rows_sb, pad_sb, nt_sb = nu * c, lddh.pad, lddh.nt
    what = f"layout (b), L3 transfer probe ({nu} runs of {c} rows, pad {pad_sb})"
    res_sb, plain_ms_sb, _ = _compare(wc, pb, Fb, Gb, lddh.wh_maxit, bmask == 0, what,
                                      ("mma", "sparse", "streamed"), reps=1, form=form_sb,
                                      tiles=tiles_sb, s_group_size=c)
    bound_sb, by_sb = _cycle_bound(form_sb, c, rows_sb, pad_sb, nt_sb, lddh.wh_maxit)
    _rates(what, _cycle_flop(form_sb, c, nt_sb, lddh.wh_maxit), rows_sb, pad_sb, nt_sb,
           lddh.wh_maxit, res_sb, bound_sb, by_sb)
    _add_shape(wc, dev, shapes, "grouped",
               f"L3 transfer probe, {nu} runs of {c} rows, pad {pad_sb}, nt {nt_sb}", res_sb,
               plain_ms_sb, (bound_sb, by_sb), pad_sb, nt_sb, lddh.wh_maxit, form=form_sb,
               form_ms=form_ms_sb, tiles=tiles_sb, tiles_ms=tiles_ms_sb, group_rows=c,
               dense="streamed")
    del res9, lddh, lp, pb, Fb, Gb, bmask
    torch.cuda.empty_cache()

    # --- 11. streamed against resident and sparse at the flagship shape -------
    res_s176, _, uv_s = _compare(wc, p, F, G, ddh.wh_maxit, ddh.gmask == 0,
                                 "streamed (a) forced, flagship", ("sparse", "streamed"),
                                 form=form_a)
    u_s, v_s = uv_s["streamed"]
    for v in ("mma", "resident", "sparse"):
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
    _only_k1(launches, "shared", "helmholtz_ddh_1e6 prepare", _k1(res12.extra["ddh"]))
    for k in total:
        total[k] += launches[k]
    # phase 22 holds its patch path to the gather path, in P too
    hddh12, P12, n12 = res12.extra["ddh"], res12.extra["precond"], 2 * res12.extra["ndof"]
    del res12

    # --- 13. the composite 1e-6 solve on the unstructured square ---------------
    res13, launches, c13 = _composite_run(
        wc, lambda: run_config(HELMHOLTZ_DDH_UNSTRUCTURED_1E6, device=dev),
        "helmholtz_ddh_unstructured_1e6", 8, ufem, dev)
    _only_k1(launches, "grouped", "helmholtz_ddh_unstructured_1e6 prepare",
             _k1(res13.extra["ddh"]))
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
    res = res14 = run_config(HELMHOLTZ_UNPRECONDITIONED, maxit=10, device=dev)
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
    _reset_launches()
    rec = lu.run_case("unstructured_L3", lmesh, 256, 3, lomega, ucfg.gmres.tol,
                      composite=True, device=dev)
    launches = wc.launch_counts()
    comp = rec["composite"]
    print(f"large_unstructured L3 --composite: lambda-solve {rec['restarts']} / "
          f"{rec['matvecs']} in {rec['solve_seconds']:.3f} s (prepare "
          f"{rec['prepare_seconds']:.3f} s); composite {comp}; launches {launches}")
    _only_k1(launches, "grouped", "L3 --composite", k1_l3)
    key = f"{k1_l3}_grouped"
    if launches[key] != 2 * launches9[key]:
        _fail(f"L3 --composite launched {launches[key]} {k1_l3} kernels; want twice phase "
              f"9's {launches9[key]} (two prepares, none in P)")
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
    _only_k1(launches, "shared", "ddh_high_frequency probes", _k1(hddh))
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
    tiles_h, tiles_ms_h = _tiles_ms(wc, hddh.S)
    what = f"layout (a), ddh_high_frequency transfer probe ({nu} x {c} rows, pad {hddh.pad})"
    form_h, form_ms_h = _form_ms(wc, hddh.S)
    fac_h = hddh.k1.form if hddh.k1.variant == "factored" else None
    res_h, plain_ms_h, _ = _compare(wc, ph, Fh, Gh, hddh.wh_maxit, hmask == 0, what,
                                    ("factored",) * (fac_h is not None) + ("mma", "sparse"),
                                    reps=1, form=form_h, tiles=tiles_h, factored=fac_h)
    bound_h, by_h = _cycle_bound(form_h, rows_h, rows_h, hddh.pad, hddh.nt, hddh.wh_maxit)
    _rates(what, _cycle_flop(form_h, rows_h, hddh.nt, hddh.wh_maxit), rows_h, hddh.pad,
           hddh.nt, hddh.wh_maxit, res_h, bound_h, by_h)
    _add_shape(wc, dev, shapes, "shared",
               f"ddh_high_frequency transfer probe, {rows_h} rows, pad {hddh.pad}, nt {hddh.nt}",
               res_h, plain_ms_h, (bound_h, by_h), hddh.pad, hddh.nt, hddh.wh_maxit,
               form=form_h, form_ms=form_ms_h, tiles=tiles_h, tiles_ms=tiles_ms_h,
               group_rows=rows_h, factored=fac_h)
    del res17, hddh, hp, ph, Fh, Gh, hmask
    torch.cuda.empty_cache()
    print(f"phase 17: {time.perf_counter() - t17:.1f} s")

    # --- 18. ddh_multi_source_8 at full size: block GMRES(40), 8 sources --------
    from cuddhelmholtz_tpu_torch.bench import HEADLINE_GMRES

    t18 = time.perf_counter()
    _reset_launches()
    res18 = run_config(mcfg, device=dev)
    launches = wc.launch_counts()
    mddh = res18.extra["ddh"]
    bs = res18.extra["rhs"]
    K, gm18 = res18.extra["n_sources"], mcfg.gmres
    block_opts = {"reorth": False}
    _reset_launches()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out18, _ = mddh.solver(gm18.m, gm18.maxit, gm18.tol, gmres_opts=block_opts, block=True)(bs)
    torch.cuda.synchronize()
    warm18 = time.perf_counter() - t0
    again = sum(wc.launch_counts().values())
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
    _only_k1(launches, "shared", "ddh_multi_source_8 probes", _k1(mddh))
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
    ms18 = {"solution": Us, "restarts": res18.num_iter, "per": per}
    del res18, mddh, bs, lam18, solo, head
    torch.cuda.empty_cache()
    print(f"phase 18: {time.perf_counter() - t18:.1f} s")

    # --- 19. the direct multi-source path at nx 64, 4 sources ------------------
    from cuddhelmholtz_tpu_torch.examples.drivers import run_ddh_multi_source
    from cuddhelmholtz_tpu_torch.solvers.ddh import _rows

    t19 = time.perf_counter()
    small = dict(nx=64, n_sources=4, m=20, maxit=100, tol=1e-4, transfer=False, device=dev)
    _reset_launches()
    rb = run_ddh_multi_source(method="block", **small)
    lb = wc.launch_counts()
    _reset_launches()
    rv = run_ddh_multi_source(method="vmap", **small)
    lv = wc.launch_counts()
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
    k1_v = _k1(vddh)
    if lb != {**dict.fromkeys(lb, 0), f"{k1_v}_shared": block_mv + 2}:
        _fail(f"direct multi-source block: launches {lb}, want {block_mv + 2} {k1_v} "
              "layout-(a) launches (one per block matvec, rhs and postprocess) and no other")
    if rb.num_iter > max(rv.extra["per_source_restarts"]):
        _fail(f"direct multi-source: block took {rb.num_iter} restarts, more than the slowest "
              f"lock-step lane's {max(rv.extra['per_source_restarts'])}")
    if solo_counts != list(zip(rv.extra["per_source_restarts"], rv.extra["per_source_matvecs"])):
        _fail(f"direct multi-source vmap: lanes {rv.extra['per_source_restarts']} / "
              f"{rv.extra['per_source_matvecs']}, solo solves {solo_counts}")
    _only_k1(lv, "shared", "direct multi-source vmap", k1_v)
    for k in total:
        total[k] += lb[k] + lv[k]
    pk = _rows(vddh.params, K19)
    kmask = vddh.gmask.repeat(K19, 1)
    km = kmask.cpu().numpy()
    Fk, Gk = _masked_normal(rng, km, dev), _masked_normal(rng, km, dev)
    rows_k = K19 * vddh.n_domains
    tiles_k, tiles_ms_k = _tiles_ms(wc, vddh.S)
    what = f"layout (a), direct multi-source block matvec ({K19} x {vddh.n_domains} rows)"
    form_k, form_ms_k = _form_ms(wc, vddh.S)
    fac_k = vddh.k1.form if vddh.k1.variant == "factored" else None
    res_k, plain_ms_k, _ = _compare(wc, pk, Fk, Gk, vddh.wh_maxit, kmask == 0, what,
                                    ("factored",) * (fac_k is not None) + ("mma", "sparse"),
                                    form=form_k, tiles=tiles_k, factored=fac_k)
    bound_k, by_k = _cycle_bound(form_k, rows_k, rows_k, vddh.pad, vddh.nt, vddh.wh_maxit)
    _rates(what, _cycle_flop(form_k, rows_k, vddh.nt, vddh.wh_maxit), rows_k, vddh.pad,
           vddh.nt, vddh.wh_maxit, res_k, bound_k, by_k)
    _add_shape(wc, dev, shapes, "shared",
               f"direct multi-source matvec, {K19} x {vddh.n_domains} rows, pad {vddh.pad}, "
               f"nt {vddh.nt}", res_k, plain_ms_k, (bound_k, by_k), vddh.pad, vddh.nt,
               vddh.wh_maxit, form=form_k, form_ms=form_ms_k, tiles=tiles_k,
               tiles_ms=tiles_ms_k, group_rows=rows_k, factored=fac_k)
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
    rec = bench20 = _subprocess_json([sys.executable, "-m", "cuddhelmholtz_tpu_torch.bench"],
                                     "bench", BENCH_SKIP_CONFIGS="1")
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
        if launches != {**dict.fromkeys(launches, 0), f"{k1}_shared": 2}:
            _fail(f"setup cache: the cold flagship run launched {launches}; want the two "
                  f"{k1} layout-(a) probes of phase 5")
        if (cold.num_iter, cold.num_matvec) != counts5:
            _fail(f"setup cache: {cold.num_iter} / {cold.num_matvec}, phase 5 {counts5}")
        for k in total:
            total[k] += launches[k]
        del cold
        cold, launches = _cache_pair(wc, lambda: run_config(bcfg, device=dev),
                                     "setup cache, ddh_512_block32", cache_dir)
        _only_k1(launches, "shared", "setup cache, ddh_512_block32 cold run",
                 _k1(cold.extra["ddh"]))
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
    tiles_23, tiles_ms_23 = _tiles_ms(wc, cddh.S)
    what = f"layout (a), nx 512 / block 16 transfer probe ({nu} x {c} rows, pad {cddh.pad})"
    form_23, form_ms_23 = _form_ms(wc, cddh.S)
    fac_23 = cddh.k1.form if cddh.k1.variant == "factored" else None
    res_23, plain_ms_23, _ = _compare(wc, p23, F23, G23, cddh.wh_maxit, m23 == 0, what,
                                      ("factored",) * (fac_23 is not None) + ("mma", "sparse"),
                                      reps=1, form=form_23, tiles=tiles_23, factored=fac_23)
    bound_23, by_23 = _cycle_bound(form_23, rows_23, rows_23, cddh.pad, cddh.nt, cddh.wh_maxit)
    _rates(what, _cycle_flop(form_23, rows_23, cddh.nt, cddh.wh_maxit), rows_23,
           cddh.pad, cddh.nt, cddh.wh_maxit, res_23, bound_23, by_23)
    _add_shape(wc, dev, shapes, "shared",
               f"nx 512 / block 16 transfer probe, {rows_23} rows, pad {cddh.pad}, "
               f"nt {cddh.nt}", res_23, plain_ms_23, (bound_23, by_23), cddh.pad, cddh.nt,
               cddh.wh_maxit, form=form_23, form_ms=form_ms_23, tiles=tiles_23,
               tiles_ms=tiles_ms_23, group_rows=rows_23, factored=fac_23)
    del res23, cddh, cp, p23, F23, G23, m23
    torch.cuda.empty_cache()
    print(f"phase 23: {time.perf_counter() - t23:.1f} s")

    # --- 24. large_unstructured L3 --coarse multiplicative ---------------------
    t24 = time.perf_counter()
    _reset_launches()
    rec = lu.run_case("unstructured_L3_coarse_mult", lmesh, 256, 3, lomega, ucfg.gmres.tol,
                      coarse="multiplicative", device=dev)
    launches = wc.launch_counts()
    print(f"large_unstructured L3 --coarse multiplicative: {json.dumps(rec)}; launches {launches}")
    _only_k1(launches, "grouped", "L3 --coarse", k1_l3)
    if not rec["success"] or rec["restarts"] > 21 or "coarse" not in rec:
        _fail(f"L3 --coarse: success={rec['success']}, {rec['restarts']} restarts (> 21?)")
    for k in total:
        total[k] += launches[k]
    print(f"phase 24: {time.perf_counter() - t24:.1f} s")

    _phases_25_to_27(wc, dev, res14, counts5, total, k1)
    print(f"phases 1-27: {time.perf_counter() - t_main:.1f} s")
    cmp4 = _phases_28_to_32(wc, dev, rng, counts5, ms18, bench20, lomega, total, shapes, k1)
    print(f"phases 1-32: {time.perf_counter() - t_main:.1f} s")
    print(f"kernel launches over the main-path runs: {total}")
    missing = sorted(k for k in REQUIRED if not total[k])
    if missing or not REQUIRED:
        _fail(f"the main-path runs launched no {', '.join(missing)} kernel: {total}")
    for key, rows in shapes.items():
        for row in rows:
            extra = (f" against {row['dense']} {row['dense_ms']:.3f} ms "
                     f"({row['dense_ms'] / row['ms']:.2f}x)" if "dense" in row else "")
            if "tiled_ms" in row:
                extra += (f", the x8-tiled route {row['tiled_ms']:.3f} ms "
                          f"({row['tiled_ms'] / row['ms']:.2f}x)")
            if "nnz" in row:
                extra += (f", nnz {row['nnz']} (stride {row['stride']}), form "
                          f"{row['form_ms']:.3f} ms")
            print(f"{key} kernel at {row['at']}: {row['ms']:.3f} ms{extra}, plain "
                  f"{row['plain_ms']:.3f} ms, bound {row['bound_ms']:.3f} ms ({row['bound_by']}, "
                  f"{row['bound_ms'] / row['ms']:.1%} of it)")

    # --- 33. the factored and tensor-core kernels against the FFMA one ---------
    for row in shapes["factored_shared"]:
        others = ", ".join(f"{o} {row[o + '_ms']:.3f} ms ({row[o + '_ms'] / row['ms']:.2f}x)"
                           for o in ("sparse", "mma") if o + "_ms" in row)
        print(f"phase 33, {row['at']}: factored {row['ms']:.3f} ms against {others} in the "
              f"same turns; default {row['default']}; plain {row['plain_ms']:.3f} ms; bound "
              f"(FP32 FMA on the non-zeros) {row['bound_ms']:.3f} ms ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it); lines, rs, L {row['shape']}; "
              f"{json.dumps(row['occupancy'])}")
    for row in shapes["mma_shared"] + shapes["mma_grouped"]:
        print(f"phase 33, {row['at']}: mma {row['ms']:.3f} ms against sparse (FFMA) "
              f"{row['sparse_ms']:.3f} ms in the same turns ({row['sparse_ms'] / row['ms']:.2f}x); "
              f"default {row['default']}; plain {row['plain_ms']:.3f} ms; bound (3 TF32 passes "
              f"on the non-zeros) {row['bound_ms']:.3f} ms ({row['bound_by']}, "
              f"{row['bound_ms'] / row['ms']:.1%} of it); the route's own tile work ("
              f"{row['pairs']} tiles) {row['tile_work_ms']:.3f} ms "
              f"({row['tile_work_ms'] / row['ms']:.1%}); tiles {row['tiles_ms']:.3f} ms to "
              f"build, at most {row['depth']} a slot; {json.dumps(row['occupancy'])}")

    def entry(name, source, line, key, err, kms, pms, bound, by, **extra):
        return {
            "name": name, "route": "cuda", "source": f"cuddhelmholtz_tpu_torch/csrc/{source}",
            "replaces": f"cuddhelmholtz_tpu/ops/pallas/wave_cycle.py:{line}",
            "launches": total[key], "max_abs_err": err, "ms": kms, "plain_ms": pms,
            "bound_ms": bound, "bound_by": by, "library_ms": None, **extra,
        }

    mma_a, mma_b = shapes["mma_shared"][0], shapes["mma_grouped"]
    mma_b = next(r for r in mma_b if r["at"].startswith("L3"))
    fac_rows = shapes["factored_shared"]
    fac_entry = [entry(
        "wave_cycle factored (a) shared S", "wave_cycle_factored.cu", 69, "factored_shared",
        max(r["factored"][0] for r in (res_a, res_384, res_sa, res_h, res_k, res_23)
            if "factored" in r),
        fac_rows[0]["ms"], plain_ms, bound_a, by_a, shapes=fac_rows)] if fac_rows else []
    print(json.dumps({"kernels": fac_entry + [
        entry("wave_cycle mma (a) shared S", "wave_cycle_mma.cu", 69, "mma_shared",
              max(res_a["mma"][0], res_384["mma"][0], res_h["mma"][0], res_k["mma"][0],
                  res_23["mma"][0]),
              res_a["mma"][1], plain_ms, mma_a["bound_ms"], mma_a["bound_by"],
              tile_work_ms=mma_a["tile_work_ms"],
              sparse_ms=res_a["sparse"][1], pairs=tiles_a.pairs, tiles_ms=tiles_ms_a,
              shapes=shapes["mma_shared"]),
        entry("wave_cycle mma (b) grouped S", "wave_cycle_mma.cu", 201, "mma_grouped",
              max(res_b["mma"][0], res_io["mma"][0], res_sb["mma"][0], cmp4["b_mma"][0]),
              res_sb["mma"][1],
              plain_ms_sb, mma_b["bound_ms"], mma_b["bound_by"],
              tile_work_ms=mma_b["tile_work_ms"],
              sparse_ms=res_sb["sparse"][1], pairs=tiles_sb.pairs, tiles_ms=tiles_ms_sb,
              shapes=shapes["mma_grouped"]),
        entry("wave_cycle sparse (a) shared S", "wave_cycle_sparse.cu", 69, "sparse_shared",
              max(res_a["sparse"][0], res_384["sparse"][0], res_sa["sparse"][0],
                  res_s176["sparse"][0], res_h["sparse"][0], res_k["sparse"][0],
                  res_23["sparse"][0]),
              res_a["sparse"][1], plain_ms, bound_a, by_a, nnz=nnz_a, stride=form_a.stride,
              form_ms=form_ms_a,
              shapes=shapes["sparse_shared"]),
        entry("wave_cycle sparse (b) grouped S", "wave_cycle_sparse.cu", 201, "sparse_grouped",
              max(res_b["sparse"][0], res_io["sparse"][0], res_c["sparse_tiled"][0],
                  res_sb["sparse"][0], cmp4["b"][0]),
              res_sb["sparse"][1], plain_ms_sb, bound_sb, by_sb, nnz=_nnz(form_sb),
              stride=form_sb.stride, form_ms=form_ms_sb, shapes=shapes["sparse_grouped"]),
        entry("wave_cycle sparse (c) per-row S", "wave_cycle_sparse.cu", 233, "sparse_per_row",
              max(res_c["sparse"][0], cmp4["c"][0]), cmp4["c"][1], cmp4["c_plain_ms"],
              *cmp4["c_bound"], tiled_ms=shapes["sparse_per_row"][-1]["tiled_ms"],
              shapes=shapes["sparse_per_row"]),
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
