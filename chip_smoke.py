#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (multigrid_petsc_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero):
  1. build the CUDA kernels from the package's csrc/, name the card, and
     measure its device-to-device copy rate (a 1 GiB copy); then K18a,
     the stream-rate probe's blocked copy o = 1.0001 u, against its plain
     version at 8192^2 (f32, f64, bf16; bit for bit, also on an unaligned
     view), timed beside torch.mul(out=), and its loop-differenced rate
     (k = 18 less k = 2 chained launches, 3 samples) beside y.copy_(x)'s;
  1b. the attribution probes' kernels (K18b part 1): KP1, every visit
     ablation mode (base, norm, nomask, norestrict, nosweep, loadstore;
     ``probe_kernel``) at 8191^2, k = 3, against its plain version
     (TOL_ARRAY; loadstore bit for bit) and nomask against base; KP2, the
     copy in place (``scale_copy_``) at 8192^2 in f32, f64 and bf16, bit
     for bit; KP3, the staged copy (``pipeline_kernel.staged_copy``, k = 1,
     2, 3) at 8191^2, 8192^2 and on an offset view, and the visit pipeline
     in every mode at every t of 16-64 it takes, bit for bit on 8191^2, 8192^2, 4097^2, narrow last strips (1000
     x 777, 45 x 259, 3 x 257), fewer rows than a window (20 x 1000) and
     row pairs the grid does not divide (37 x 229, 300 x 301, 1500 x
     1501), its device time in every mode at t = 32, 16 and 48 beside
     the bytes it moves and y.copy_(x)'s (v_norc, v_bare);
     each kernel's device time beside its bound and K18a's rate; K18b part
     2: K18b-W, the halo windows (``xfer_probe_kernel.halo_windows``) at
     8191^2 on (stride, g, top, bot) = (160, 52, 5, 5), (160, 52, 3, 3),
     (160, 52, 5, 2), (96, 90, 5, 5) (g past cdiv(n, stride)) and on an
     offset view, bit for bit; K18b-R (``xfer_restrict``) in every mode on
     the (48, 8192) slab and K18b-P (``xfer_prolong``) on (57, 4096), G =
     86, bit for bit, with device times at G = 86 and G = 1 and the time a
     pass beside the bound (``xfer_bound``) and the design's shared-memory
     bytes, and bit for bit on the edge cases (the smallest width, one
     row; 5 and 57 rows; G = 1 and G = MAX_PASSES on a narrow slab; an
     offset view); then the probes' path (``python -m
     multigrid_petsc_tpu_torch.probes <name> --quick`` for all eight at
     full size, in this process) with the launch counts from 0;
  2. every 5-point kernel against its plain PyTorch version on the card,
     at the shapes of the 8193^2 / 11-level paths, with times: the mg-CG
     kernels K1-K4 (K4 on scripts/time_coarse_tree.py's seven trees, timed
     per call and as device time, with the grid-sync probe's cost of one
     barrier and the latency floor it gives), then K6, K7 (Jacobi and
     Chebyshev) and K9 in each
     mode the V-cycle family uses, a k = 8 and a k = 32 visit; then the
     5-point strip visit (every flag set, K17's row blocks) and K12 (three
     coefficient layouts, row blocks) on ragged shapes, at k = 1, at the
     sweep bound and on either side of the region rule, untimed;
  2b. the 9-point kernels at 8191^2, on the anisotropic stencil and on a
     random stencil with every coefficient kind: K12 (apply, residual;
     timed, with conv2d, on the constant stencil as the solver builds it,
     cc an (n, n) field: the anisotropic layout; and on its nine scalars),
     K13 (Jacobi, Chebyshev), K14 in every mode, K15 (u, u + r, the
     zero-guess rc, correction + u + <b, u>, x-varying line
     coefficients), with times, and conv2d's time where one PyTorch call
     computes the same function; then K14 (every mode, both stencils) and
     K15 (every mode, both factor layouts) on ragged shapes (a 1025^2 and
     a 33^2 level, an 8191 x 1025 block of the 8191^2 level), untimed;
  2c. the explicit sparse backend's kernels: K8 (the field-coefficient
     stencil, A u and b - A u) at 8191^2 on the assembled Poisson level-0
     matrix and on random fields, K16 (the DIA SpMV) on the 2-grid A1 at
     8193^2 (7 diagonals) and on a random 16-diagonal matrix, with times
     and cuSPARSE's (torch.mv / torch.addmv on the same matrix in CSR);
  3. whole solves on the card against the same solves on the CPU (plain
     versions) at 1025^2 / 8 levels: mg-CG (Jacobi and Chebyshev), the
     V-cycle (Jacobi, Chebyshev, v = 8,8), MG-Richardson, FMG, Additive;
  3b. the same for the 9-point family: mg-CG Jacobi on aniso
     (1,1,1,2,0.4), BASELINE config 4 (mg-CG, y-line, aniso (1,0,100,0,0);
     in f32, the kernels' type), mg-FGMRES on the mixed-term problem, the
     aniso V-cycle;
  3c. the same for the sparse backend and the cycle zoo: sparse mg-CG and
     V-cycle (8 levels), the I, E, D1, D2 and D1PS cycles on 2 merged
     grids (matrix-free and sparse), Additive2, and a V-cycle whose last
     level merges 3 grids (its coarsest solve CG);
  4. the mg-CG path: the 8193^2 / 11-level f32 solve on the card, with
     launch counts, error norms and ms per iteration;
  5. the V-cycle family at 8193^2 / 11 levels, f32: V-cycle, FMG, the
     Chebyshev V-cycle, MG-Richardson, Additive, and the 3-level V-cycle
     that smooths its 2047^2 coarsest level (K7), each with launch
     counts, error norms and ms per iteration;
  6. the 9-point family at 8193^2 / 11 levels, f32, rtol 1e-5: mg-CG
     Jacobi (K12 + K14), mg-CG y-line (K15 + K12), mg-FGMRES, and a
     3-level V-cycle that smooths its 2047^2 coarsest level (K13), each
     with launch counts, error norms and ms per iteration;
  7. the sparse backend and the cycle zoo at full width, f32: (a) sparse
     mg-CG at 8193^2 / 11 levels to rtol 1e-5 (K8 on every level but the
     directly solved coarsest), (b) the sparse V-cycle, (c) D1, D2 and
     D1PS on 2 merged grids at 8193^2, sparse (A1 through K16), (d) the E-
     and the I-cycle on 2 merged grids at 4097^2, sparse (the host CSR of
     the coupled operator caps the size), (e) D1 and E matrix-free at
     8193^2; each with set-up seconds, peak device memory, launch counts
     and ms per iteration;
  2d. the precision slice's kernels at 8191^2: K10 and K11 (the fused
     mg-CG route, f32), and the f64 and bf16 instantiations of K6,
     residual5, K7, K9 (K2b's zero-guess rc, K3's correcting u + dot, a
     nonzero-guess rc), K12, K13 and K14, and K15 in f64, each against its
     plain version, with times and conv2d's where one call computes it;
     then 2b's ragged shapes for K14 in f64 and bf16 and K15 in f64, and
     phase 2's ragged checks of the 5-point visit and K12 in f64 and bf16;
  3d. card against CPU at 1025^2 / 8 levels: the fused route (-v 8,8),
     mg-CG in f64 to rtol 1e-7 (generic route), the mixed outer (f32
     V-cycle + f64 outer) to 1e-8 and float32x2, the bf16 preconditioner
     (mg-CG, mg-FGMRES, and under the f64 outer), BASELINE config 4's
     mixed certification (aniso y-line), and the aniso f64 solves (y-line
     and Jacobi);
  8. the precision paths at full width (8193^2 / 11 levels): (a) the
     mixed certification to rtol 1e-8 (true f64 residual <= 1e-8), (b)
     the same warm-started from FMG (BASELINE config 5), (c) f32 mg-CG
     with the bf16 preconditioner (config 6) to 1e-5, (d) mg-CG in f64 to
     1e-7, (e) the fused route (-v 8,8, f32, 1e-5: K11 and K10 once per
     iteration, no K1 or K2a), (f) a 3-level f64 V-cycle smoothing its
     2047^2 coarsest level; each with its true f64 residual, error norms,
     launch counts and ms per iteration;
  9. row-partition distribution: (a) K17 at full width in one process,
     the 8191^2 level cut into 4 row blocks with their halo rows, every
     emit of the 5-point and the aniso 9-point visit (f32; one in f64)
     against the whole-grid kernels and the plain row-block version, with
     times per block, for 4 blocks and for the whole-grid kernel, and the
     5-point a, r and zero-guess rc blocks as device time (20 launches
     queued behind a sleep) beside conv2d on the block and its halo rows;
     and each block's visit split as the rows layout runs it on a 2-rank
     level (JAX's tile t, the interior rows [t, R - t), then the two
     edge tiles with the exchanged rows; ``row_visit_split``), held to
     the whole-block launch bit for bit (within TOL_ARRAY at worst), with
     the device time of the interior, of the edges and of all three
     beside the whole-block launch's, and the host time per split visit
     beside one launch's and ``row_visit``'s;
     (b) the distributed main path, 2 ranks (this script re-run with
     --rank, one process each) sharing the card over gloo with halos
     staged through the host: Poisson mg-CG at 8193^2 / 11 levels against
     phase 4 (its iterations, solution and error; K17's launches per
     emit; every visit of levels 8191, 4095 and 2047 split, of 1023 and
     below whole), then the aniso (1,1,1,2,0.4) mg-CG; (c) the 2-rank
     mg-CG at
     1025^2 in f32 and f64, on the card and over gloo on the CPU;
 10. the CLI's outputs and the last smoothers: (a) ``poisson.main`` at
     8193^2 / 11 levels, mg-CG, -view 1, in a temporary directory (the
     banner, the solver dump, the five artifact files checked against the
     solve, the write's seconds and bytes); (b) an RBGS V-cycle (forced 5
     iterations), mg-CG with -coarse_smoother rbgs (its coarse-tree
     split), LINE_X mg-CG and a LINE_XY V-cycle (forced 5) on the x-strong
     aniso (100,0,1,0,0) problem at 8193^2, each with its launches (none
     of K1-K4 or the fused visits on their levels), error and ms per
     iteration; (c) each of (b) card against CPU at 1025^2; (d)
     ``solve(profile_phases=True)`` at 8193^2; (e) a checkpoint after 2
     iterations of phase 4's solve, loaded and resumed to convergence;
 11. distribution, every single-grid cycle: (a) K15's rank-spanning mode
     (a row-sharded level's y-lines across the ranks) on row blocks in
     one process, against one whole-grid plain sweep and the one-card
     K15, f32 and f64, blocks of 2048 rows of the 8191^2 level (timed)
     down to 8 rows (8-row segments); (b) 2 ranks sharing the card over
     gloo at 8193^2 / 11 levels, ``row_plan(min_local=32)``: the mixed
     outer to a true f64 residual of 1e-8, the bf16 preconditioner (K17
     in bf16), mg-FGMRES(10) forced 3 blocks, Additive forced 5, an RBGS
     V-cycle, y-line and x-line mg-CG on the aniso problems, each held to
     the same config on one card where phases 6, 8 and 10 run it, with
     its launches (per kernel, per K17 emit) and its all-gathers (none of
     a sharded level's own rows); (c) the same and mg-CG -v 8,8 card
     against CPU at 1025^2 / 8 levels, ``min_local=8``.  Phase 2d also
     holds K17 in bf16 against its plain version on 4 row blocks of the
     8191^2 level;
 12. distribution, the merged-grid cycles and merged levels (2 ranks
     sharing the card over gloo, ``row_plan(min_local=32)``): (a) I, E,
     D1, D2 and D1PS matrix-free on 2 grids at 8193^2 (both sharded),
     forced 10, each held to its one-card twin (histories within 1e-5,
     u within TOL_ARRAY; K17 on both ranks, no K6 or K7); (b) a V-cycle
     (forced 5) and mg-CG over a sharded CG-solved merged level 2 (grids
     4 / levels 3), held to their twins (iterations within 1, error <=
     1.1x); (c) card against CPU at 1025^2 with merged levels holding
     replicated grids (the one-level cycles, a V-cycle, mg-CG over a
     directly solved merged level); each with its launches per kernel and
     per K17 emit, its all-gathers by label and its ms per iteration
     (gloo host staging);
 13. the 2-D blocks layout (``-map 0/1``): (a) K17's 2-D block mode at
     full width in one process, the 8191^2 level cut 2x2 (4096^2 blocks)
     and 1x2 (8191 x 4096) with their halo rings, every emit of the
     5-point and the aniso 9-point visit (f32; one in f64) against the
     whole-grid kernels and the plain block version (pad row and column
     exactly 0), the 5-point a, r and zero-guess rc blocks timed as
     device time beside their bytes bound and conv2d on the block and
     its ring, and the zero-guess rc block in bf16 (device time); K15's
     2-D block mode (y-lines across a mesh column, x-lines on the
     transposed block across a mesh row) on 2x2, 1x2 and 2x1 cuts of the
     8191^2 level (f32) and 2x2 of 1023^2 (f64), against its plain
     version and the whole-grid plain sweep, a 4096^2 block's sweep
     timed as device time; (b) 4 ranks (a 2x2 mesh) sharing the card over gloo,
     ``blocks_plan(min_local=32)`` at 8193^2 / 11 levels: mg-CG, a
     V-cycle (forced 5), mg-FGMRES(10) (forced 3 blocks) and the aniso
     mg-CG Jacobi, each held to its one-card twin, with K17's 2-D block
     launches per emit on every rank, no K1, K2a or K4 (K2b and K3 on the
     replicated levels only), its all-gathers by label and its ms per
     iteration; (b') the 2-rank (1x2) mg-CG; (c) card against CPU at
     1025^2 / 8 levels, 2x2, ``min_local=8``, f32 and f64;
 14. under the blocks layout, the precision outers, the checkpoint, RBGS
     and the line smoothers: 4 ranks (2x2) sharing the card over gloo,
     ``blocks_plan(min_local=32)`` at 8193^2 / 11 levels, f32: the mixed
     outer to a true f64 residual of 1e-8, the bf16 preconditioner, an
     RBGS V-cycle (5), y-line and x-line mg-CG on the aniso problems, a
     LINE_XY V-cycle (forced 5), phase 4's mg-CG checkpointed after 2
     iterations and resumed; each held to its one-card twin, with K17's
     2-D block launches (``.bf16`` in the bf16 run) and K15's 2-D block
     launches (the line runs) on every rank, no K1, K2a or K4, and only
     "agglomerate" and "line" all-gathers; card against CPU at 1025^2,
     ``min_local=8``;
 15. under the blocks layout, merged levels and the merged-grid cycles,
     every grid of a merged level on its own 2-D block: 4 ranks (2x2)
     sharing the card over gloo, ``blocks_plan(min_local=32)``, f32: (a)
     I, E, D1, D2 and D1PS on 2 split grids at 8193^2, forced 10, each
     held to its one-card twin (histories within 1e-5, u within
     TOL_ARRAY); (b) a V-cycle and mg-CG (forced 5 each) at grids
     4 / levels 3 over the split CG-solved merged level 2 (errors and last
     residuals within 1.1x of the twins'); (c) D1 on the 1x2 mesh (every
     grid split along x alone); (d) card against CPU at 1025^2, merged
     levels holding whole grids (I, D1, a V-cycle over a CG-solved merged
     level, mg-CG over a directly solved one); K17's 2-D mode on every
     rank, no K6 or K7 where every grid is split, only "agglomerate" and
     "coarsest" all-gathers, each run's launches, gathers with bytes and
     ms per iteration (gloo host staging);
 16. the blocks layout on any rank count (uneven blocks, nested and
     even: ``device_mesh.block_sides``): (a) K17's 2-D block mode (5- and
     9-point; zero-guess rc, u, correct + ur, a, r; f32, f64, bf16) and
     K15's (y- and x-lines, the carry pass over unequal segment counts)
     on the 1x3, 2x3 and 3x2 cuts of 8191^2 and a ragged 1119^2, against
     the whole-grid kernels and their plain versions, the largest uneven
     block's device time beside 13 (a)'s even block, K15's launches on
     uneven and even segment counts and the stacking of the gathered
     ends; (b) 6 and
     3 ranks sharing the card over gloo at 8193^2: mg-CG on 2x3 and 1x3,
     a V-cycle (forced 5) on 2x3, y-line mg-CG (forced 3) on 3x2, x-line
     mg-CG (forced 3) on 2x3, D1 on 2 split grids (forced 10) on 1x3,
     each held to its one-card twin; (c) 1025^2 mg-CG on 3 ranks, card
     against CPU.
Every path run starts with the launch counters at 0 and reads them right
after (a rank's counters in its own process).  ``--only
k18,9a,9b,10,11a,11,12,13a,13,14,15,16a,16`` runs the build and just those
phases
(phase 4 first where they read it), and prints no result line.  The line before the last two is the kernels' JSON record (times,
launches, errors, byte and operation bounds); the last line is the
result object.  With no CUDA device the script exits non-zero without
printing it.
"""

from __future__ import annotations

import dataclasses
import json
import re
import statistics
import subprocess
import sys
import time

T_START = time.perf_counter()  # the process's start, for its seconds
TOL_ARRAY = 1e-5  # max|kernel - plain| <= TOL_ARRAY * max|plain|
TOL_DOT = 1e-4    # relative, on each inner product
# K15 solves each line by Thomas's recurrence cut into 32-row segments,
# with f64-made factors, its plain version by f32 parallel cyclic
# reduction: they differ by solve rounding, not by arithmetic order alone.
TOL_LINE = 1e-4
# bf16 outputs are the same f32 values rounded once, on the card and in
# the plain version; the card's FMA contraction and summation order move
# the f32 value by f32 noise and so can flip that one rounding: every bf16
# entry is held to one bf16 ulp of itself, or, where cancellation leaves
# an entry smaller than the f32 noise, to the f32 kernels' TOL_ARRAY of
# max|plain| (TOL_ARRAY alone is below bf16's resolution of 2^-8).  f64
# and f32 outputs are held to TOL_ARRAY.
BF16_ULPS = 1
REPS = 10
HBM_PEAK = 3.35e12  # B/s, H100 SXM published
F32_PEAK = 67e12    # FLOP/s, H100 SXM f32 outside the tensor cores
F64_PEAK = 34e12    # FLOP/s, H100 SXM f64 outside the tensor cores


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def ptxas_summary(log: str) -> list[str]:
    """Registers and spilled bytes per kernel template and storage type
    (and, for the 5-point visit, region), from the build's -Xptxas -v
    output."""
    groups: dict = {}
    fam = re.compile(r"(visit5p|visit5|visit9|apply9|stencil|cg_papply|"
                     r"line_fix|line_carry|line_segment|line_residual|"
                     r"coarse_tree|dia_spmv|scale_copy|staged_copy|"
                     r"staged_pipe|halo_windows|xfer_pass)_kernel"
                     r"(I(f|d|13__nv_bfloat16))?")
    types = {"f": "f32", "d": "f64", "13__nv_bfloat16": "bf16"}
    key = None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            k = fam.search(m.group(1))
            key = None if k is None else " ".join(
                [k.group(1) + "_kernel"] + ([types[k.group(3)]] if k.group(3)
                                            else []))
            r = re.search(r"Region5ILi\d+ELi\d+ELi(\d+)E", m.group(1))
            if key and r:
                key += " short" if r.group(1) == "16" else " tall"
            # visit5_kernel's probe modes (KP1), apart from the solves'
            if key and re.search(r"Region5ILi\d+ELi\d+ELi\d+EEELi[1-9]E",
                                 m.group(1)):
                key += " probe"
            continue
        if key is None:
            continue
        g = groups.setdefault(key, [10**9, 0, 0, 0])
        s = re.search(r"(\d+) bytes spill stores", line)
        if s:
            g[2] += int(s.group(1))
        u = re.search(r"Used (\d+) registers", line)
        if u:
            n = int(u.group(1))
            g[0], g[1], g[3] = min(g[0], n), max(g[1], n), g[3] + 1
            key = None
    return [f"{k}: {g[0]}-{g[1]} registers, {g[2]} B spilled ({g[3]} "
            f"instantiations)" for k, g in sorted(groups.items())]


def time_ms(torch, fn) -> float:
    """Median over REPS runs of fn, timed with CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def compare(torch, name, got, want, record, tol=TOL_ARRAY, dot_scale=None,
            floor=0.0):
    """Assert kernel outputs against plain outputs; track the worst error.
    An inner product is held to TOL_DOT of its value, or, with
    ``dot_scale`` (the sum of |products|), to ``tol`` of that.  An array
    is held to ``tol`` of max(max|plain|, ``floor``)."""
    if isinstance(want, torch.Tensor) and want.dim() == 0:
        err = abs(float(got) - float(want))
        lim = (TOL_DOT * abs(float(want)) if dot_scale is None
               else tol * dot_scale)
    elif want.dtype == torch.bfloat16:
        g, w = got.float(), want.float()
        err = float((g - w).abs().max())

        def ulp(x):
            return torch.exp2(torch.floor(torch.log2(
                x.abs().clamp_min(1e-30))) - 7)

        lim = torch.maximum(BF16_ULPS * torch.maximum(ulp(g), ulp(w)),
                            TOL_ARRAY * w.abs().max().clamp_min(floor))
        worst = float(((g - w).abs() / lim).max())
        print(f"  {name}: max|kernel - plain| = {err:.3e}, at most "
              f"{worst:.2f} of the limit ({BF16_ULPS} bf16 ulp of the entry "
              f"or {TOL_ARRAY:g} of max|plain|)")
        if not worst <= BF16_ULPS:
            raise AssertionError(f"{name}: kernel disagrees with plain "
                                 f"version ({worst:.2f} of the limit)")
        record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)
        return
    else:
        err = float((got - want).abs().max())
        lim = tol * max(float(want.abs().max()), floor)
    print(f"  {name}: max|kernel - plain| = {err:.3e} (limit {lim:.3e}, "
          f"{err / max(lim / tol, 1e-300):.3e} of max|plain|)")
    if not err <= lim:
        raise AssertionError(f"{name}: kernel disagrees with plain version "
                             f"({err:.3e} > {lim:.3e})")
    record["max_abs_err"] = max(record.get("max_abs_err", 0.0), err)


def keep_time(record, ms, pms, nbytes, flops, library_ms=None,
              library_device_ms=None):
    """The first timing of each kernel is the one its record keeps."""
    if "ms" not in record:
        record.update(ms=ms, plain_ms=pms, bytes=nbytes, flops=flops,
                      library_ms=library_ms,
                      library_device_ms=library_device_ms)


def library_device_ms(torch, fn, ms: float) -> float:
    """``device_ms`` of a library call that takes ``ms`` a call: 20 calls
    queued, fewer (at least 3) where 20 would take over 40 ms."""
    return device_ms(torch, fn, max(3, min(20, int(40.0 / max(ms, 1e-3)))))


def device_ms(torch, fn, n: int = 20) -> float:
    """Device ms per call of ``fn``: ``n`` calls queued behind a sleeping
    kernel, so that the events bracket the kernels' back-to-back run and
    none of the wrappers' host work.  The sleep is sized from the host
    time of ``n`` calls and checked to have covered them; a run it did
    not cover is not kept, and the next sleeps twice as long (at most 64
    times the first)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    torch.cuda.synchronize()
    host_ms = 1e3 * (time.perf_counter() - t0)
    probe = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
    probe[0].record()
    torch.cuda._sleep(10**6)
    probe[1].record()
    probe[1].synchronize()
    cycles_per_ms = 10**6 / probe[0].elapsed_time(probe[1])
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    times = []
    cover = 2 * host_ms + 1.0  # ms of sleep ahead of the queued calls
    while len(times) < 3:
        torch.cuda._sleep(int(cycles_per_ms * cover))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        if queued_ms < cover:
            times.append(start.elapsed_time(end) / n)
            continue
        # A slow enqueue (the host is shared): the run is not kept, and
        # the next sleeps longer.
        cover *= 2
        if cover > 64 * (2 * host_ms + 1.0):
            raise RuntimeError("the sleep did not cover the queued calls")
    return statistics.median(times)


def host_ms(torch, fn, n: int = 50) -> float:
    """Host ms per call of ``fn``: the median over 3 runs of ``n`` calls
    enqueued back to back, from the first call's start to the last one's
    return (no synchronisation inside a run; the device queue is deep
    enough not to block it)."""
    fn()
    torch.cuda.synchronize()
    runs = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        runs.append(1e3 * (time.perf_counter() - t0) / n)
        torch.cuda.synchronize()
    return statistics.median(runs)


def split_check(torch, dk, tag, calls, got, isz, record):
    """9 (a)'s split visits: each row block's visit run as the rows
    layout runs it on a 2-rank level's block (``row_visit_split``: JAX's
    tile t for the block, the interior rows [t, R - t), then the edge
    rows with the exchanged rows), stitched and held to the whole-block
    launches ``got`` bit for bit (expected: each point's steps are the
    same), within TOL_ARRAY at worst, the pad rows exactly 0.  Returns
    the tile and, for block 1, a function that runs its split visit, and
    the pieces' arguments."""
    a1, kw1 = calls[0]
    R = (a1[1] if a1[1] is not None else a1[2]).shape[0]
    emit = a1[4]
    h = dk.halo_rows(len(a1[3]), emit)
    t = dk.pick_tile(R, h, nx=kw1["ny"], itemsize=isz)
    assert len(dk.split_pieces(R, t)) == 3, (tag, R, t)
    prepared = [dict() for _ in calls]

    def split(p):
        a, kw = calls[p]
        rem = dict(b=kw["b_halo"], u=kw["u_halo"], e=kw["e_halo"])
        return dk.row_visit_split(*a, row0=kw["row0"], ny=kw["ny"], t=t,
                                  halos=lambda: rem, e=kw["e"],
                                  coeff_row0=kw["coeff_row0"],
                                  prepared=prepared[p])

    outs = [split(p) for p in range(len(calls))]
    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
    split_out = tuple(torch.cat([o[i] for o in outs])
                      for i in range(len(outs[0])))
    worst = 0.0
    for i, (g, w) in enumerate(zip(split_out, got)):
        assert bool((g[-1] == 0).all()), f"{tag}: split output {i} pad row"
        if torch.equal(g, w):
            continue
        d = (g.double() - w.double()).abs()
        rows = torch.nonzero(d.amax(1) > 0).flatten().tolist()
        err = float(d.max())
        worst = max(worst, err)
        print(f"  {tag}: split output {i} differs from the whole-block "
              f"launches by {err:.3e} on rows {rows[:16]}"
              f"{' ...' if len(rows) > 16 else ''}")
        compare(torch, f"split output {i} vs whole-block launches", g, w,
                record)
    print(f"  {tag}: split (t = {t}, {R // t} tiles) vs whole-block "
          f"launches: max |difference| {worst:.3e}"
          + (" (bit for bit)" if worst == 0.0 else ""))
    return t, (lambda: split(1)), prepared[1]


def copy_rate(torch) -> float:
    """Device-to-device copy rate, B/s (bytes read + written), of a 1 GiB
    f32 copy: the yardstick the byte bounds are read against."""
    n = 2**28
    x = torch.empty(n, device="cuda")
    y = torch.empty_like(x)
    ms = time_ms(torch, lambda: y.copy_(x))
    rate = 2 * 4 * n / (ms * 1e-3)
    print(f"device copy of {4 * n} B: {ms:.4f} ms, {rate / 1e9:.1f} GB/s "
          f"(read + write)")
    return rate


def differenced_rate(torch, step, nbytes, samples=3):
    """B/s of ``step`` (one call moves ``nbytes``), loop-differenced as
    ``stream_kernel.measured_kernel_bandwidth`` is: k = 2 and k = 18
    calls, each run warmed and timed on the host clock between two
    synchronisations; one sample per pair."""
    def timed(k):
        for _ in range(k):
            step()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(k):
            step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    return [nbytes / max((timed(18) - timed(2)) / 16, 1e-12)
            for _ in range(samples)]


def copy_cases(sk, flat, n):
    """K18a's and KP2's check shapes, views of ``flat`` (n^2 entries): the
    n^2 tensor, (n - 1)^2 views 1-3 entries in (no 16-byte loads), and
    sizes smaller than a vector and than a block's tile, or not a multiple
    of the tile, at offsets 0-3."""
    w = 16 // flat.element_size()  # entries a 16-byte vector
    tile = sk.UNROLL * sk.THREADS * w
    shapes = [(f"{n}^2", 0, n, n)] + [
        (f"{n - 1}^2 view, offset {o}", o, n - 1, n - 1) for o in (1, 2, 3)]
    small = dict.fromkeys(((1, 1), (1, w - 1), (3, w + 1), (1, tile - 1),
                           (3, tile // 3 + 5), (7, 2 * tile + 3)))
    for i, (rows, cols) in enumerate(small):
        for off in (0, 1 + i % 3):
            shapes.append((f"{rows} x {cols} at {off}", off, rows, cols))
    return [(what, flat[o:o + r * c].view(r, c))
            for what, o, r, c in shapes]


def phase_stream(torch, dev, rec):
    """1 (K18a): the blocked copy o = 1.0001 u (``stream_kernel``) at
    8192^2 against its plain version on the card, bit for bit, in f32,
    f64 and bf16, on the tensor and on an (8191, 8191) view one entry
    past it (no 16-byte loads); its f32 time beside the plain version's,
    torch.mul(x, 1.0001, out=y) (the library call) and its bound; then
    its loop-differenced rate (``measured_kernel_bandwidth``: 3 samples
    of k = 18 less k = 2 chained launches) beside y.copy_(x)'s, taken the
    same way.  Returns the rate's record; ``rec["scale_copy"]`` keeps the
    kernel's, its launches those of the rate's run."""
    from multigrid_petsc_tpu_torch.ops.cuda import launches
    from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as sk

    n, a = 8192, 1.0001
    r = rec.setdefault("scale_copy", {})
    gen = torch.Generator(device=dev).manual_seed(99)
    for dt in sk.DTYPES:
        flat = torch.randn(n * n, generator=gen, device=dev).to(dt)
        for what, u in copy_cases(sk, flat, n):
            got, want = sk.scale_copy(u, a), sk.scale_copy_plain(u, a)
            err = float((got.double() - want.double()).abs().max())
            assert torch.equal(got, want), \
                f"scale_copy {what} {dt}: {err:.3e} from plain"
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        print(f"K18a scale_copy {dt}: bit for bit on "
              + ", ".join(w for w, _ in copy_cases(sk, flat, n)))
        del flat, got, want
    x = torch.randn((n, n), generator=gen, device=dev)
    y = torch.empty_like(x)
    nbytes = 2 * 4 * n * n
    ms = time_ms(torch, lambda: sk.scale_copy(x, a, out=y))
    pms = time_ms(torch, lambda: sk.scale_copy_plain(x, a))
    lms = time_ms(torch, lambda: torch.mul(x, a, out=y))
    ldms = device_ms(torch, lambda: torch.mul(x, a, out=y))
    dms = device_ms(torch, lambda: sk.scale_copy(x, a, out=y))
    keep_time(r, ms, pms, nbytes, n * n, lms, ldms)
    r["device_ms"] = dms
    print(f"  scale_copy {n}^2 f32: kernel {ms:.4f} ms per call (device "
          f"time {dms:.4f} ms, {nbytes / dms / 1e6:.1f} GB/s), plain "
          f"{pms:.4f} ms, torch.mul(out=) {lms:.4f} ms a call, device "
          f"{ldms:.4f} ms; bound "
          f"{1e3 * nbytes / HBM_PEAK:.4f} ms ({nbytes} B at "
          f"{HBM_PEAK / 1e12:.2f} TB/s)")
    del x, y
    torch.cuda.empty_cache()
    launches.clear()
    info = sk.measured_kernel_bandwidth(n, torch.float32, dev)
    r["launches"] = launches["scale_copy"]
    assert r["launches"] > 0
    x = torch.ones((n, n), device=dev)
    y = torch.empty_like(x)
    copies = differenced_rate(torch, lambda: y.copy_(x), nbytes)
    del x, y
    print(f"K18a stream rate {n}^2 f32 ({r['launches']} launches): "
          f"{info['bytes_per_s'] / 1e9:.1f} GB/s, samples "
          f"{[round(v, 1) for v in info['samples_GBps']]} GB/s, above the "
          f"{info['spec_GBps']:.0f} GB/s data sheet: {info['above_spec']}, "
          f"clamped {info['clamped_to_spec']}; y.copy_(x) the same way: "
          f"{statistics.median(copies) / 1e9:.1f} GB/s, samples "
          f"{[round(v / 1e9, 1) for v in copies]} GB/s; on "
          f"{nvidia_smi_line()}")
    info["copy_samples_GBps"] = [v / 1e9 for v in copies]
    return info


def phase_probes(torch, dev, rec, stream):
    """1b (K18b part 1): the attribution probes' kernels against their
    plain versions on the card, with device times, then the probes' path
    with the launch counts from 0.  ``stream``: phase 1's K18a rate
    record, the yardstick printed beside each time."""
    import importlib

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import launches
    from multigrid_petsc_tpu_torch.ops.cuda import pipeline_kernel as plk
    from multigrid_petsc_tpu_torch.ops.cuda import probe_kernel as pk
    from multigrid_petsc_tpu_torch.ops.cuda import stream_kernel as sk
    from multigrid_petsc_tpu_torch.probes import PROBES
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    rate = stream["bytes_per_s"]
    gen = torch.Generator(device=dev).manual_seed(2121)

    def timed(key, label, fn, plain, nbytes, flops, library=None,
              bound=None):
        """``bound``: (ms, what binds it) where the kernel's yardstick is
        not its HBM bytes and F32_PEAK operations (K18b-R / K18b-P)."""
        r = rec.setdefault(key, {})
        ms, pms = time_ms(torch, fn), time_ms(torch, plain)
        lms = None if library is None else time_ms(torch, library)
        ldms = None if library is None else device_ms(torch, library)
        dms = device_ms(torch, fn)
        keep_time(r, ms, pms, nbytes, flops, lms, ldms)
        r["device_ms"] = dms
        bms, by = bound or (1e3 * max(nbytes / HBM_PEAK, flops / F32_PEAK),
                            "")
        share = 1e5 * nbytes / dms / rate
        print(f"  {label}: kernel {ms:.4f} ms a call, device {dms:.4f} ms "
              f"({nbytes / dms / 1e6:.1f} GB/s, {share:.1f}% of K18a's "
              f"{rate / 1e9:.1f} GB/s); plain {pms:.4f} ms"
              + ("" if lms is None else f"; library {lms:.4f} ms a call, "
                 f"device {ldms:.4f} ms")
              + f"; bound {bms:.4f} ms{f' ({by})' if by else ''} "
              f"({100 * bms / dms:.1f}% device)")

    def exact(key, label, got, want):
        r = rec.setdefault(key, {})
        for g, w in zip(got, want):
            err = float((g.double() - w.double()).abs().max())
            assert torch.equal(g, w), f"{label}: not bit for bit ({err:.3e})"
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        print(f"  {label}: bit for bit")

    # KP1: the visit ablations, 8191^2, k = 3.
    n, nyc = 8191, 4095
    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, dev)
    steps = jacobi_step_coeffs(3, 0.8)
    b = torch.randn((n, n), generator=gen, device=dev)
    vbytes = 4 * (2 * n * n + nyc * nyc)
    print("KP1 visit ablations at 8191^2, k = 3")
    base = pk.visit_ablate(st, b, steps, "base")
    for mode in pk.MODES:
        key = f"visit_ablate.{mode}"
        got = pk.visit_ablate(st, b, steps, mode)
        want = pk.visit_ablate_plain(st, b, steps, mode)
        if mode == "loadstore":
            exact(key, "loadstore vs plain", got, want)
        else:
            for nm, g, w in zip(("u", "rc"), got, want):
                compare(torch, f"{mode} {nm}", g, w, rec.setdefault(key, {}))
        if mode == "norm":  # another rounding, the same function
            for nm, g, w in zip(("u", "rc"), got, base):
                compare(torch, f"norm {nm} vs base", g, w, {})
        if mode == "nomask":
            same = all(torch.equal(g, w) for g, w in zip(got, base))
            d = max(float((g - w).abs().max()) for g, w in zip(got, base))
            print(f"  nomask vs base: max |difference| {d:.3e}"
                  + (" (bit for bit)" if same else ""))
            for nm, g, w in zip(("u", "rc"), got, base):
                compare(torch, f"nomask {nm} vs base", g, w, {})
        flops = n * n * (0 if mode == "loadstore" else
                         15 * (1 if mode == "nosweep" else 3) + 10)
        timed(key, mode, lambda m=mode: pk.visit_ablate(st, b, steps, m),
              lambda m=mode: pk.visit_ablate_plain(st, b, steps, m),
              vbytes, flops)
    del b, base, got, want
    # KP2: the copy in place, 8192^2 and copy_cases' views (the storage
    # around a view must stay as it was).
    m = 8192
    print("KP2 scale_copy_ (in place) at 8192^2")
    for dt in sk.DTYPES:
        flat = torch.randn(m * m, generator=gen, device=dev).to(dt)
        for what, v in copy_cases(sk, flat, m):
            lo, hi = v.storage_offset(), v.storage_offset() + v.numel()
            base = flat.clone()
            view = base[lo:hi].view(v.shape)
            want = sk.scale_copy_plain(v, 1.0001)
            sk.scale_copy_(view, 1.0001)
            exact("scale_copy_", f"scale_copy_ {dt} {what}", (view,),
                  (want,))
            assert torch.equal(base[:lo], flat[:lo]) and torch.equal(
                base[hi:], flat[hi:]), f"scale_copy_ {what}: wrote outside"
        del flat, base, view, want
    x = torch.randn((m, m), generator=gen, device=dev)
    y = x.clone()
    timed("scale_copy_", "scale_copy_ f32", lambda: sk.scale_copy_(y, 1.0001),
          lambda: sk.scale_copy_plain_(y, 1.0001), 8 * m * m, m * m,
          lambda: y.mul_(1.0001))
    # KP3: the staged copy and the visit pipeline.
    print("KP3 staged_copy and the visit pipeline")
    # Sizes below one chunk (a stage), not a multiple of a round (one chunk
    # a block), views 1-3 entries in.
    flat = x.view(-1)
    for what, u in [("8192^2", x), ("8191^2", x[:n, :n].contiguous())] + [
            (f"8191^2 view, offset {o}", flat[o:o + n * n].view(n, n))
            for o in (1, 2, 3)] + [
            (f"{r} x {c} at {o}", flat[o:o + r * c].view(r, c))
            for r, c in ((1, 1), (1, 3), (31, 129), (37, 229), (1500, 1501))
            for o in (0, 1, 2, 3)]:
        for k in (1, 2, 3):
            exact("staged_copy", f"staged_copy {what} k = {k}",
                  (plk.staged_copy(u, k),), (plk.staged_copy_plain(u, k),))
    y = torch.empty_like(x)
    timed("staged_copy", "staged_copy 8192^2 k = 1",
          lambda: plk.staged_copy(x, 1), lambda: plk.staged_copy_plain(x, 1),
          8 * m * m, 0, lambda: y.copy_(x))
    # The visit pipeline, bit for bit in every mode at every t the wrapper
    # takes among 16-64: on 8191^2 and 8192^2, a last strip
    # of 9, 3 and 1 columns, fewer rows than a window (ny < t + 2 H), and
    # row pairs that the grid does not divide (the spans differ by one).
    for shape in ((n, n), (m, m), (1000, 777), (45, 259), (20, 1000),
                  (3, 257), (37, 229), (300, 301), (1500, 1501),
                  (4097, 4097)):
        bb = x.view(-1)[:shape[0] * shape[1]].view(shape)
        for mode in plk.PIPE_MODES:
            want = tuple(o for o in plk.staged_visit_pipeline_plain(
                bb, 32, mode) if o is not None)
            for t in (16, 32, 48, 64):
                if plk.pipe_stages(t, mode) is None:
                    continue
                got = tuple(o for o in plk.staged_visit_pipeline(bb, t, mode)
                            if o is not None)
                for g, w in zip(got, want):
                    assert torch.equal(g, w), (
                        f"pipeline {shape} {mode} t = {t}: not bit for bit")
        print(f"  pipeline {shape[0]} x {shape[1]}: every mode, t = 16-64: "
              f"bit for bit")
    rec.setdefault("staged_visit_pipeline", {})["max_abs_err"] = 0.0
    bb = x[:n, :n].contiguous()
    r = rec.setdefault("staged_visit_pipeline", {})
    yn = torch.empty_like(bb)
    copy_ms = time_ms(torch, lambda: yn.copy_(bb))
    copy_dms = device_ms(torch, lambda: yn.copy_(bb))
    print(f"  y.copy_(x) at 8191^2: {copy_ms:.4f} ms a call, device "
          f"{copy_dms:.4f} ms")
    modes = {}
    for mode in plk.PIPE_MODES:
        rc_on = plk.PIPE_MODES[mode][2]
        nb = 4 * (2 * n * n + (nyc * nyc if rc_on else 0))
        modes[mode] = {"bytes": nb}
        if not rc_on:  # u = b alone: one PyTorch call computes it
            modes[mode].update(library_ms=copy_ms, library_device_ms=copy_dms)
        for t in (32, 16, 48):
            if plk.pipe_stages(t, mode) is None:
                continue
            blocks, bands = plk.pipe_plan((n, n), t, mode)
            cnt = plk.pipe_bytes(n, n, t, mode, bands)
            dms = device_ms(torch, lambda md=mode, tt=t:
                            plk.staged_visit_pipeline(bb, tt, md))
            key = "" if t == 32 else f"_t{t}"
            modes[mode].update({f"device_ms{key}": dms,
                                f"moved{key}": cnt["moved"],
                                f"blocks{key}": blocks,
                                f"stages{key}": plk.pipe_stages(t, mode)})
            print(f"  pipeline 8191^2 {mode} t = {t}: device {dms:.4f} ms "
                  f"({nb / dms / 1e6:.1f} GB/s of the bound's {nb / 1e6:.1f}"
                  f" MB, {1e5 * nb / dms / rate:.1f}% of K18a's; "
                  f"{100 * 1e3 * nb / HBM_PEAK / dms:.1f}% of the bound); "
                  f"moves {cnt['moved'] / 1e6:.1f} MB ({cnt['reread'] / 1e6:.1f}"
                  f" MB re-read) on {blocks} blocks, {bands} bands, "
                  f"{plk.pipe_stages(t, mode)} stages")
    timed("staged_visit_pipeline", "pipeline 8191^2 v_full t = 32",
          lambda: plk.staged_visit_pipeline(bb, 32, "v_full"),
          lambda: plk.staged_visit_pipeline_plain(bb, 32, "v_full"),
          modes["v_full"]["bytes"], 0)
    r["modes"] = modes
    del x, y, yn, bb, u, got, want
    torch.cuda.empty_cache()
    phase_probes_xfer(torch, dev, rec, timed)
    # The probes' path: each probe once, quick, at full size.
    launches.clear()
    per_probe = {}
    for name in PROBES:
        before = dict(launches)
        importlib.import_module(
            f"multigrid_petsc_tpu_torch.probes.{name}").run(dev, quick=True)
        per_probe[name] = {k: v - before.get(k, 0)
                           for k, v in launches.items()
                           if v != before.get(k, 0)}
    counts = dict(launches)
    print(f"probes' path launches: {counts}")
    for name, c in per_probe.items():  # K18a's rate reading included
        print(f"  probe {name}'s launches: {c}")
    for key in [f"visit_ablate.{md}" for md in pk.MODES] + [
            "scale_copy_", "staged_copy", "staged_visit_pipeline",
            "halo_windows", "xfer_restrict", "xfer_prolong"]:
        rec[key]["launches"] = counts.get(key, 0)
        assert rec[key]["launches"] > 0, f"{key} never launched on its path"


def phase_probes_xfer(torch, dev, rec, timed):
    """1b (K18b part 2): K18b-W, the halo windows, at 8191^2 on four
    (stride, g, top, bot) cases and an offset view, bit for bit; K18b-R in
    every mode and K18b-P at the transpose probe's shapes, bit for bit,
    device times at G = 86 and G = 1 and the time a pass, (t86 - t1) / 85,
    which leaves out each launch's fixed cost (its fill, block start and
    the launch gap), beside the bound (``xfer_bound``: the JAX function's
    operations or its slab's bytes once a pass, at 128 a clock an SM) and
    the bytes the design reads from shared memory; then every mode bit for
    bit on the edge cases.  ``timed``: phase 1b's timer."""
    from multigrid_petsc_tpu_torch.ops.cuda import xfer_probe_kernel as xk
    from multigrid_petsc_tpu_torch.probes import smem_rate
    from multigrid_petsc_tpu_torch.probes import transpose as tp

    gen = torch.Generator(device=dev).manual_seed(2222)
    n = 8191
    flat = torch.randn(n * n + 1, generator=gen, device=dev)
    x = flat[:n * n].view(n, n)
    print("K18b-W halo_windows at 8191^2 (stride, g, top, bot)")
    r = rec.setdefault("halo_windows", {})
    for what, u, case in (
            ("", x, (160, 52, 5, 5)), ("", x, (160, 52, 3, 3)),
            ("", x, (160, 52, 5, 2)), ("", x, (96, 90, 5, 5)),
            (" view, offset 1", flat[1:].view(n, n), (160, 52, 5, 5))):
        got = xk.halo_windows(u, *case)
        want = xk.halo_windows_plain(u, *case)
        for g, w in zip(got, want):
            err = float((g - w).abs().max())
            assert torch.equal(g, w), f"halo_windows {case}{what}: {err:.3e}"
            r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        print(f"  {case}{what}: bit for bit")
    case = (160, 52, 5, 5)
    timed("halo_windows", f"halo_windows {case}",
          lambda: xk.halo_windows(x, *case),
          lambda: xk.halo_windows_plain(x, *case),
          xk.windows_bytes(n, n, *case), 0)
    del flat, x, got, want
    # K18b-R and K18b-P: the probe's slabs, G = 86 passes.
    rate = smem_rate(dev)
    x = torch.randn((tp.TH, tp.NXP), generator=gen, device=dev)
    e = torch.randn((tp.T2 // 2 + 1, tp.NXP // 2), generator=gen,
                    device=dev)
    print(f"K18b-R / K18b-P x-transfer passes, ({tp.TH}, {tp.NXP}) and "
          f"{tuple(e.shape)}, G = {tp.G}; bound at {rate / 1e12:.2f} T "
          f"instructions or shared-memory bytes a second (128 a clock an "
          f"SM at nvidia-smi clocks.max.sm)")

    def call(inp, mode, G):
        return (xk.xfer_prolong(inp, G) if mode == "prolong"
                else xk.xfer_restrict(inp, mode, G))

    def plain_call(inp, mode, G):
        return (xk.xfer_prolong_plain(inp, G) if mode == "prolong"
                else xk.xfer_restrict_plain(inp, mode, G))

    for mode in tp.MODES + ("prolong",):
        key = "xfer_prolong" if mode == "prolong" else "xfer_restrict"
        inp = e if mode == "prolong" else x
        r = rec.setdefault(key, {})
        got, want = call(inp, mode, tp.G), plain_call(inp, mode, tp.G)
        err = float((got - want).abs().max())
        assert torch.equal(got, want), f"{mode}: not bit for bit ({err:.3e})"
        r["max_abs_err"] = max(r.get("max_abs_err", 0.0), err)
        b = xk.xfer_bound(mode, inp.shape[0], tp.NXP, tp.G, rate)
        smem = xk.smem_read_bytes(mode, inp.shape[0], tp.NXP, tp.G)
        hbm = 4 * (inp.numel() + got.numel())
        dms = device_ms(torch, lambda: call(inp, mode, tp.G))
        dms1 = device_ms(torch, lambda: call(inp, mode, 1))
        per_pass = (dms - dms1) / (tp.G - 1)
        r.setdefault("modes", {})[mode] = {
            "device_ms": dms, "device_ms_g1": dms1, "pass_ms": per_pass,
            "bound_ms": b["bound_ms"], "bound_by": b["bound_by"],
            "bound_ops": b["ops"], "bound_bytes": b["bytes"],
            "smem_bytes": smem}
        print(f"  {mode}: bit for bit; device {dms:.4f} ms at G = {tp.G}, "
              f"{dms1:.4f} at G = 1, {1e3 * per_pass:.3f} us a pass; bound "
              f"{b['bound_ms']:.4f} ms by {b['bound_by']} ({b['ops']} "
              f"operations {b['ops_ms']:.4f} ms, {b['bytes'] / 1e6:.1f} MB "
              f"{b['smem_ms']:.4f} ms; {100 * b['bound_ms'] / dms:.1f}% of "
              f"the device time, the passes alone "
              f"{100 * b['bound_ms'] / ((tp.G - 1) * per_pass):.1f}% at G - 1"
              f"); the design reads {smem / 1e6:.1f} MB of shared memory")
        if mode in ("full", "prolong"):  # the production transfers
            timed(key, f"{key} {mode}", lambda: call(inp, mode, tp.G),
                  lambda: plain_call(inp, mode, tp.G), hbm, b["ops"],
                  bound=(b["bound_ms"], b["bound_by"]))
            r["bound_ms"], r["bound_by"] = b["bound_ms"], b["bound_by"]
    del x, e, got, want
    # The edge cases, each mode bit for bit: (what, rows, fine width, G,
    # offset of the slab in its storage: 1 is not 16-byte aligned).
    narrow = xk.XFER_UNIT
    edges = [("the smallest width, one row", 1, narrow, tp.G, 0),
             ("5 rows", 5, tp.NXP, tp.G, 0),
             ("57 rows", 57, tp.NXP, tp.G, 0),
             ("G = 1, narrow", 8, narrow, 1, 0),
             (f"G = {xk.MAX_PASSES}, narrow", 3, narrow, xk.MAX_PASSES, 0),
             ("an offset view", 5, 2 * narrow, 7, 1)]
    for what, rows, nxp, G, off in edges:
        ok = []
        for mode in tp.MODES + ("prolong",):
            cols = nxp // 2 if mode == "prolong" else nxp
            flat = torch.randn(rows * cols + off, generator=gen, device=dev)
            inp = flat[off:].view(rows, cols)
            got, want = call(inp, mode, G), plain_call(inp, mode, G)
            err = float((got - want).abs().max())
            assert torch.equal(got, want), \
                f"{mode} {what}: not bit for bit ({err:.3e})"
            ok.append(mode)
        print(f"  {what} ({rows} x {nxp}, G = {G}): {', '.join(ok)} bit "
              f"for bit")


def conv_call(torch, w3, u, b=None):
    """One torch.nn.functional.conv2d call with a 3x3 weight and padding 1
    that computes A u (or b - A u, from the stacked (b, u) channels) for a
    constant-coefficient stencil w3 = [[sw, s, se], [w, c, e], [nw, n, ne]]:
    the library yardstick of K6 / residual5 / K12."""
    F = torch.nn.functional
    if b is None:
        x, w = u[None, None], w3[None, None]
    else:
        delta = torch.zeros_like(w3)
        delta[1, 1] = 1.0
        x, w = torch.stack([b, u])[None], torch.stack([delta, -w3])[None]
    return lambda: F.conv2d(x, w, padding=1)[0, 0]


def check_kernel(torch, rec, key, label, nbytes, flops, kern, plain, names,
                 tol=TOL_ARRAY, library=None, timed=True, dot_scale=None,
                 library_name="conv2d", floors=None):
    """Hold a kernel's outputs to its plain version's; then (``timed``)
    time both, and the library call where there is one.  The kernel's
    record keeps its first timing.  ``dot_scale(want)`` gives the scale an
    inner product is held to, ``floors`` an output's floor (by name; see
    ``compare``)."""
    print(label)
    got, want = kern(), plain()
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    for nm, g, w in zip(names, got, want):
        scale = dot_scale(want) if dot_scale and w.dim() == 0 else None
        compare(torch, nm, g, w, rec[key], tol, scale,
                (floors or {}).get(nm, 0.0))
    del got
    if not timed:
        return
    ms, pms = time_ms(torch, kern), time_ms(torch, plain)
    lms = ldms = None
    if library is not None:
        lms = time_ms(torch, library)
        ldms = library_device_ms(torch, library, lms)
        lerr = float((library() - want[0]).abs().max() / want[0].abs().max())
        print(f"  {library_name}: {lms:.4f} ms a call, device {ldms:.4f} ms "
              f"(rel. diff. from plain {lerr:.2e})")
    print(f"  {label}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s "
          f"effective), plain {pms:.4f} ms")
    keep_time(rec[key], ms, pms, nbytes, flops, lms, ldms)


def phase_kernels(torch, dev, rate):
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import coarse_tree_kernel as ctk
    from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    gen = torch.Generator(device=dev).manual_seed(1234)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    def st_of(n):
        return stencil_coefficients(MeshType.UNIFORM, n, n, f32, dev)

    steps = jacobi_step_coeffs(3, 0.8)
    k = len(steps)
    rec = {key: {} for key in ("cg_papply_u", "cg_visit_down", "visit_down",
                               "visit_up", "coarse_tree")}

    def timed(key, n, nbytes, flops, kern, plain):
        ms, pms = time_ms(torch, kern), time_ms(torch, plain)
        print(f"  {key} {n}^2: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} "
              f"GB/s effective), plain {pms:.4f} ms")
        keep_time(rec[key], ms, pms, nbytes, flops)

    n = 8191
    st = st_of(n)
    z, p, u, r, ap = (rnd(n, n) for _ in range(5))
    a_prev = torch.tensor(0.21, device=dev)
    beta = torch.tensor(0.43, device=dev)
    alpha = torch.tensor(0.37, device=dev)
    print(f"K1 cg_papply_u at {n}^2")
    got = mdma.cg_papply_u(st, z, p, u, a_prev, beta)
    want = mdma.cg_papply_u_plain(st, z, p, u, a_prev, beta)
    for nm, g, w in zip(("p'", "Ap'", "u'", "<p',Ap'>"), got, want):
        compare(torch, nm, g, w, rec["cg_papply_u"])
    timed("cg_papply_u", n, 6 * n * n * 4, 15 * n * n,
          lambda: mdma.cg_papply_u(st, z, p, u, a_prev, beta),
          lambda: mdma.cg_papply_u_plain(st, z, p, u, a_prev, beta))

    print(f"K2a cg_visit_down at {n}^2")
    got = mdma.cg_visit_down(st, r, ap, alpha, steps)
    want = mdma.cg_visit_down_plain(st, r, ap, alpha, steps)
    for nm, g, w in zip(("u0", "rc", "r'", "||r'||^2"), got, want):
        compare(torch, nm, g, w, rec["cg_visit_down"])
    timed("cg_visit_down", n, 4.25 * n * n * 4, (15 * k + 16) * n * n,
          lambda: mdma.cg_visit_down(st, r, ap, alpha, steps),
          lambda: mdma.cg_visit_down_plain(st, r, ap, alpha, steps))
    del z, p, ap

    for n in (8191, 4095, 2047):
        st = st_of(n)
        b, u = (r, rnd(n, n)) if n == 8191 else (rnd(n, n), rnd(n, n))
        e = rnd((n - 1) // 2, (n - 1) // 2)
        if n != 8191:
            print(f"K2b visit_down at {n}^2")
            got = mdma.visit_down(st, b, steps)
            want = mdma.visit_down_plain(st, b, steps)
            for nm, g, w in zip(("u0", "rc"), got, want):
                compare(torch, nm, g, w, rec["visit_down"])
            timed("visit_down", n, 2.25 * n * n * 4, (15 * k + 12) * n * n,
                  lambda: mdma.visit_down(st, b, steps),
                  lambda: mdma.visit_down_plain(st, b, steps))
        for emit_dot in (True, False):
            print(f"K3 visit_up at {n}^2, emit_dot={emit_dot}")
            got = mdma.visit_up(st, b, u, e, steps, emit_dot)
            want = mdma.visit_up_plain(st, b, u, e, steps, emit_dot)
            if not emit_dot:
                got, want = (got,), (want,)
            for nm, g, w in zip(("z", "<b,z>"), got, want):
                compare(torch, nm, g, w, rec["visit_up"])
            if emit_dot or n != 8191:
                timed("visit_up", n, 3.25 * n * n * 4, (15 * k + 4) * n * n,
                      lambda: mdma.visit_up(st, b, u, e, steps, emit_dot),
                      lambda: mdma.visit_up_plain(st, b, u, e, steps,
                                                  emit_dot))
    del r, b, u, e

    # K4 on scripts/time_coarse_tree.py's trees: the main path's (1023^2 ->
    # 7^2), the 513^2 / 7-level split, a tree all in block 0's tail, three
    # smoothing their coarsest level (one with no tail, one with the
    # coarsest alone in it), k = 1.
    tct = load_script("time_coarse_tree")
    trees = tct.tree_cases(torch, dev)
    print(f"K4 coarse_tree on {len(trees)} trees (tail constant "
          f"{ctk.TREE_TAIL_MAX_N})")
    for t in trees:
        plan = t.solve.plan
        print(f"  {t.name}: tail from level {plan.tail_from}, "
              f"{plan.grid_syncs} grid syncs, {plan.blocks} blocks")
        compare(torch, t.name, t.solve(t.b), t.plain(), rec["coarse_tree"])
    main = trees[0]
    shapes, plan = main.shapes, main.solve.plan
    tree_flops = sum((30 * k + 14) * a * c for a, c in shapes) + 2 * 49**2
    nbytes = 2 * 1023 * 1023 * 4 + 4 * 49**2
    timed("coarse_tree", 1023, nbytes, tree_flops,
          lambda: main.solve(main.b), main.plain)
    dev_ms = tct.device_ms(torch, lambda: main.solve(main.b))
    sync_us = tct.sync_cost_us(torch, tct.load_probe(), plan.blocks)
    floor_ms = plan.grid_syncs * sync_us * 1e-3 + 1e3 * nbytes / rate
    print(f"  coarse_tree 1023^2 -> 7^2: device {dev_ms:.4f} ms a call "
          f"({tct.CALLS} calls between two events); one grid.sync() of "
          f"{plan.blocks} blocks {sync_us:.3f} us (probe); latency floor "
          f"{plan.grid_syncs} x {sync_us:.3f} us + bytes / copy rate = "
          f"{floor_ms:.4f} ms; on {nvidia_smi_line()}")
    rec["coarse_tree"].update(device_ms=dev_ms, grid_syncs=plan.grid_syncs,
                              grid_sync_us=sync_us,
                              latency_floor_ms=floor_ms)
    return rec


def load_script(name: str):
    """A module of the repo's scripts/ folder, by path."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parent / "scripts" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def phase_kernels_vcycle(torch, dev, rec):
    """K6, K7 and K9 (every mode of the V-cycle family) at 8191^2."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.problems import stencil_coefficients
    from multigrid_petsc_tpu_torch.solvers.smoothers import (
        chebyshev_step_coeffs,
        jacobi_step_coeffs,
    )

    gen = torch.Generator(device=dev).manual_seed(4321)
    n = 8191
    arr = n * n * 4  # bytes of one f32 level-0 array
    pts = n * n
    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, dev)
    b, u = (torch.randn((n, n), generator=gen, device=dev) for _ in range(2))
    e = torch.randn(((n - 1) // 2, (n - 1) // 2), generator=gen, device=dev)
    for key in ("apply_stencil5", "residual5", "smooth_sweeps",
                "fused_level_visit"):
        rec[key] = {}
    # The uniform mesh's stencil is constant: conv2d computes K6's function.
    c = [float(x[0, 0]) for x in st]  # cs, cw, cc, ce, cn
    w5 = torch.tensor([[0.0, c[0], 0.0], [c[1], c[2], c[3]],
                       [0.0, c[4], 0.0]], device=dev)

    def check(key, label, *args, **kw):
        check_kernel(torch, rec, key, f"{label} at {n}^2", *args, **kw)

    check("apply_stencil5", "K6 apply_stencil5", 2 * arr, 9 * pts,
          lambda: sk.apply_stencil5(st, u),
          lambda: sk.apply_stencil5_plain(st, u), ("Au",),
          library=conv_call(torch, w5, u))
    jac = jacobi_step_coeffs(3, 0.8)
    cheb = chebyshev_step_coeffs(3, 1.9)
    for name, steps in (("Jacobi", jac), ("Chebyshev", cheb)):
        check("smooth_sweeps", f"K7 smooth_sweeps {name} k=3", 3 * arr,
              45 * pts, lambda: sk.smooth_sweeps(st, b, u, steps),
              lambda: sk.smooth_sweeps_plain(st, b, u, steps), ("u'",))
    modes = (  # label, (u, steps, emit, e_coarse), bytes, output names
        ("K9 nonzero-guess rc", (u, jac, "rc", None), 3.25, ("u'", "rc")),
        ("K9 zero-guess rc (K2b)", (None, jac, "rc", None), 2.25,
         ("u'", "rc")),
        ("K9 correct + u (K3)", (u, jac, "u", e), 3.25, ("u'",)),
        ("K9 correct + ur", (u, jac, "ur", e), 4.25, ("u'", "r")),
        ("K9 nonzero-guess rc, k=8", (u, jacobi_step_coeffs(8, 0.8), "rc",
                                      None), 3.25, ("u'", "rc")),
        ("K9 nonzero-guess rc, k=32 (past the old 31-step cap)",
         (u, jacobi_step_coeffs(32, 0.8), "rc", None), 3.25, ("u'", "rc")),
    )
    for label, (u_in, steps, emit, e_c), nb, names in modes:
        check("fused_level_visit", label, nb * arr, (15 * len(steps) + 12)
              * pts,
              lambda: sk.fused_level_visit(st, b, u_in, steps, emit, e_c),
              lambda: sk.fused_level_visit_plain(st, b, u_in, steps, emit,
                                                 e_c), names)
    check("residual5", "K9 r (residual5)", 3 * arr, 10 * pts,
          lambda: sk.residual5(st, b, u),
          lambda: sk.residual5_plain(st, b, u), ("r",),
          library=conv_call(torch, w5, u, b))
    del b, u, e
    torch.cuda.empty_cache()
    check_ragged_5pt(torch, dev, rec, torch.float32)


def time_scalar_layout(torch, record, label, nbytes, fn):
    """K12 on its nine-scalar layout (the constant stencil with cc a scalar
    too, so only the (n, n) arrays u [, b] and the output move), kept
    beside the record's time on the solver's layout of the same stencil."""
    ms = time_ms(torch, fn)
    record.update(scalars_ms=ms, scalars_bound_ms=1e3 * nbytes / HBM_PEAK)
    print(f"  {label} (nine scalars): kernel {ms:.4f} ms "
          f"({nbytes / ms / 1e6:.1f} GB/s effective)")


def phase_kernels_9pt(torch, dev, rec):
    """K12-K15 at 8191^2 against their plain versions, on the anisotropic
    stencils and on a random stencil with every coefficient kind."""
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import (
        chebyshev_step_coeffs,
        jacobi_step_coeffs,
    )

    gen = torch.Generator(device=dev).manual_seed(999)
    n = 8191
    arr, pts = n * n * 4, n * n
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    def aniso(*p):
        return stencil9_coefficients(AnisoProblem(*p), n, n, f32, dev)

    mixed = aniso(1.0, 1.0, 1.0, 2.0, 0.4)   # x-varying cc, all kinds
    # Constant coefficients as the solver builds them (cc an (n, n) field:
    # the anisotropic layout, phase 6's A p), and as nine scalars (K12's
    # compiled scalar layout).
    const = aniso(1.0, 0.0, 100.0, 0.0, 0.3)
    scal = Stencil9(*(x.reshape(-1)[:1].reshape(1, 1) for x in const))
    # Every kind, cc a random field scaled like the O(1/h^2) stencils.
    h2 = float(n + 1) ** 2
    allk = Stencil9(h2 * rnd(1, 1), h2 * rnd(n, 1), h2 * rnd(1, n),
                    h2 * rnd(n, n), -h2 * (12 + 4 * rnd(n, n).abs()),
                    h2 * rnd(1, n), h2 * rnd(n, 1), h2 * rnd(1, 1),
                    h2 * rnd(n, n))
    b, u = rnd(n, n), rnd(n, n)
    e = rnd((n - 1) // 2, (n - 1) // 2)
    for key in ("apply_stencil9", "residual9", "smooth9_sweeps",
                "fused_level_visit9", "line_visit9"):
        rec[key] = {}

    def check(key, label, *args, **kw):
        check_kernel(torch, rec, key, f"{label} at {n}^2", *args, **kw)

    # K12 on the constant-coefficient stencil first (its timing and
    # conv2d's), then on the other three for agreement; its time on the
    # nine scalars is kept beside.
    q = [float(x.reshape(-1)[0]) for x in scal]
    w9 = torch.tensor([q[0:3], q[3:6], q[6:9]], device=dev)
    for name, st in (("constant-coefficient", const), ("nine scalars", scal),
                     ("mixed", mixed), ("all kinds", allk)):
        first = st is const  # u and cc in, A u out
        check("apply_stencil9", f"K12 apply_stencil9 ({name})", 3 * arr,
              17 * pts, lambda: k9.apply_stencil9(st, u),
              lambda: k9.apply_stencil9_plain(st, u), ("Au",),
              library=conv_call(torch, w9, u) if first else None,
              timed=first)
        check("residual9", f"K12 residual9 ({name})", 4 * arr, 18 * pts,
              lambda: k9.residual9(st, b, u),
              lambda: k9.residual9_plain(st, b, u), ("r",),
              library=conv_call(torch, w9, u, b) if first else None,
              timed=first)
    time_scalar_layout(torch, rec["apply_stencil9"], "K12 apply_stencil9",
                       2 * arr, lambda: k9.apply_stencil9(scal, u))
    time_scalar_layout(torch, rec["residual9"], "K12 residual9", 3 * arr,
                       lambda: k9.residual9(scal, b, u))
    del scal
    jac, cheb = jacobi_step_coeffs(3, 0.8), chebyshev_step_coeffs(3, 1.9)
    for name, st in (("mixed", mixed), ("all kinds", allk)):
        for sname, steps in (("Jacobi", jac), ("Chebyshev", cheb)):
            check("smooth9_sweeps", f"K13 smooth9_sweeps {sname} k=3 "
                  f"({name})", 4 * arr, 69 * pts,
                  lambda: k9.smooth9_sweeps(st, b, u, steps),
                  lambda: k9.smooth9_sweeps_plain(st, b, u, steps), ("u'",),
                  timed=st is mixed)
    modes = (  # label, (u, emit, e_coarse, dot), arrays moved, names
        ("zero-guess rc", (None, "rc", None, False), 3.25, ("u'", "rc")),
        ("nonzero-guess rc", (u, "rc", None, False), 4.25, ("u'", "rc")),
        ("correct + u", (u, "u", e, False), 4.25, ("u'",)),
        ("correct + ur", (u, "ur", e, False), 5.25, ("u'", "r")),
        ("r", (u, "r", None, False), 4, ("r",)),
        ("correct + u + <b,u>", (u, "u", e, True), 4.25, ("u'", "<b,u>")),
    )
    for name, st in (("mixed", mixed), ("all kinds", allk)):
        for label, (u_in, emit, e_c, dot), nb, names in modes:
            check("fused_level_visit9", f"K14 {label} ({name})", nb * arr,
                  (69 + 20) * pts,
                  lambda: k9.fused_level_visit9(st, b, u_in, jac, emit, e_c,
                                                dot),
                  lambda: k9.fused_level_visit9_plain(st, b, u_in, jac, emit,
                                                      e_c, dot), names,
                  timed=st is mixed)
    del allk, b, u, e, mixed, const
    torch.cuda.empty_cache()
    phase_line_card(torch, dev, rec)
    check_ragged_9pt(torch, dev, rec, torch.float32)


def phase_line_card(torch, dev, rec):
    """K15 (one card) at 8191^2 against its plain version, every mode, on
    BASELINE config 4's line stencil ((ny, 1) line coefficients) and on
    the mixed one, whose cc varies with x ((ny, nx) factors); on the
    first, the sweep's three launches alone as device time
    (``line_launch_ms``, through the split entries on the whole level)."""
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )

    gen = torch.Generator(device=dev).manual_seed(999)
    n = 8191
    arr, pts = n * n * 4, n * n
    f32 = torch.float32
    b, u = (torch.randn((n, n), generator=gen, device=dev, dtype=f32)
            for _ in range(2))
    e = torch.randn(((n - 1) // 2, (n - 1) // 2), generator=gen, device=dev,
                    dtype=f32)
    rec.setdefault("line_visit9", {})

    def aniso(*p):
        return stencil9_coefficients(AnisoProblem(*p), n, n, f32, dev)

    def check(key, label, *args, **kw):
        check_kernel(torch, rec, key, f"{label} at {n}^2", *args, **kw)

    line = lk.collapse_stencil(aniso(1.0, 0.0, 100.0, 0.0, 0.0))
    xvar = lk.collapse_stencil(aniso(1.0, 1.0, 1.0, 2.0, 0.4))
    assert line.cc.shape == (1, 1) or line.cc.shape[1] == 1
    assert xvar.cc.shape == (n, n)
    lmodes = (  # label, (u, emit, e_coarse, dot), arrays moved, names
        ("u", (u, "u", None, False), 3, ("u'",)),
        ("ur", (u, "ur", None, False), 4, ("u'", "r")),
        ("zero-guess rc", (None, "rc", None, False), 2.25, ("u'", "rc")),
        ("correct + u + <b,u>", (u, "u", e, True), 3.25, ("u'", "<b,u>")),
    )
    def line_dot_scale(want):
        # K15's <b, u>: u differs from the plain one by solve rounding
        # (TOL_LINE), and random data make <b, u> cancel ~1e3-fold, so
        # the dot is held to TOL_LINE of sum |b u|.
        return float((b * want[0]).abs().sum())

    for name, st in (("columns", line), ("x-varying cc", xvar)):
        fac = lk.line_factor(st, n)
        for label, (u_in, emit, e_c, dot), nb, names in lmodes:
            if st is xvar and label in ("ur", "correct + u + <b,u>"):
                continue
            check("line_visit9", f"K15 line_visit9 {label} k=3 ({name})",
                  nb * arr, 3 * 20 * pts,
                  lambda: lk.line_visit9(st, b, u_in, 3, 0.8, emit, e_c, dot,
                                         fac=fac),
                  lambda: lk.line_visit9_plain(st, b, u_in, 3, 0.8, emit,
                                               e_c, dot), names, TOL_LINE,
                  timed=st is line, dot_scale=line_dot_scale)
    lf = lk.row_line(line, n, n, 0, plain=False)
    zero = u.new_zeros((1, n))
    halo = Halo(zero, zero)
    every = lk.line_rows_begin(lf, b, u, halo)
    fac = lk.line_factor(line, n)
    sweeps = [device_ms(torch, lambda k=k: lk.line_visit9(
        line, b, u, k, 0.8, fac=fac)) for k in (1, 3)]
    split = line_launch_ms(torch, lk, lf, b, u, halo, every)
    print(f"  K15 u (columns) at {n}^2, device time: k=1 {sweeps[0]:.4f} "
          f"ms, k=3 {sweeps[1]:.4f} ms; {split}")
    rec["line_visit9"]["device_ms"] = sweeps[1]
    rec["line_visit9"]["launch_ms"] = split
    del b, u, e, line, xvar, every, lf, halo, zero
    torch.cuda.empty_cache()


# Shapes of phase 2b / 2d: K15's segments cut by the edge (1025, 33), a
# level's whole line systems (8191 x 1025), levels of one segment (31, 7).
RAGGED = ((1025, 1025), (8191, 1025), (33, 33), (31, 31), (7, 7))


def check_ragged_9pt(torch, dev, rec, dt, sfx=""):
    """K14 (every mode, the anisotropic and the all-kinds stencil) and,
    in f32 and f64, K15 (every mode, (ny, 1) and (ny, nx) line factors)
    against their plain versions on ragged shapes: a 1025^2 and a 33^2
    level (K15: ny not a multiple of its 32-row segments; K14: tiles cut
    by the edge), an 8191 x 1025 block of the 8191^2 level (the full
    level's line systems, 256 segments), and a 31^2 and a 7^2 level (K15:
    one segment, its fix-up launch alone; K14: a level smaller than its
    tile).  Held as at 8191^2, not timed."""
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    gen = torch.Generator(device=dev).manual_seed(2468)
    jac = jacobi_step_coeffs(3, 0.8)
    tag = str(dt).replace("torch.", "")

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    for ny, nx in RAGGED:
        n = max(ny, nx)

        def level(*p):  # the n x n level's stencil, its first nx columns
            st = stencil9_coefficients(AnisoProblem(*p), n, n, dt, dev)
            return Stencil9(*(c[:, :nx].contiguous() if c.shape[1] > 1
                              else c for c in st))

        mixed = level(1.0, 1.0, 1.0, 2.0, 0.4)
        h2 = float(n + 1) ** 2
        allk = Stencil9(h2 * rnd(1, 1), h2 * rnd(ny, 1), h2 * rnd(1, nx),
                        h2 * rnd(ny, nx), -h2 * (12 + 4 * rnd(ny, nx).abs()),
                        h2 * rnd(1, nx), h2 * rnd(ny, 1), h2 * rnd(1, 1),
                        h2 * rnd(ny, nx))
        b, u = rnd(ny, nx), rnd(ny, nx)
        e = rnd((ny - 1) // 2, (nx - 1) // 2)
        modes = (  # label, (u, emit, e_coarse, dot), names
            ("zero-guess rc", (None, "rc", None, False), ("u'", "rc")),
            ("nonzero-guess rc", (u, "rc", None, False), ("u'", "rc")),
            ("correct + u", (u, "u", e, False), ("u'",)),
            ("correct + ur", (u, "ur", e, False), ("u'", "r")),
            ("r", (u, "r", None, False), ("r",)),
            ("correct + u + <b,u>", (u, "u", e, True), ("u'", "<b,u>")))
        for name, st in (("mixed", mixed), ("all kinds", allk)):
            for label, (u_in, emit, e_c, dot), names in modes:
                check_kernel(
                    torch, rec, "fused_level_visit9" + sfx,
                    f"K14 {label} ({name}) {tag} at {ny} x {nx}", 0, 0,
                    lambda: k9.fused_level_visit9(st, b, u_in, jac, emit,
                                                  e_c, dot),
                    lambda: k9.fused_level_visit9_plain(st, b, u_in, jac,
                                                        emit, e_c, dot),
                    names, timed=False)
        del allk
        if dt == torch.bfloat16:
            continue
        line = lk.collapse_stencil(level(1.0, 0.0, 100.0, 0.0, 0.0))
        xvar = lk.collapse_stencil(mixed)
        lmodes = (
            ("u", (u, "u", None, False), ("u'",)),
            ("ur", (u, "ur", None, False), ("u'", "r")),
            ("zero-guess rc", (None, "rc", None, False), ("u'", "rc")),
            ("correct + u + <b,u>", (u, "u", e, True), ("u'", "<b,u>")))
        for name, st in (("columns", line), ("x-varying cc", xvar)):
            fac = lk.line_factor(st, ny)
            for label, (u_in, emit, e_c, dot), names in lmodes:
                check_kernel(
                    torch, rec, "line_visit9" + sfx,
                    f"K15 line_visit9 {label} k=3 ({name}) {tag} at {ny} x "
                    f"{nx}", 0, 0,
                    lambda: lk.line_visit9(st, b, u_in, 3, 0.8, emit, e_c,
                                           dot, fac=fac),
                    lambda: lk.line_visit9_plain(st, b, u_in, 3, 0.8, emit,
                                                 e_c, dot), names, TOL_LINE,
                    timed=False,
                    dot_scale=lambda w: float((b * w[0]).abs().sum()))
        del mixed, line, xvar, b, u, e
        torch.cuda.empty_cache()


def row_blocks_of(ny: int) -> int:
    """Row blocks a RAGGED level is cut into for K17's checks: the most
    (at most 4) whose blocks of the padded ny + 1 rows are even and hold
    at least 8 rows."""
    return next(p for p in (4, 2, 1)
                if (ny + 1) % p == 0 and (ny + 1) // p % 2 == 0
                and ((ny + 1) // p >= 8 or p == 1))


def check_rows(torch, rec, key, label, st, b, u, e, steps, emit,
               guess=True, floor=0.0):
    """K17 on a level cut into row_blocks_of(ny) blocks, each with its
    halo rows cut from its neighbours: the stitched blocks against the
    plain row-block version (TOL_ARRAY of max|plain|, a residual's of
    max(max|plain|, ``floor``)); the pad row and the coarse pad row
    exactly 0."""
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk

    ny = b.shape[0]
    P = row_blocks_of(ny)
    R = (ny + 1) // P
    h = dk.halo_rows(len(steps), emit)
    hc = dk.coarse_halo_rows(h)
    bb, ub = k17_blocks(torch, b, P, h), k17_blocks(torch, u, P, h)
    eb = k17_blocks(torch, e, P, hc) if e is not None else None
    calls = [((st, None if emit == "a" else bb[p][0],
               ub[p][0] if guess else None, steps, emit),
              dict(row0=p * R, ny=ny, b_halo=bb[p][1], u_halo=ub[p][1],
                   e=None if eb is None else eb[p][0][:R // 2],
                   e_halo=None if eb is None else eb[p][1]))
             for p in range(P)]

    def stitched(fn):
        outs = [fn(*a, **kw) for a, kw in calls]
        outs = [o if isinstance(o, tuple) else (o,) for o in outs]
        return tuple(torch.cat([o[i] for o in outs])
                     for i in range(len(outs[0])))

    print(f"{label}, {P} row blocks of {R}")
    got, want = stitched(dk.row_visit), stitched(dk.row_visit_plain)
    for i, (g, w) in enumerate(zip(got, want)):
        assert bool((g[-1] == 0).all()), f"{label}: output {i} pad row"
        compare(torch, f"output {i}", g, w, rec[key],
                floor=floor if i or emit == "r" else 0.0)


def check_blocks(torch, rec, key, label, st, b, u, e, steps, emit, my, mx,
                 guess=True, floor=0.0):
    """K17's 2-D block mode on a level cut into my x mx blocks, each with
    its ring cut from its neighbours: the stitched blocks against the plain
    block version (TOL_ARRAY of max|plain|, a residual's of max(max|plain|,
    ``floor``); bf16 one bf16 ulp), the pad row and column (fine and
    coarse) exactly 0.  Skipped where the blocks cannot carry the halo."""
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk

    n = b.shape[0]
    h = dk.halo_rows(len(steps), emit)
    hc = dk.coarse_halo_rows(h)
    bb, ub = k17_2d_blocks(b, my, mx, h), k17_2d_blocks(u, my, mx, h)
    eb = k17_2d_blocks(e, my, mx, hc) if e is not None else None
    R, C = bb[0][2].shape
    if h > min(R, C):
        return
    calls = [((st, bb[p][2], ub[p][2] if guess else None, steps, emit),
              dict(row0=bb[p][0], col0=bb[p][1], ny=n, nx=n,
                   b_halo=bb[p][3], u_halo=ub[p][3],
                   e=None if eb is None else eb[p][2],
                   e_halo=None if eb is None else eb[p][3]))
             for p in range(my * mx)]

    def run(fn):
        outs = [fn(*a, **kw) for a, kw in calls]
        return stitch(torch, [o if isinstance(o, tuple) else (o,)
                              for o in outs], my, mx)

    print(f"{label}, {my}x{mx} blocks of {R} x {C}")
    got, want = run(dk.block_visit), run(dk.block_visit_plain)
    for i, (g, w) in enumerate(zip(got, want)):
        ext = (n - 1) // 2 if emit == "rc" and i == 1 else n
        assert bool((g[ext:] == 0).all()), f"{label}: output {i} pad row"
        assert bool((g[:, ext:] == 0).all()), \
            f"{label}: output {i} pad column"
        compare(torch, f"output {i}", g, w, rec[key],
                floor=floor if i or emit == "r" else 0.0)


def check_bf16_cuts(torch, dev, rec):
    """K17 in bf16 on ragged cuts, untimed: row blocks of odd width
    (1119^2 on 4 blocks, 63^2 on 4; ``check_rows``) and 2-D blocks
    (``check_blocks``: a 2x1 cut of 1119^2, an odd row stride; 1x2 cuts,
    an odd row count; 2x2 of 63^2), for every flag set of the 5-point
    visit K17 runs (zero-guess u / ur / rc; u / ur / rc from a guess;
    correct + u / ur / rc) at k = 1, 3 and on both sides of the bf16
    step's region rule (V5_PAIR_MAX_H: halos 8 and 9), where the blocks
    carry the halo.
    Each is held to the plain version within one bf16 ulp (a residual of
    max(max|plain|, max|b|): it cancels b and A u), pads exactly 0."""
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
    from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil5
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    gen = torch.Generator(device=dev).manual_seed(2468)
    key, key2 = "dist_level_visit.bf16", dk.BLOCKS + ".bf16"
    rec.setdefault(key, {})
    rec.setdefault(key2, {})

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    flagsets = (  # emit, guess, correct
        ("u", False, False), ("ur", False, False), ("rc", False, False),
        ("u", True, False), ("ur", True, False), ("rc", True, False),
        ("u", True, True), ("ur", True, True),
        ("rc", True, True))
    for n, cuts in ((1119, ("rows", (2, 1), (1, 2))),
                    (63, ("rows", (2, 2), (1, 2)))):
        h2 = float(n + 1) ** 2

        def col():
            return (h2 * (1.0 + 0.25 * rnd(n, 1))).to(torch.bfloat16)

        st = Stencil5(col(), col(), (-h2 * (5.0 + rnd(n, 1).abs())).to(
            torch.bfloat16), col(), col())
        b, u = rnd(n, n).to(torch.bfloat16), rnd(n, n).to(torch.bfloat16)
        e = rnd((n - 1) // 2, (n - 1) // 2).to(torch.bfloat16)
        floor = float(b.float().abs().max())
        for emit, g, c in flagsets:
            e0 = mdma._halo(emit, 0)
            for k in sorted({1, 3, mdma.V5_PAIR_MAX_H - e0,
                             mdma.V5_PAIR_MAX_H - e0 + 1}):
                steps = jacobi_step_coeffs(k, 0.8)
                h = dk.halo_rows(k, emit)
                label = (f"K17 bf16 5-point {'correct + ' if c else ''}"
                         f"{'' if g else 'zero-guess '}{emit} k={k} at "
                         f"{n}^2")
                for cut in cuts:
                    if cut == "rows":
                        if h <= (n + 1) // row_blocks_of(n):
                            check_rows(torch, rec, key, label, st, b, u,
                                       e if c else None, steps, emit,
                                       guess=g, floor=floor)
                    else:
                        check_blocks(torch, rec, key2, label, st, b, u,
                                     e if c else None, steps, emit, *cut,
                                     guess=g, floor=floor)
        del st, b, u, e
        torch.cuda.empty_cache()


def check_ragged_5pt(torch, dev, rec, dt, sfx=""):
    """The 5-point strip visit and K12's strip kernel against their plain
    versions on RAGGED's shapes (tiles cut by the edge, levels smaller
    than a tile), untimed.  The visit: every flag set (f32: also the CG
    set, K2a / K10) at k = 1, at its emit's bound (max_visit_steps: 43
    with emit rc in f32 and bf16, 23 in f64) and, in the f32 compute type,
    at the two halos on either side of the region rule (V5_SHORT_MAX_H), so
    every region a storage type has is launched; then K17's row blocks
    (f32, f64) in every emit at the same steps where the halo fits a
    block.  K12: apply and residual on a stencil of nine scalars (the
    compiled constant layout), the anisotropic (1,1,1,2,0.4) stencil (its
    compiled layout) and one with every coefficient kind (run-time
    strides), whole grids and (f32, f64) row blocks.  A dot is held to
    TOL_ARRAY of sum |b u|: its rounding scales with that sum, and random
    data on a small level cancel far below it.  A residual (r, rc) is held
    to TOL_ARRAY of max(max|plain|, max|b|): after tens of steps it is
    small beside b and A u, the terms it cancels, and carries their
    rounding."""
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
    from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil5, Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    gen = torch.Generator(device=dev).manual_seed(1357)
    tag = str(dt).replace("torch.", "")
    size = 8 if dt == torch.float64 else 4  # the compute type's bytes
    rows = dt in dk.ROW_DTYPES
    key, key9 = "fused_level_visit" + sfx, "apply_stencil9" + sfx
    rec.setdefault(key, {})
    rec.setdefault(key9, {})

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def ks_for(emit):
        ks = {1, mdma.max_visit_steps(None, emit, size)}
        if size == 4:
            h0 = mdma.V5_SHORT_MAX_H - mdma._halo(emit, 0)
            ks |= {h0, h0 + 1}
        return sorted(ks)

    modes = [  # label, guess, correct, emit, dot
        (f"{'correct + ' if c else ''}{'' if g else 'zero-guess '}{em}"
         f"{' + <b,u>' if d else ''}", g, c, em, d)
        for g, c in ((False, False), (True, False), (True, True))
        for em, d in (("u", False), ("ur", False), ("r", False),
                      ("rc", False), ("u", True))]
    for ny, nx in RAGGED:
        n = max(ny, nx)
        h2 = float(n + 1) ** 2

        def col():
            return h2 * (1.0 + 0.25 * rnd(ny, 1))

        st = Stencil5(col(), col(), -h2 * (5.0 + rnd(ny, 1).abs()), col(),
                      col())
        b, u = rnd(ny, nx), rnd(ny, nx)
        e = rnd((ny - 1) // 2, (nx - 1) // 2)
        where = f"{tag} at {ny} x {nx}"
        floors = dict.fromkeys(("r", "rc"), float(b.abs().max()))
        for label, g, c, emit, dot in modes:
            for k in ks_for(emit):
                steps = jacobi_step_coeffs(k, 0.8)
                u_in, e_c = (u if g else None), (e if c else None)
                check_kernel(
                    torch, rec, key, f"5-point visit {label} k={k} {where}",
                    0, 0,
                    lambda: sk.fused_level_visit(st, b, u_in, steps, emit,
                                                 e_c, dot),
                    lambda: sk.fused_level_visit_plain(st, b, u_in, steps,
                                                       emit, e_c, dot),
                    {"u": ("u'", "<b,u>"), "ur": ("u'", "r"), "r": ("r",),
                     "rc": ("u'", "rc")}[emit], timed=False,
                    dot_scale=lambda w: float(
                        (b.float() * w[0].float()).abs().sum()),
                    floors=floors)
        if dt == torch.float32:
            ap = rnd(ny, nx)
            alpha = torch.tensor(0.37, device=dev)
            for k in ks_for("rc"):
                steps = jacobi_step_coeffs(k, 0.8)
                check_kernel(
                    torch, rec, key, f"5-point visit CG rc k={k} {where}", 0,
                    0, lambda: sk.cg_visit_down(st, b, ap, alpha, steps),
                    lambda: sk.cg_visit_down_plain(st, b, ap, alpha, steps),
                    ("u0", "rc", "r'", "||r'||^2"), timed=False,
                    floors=floors)
        if rows:
            R = (ny + 1) // row_blocks_of(ny)
            for emit in ("u", "ur", "rc"):
                for g, c in ((False, False), (True, False), (True, True)):
                    for k in ks_for(emit):
                        if dk.halo_rows(k, emit) > R:
                            continue
                        check_rows(
                            torch, rec, key,
                            f"K17 5-point {'correct + ' if c else ''}"
                            f"{'' if g else 'zero-guess '}{emit} k={k} "
                            f"{where}", st, b, u, e if c else None,
                            jacobi_step_coeffs(k, 0.8), emit, guess=g,
                            floor=floors["r"])
        # K12.
        aniso = stencil9_coefficients(AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4),
                                      n, n, dt, dev)
        aniso = Stencil9(*(x[:, :nx].contiguous() if x.shape[1] > 1 else
                           x[:ny] if x.shape[0] > 1 else x for x in aniso))
        scal = Stencil9(*(h2 * rnd(1, 1) for _ in range(9)))
        allk = Stencil9(h2 * rnd(1, 1), h2 * rnd(ny, 1), h2 * rnd(1, nx),
                        h2 * rnd(ny, nx), -h2 * (12 + 4 * rnd(ny, nx).abs()),
                        h2 * rnd(1, nx), h2 * rnd(ny, 1), h2 * rnd(1, 1),
                        h2 * rnd(ny, nx))
        for name, st9 in (("scalars", scal), ("aniso", aniso),
                          ("all kinds", allk)):
            check_kernel(torch, rec, key9, f"K12 apply ({name}) {where}", 0,
                         0, lambda: k9.apply_stencil9(st9, u),
                         lambda: k9.apply_stencil9_plain(st9, u), ("Au",),
                         timed=False)
            check_kernel(torch, rec, key9, f"K12 residual ({name}) {where}",
                         0, 0, lambda: k9.residual9(st9, b, u),
                         lambda: k9.residual9_plain(st9, b, u), ("r",),
                         timed=False)
            if rows:
                for emit in ("a", "r"):
                    check_rows(torch, rec, key9,
                               f"K17 K12 {emit} ({name}) {where}", st9, b,
                               u, None, (), emit)
        del st, b, u, e, aniso, scal, allk
        torch.cuda.empty_cache()


def phase_parity(torch, runs, base=None):
    """Each cycle on the card against the same cycle on the CPU.  The
    V-cycle family and mg-FGMRES run a forced count: in f32 the true
    residual b - A u they test stalls at the roundoff floor (~7.6e-3
    relative at 1025^2 for the V-cycle, ~9e-3 for mg-FGMRES on the
    mixed-term problem; the JAX package's f32 behaviour too), so it never
    meets rtol 1e-5.  Each run is (cycle, smoother, max_iter, config
    changes, history atol)."""
    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    from multigrid_petsc_tpu_torch.ops.cuda import launches

    counts, results = [], []
    for run in runs:
        cycle, smoother, max_iter, extra, atol = run[:5]
        slack = run[5] if len(run) > 5 else 0
        cfg = SolverConfig(**{**dict(npts=1025, grids=8, levels=8,
                                     cycle=cycle, smoother=smoother,
                                     dtype="float32", rtol=1e-5,
                                     max_iter=max_iter),
                              **(base or {}), **extra})
        launches.clear()
        g = solve(cfg, device="cuda")
        counts.append(dict(launches))
        c = solve(cfg, device="cpu")
        err = float(np.abs(g.u_fine - c.u_fine).max()
                    / np.abs(c.u_fine).max())
        print(f"parity 1025^2/8 {cycle.name} {smoother.value} "
              f"{cfg.problem} {extra}: iters cuda {g.iters} cpu {c.iters}; "
              f"rnorm cuda {g.rnorm.tolist()} cpu {c.rnorm.tolist()}; "
              f"max|du|/max|u| {err:.3e}; paths {g.path}/{c.path}; max "
              f"error vs exact cuda "
              f"{error_norms(g.ctx.problem, MeshType(cfg.mesh), g.u)[0]:.3e}"
              f" cpu "
              f"{error_norms(c.ctx.problem, MeshType(cfg.mesh), c.u)[0]:.3e}")
        assert g.path == "cuda" and c.path == "torch"
        assert g.converged == c.converged
        assert cycle != CycleType.MGCG or g.converged
        assert abs(g.iters - c.iters) <= slack
        # rtol 0.05, plus an absolute floor (atol) for the entries near the
        # f32 roundoff floor of the residual: at 1023^2 the stencil's
        # 4/h^2 ~ 4e6 terms cancel to O(|b|), so each A u carries ~1e-2
        # relative f32 noise, and the card's FMA rounding differs from
        # the CPU's (measured: 1.76e-5 vs 1.58e-5 at the 4th entry of
        # mg-CG, H100).
        if atol is not None:
            np.testing.assert_allclose(g.rnorm, c.rnorm, rtol=0.05,
                                       atol=atol)
        assert err <= 1e-3
        results.append(g)
    return counts, results


def phase_main(torch):
    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import launches
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.krylov import build_coarse_tree
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    cfg = SolverConfig(npts=8193, grids=11, levels=11, cycle=CycleType.MGCG,
                       dtype="float32", rtol=1e-5, max_iter=100)
    launches.clear()
    res = solve(cfg, device="cuda", timed=True)  # the solve runs twice
    counts = dict(launches)
    precs = 2 * (res.iters + 1)
    print(f"main path 8193^2/11 levels: iters {res.iters}, converged "
          f"{res.converged}, path {res.path}, wall {res.wall_time:.6f} s")
    print(f"  residual history {res.rnorm.tolist()}")
    print(f"  launches {counts} over {precs} preconditioner applications")
    assert res.converged and res.path == "cuda"
    assert np.all(np.isfinite(res.rnorm)) and res.u.shape == (8191, 8191)
    assert bool(torch.isfinite(res.u).all())
    for k in ("cg_papply_u", "cg_visit_down", "visit_down", "visit_up",
              "coarse_tree"):
        assert counts.get(k, 0) > 0, f"kernel {k} never launched"
    assert counts["coarse_tree"] == precs == counts["cg_visit_down"]
    assert abs(res.iters - 5) <= 1, f"{res.iters} iterations, expected 5 +- 1"
    errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u)
    print("  error vs exact (max, L1, L2): "
          + " ".join(f"{e:.6e}" for e in errs))
    ms_per_iteration(res, cfg)
    tree = build_coarse_tree(res.ctx)
    print(f"  coarse tree from level {tree[0]}")
    return counts, res.u, {"iters": res.iters, "err": errs[0],
                           "tree": tree[0]}


def ms_per_iteration(res, cfg, u0=None):
    """Device ms per outer iteration by differencing forced-length runs on
    one context (bench.py's method): the difference cancels the fixed
    per-solve costs (FMG's start, the first residual)."""
    from multigrid_petsc_tpu_torch.solvers.solve import solve

    forced = dataclasses.replace(cfg, rtol=1e-30, divtol=1e30)
    est = max(res.wall_time / max(res.iters, 1), 1e-6)
    k1 = 3
    k2 = k1 + min(200, max(10, int(0.25 / est)))
    pairs = []
    for _ in range(3):
        t = [solve(forced, ctx=dataclasses.replace(
                 res.ctx, config=dataclasses.replace(forced, max_iter=k)),
                 device="cuda", u0=u0, timed=True).wall_time
             for k in (k1, k2)]
        pairs.append((t[1] - t[0]) / (k2 - k1))
    ms = 1e3 * statistics.median(pairs)
    print(f"  ms per iteration (median of 3 differenced pairs, {k1} vs {k2} "
          f"iterations): {ms:.4f}; samples "
          f"{[round(1e3 * p, 4) for p in pairs]}")


def run_full_width(torch, label, cfg, expect, near, forced, u_ref=None,
                   err_max=1e-2, ctx=None, forbid=(), u0=None):
    """One full-width solve: launch counts from 0, error norms, ms per
    iteration.  ``near``: the solution within ``err_max`` of the exact
    one; ``forced``: a forced count (max_iter +- 1), else it must
    converge.  ``ctx``: a context built for ``cfg`` already; ``forbid``:
    kernels the run must not launch; ``u0``: the warm start."""
    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import launches
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve

    launches.clear()
    res = solve(cfg, device="cuda", ctx=ctx, u0=u0)
    counts = dict(launches)
    print(f"{label} {cfg.npts}^2/{cfg.levels} levels: iters {res.iters} "
          f"(max_iter {cfg.max_iter}), converged {res.converged}, path "
          f"{res.path}, wall {res.wall_time:.6f} s")
    print(f"  residual history {res.rnorm.tolist()}")
    print(f"  launches {counts}")
    if u_ref is not None:
        du = float((res.u - u_ref).abs().max() / u_ref.abs().max())
        print(f"  max|u - u_mgcg|/max|u_mgcg| {du:.3e}")
    errs = error_norms(res.ctx.problem, MeshType(cfg.mesh), res.u)
    print("  error vs exact (max, L1, L2): "
          + " ".join(f"{e:.6e}" for e in errs))
    n = cfg.npts - 2
    assert res.path == "cuda" and res.u.shape == (n, n)
    assert np.all(np.isfinite(res.rnorm))
    assert bool(torch.isfinite(res.u).all())
    for k in expect:
        assert counts.get(k, 0) > 0, f"{label}: kernel {k} never launched"
    for k in forbid:
        assert counts.get(k, 0) == 0, f"{label}: kernel {k} launched"
    if forced:
        assert abs(res.iters - cfg.max_iter) <= 1, (
            f"{label}: {res.iters} iterations, expected {cfg.max_iter} +- 1")
    else:
        assert res.converged, f"{label}: not converged"
    if near:
        assert errs[0] <= err_max, f"{label}: max error {errs[0]:.3e}"
    else:  # slow cycles: the residual must still have fallen
        assert res.rnorm[-1] < 1, f"{label}: no descent"
    ms_per_iteration(res, cfg, u0)
    return counts, res


def phase_vcycle(torch, u_ref):
    """The V-cycle family at full width.  Expected iterations are the JAX
    package's own for these f32 configs (backend="xla" on the CPU): at
    1025^2, 2049^2 and 4097^2 every one of them stalls at the f32 floor of
    its true residual (7.6e-3, 3.0e-2, 1.2e-1 relative for the V-cycle,
    growing 4x per doubling) and runs to max_iter, as FMG did at 8193^2 on
    the TPU (0.986 after 8 cycles, benchmarks/results/baseline_r02.json).
    So the count is max_iter here, and correctness is read from the
    solution of every cycle that converges in the forced count: within
    1e-2 of the exact solution in the max norm.  That is the f32
    attainable accuracy at this size with room (the converged mg-CG
    solution of phase 4 is 4.7e-3 from it, H100); an unconverged solve is
    off by O(1).  Additive and the 3-level cycle (slow by design) must
    lower their residual.  Phase 3 holds every one of them against the
    CPU at 1025^2."""
    from multigrid_petsc_tpu_torch.utils.config import (
        CycleType,
        SmootherType,
        SolverConfig,
    )

    visits = {"fused_level_visit", "visit_down", "visit_up", "residual5"}
    runs = (  # label, config changes, expected kernels, near u_ref
        ("V-cycle", {}, visits, True),
        ("FMG", {"cycle": CycleType.FMG}, visits, True),
        ("V-cycle Chebyshev", {"smoother": SmootherType.CHEBYSHEV},
         visits | {"apply_stencil5"}, True),
        ("MG-Richardson", {"cycle": CycleType.PCMG, "max_iter": 5},
         {"visit_down", "visit_up", "residual5"}, True),
        ("Additive", {"cycle": CycleType.ADDITIVE, "max_iter": 5},
         {"smooth_sweeps", "residual5"}, False),
        ("V-cycle, 3 levels, smoothed 2047^2 coarsest",
         {"grids": 3, "levels": 3, "coarse_solver": "smooth",
          "max_iter": 5},
         visits | {"smooth_sweeps"}, False),
    )
    total = {}
    for label, changes, expect, near in runs:
        cfg = dataclasses.replace(
            SolverConfig(npts=8193, grids=11, levels=11,
                         cycle=CycleType.VCYCLE, dtype="float32", rtol=1e-5,
                         max_iter=10), **changes)
        counts, _ = run_full_width(torch, label, cfg, expect, near, True,
                                   u_ref)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    for k in ("apply_stencil5", "smooth_sweeps", "fused_level_visit",
              "residual5"):
        assert total.get(k, 0) > 0, f"kernel {k} never launched in phase 5"
    return total


def phase_aniso(torch):
    """The 9-point family at full width (8193^2 / 11 levels, f32, rtol
    1e-5): (a) mg-CG Jacobi and (b) mg-CG y-line (BASELINE config 4's
    problem) to convergence; (c) mg-FGMRES for a forced count of restart
    blocks (its stop test reads the true residual, whose f32 floor at
    this size is O(1e-1), as the V-cycle's in phase 5); each with the
    solution within 1e-2 of the exact one; (d) a 3-level V-cycle that
    smooths its 2047^2 coarsest level through K13, for a forced count.
    The solutions are held within 5e-2 of the exact one: the f32
    attainable accuracy of this operator falls fast with the grid
    (measured max error of the f32 mg-CG Jacobi solve: 1.2e-5 on the card
    and 3.8e-5 on the CPU at 1025^2 in phase 3b, 2.5e-2 at 8193^2 on an
    H100; the f64 solve's discretization error is below 1e-6); an
    unconverged solve is O(1) off."""
    from multigrid_petsc_tpu_torch.utils.config import (
        CycleType,
        SmootherType,
        SolverConfig,
    )

    mixed, strong_y = (1.0, 1.0, 1.0, 2.0, 0.4), (1.0, 0.0, 100.0, 0.0, 0.0)
    base = dict(npts=8193, grids=11, levels=11, problem="aniso",
                dtype="float32", rtol=1e-5, max_iter=100)
    runs = (  # label, config changes, expected kernels, near, forced
        ("(a) aniso mg-CG Jacobi", dict(cycle=CycleType.MGCG, aniso=mixed),
         {"apply_stencil9", "residual9", "fused_level_visit9"}, True, False),
        ("(b) aniso mg-CG y-line", dict(cycle=CycleType.MGCG,
                                        aniso=strong_y,
                                        smoother=SmootherType.LINE_Y),
         {"apply_stencil9", "residual9", "line_visit9"}, True, False),
        ("(c) aniso mg-FGMRES", dict(cycle=CycleType.MGFGMRES, aniso=mixed,
                                     max_iter=3),
         {"apply_stencil9", "fused_level_visit9"}, True, True),
        ("(d) aniso V-cycle, 3 levels, smoothed 2047^2 coarsest",
         dict(cycle=CycleType.VCYCLE, aniso=mixed, grids=3, levels=3,
              coarse_solver="smooth", max_iter=5),
         {"smooth9_sweeps", "fused_level_visit9", "residual9"}, False, True),
    )
    total = {}
    for label, changes, expect, near, forced in runs:
        cfg = SolverConfig(**{**base, **changes})
        counts, _ = run_full_width(torch, label, cfg, expect, near, forced,
                                   err_max=5e-2)
        for k, v in counts.items():
            total[k] = total.get(k, 0) + v
    for k in ("apply_stencil9", "residual9", "smooth9_sweeps",
              "fused_level_visit9", "line_visit9"):
        assert total.get(k, 0) > 0, f"kernel {k} never launched in phase 6"
    return total


def csr_on_card(torch, csr, dev):
    """The matrix of a host CSR triple as a torch sparse CSR tensor (f32,
    int32 indices) on the card: torch.mv / torch.addmv on it run cuSPARSE,
    the library yardstick of K8 and K16."""
    import numpy as np

    indptr, indices, data = csr
    n = len(indptr) - 1
    return torch.sparse_csr_tensor(
        torch.as_tensor(indptr.astype(np.int32), device=dev),
        torch.as_tensor(indices, device=dev),
        torch.as_tensor(data, dtype=torch.float32, device=dev), size=(n, n),
        check_invariants=False)


def phase_kernels_sparse(torch, dev, rec):
    """K8 and K16 at the shapes of the sparse paths against their plain
    versions, with times and cuSPARSE's on the same matrix."""
    from multigrid_petsc_tpu_torch.ops import sparse as sp
    from multigrid_petsc_tpu_torch.ops.cuda import spmv_dia_kernel as dk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil5

    gen = torch.Generator(device=dev).manual_seed(2468)
    f32 = torch.float32

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    for key in ("apply_stencil5_field", "residual5_field", "dia_spmv"):
        rec[key] = {}
    n = 8191
    arr, pts = n * n * 4, n * n
    t0 = time.perf_counter()
    csr = sp.assemble_level_csr(8193, 0, (0,))
    t1 = time.perf_counter()
    op = sp.SparseLevelOp(*csr, [(n, n)], device=dev, dtype=f32)
    torch.cuda.synchronize()
    print(f"K8 set-up at {n}^2: CSR assembly {t1 - t0:.2f} s ({len(csr[1])} "
          f"entries), conversion to the stencil form on the card "
          f"{time.perf_counter() - t1:.2f} s")
    assert op.form == "stencil"
    A = csr_on_card(torch, csr, dev)
    del csr
    st = op.stencil
    u, b = rnd(n, n), rnd(n, n)
    uf, bf = u.reshape(-1), b.reshape(-1)

    def check(key, label, *args, **kw):
        check_kernel(torch, rec, key, f"{label} at {n}^2", *args,
                     library_name="cuSPARSE (torch CSR)", **kw)

    check("apply_stencil5_field", "K8 apply_stencil5_field (assembled "
          "Poisson level 0)", 7 * arr, 9 * pts,
          lambda: sk.apply_stencil5_field(st, u),
          lambda: sk.apply_stencil5_field_plain(st, u), ("Au",),
          library=lambda: torch.mv(A, uf).reshape(n, n))
    check("residual5_field", "K8 residual5_field (assembled Poisson level "
          "0)", 8 * arr, 10 * pts,
          lambda: sk.residual5_field(st, b, u),
          lambda: sk.residual5_field_plain(st, b, u), ("r",),
          library=lambda: torch.addmv(bf, A, uf, alpha=-1.0).reshape(n, n))
    del A, op, st
    h2 = float(n + 1) ** 2
    rst = Stencil5(h2 * rnd(n, n), h2 * rnd(n, n),
                   -h2 * (4 + rnd(n, n).abs()), h2 * rnd(n, n),
                   h2 * rnd(n, n))
    check("apply_stencil5_field", "K8 apply_stencil5_field (random "
          "fields)", 7 * arr, 9 * pts,
          lambda: sk.apply_stencil5_field(rst, u),
          lambda: sk.apply_stencil5_field_plain(rst, u), ("Au",),
          timed=False)
    check("residual5_field", "K8 residual5_field (random fields)", 8 * arr,
          10 * pts, lambda: sk.residual5_field(rst, b, u),
          lambda: sk.residual5_field_plain(rst, b, u), ("r",), timed=False)
    del rst, u, b, uf, bf
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    csr = sp.assemble_level_csr(8193, 0, (0, 1), include_couplings=False)
    t1 = time.perf_counter()
    op = sp.SparseLevelOp(*csr, [(n, n), (4095, 4095)], device=dev,
                          dtype=f32)
    torch.cuda.synchronize()
    print(f"K16 set-up, 2-grid A1 at 8193^2: CSR assembly {t1 - t0:.2f} s "
          f"({len(csr[1])} entries), conversion to DIA on the card "
          f"{time.perf_counter() - t1:.2f} s")
    offs, vals = op.dia
    assert op.form == "dia" and len(offs) == 7, (op.form, op.dia)
    A = csr_on_card(torch, csr, dev)
    del csr
    N = op.rows
    x = rnd(N)
    check_kernel(torch, rec, "dia_spmv", f"K16 dia_spmv (2-grid A1, offsets "
                 f"{offs}) at N = {N}", (len(offs) + 2) * N * 4,
                 2 * len(offs) * N, lambda: dk.dia_spmv(offs, vals, x),
                 lambda: dk.dia_spmv_plain(offs, vals, x), ("Ax",),
                 library=lambda: torch.mv(A, x),
                 library_name="cuSPARSE (torch CSR)")
    del A, op, vals, x
    torch.cuda.empty_cache()
    N = n * n
    offs = (-3 * n - 5, -2 * n, -n - 1, -n, -n + 1, -2, -1, 0, 1, 2, n - 1,
            n, n + 1, 2 * n, 3 * n + 5, 4 * n + 7)
    vals, x = rnd(len(offs), N), rnd(N)
    check_kernel(torch, rec, "dia_spmv", f"K16 dia_spmv (random, 16 "
                 f"diagonals to +-4 nx) at N = {N}", (len(offs) + 2) * N * 4,
                 2 * len(offs) * N, lambda: dk.dia_spmv(offs, vals, x),
                 lambda: dk.dia_spmv_plain(offs, vals, x), ("Ax",),
                 timed=False)
    del vals, x
    torch.cuda.empty_cache()


def phase_parity_zoo(torch):
    """Phase 3c: the sparse backend and the cycle zoo, card against CPU at
    1025^2.  Single-grid sparse runs must launch K8 and none of the
    matrix-free kernels."""
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SmootherType

    jac = SmootherType.JACOBI
    one = {"grids": 2, "levels": 1}
    runs = [(CycleType.MGCG, jac, 100, {"backend": "sparse"}, 5e-6),
            (CycleType.VCYCLE, jac, 6, {"backend": "sparse"}, 5e-6)]
    for cycle in (CycleType.ICYCLE, CycleType.ECYCLE, CycleType.D1CYCLE,
                  CycleType.D2CYCLE, CycleType.D1PSCYCLE):
        for backend in ("auto", "sparse"):
            runs.append((cycle, jac, 20, {**one, "backend": backend}, 5e-6))
    runs += [(CycleType.ADDITIVE2, jac, 6, {"grids": 2, "levels": 2}, 5e-6),
             (CycleType.VCYCLE, jac, 6, {"grids": 4, "levels": 2}, 5e-6)]
    counts, _ = phase_parity(torch, runs)
    for run, c in zip(runs[:2], counts):
        assert c.get("apply_stencil5_field", 0) > 0, (run, c)
        assert not set(c) & MATRIX_FREE, (run, c)
    return counts


# The matrix-free 5-point kernels (K1-K4, K6, K7, K9): a single-grid sparse
# run launches none of them.
MATRIX_FREE = {"cg_papply_u", "cg_visit_down", "visit_down", "visit_up",
               "coarse_tree", "apply_stencil5", "smooth_sweeps",
               "fused_level_visit", "residual5"}


def phase_zoo(torch):
    """Phase 7: the sparse backend and the cycle zoo at full width, f32,
    v = (3, 3).  Each run prints its set-up seconds (assembly and
    conversion included) and peak device memory; run_full_width its
    launch counts and ms per iteration."""
    from multigrid_petsc_tpu_torch.solvers.context import build_context
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    k8 = {"apply_stencil5_field", "residual5_field"}

    def run(label, cfg, expect, near, forced, forbid=(), ctx=None):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        if ctx is None:
            ctx = build_context(cfg, device="cuda")
            torch.cuda.synchronize()
        print(f"{label}: set-up {time.perf_counter() - t0:.2f} s")
        counts, res = run_full_width(torch, label, cfg, expect, near, forced,
                                     ctx=ctx, forbid=forbid)
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f}"
              f" GiB; sparse forms "
              + " ".join("/".join(f"{n}:{op.form}" for n, op in (
                  ("A", lc.sparse_full), ("A1", lc.sparse_diag),
                  ("A2", lc.sparse_coup)) if op is not None)
                  for lc in res.ctx.levels))
        return counts, res

    base = dict(npts=8193, dtype="float32", rtol=1e-5, backend="sparse")
    cfg = SolverConfig(**base, grids=11, levels=11, cycle=CycleType.MGCG,
                       max_iter=100)
    counts, res = run("(a) sparse mg-CG", cfg, k8, True, False,
                      forbid=MATRIX_FREE)
    # K8 on every level but the directly solved coarsest: per
    # preconditioner application 2 v applies and 1 residual on each of
    # levels 0..L-2, plus A p per iteration and the first residual.
    L, v, its = len(res.ctx.levels), cfg.v[0], res.iters
    assert all(lc.sparse_full.form == "stencil" for lc in res.ctx.levels)
    assert counts["apply_stencil5_field"] == its + (its + 1) * (L - 1) * 2 * v
    assert counts["residual5_field"] == 1 + (its + 1) * (L - 1)
    k8_launches = dict(counts)
    # (b) on (a)'s context: the same levels and operators (only the
    # merged-grid cycles and a Krylov cycle's own precision build others).
    cfg = SolverConfig(**base, grids=11, levels=11, cycle=CycleType.VCYCLE,
                       max_iter=5)
    run("(b) sparse V-cycle", cfg, k8, True, True, forbid=MATRIX_FREE,
        ctx=dataclasses.replace(res.ctx, config=cfg))
    del res
    # (c) the delayed cycles share one context: they read A1 only.
    ctx = None
    k16_launches = {}
    for cycle in (CycleType.D1CYCLE, CycleType.D2CYCLE, CycleType.D1PSCYCLE):
        cfg = SolverConfig(**base, grids=2, levels=1, cycle=cycle,
                           max_iter=10)
        if ctx is None:
            t0 = time.perf_counter()
            ctx = build_context(cfg, device="cuda")
            torch.cuda.synchronize()
            print(f"(c) delayed cycles, 8193^2 grids 2: set-up "
                  f"{time.perf_counter() - t0:.2f} s (A1 only)")
        counts, _ = run(f"(c) sparse {cycle.name}", cfg, {"dia_spmv"}, False,
                        True, forbid=MATRIX_FREE,
                        ctx=dataclasses.replace(ctx, config=cfg))
        if not k16_launches:
            k16_launches = counts
    del ctx
    half = dict(base, npts=4097)
    cfg = SolverConfig(**half, grids=2, levels=1, cycle=CycleType.ECYCLE,
                       max_iter=10)
    run("(d) sparse E-cycle", cfg, {"dia_spmv"}, False, True,
        forbid=MATRIX_FREE)
    cfg = SolverConfig(**half, grids=2, levels=1, cycle=CycleType.ICYCLE,
                       max_iter=10)
    run("(d) sparse I-cycle", cfg, {"apply_stencil5", "smooth_sweeps"},
        False, True)
    mf = dict(base, backend="auto")
    for cycle in (CycleType.D1CYCLE, CycleType.ECYCLE):
        cfg = SolverConfig(**mf, grids=2, levels=1, cycle=cycle, max_iter=10)
        run(f"(e) matrix-free {cycle.name}", cfg, {"apply_stencil5"}, False,
            True)
    return k8_launches, k16_launches



def phase_kernels_precision(torch, dev, rec):
    """Phase 2d: K10 and K11 (f32), then the f64 and bf16 instantiations at
    8191^2 against their plain versions.  Bytes are counted at each
    storage type's element size (8 for f64, 2 for bf16); operations as for
    f32 (bf16 computes in f32; f64 has no tensor-core path here)."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
        stencil_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    gen = torch.Generator(device=dev).manual_seed(5678)
    n = 8191
    pts = n * n
    jac = jacobi_step_coeffs(3, 0.8)
    k = len(jac)

    def rnd(*shape, dt=torch.float32):
        return torch.randn(shape, generator=gen, device=dev).to(dt)

    def check(key, label, arrays, isz, flops, *args, **kw):
        rec.setdefault(key, {})
        check_kernel(torch, rec, key, f"{label} at {n}^2", arrays * pts * isz,
                     flops, *args, **kw)

    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, dev)
    z, p = rnd(n, n), rnd(n, n)
    beta = torch.tensor(0.43, device=dev)
    alpha = torch.tensor(0.37, device=dev)
    check("cg_papply", "K11 cg_papply", 4, 4, 13 * pts,
          lambda: sk.cg_papply(st, z, p, beta),
          lambda: sk.cg_papply_plain(st, z, p, beta),
          ("p'", "Ap'", "<p',Ap'>"))
    check("fused_cg_visit_down", "K10 cg_visit_down", 4.25, 4,
          (15 * k + 16) * pts,
          lambda: sk.cg_visit_down(st, z, p, alpha, jac),
          lambda: sk.cg_visit_down_plain(st, z, p, alpha, jac),
          ("u0", "rc", "r'", "||r'||^2"))
    del z, p, st
    for dt, tag in ((torch.float64, "f64"), (torch.bfloat16, "bf16")):
        isz = 8 if dt == torch.float64 else 2
        sfx = "." + tag
        st = stencil_coefficients(MeshType.UNIFORM, n, n, dt, dev)
        b, u = rnd(n, n, dt=dt), rnd(n, n, dt=dt)
        e = rnd((n - 1) // 2, (n - 1) // 2, dt=dt)
        c = [float(x[0, 0]) for x in st]  # cs, cw, cc, ce, cn
        w5 = torch.tensor([[0.0, c[0], 0.0], [c[1], c[2], c[3]],
                           [0.0, c[4], 0.0]], device=dev, dtype=dt)
        check("apply_stencil5" + sfx, f"K6 apply_stencil5 {tag}", 2, isz,
              9 * pts, lambda: sk.apply_stencil5(st, u),
              lambda: sk.apply_stencil5_plain(st, u), ("Au",),
              library=conv_call(torch, w5, u))
        check("residual5" + sfx, f"K9 r (residual5) {tag}", 3, isz, 10 * pts,
              lambda: sk.residual5(st, b, u),
              lambda: sk.residual5_plain(st, b, u), ("r",),
              library=conv_call(torch, w5, u, b))
        check("smooth_sweeps" + sfx, f"K7 smooth_sweeps Jacobi k=3 {tag}", 3,
              isz, 45 * pts, lambda: sk.smooth_sweeps(st, b, u, jac),
              lambda: sk.smooth_sweeps_plain(st, b, u, jac), ("u'",))
        check("visit_down" + sfx, f"K9 zero-guess rc (K2b) {tag}", 2.25, isz,
              (15 * k + 12) * pts,
              lambda: sk.fused_level_visit(st, b, None, jac, "rc"),
              lambda: sk.fused_level_visit_plain(st, b, None, jac, "rc"),
              ("u'", "rc"))
        check("visit_up" + sfx, f"K9 correct + u + <b,u> (K3) {tag}", 3.25,
              isz, (15 * k + 4) * pts,
              lambda: sk.fused_level_visit(st, b, u, jac, "u", e, True),
              lambda: sk.fused_level_visit_plain(st, b, u, jac, "u", e,
                                                 True), ("u'", "<b,u>"))
        check("fused_level_visit" + sfx, f"K9 nonzero-guess rc {tag}", 3.25,
              isz, (15 * k + 12) * pts,
              lambda: sk.fused_level_visit(st, b, u, jac, "rc"),
              lambda: sk.fused_level_visit_plain(st, b, u, jac, "rc"),
              ("u'", "rc"))
        del st, e
        # K12 on the solver's layout of the constant stencil (cc a field),
        # then on its nine scalars.
        const = stencil9_coefficients(AnisoProblem(1.0, 0.0, 100.0, 0.0, 0.3),
                                      n, n, dt, dev)
        scal = Stencil9(*(x.reshape(-1)[:1].reshape(1, 1) for x in const))
        q = [float(x.reshape(-1)[0]) for x in scal]
        w9 = torch.tensor([q[0:3], q[3:6], q[6:9]], device=dev, dtype=dt)
        check("apply_stencil9" + sfx, f"K12 apply_stencil9 {tag}", 3, isz,
              17 * pts, lambda: k9.apply_stencil9(const, u),
              lambda: k9.apply_stencil9_plain(const, u), ("Au",),
              library=conv_call(torch, w9, u))
        check("residual9" + sfx, f"K12 residual9 {tag}", 4, isz, 18 * pts,
              lambda: k9.residual9(const, b, u),
              lambda: k9.residual9_plain(const, b, u), ("r",),
              library=conv_call(torch, w9, u, b))
        check("apply_stencil9" + sfx, f"K12 apply_stencil9 (nine scalars) "
              f"{tag}", 2, isz, 17 * pts, lambda: k9.apply_stencil9(scal, u),
              lambda: k9.apply_stencil9_plain(scal, u), ("Au",), timed=False)
        check("residual9" + sfx, f"K12 residual9 (nine scalars) {tag}", 3,
              isz, 18 * pts, lambda: k9.residual9(scal, b, u),
              lambda: k9.residual9_plain(scal, b, u), ("r",), timed=False)
        time_scalar_layout(torch, rec["apply_stencil9" + sfx],
                           f"K12 apply_stencil9 {tag}", 2 * isz * pts,
                           lambda: k9.apply_stencil9(scal, u))
        time_scalar_layout(torch, rec["residual9" + sfx],
                           f"K12 residual9 {tag}", 3 * isz * pts,
                           lambda: k9.residual9(scal, b, u))
        del const, scal
        mixed = stencil9_coefficients(AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4),
                                      n, n, dt, dev)
        check("smooth9_sweeps" + sfx, f"K13 smooth9_sweeps Jacobi k=3 {tag}",
              4, isz, 69 * pts, lambda: k9.smooth9_sweeps(mixed, b, u, jac),
              lambda: k9.smooth9_sweeps_plain(mixed, b, u, jac), ("u'",))
        check("fused_level_visit9" + sfx, f"K14 zero-guess rc {tag}", 3.25,
              isz, (69 + 20) * pts,
              lambda: k9.fused_level_visit9(mixed, b, None, jac, "rc"),
              lambda: k9.fused_level_visit9_plain(mixed, b, None, jac, "rc"),
              ("u'", "rc"))
        del mixed
        if dt == torch.float64:
            line = lk.collapse_stencil(stencil9_coefficients(
                AnisoProblem(1.0, 0.0, 100.0, 0.0, 0.0), n, n, dt, dev))
            fac = lk.line_factor(line, n)
            check("line_visit9" + sfx, "K15 line_visit9 zero-guess rc k=3 "
                  "f64", 2.25, isz, 3 * 20 * pts,
                  lambda: lk.line_visit9(line, b, None, 3, 0.8, "rc",
                                         fac=fac),
                  lambda: lk.line_visit9_plain(line, b, None, 3, 0.8, "rc"),
                  ("u'", "rc"))
            del line, fac
        del b, u
        torch.cuda.empty_cache()
        check_ragged_9pt(torch, dev, rec, dt, sfx)
        check_ragged_5pt(torch, dev, rec, dt, sfx)
    # K17 in bf16 (the bf16 preconditioner's sharded levels), as 9 (a)
    # holds it in f32.
    phase_k17(torch, dev, rec, ("bf16",))


def phase_parity_precision(torch):
    """Phase 3d: the precision paths, card against CPU at 1025^2 / 8
    levels, held to phase 3's tolerances.  The bf16-preconditioned runs
    are held as the JAX package's own bf16 test holds them (converged,
    the solution; no history entry by entry): the card's FMA rounding
    flips some bf16 roundings of the preconditioner's stores (one ulp
    each; phase 2d), and the flexible PCG carries that into its history
    (measured on an H100 for f32 mg-CG at rtol 1e-5: 28.0 vs 23.5 at the
    third entry, 10 vs 9 iterations), so they get one iteration of
    slack."""
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SmootherType

    jac, line = SmootherType.JACOBI, SmootherType.LINE_Y
    cg, fg = CycleType.MGCG, CycleType.MGFGMRES
    strong_y = (1.0, 0.0, 100.0, 0.0, 0.0)
    f64 = {"dtype": "float64", "rtol": 1e-7}
    mixed = {"outer_dtype": "float64", "rtol": 1e-8}
    bf = {"precond_dtype": "bfloat16"}
    # cycle, smoother, max_iter, extra, history atol (None: not compared),
    # iteration slack
    runs = (
        (cg, jac, 100, {"v": (8, 8)}, 5e-6, 0),
        (cg, jac, 100, f64, 5e-6, 0),
        (cg, jac, 100, mixed, 5e-6, 0),
        (cg, jac, 100, {**mixed, "outer_dtype": "float32x2"}, 5e-6, 0),
        (cg, jac, 100, bf, None, 1),
        (fg, jac, 4, bf, None, 0),
        (cg, jac, 100, {**mixed, **bf}, None, 1),
        (cg, line, 100, {**mixed, "problem": "aniso", "aniso": strong_y},
         2e-2, 0),
        (cg, line, 100, {**f64, "problem": "aniso", "aniso": strong_y}, 5e-6,
         0),
        (cg, jac, 100, {**f64, "problem": "aniso",
                        "aniso": (1.0, 1.0, 1.0, 2.0, 0.4)}, 5e-6, 0),
    )
    counts, results = phase_parity(torch, runs)
    fused, f64_run, mixed_run = counts[0], counts[1], counts[2]
    assert results[0].route == "fused"
    for k in ("cg_papply", "fused_cg_visit_down", "visit_down", "visit_up"):
        assert fused.get(k, 0) > 0, (k, fused)
    for k in ("cg_papply_u", "cg_visit_down", "coarse_tree"):
        assert fused.get(k, 0) == 0, (k, fused)
    assert results[1].route == "generic"
    assert all(k.endswith(".f64") for k in f64_run), f64_run
    assert mixed_run.get("apply_stencil5.f64", 0) > 0, mixed_run
    for r in results[2:4] + results[6:8]:
        assert r.outer_dtype == "float64" and r.converged
    for c in counts[4:7]:
        assert c.get("visit_down.bf16", 0) > 0 and c.get("visit_up.bf16", 0) \
            > 0, c
    total = {}
    for c in counts:
        for k, v in c.items():
            total[k] = total.get(k, 0) + v
    return total


def phase_precision(torch):
    """Phase 8: the precision paths at full width (8193^2 / 11 levels).
    The mixed runs certify against the true f64 residual of the returned
    solution (b and A in f64 on the card, K6 f64)."""
    from multigrid_petsc_tpu_torch.solvers import krylov as kr
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    base = dict(npts=8193, grids=11, levels=11, cycle=CycleType.MGCG,
                max_iter=100)
    mixed = dict(base, dtype="float32", outer_dtype="float64", rtol=1e-8)
    f32 = {"cg_papply_u", "cg_visit_down", "coarse_tree"}  # the mdma route
    counts = {}

    def run(label, cfg, expect, forbid=(), u0=None, cert=False,
            forced=False, err_max=1e-2):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        c, res = run_full_width(torch, label, cfg, expect, not forced,
                                forced, err_max=err_max, forbid=forbid,
                                u0=u0)
        true = kr.true_relative_residual(res.ctx, res.u)
        print(f"  true f64 relative residual {true:.6e}; route {res.route}, "
              f"outer dtype {res.outer_dtype}; {time.perf_counter() - t0:.2f}"
              f" s with set-up; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        if cert:
            assert true <= 1e-8, f"{label}: true residual {true:.3e}"
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        return c, res

    run("(a) mixed certification (f32 V-cycle + f64 outer)",
        SolverConfig(**mixed),
        {"apply_stencil5.f64", "visit_down", "visit_up"}, f32, cert=True)
    t0 = time.perf_counter()
    fmg = solve(SolverConfig(**dict(base, cycle=CycleType.FMG,
                                    dtype="float32", rtol=1e-12,
                                    max_iter=8)), device="cuda")
    torch.cuda.synchronize()
    print(f"(b) FMG start (FMG + 8 V-cycles, f32): "
          f"{time.perf_counter() - t0:.2f} s, true f64 relative residual "
          f"{kr.true_relative_residual(fmg.ctx, fmg.u):.6e}")
    _, rb = run("(b) mixed certification warm-started from FMG",
                SolverConfig(**mixed),
                {"apply_stencil5.f64", "visit_down", "visit_up"}, f32,
                u0=fmg.u, cert=True)
    del fmg, rb
    c, res = run("(c) f32 mg-CG, bf16 preconditioner (BASELINE config 6)",
                 SolverConfig(**dict(base, dtype="float32", rtol=1e-5,
                                     precond_dtype="bfloat16")),
                 {"visit_down.bf16", "visit_up.bf16", "apply_stencil5",
                  "residual5"}, f32)
    assert res.route == "generic"
    del res
    c, res = run("(d) mg-CG in f64 (the reference precision)",
                 SolverConfig(**dict(base, dtype="float64", rtol=1e-7)),
                 {"apply_stencil5.f64", "residual5.f64", "visit_down.f64",
                  "visit_up.f64"})
    assert res.route == "generic"
    assert all(k.endswith(".f64") for k in c), c
    del res
    # An f32 solve's error at this size is its roundoff (the f64 solves'
    # is 1.2e-8): 4.7e-3 for phase 4's mg-CG, 1.07e-2 for this one (its 4
    # iterations of 8 sweeps stop at rtol 1e-5 a step earlier; H100); an
    # unconverged solve is O(1) off.  Held to 5e-2, as phase 6's f32
    # solves.
    c, res = run("(e) fused route, -v 8,8, f32",
                 SolverConfig(**dict(base, dtype="float32", rtol=1e-5,
                                     v=(8, 8))),
                 {"cg_papply", "fused_cg_visit_down", "visit_down",
                  "visit_up"}, f32, err_max=5e-2)
    assert res.route == "fused"
    assert c["cg_papply"] == c["fused_cg_visit_down"] == res.iters, c
    del res
    run("(f) f64 V-cycle, 3 levels, smoothed 2047^2 coarsest",
        SolverConfig(npts=8193, grids=3, levels=3, cycle=CycleType.VCYCLE,
                     dtype="float64", coarse_solver="smooth", max_iter=5,
                     rtol=1e-30),
        {"smooth_sweeps.f64", "fused_level_visit.f64", "residual5.f64"},
        forced=True)
    return counts


# ---------------------------------------------------------------------------
# Phase 9: row-partition distribution and K17.
# ---------------------------------------------------------------------------

P9_BLOCKS = 4  # (a): row blocks of the 8191^2 level, in one process
P9_RANKS = 2   # (b), (c): ranks sharing the one card, over gloo
P9_TIMEOUT = 900  # seconds for a world of ranks
P9_N, P9_SMALL = 8193, 1025  # (b)'s and (c)'s npts; (a) is (b)'s level 0


def k17_blocks(torch, x, P, h):
    """x with its pad row appended, cut into P row blocks, each with the
    h rows above and below it cut from its neighbours (zeros at the
    edges): [(block, Halo)]."""
    from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo

    xp = torch.cat([x, x.new_zeros((1, x.shape[1]))])
    R = xp.shape[0] // P
    z = x.new_zeros((h, x.shape[1]))
    ext = torch.cat([z, xp, z])
    return [(xp[p * R:(p + 1) * R],
             Halo(ext[p * R:p * R + h].contiguous(),
                  ext[h + (p + 1) * R:2 * h + (p + 1) * R].contiguous()))
            for p in range(P)]


def split_times(torch, dk, tag, a, kw, t, split, prepared, whole_ms):
    """Block 1's split visit as device time (``device_ms``): the interior
    launch alone, the two edge launches, all three, beside the
    whole-block launch's ``whole_ms``; and the host time per visit
    (``host_ms``) of the split visit (its launch arguments kept, as a
    level's operators keep them), of one launch on the whole block kept
    alike, and of ``row_visit`` (its arguments made anew each call)."""
    R = (a[1] if a[1] is not None else a[2]).shape[0]
    outs = dk.row_outputs(a[1] if a[1] is not None else a[2], a[4])
    rem = dict(b=kw["b_halo"], u=kw["u_halo"], e=kw["e_halo"])
    piece = dict(row0=kw["row0"], ny=kw["ny"], out=outs, e=kw["e"],
                 coeff_row0=kw["coeff_row0"], prepared=prepared)

    def run(lo, hi):
        dk.row_visit_piece(*a, lo=lo, hi=hi, halos=rem, **piece)

    inner = device_ms(torch, lambda: run(t, R - t))
    edges = device_ms(torch, lambda: (run(0, t), run(R - t, R)))
    total = device_ms(torch, split)
    whole = {}

    def one():
        return dk.row_visit_split(*a, row0=kw["row0"], ny=kw["ny"], t=None,
                                  halos=lambda: rem, e=kw["e"],
                                  coeff_row0=kw["coeff_row0"],
                                  prepared=whole)

    h_split = host_ms(torch, split)
    h_one = host_ms(torch, one)
    h_row = host_ms(torch, lambda: dk.row_visit(*a, **kw))
    print(f"  {tag}: split device time {total:.4f} ms per block (interior "
          f"[{t}, {R - t}) {inner:.4f}, edges {edges:.4f}; whole-block "
          f"launch {whole_ms:.4f}); host time per visit: split (3 launches,"
          f" arguments kept) {h_split:.4f} ms, one launch (kept) "
          f"{h_one:.4f} ms, row_visit (arguments made each call) "
          f"{h_row:.4f} ms")
    return {"t": t, "device_ms": total, "interior_ms": inner,
            "edges_ms": edges, "host_ms": h_split, "host_ms_one_launch":
            h_one, "host_ms_row_visit": h_row}


def phase_k17(torch, dev, rec, dtypes=("f32", "f64")):
    """9 (a): K17 at full width in one process.  The 8191^2 level, padded
    to 8192 rows, cut into 4 row blocks of 2048 rows on the card, each
    block's halo rows cut from its neighbours; every emit of the 5-point
    visit (Jacobi k = 3) and of the aniso (1,1,1,2,0.4) 9-point visit in
    f32 and (phase 2d, ``dtypes=("bf16",)``) bf16, the zero-guess rc visit
    in f64.  The stitched blocks are held to
    the whole-grid kernel of the same flags (K9 / K12 / K14) and to the
    plain row-block version (TOL_ARRAY of max|plain|); the pad row and the
    coarse pad row must be exactly 0.  Times: one block (block 1), all 4
    blocks, the whole-grid kernel; the bound counts one block's bytes:
    its rows and halo rows of each input read once, each output once.  The
    per-call time brackets the wrapper's host work too, so the 5-point
    "a", "r" (f32) and the zero-guess "rc" and "correct + u" blocks (f32,
    bf16: the bf16 preconditioner's visits) are also timed as device time
    (``device_ms``: 20 launches queued behind a sleep; each storage type's
    ``modes_5pt``), "a" and "r" beside conv2d on the block and its halo
    rows (the library call).  The bf16 pass then checks the ragged bf16
    cuts (``check_bf16_cuts``)."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
        stencil_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    n, P = P9_N - 2, P9_BLOCKS
    R = (n + 1) // P
    nxc = (n - 1) // 2
    jac = jacobi_step_coeffs(3, 0.8)
    gen = torch.Generator(device=dev).manual_seed(4321)
    modes = (  # label, guess, steps, emit, correct
        ("zero-guess rc", False, jac, "rc", False),
        ("u", True, jac, "u", False),
        ("correct + u", True, jac, "u", True),
        ("correct + ur", True, jac, "ur", True),
        ("a", True, (), "a", False),
        ("r", True, (), "r", False),
    )
    summary = []
    types = {"f32": (torch.float32, ""), "f64": (torch.float64, ".f64"),
             "bf16": (torch.bfloat16, ".bf16")}
    for dt, sfx in (types[t] for t in dtypes):
        key = "dist_level_visit" + sfx
        rec.setdefault(key, {})
        isz = dt.itemsize
        b = torch.randn((n, n), generator=gen, device=dev).to(dt)
        u = torch.randn((n, n), generator=gen, device=dev).to(dt)
        e = torch.randn((nxc, nxc), generator=gen, device=dev).to(dt)
        stencils = [("5-point", stencil_coefficients(MeshType.UNIFORM, n, n,
                                                     dt, dev))]
        if dt != torch.float64:
            stencils.append(("9-point (1,1,1,2,0.4)", stencil9_coefficients(
                AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), n, n, dt, dev)))
        modes_rec = {}
        for sname, st in stencils:
            nine = isinstance(st, Stencil9)
            whole = k9 if nine else sk
            for label, guess, steps, emit, correct in modes:
                if dt == torch.float64 and label != "zero-guess rc":
                    continue
                if nine and label == "correct + u":
                    continue
                k = len(steps)
                h = dk.halo_rows(k, emit)
                hc = dk.coarse_halo_rows(h)
                bb = k17_blocks(torch, b, P, h)
                ub = k17_blocks(torch, u, P, h)
                eb = k17_blocks(torch, e, P, hc)
                m = k + 2  # the coefficient rows a block keeps, as in a solve

                def args(p):
                    lo = max(0, p * R - m)
                    stp = (Stencil9(*(c if c.shape[0] == 1 else
                                      c[lo:min(n, (p + 1) * R + m)]
                                      .contiguous() for c in st))
                           if nine else st)
                    return (stp, None if emit == "a" else bb[p][0],
                            ub[p][0] if guess else None, steps, emit), dict(
                        row0=p * R, ny=n, b_halo=bb[p][1], u_halo=ub[p][1],
                        e=eb[p][0][:R // 2] if correct else None,
                        e_halo=eb[p][1] if correct else None,
                        coeff_row0=lo if nine else 0)

                calls = [args(p) for p in range(P)]

                def stitched(fn):
                    outs = [fn(*a, **kw) for a, kw in calls]
                    outs = [o if isinstance(o, tuple) else (o,) for o in outs]
                    return tuple(torch.cat([o[i] for o in outs])
                                 for i in range(len(outs[0])))

                def whole_fn():
                    if emit == "a":
                        return ((k9.apply_stencil9 if nine else
                                 sk.apply_stencil5)(st, u),)
                    if emit == "r":
                        return ((k9.residual9 if nine else sk.residual5)(
                            st, b, u),)
                    out = (whole.fused_level_visit9 if nine else
                           whole.fused_level_visit)(
                        st, b, u if guess else None, steps, emit,
                        e if correct else None)
                    return out if isinstance(out, tuple) else (out,)

                tag = f"K17 {sname} {label}" + (
                    f" k={k}" if k else "") + f" {dt}".replace("torch.", " ")
                print(f"{tag}, {P} blocks of {R} rows at {n}^2")
                got = stitched(dk.row_visit)
                want = stitched(dk.row_visit_plain)
                ref = whole_fn()
                names = {"rc": ("u'", "rc"), "ur": ("u'", "r")}.get(
                    emit, (emit,))
                for nm, g, w, wh in zip(names, got, want, ref):
                    assert bool((g[-1] == 0).all()), f"{tag}: {nm} pad row"
                    assert bool((w[-1] == 0).all()), f"{tag}: plain pad row"
                    compare(torch, f"{nm} vs plain row blocks", g, w,
                            rec[key])
                    compare(torch, f"{nm} vs whole-grid kernel",
                            g[:wh.shape[0]], wh, {})
                del want, ref
                t, split1, prepared1 = split_check(torch, dk, tag, calls, got,
                                                   isz, rec[key])
                del got
                a1, kw1 = calls[1]
                ms1 = time_ms(torch, lambda: dk.row_visit(*a1, **kw1))
                ms4 = time_ms(torch, lambda: [dk.row_visit(*a, **kw)
                                              for a, kw in calls])
                msw = time_ms(torch, whole_fn)
                pms = time_ms(torch, lambda: dk.row_visit_plain(*a1, **kw1))
                # Read once: u (a, r, a guess) and b (the visits) on the
                # block's rows and halo rows, b on its own rows (r), e and
                # its coarse halo, the 9-point (ny, nx) cc on the rows
                # read; written once: the outputs.
                ext = (R + 2 * h) * n
                if emit in ("a", "r"):
                    ins = ext + (R * n if emit == "r" else 0)
                else:
                    ins = ext * (1 + int(guess)) + (
                        (R // 2 + 2 * hc) * nxc if correct else 0)
                outs = R * n * (2 if emit == "ur" else 1) + (
                    (R // 2) * nxc if emit == "rc" else 0)
                nbytes = isz * (ins + outs + (ext if nine else 0))
                per_pt = (23 * k + 20) if nine else (15 * k + 12)
                flops = per_pt * R * n
                print(f"  {tag}: kernel {ms1:.4f} ms per block "
                      f"({nbytes / ms1 / 1e6:.1f} GB/s effective), {ms4:.4f} "
                      f"ms for {P} blocks, whole-grid kernel {msw:.4f} ms; "
                      f"plain {pms:.4f} ms per block; bound "
                      f"{1e3 * nbytes / HBM_PEAK:.4f} ms per block")
                keep_time(rec[key], ms1, pms, nbytes, flops)
                summary.append((tag, ms1, ms4, msw, pms, nbytes))
                # Device time: the 5-point a, r (f32) and the two visits
                # of the bf16 preconditioner's split levels (zero-guess rc
                # down, correct + u up; f32 and bf16).
                if not nine and dt != torch.float64 and (
                        label in ("zero-guess rc", "correct + u")
                        or dt == torch.float32 and emit in ("a", "r")):
                    dms = device_ms(torch, lambda: dk.row_visit(*a1, **kw1))
                    lms = ldms = None
                    if emit in ("a", "r"):  # conv2d over the block + halo
                        c = [float(x[0, 0]) for x in st]
                        w5 = torch.tensor([[0.0, c[0], 0.0],
                                           [c[1], c[2], c[3]],
                                           [0.0, c[4], 0.0]], device=dev)
                        hal = kw1["u_halo"]
                        ue = torch.cat([hal.top, a1[2], hal.bot])
                        be = (torch.cat([torch.zeros_like(hal.top), a1[1],
                                         torch.zeros_like(hal.bot)])
                              if emit == "r" else None)
                        conv = conv_call(torch, w5, ue, be)
                        lms = time_ms(torch, conv)
                        ldms = library_device_ms(torch, conv, lms)
                        del ue, be, conv
                    bound = 1e3 * nbytes / HBM_PEAK
                    modes_rec[label if label == "correct + u" else emit] = {
                        "ms_per_call": ms1, "device_ms": dms,
                        "bound_ms": bound, "library_ms": lms,
                        "library_device_ms": ldms,
                        "split": split_times(torch, dk, tag, a1, kw1, t,
                                             split1, prepared1, dms)}
                    print(f"  {tag}: device time {dms:.4f} ms per block "
                          f"({100 * bound / dms:.1f}% of its bound "
                          f"{bound:.4f} ms), per call {ms1:.4f} ms"
                          + (f"; conv2d on the block and its halo rows "
                             f"{lms:.4f} ms a call, device {ldms:.4f} ms"
                             if lms is not None else ""))
                del bb, ub, eb, calls
            del st
        del b, u, e
        torch.cuda.empty_cache()
        if modes_rec:
            rec[key]["modes_5pt"] = modes_rec
    if "bf16" in dtypes:
        check_bf16_cuts(torch, dev, rec)
    return summary


def rank_worker(argv) -> int:
    """One rank of phase 9's and 11-16's worlds (``chip_smoke.py
    --rank RANK WORLD PORT DEVICE LABEL OUTDIR JOBS``): joins the gloo
    group, solves each job under ``row_plan(min_local=...)`` (the job's,
    default 32; with "layout": "blocks" ``blocks_plan``, over the job's
    "mesh" where it names one) on DEVICE and
    writes its results to OUTDIR/<job>.<LABEL>.<RANK>.json (rank 0 also
    the gathered solution of a job with "save_u"): its iterations,
    history, launches (per kernel and per K17 emit), the all-gathers the
    solve made (by what they gather, with their bytes), the axes the plan
    splits each level along and each grid of it (``grid_axes``), error
    norms, wall seconds, the blocks plan's extents of level 0 and, with
    "cert",
    the true f64 residual.  A job with "checkpoint": k first solves k
    iterations, saves a checkpoint under the plan, loads it and resumes
    from it (``utils.checkpoint``; the counters read the resumed solve)."""
    import dataclasses as dc
    from datetime import timedelta
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel, launches
    from multigrid_petsc_tpu_torch.parallel import blocks_plan, halo, row_plan
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers import krylov as kr
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils import checkpoint

    rank, world, port = (int(a) for a in argv[:3])
    device, label, out = argv[3], argv[4], Path(argv[5])
    jobs = json.loads(argv[6])
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=P9_TIMEOUT))
    print(f"[rank {rank} {label}] joined {time.perf_counter() - T_START:.1f}"
          f" s after its start", flush=True)
    try:
        for job in jobs:
            t_job = time.perf_counter()
            kw = dict(min_local=job.get("min_local", 32), device=device)
            if job.get("layout") == "blocks":
                plan = blocks_plan(shape=tuple(job["mesh"]) if "mesh" in job
                                   else None, **kw)
            else:
                plan = row_plan(**kw)
            cuda = plan.device.type == "cuda"
            cfg = config_of(job["cfg"])
            u0, ck = None, None
            if job.get("checkpoint"):
                part = solve(dc.replace(cfg, max_iter=job["checkpoint"]),
                             plan=plan)
                path = out / f"{job['name']}.{label}.ck.npz"
                checkpoint.save(path, cfg, part.u_local, part.rnorm,
                                part.iters, plan=plan)
                dist.barrier()
                u0, _, its = checkpoint.load(path, cfg, plan=plan)
                ck = dict(iters=its, bytes=path.stat().st_size,
                          block=list(u0[0].shape))
                del part
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            launches.clear()
            dist_kernel.emits.clear()
            dist_kernel.row_visits.clear()
            halo.gathers.clear()
            halo.gathered_bytes.clear()
            res = solve(cfg, plan=plan, u0=u0)
            counts = dict(launches)
            emits = dict(dist_kernel.emits)
            row_visits = dict(dist_kernel.row_visits)
            gathers = dict(halo.gathers)
            gathered = dict(halo.gathered_bytes)
            true = (kr.true_relative_residual(res.ctx, res.u)
                    if job.get("cert") else None)
            u = res.u_fine  # gathered from both ranks
            errs = error_norms(res.ctx.problem, MeshType(cfg.mesh),
                               torch.as_tensor(u))
            ms = None
            if job.get("forced"):
                k1, k2 = job["forced"]
                forced = dc.replace(cfg, rtol=1e-30, divtol=1e30)
                t = [solve(forced, ctx=dc.replace(
                    res.ctx, config=dc.replace(forced, max_iter=kk)),
                    timed=True).wall_time for kk in (k1, k2)]
                ms = 1e3 * (t[1] - t[0]) / (k2 - k1)
            rep = dict(iters=res.iters, converged=res.converged,
                       path=res.path, route=res.route,
                       rnorm=res.rnorm.tolist(), counts=counts,
                       emits=emits, row_visits=row_visits,
                       gathers=gathers, gathered=gathered,
                       true=true,
                       dist=[lv.sharded for lv in res.ctx.levels],
                       split=[list(lv.split) for lv in res.ctx.levels],
                       axes=[list(plan.split(*lv.shape))
                             for lv in res.ctx.levels],
                       grid_axes=[grid_axes(lv) for lv in res.ctx.levels],
                       errs=list(errs), wall=res.wall_time, ms=ms,
                       transport=plan.transport, checkpoint=ck,
                       blocks0=(plan.extents(*res.ctx.levels[0].shape)
                                if plan.layout == "blocks" else None),
                       peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                                 if cuda else None))
            (out / f"{job['name']}.{label}.{rank}.json").write_text(
                json.dumps(rep))
            if rank == 0 and job.get("save_u"):
                np.save(out / f"{job['name']}.npy", u)
            print(f"[rank {rank} {label}] {job['name']}: iters "
                  f"{res.iters}, converged {res.converged}, "
                  f"{time.perf_counter() - t_job:.1f} s (the solve "
                  f"{res.wall_time:.2f})", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def grid_axes(lv) -> list:
    """The axes (y, x) each grid of level ``lv``'s operators is split
    along ([False, False] for a grid held whole; a row block's (True,
    False))."""
    ops = getattr(lv.grid_ops, "ops", (lv.dist,) * len(lv.spec.grids))
    return [[False, False] if d is None
            else list(getattr(d, "split", (True, False))) for d in ops]


def config_of(fields):
    """A SolverConfig from a job's JSON fields (cycle as its id,
    smoothers as their values, tuples as lists)."""
    from multigrid_petsc_tpu_torch.utils.config import (
        CycleType,
        SmootherType,
        SolverConfig,
    )

    f = dict(fields, cycle=CycleType(fields["cycle"]))
    for k in ("smoother", "fine_smoother"):
        if k in f:
            f[k] = SmootherType(f[k])
    for k in ("aniso", "v"):
        if k in f:
            f[k] = tuple(f[k])
    return SolverConfig(**f)


def start_world(jobs, device, label, out, ranks=P9_RANKS):
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(ranks),
         str(port), device, label, str(out), json.dumps(jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(ranks)]


def run_worlds(worlds, out):
    """Start each (jobs, device, label[, ranks]) world side by side, wait
    for all; a failed world leaves no rank of any running."""
    t0 = time.perf_counter()
    procs = [(start_world(*w[:3], out, *w[3:]), w[2]) for w in worlds]
    try:
        for ps, lab in procs:
            finish_world(ps, f"{lab} world")
        print(f"  worlds {', '.join(lab for _, lab in procs)}: "
              f"{time.perf_counter() - t0:.1f} s")
    finally:
        for ps, _ in procs:
            for p in ps:
                if p.poll() is None:
                    p.kill()
                    p.wait()


def world_results(out, name, label, ranks=P9_RANKS):
    return [json.loads((out / f"{name}.{label}.{r}.json").read_text())
            for r in range(ranks)]


def finish_world(procs, label):
    """Wait for every rank; print their output; any non-zero exit, or a
    world past P9_TIMEOUT (then every rank is killed), fails."""
    try:
        outs = [p.communicate(timeout=P9_TIMEOUT)[0] for p in procs]
    except subprocess.TimeoutExpired:
        for p in procs:
            p.kill()
        raise AssertionError(f"{label}: a rank did not finish")
    for r, (p, o) in enumerate(zip(procs, outs)):
        print("\n".join(f"  [{label} rank {r}] {ln}"
                        for ln in o.strip().splitlines()[-12:]))
        assert p.returncode == 0, f"{label}: rank {r} exited {p.returncode}"


def phase_dist(torch, main_ref):
    """9 (b): the distributed main path at full width, 2 ranks on the one
    card over gloo with halos staged through the host: Poisson mg-CG at
    8193^2 / 11 levels (phase 4's config) under row_plan(min_local=32),
    then the aniso (1,1,1,2,0.4) mg-CG Jacobi; (c) card against CPU at
    1025^2 / 8 levels, the same 2-rank mg-CG in f32 and in f64 on the
    card and over gloo on the CPU (the two worlds run side by side).
    Returns K17's launches: f32 from (b)'s Poisson run on rank 0, f64
    from (c)'s card run."""
    import tempfile
    from pathlib import Path

    import numpy as np

    L = P9_N.bit_length() - 3  # 11 levels at 8193^2: a 7^2 coarsest
    big = dict(npts=P9_N, grids=L, levels=L, cycle=101, dtype="float32",
               rtol=1e-5, max_iter=100)
    Ls = P9_SMALL.bit_length() - 3
    small = dict(npts=P9_SMALL, grids=Ls, levels=Ls, cycle=101,
                 max_iter=100)
    parity = [{"name": "p1025", "cfg": dict(small, dtype="float32",
                                            rtol=1e-5)},
              {"name": "p1025_f64", "cfg": dict(small, dtype="float64")}]
    card_jobs = [{"name": "poisson", "cfg": big, "forced": [3, 8],
                  "save_u": True},
                 {"name": "aniso", "cfg": dict(big, problem="aniso",
                                               aniso=[1.0, 1.0, 1.0, 2.0,
                                                      0.4])},
                 *parity]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        run_worlds([(card_jobs, "cuda", "card"), (parity, "cpu", "cpu")],
                   out)

        def ranks(name, label):
            return world_results(out, name, label)

        res = ranks("poisson", "card")
        r0 = res[0]
        print(f"9 (b) Poisson mg-CG {P9_N}^2/{L} levels, {P9_RANKS} ranks "
              f"sharing one card (transport {r0['transport']}): iters "
              f"{r0['iters']} (phase 4: {main_ref['iters']}), converged "
              f"{r0['converged']}, path {r0['path']}, route {r0['route']}")
        print(f"  residual history {r0['rnorm']}")
        print(f"  sharded levels {r0['dist']}")
        for r, x in enumerate(res):
            print(f"  rank {r}: launches {x['counts']}, peak device memory "
                  f"{x['peak_gib']:.2f} GiB")
            print(f"  rank {r}: K17 launches per emit {x['emits']} (total "
                  f"{x['counts'].get('dist_level_visit', 0)})")
            assert (sum(x["emits"].values())
                    == x["counts"].get("dist_level_visit", 0))
            print(f"  rank {r}: K17 visits by level, split or whole "
                  f"{x['row_visits']}")
            # Levels 8191, 4095 and 2047 (t = 128, 256, 256: 32, 8 and 4
            # tiles of their 4096-, 2048- and 1024-row blocks) run every
            # visit split; 1023 (2 tiles) and below whole.
            for ny in (8191, 4095, 2047):
                assert x["row_visits"].get(f"{ny} split", 0) > 0, ny
                assert f"{ny} whole" not in x["row_visits"], ny
            assert not any(int(k.split()[0]) < 2047 and k.endswith("split")
                           for k in x["row_visits"]), x["row_visits"]
            splits = sum(v for k, v in x["row_visits"].items()
                         if k.endswith("split"))
            wholes = sum(v for k, v in x["row_visits"].items()
                         if k.endswith("whole"))
            assert 3 * splits + wholes == x["counts"]["dist_level_visit"]
        u = np.load(out / "poisson.npy")
        du = float(np.abs(u - main_ref["u"]).max()
                   / np.abs(main_ref["u"]).max())
        print(f"  error vs exact (max, L1, L2): "
              + " ".join(f"{x:.6e}" for x in r0["errs"])
              + f"; phase 4: {main_ref['err']:.6e}; max|u - u_phase4| / "
              f"max|u_phase4| {du:.3e}")
        print(f"  ms per iteration, {P9_RANKS} ranks sharing one card "
              f"(differenced 3 vs 8 iterations; not a speed figure): "
              f"{r0['ms']:.4f}")
        assert r0["converged"] and r0["path"] == "cuda"
        assert r0["route"] == "generic"
        assert r0["transport"] == "gloo-host"
        assert abs(r0["iters"] - main_ref["iters"]) <= 1
        # 8191 ... 63 sharded (63: 32 rows per rank), 31 and below not.
        assert r0["dist"] == [True] * (L - 3) + [False] * 3, r0["dist"]
        for x in res:
            assert x["iters"] == r0["iters"] and x["rnorm"] == r0["rnorm"]
            assert x["counts"].get("dist_level_visit", 0) > 0
            for k in ("cg_papply_u", "cg_visit_down"):
                assert x["counts"].get(k, 0) == 0, f"{k} launched"
        assert du <= 1e-3, du
        assert r0["errs"][0] <= 1.1 * main_ref["err"], r0["errs"]

        an = ranks("aniso", "card")
        print(f"9 (b) aniso (1,1,1,2,0.4) mg-CG Jacobi {P9_N}^2/{L} levels, "
              f"{P9_RANKS} ranks: iters {an[0]['iters']}, converged "
              f"{an[0]['converged']}, max error {an[0]['errs'][0]:.6e}; "
              f"launches {an[0]['counts']}; sharded levels "
              f"{an[0]['dist']}")
        assert all(x["converged"] for x in an)
        assert an[0]["errs"][0] <= 5e-2
        assert all(x["counts"].get("dist_level_visit", 0) > 0 for x in an)

        f64_launches = 0
        for name in ("p1025", "p1025_f64"):
            g, c = ranks(name, "card")[0], ranks(name, "cpu")[0]
            print(f"9 (c) {name} {P9_SMALL}^2/{Ls} levels, {P9_RANKS} ranks: "
                  f"iters "
                  f"card {g['iters']} cpu {c['iters']}; rnorm card "
                  f"{g['rnorm']} cpu {c['rnorm']}; paths {g['path']}/"
                  f"{c['path']}; launches {g['counts']}")
            assert g["converged"] and c["converged"]
            assert g["path"] == "cuda" and c["path"] == "torch"
            assert g["iters"] == c["iters"]
            np.testing.assert_allclose(g["rnorm"], c["rnorm"], rtol=0.05,
                                       atol=5e-6)
            if name == "p1025_f64":
                f64_launches = g["counts"].get("dist_level_visit.f64", 0)
                assert f64_launches > 0
                assert all(k.endswith(".f64") for k in g["counts"])
    return {"dist_level_visit": r0["counts"]["dist_level_visit"],
            "dist_level_visit.f64": f64_launches}


MAIN_ARGS = ["-npts", "8193", "-grids", "11", "-levels", "11", "-cycle",
             "101", "-dtype", "float32", "-rtol", "1e-5", "-iter", "100"]


def phase_cli(torch):
    """10 (a): the CLI (``poisson.main``) at full width, phase 4's mg-CG
    with -view 1, in a temporary directory: the banner, the solver dump
    (11 level lines, the card's kernels), the five artifact files;
    eData.dat is the solve's error norms, uData.dat 8191 lines of 8191
    fields, three of them the solution's rows at %.16e.  The solve and the
    write are observed through the module's own names (a wrapper records
    the result and the write's seconds)."""
    import contextlib
    import io
    import os
    import tempfile
    from pathlib import Path

    from multigrid_petsc_tpu_torch import poisson
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.postprocess import error_norms, format_rows

    seen = {}
    real_solve, real_write = poisson.solve, poisson.write_artifacts

    def solve_seen(*a, **kw):
        seen["res"] = real_solve(*a, **kw)
        return seen["res"]

    def write_seen(*a, **kw):
        t0 = time.perf_counter()
        real_write(*a, **kw)
        seen["write_s"] = time.perf_counter() - t0

    cwd = os.getcwd()
    poisson.solve, poisson.write_artifacts = solve_seen, write_seen
    try:
        with tempfile.TemporaryDirectory() as tmp:
            os.chdir(tmp)
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                rc = poisson.main(MAIN_ARGS + ["-view", "1"])
            out = buf.getvalue().splitlines()
            print("\n".join("  | " + ln for ln in out))
            res = seen["res"]
            n = res.u.shape[0]
            assert rc == 0 and res.converged and res.path == "cuda"
            assert "Mesh size:                 8193 x 8193" in out
            assert "Cycle:                     MGCG" in out
            assert ("Devices:                   1 x cuda ("
                    + torch.cuda.get_device_name(0) + ")") in out
            assert out.count("=" * 65) == 2
            dump = out[out.index("=" * 65, out.index("=" * 65) + 1) + 1:]
            assert dump[0].startswith("solver: cycle=MGCG") and dump[0]\
                .endswith("path=mdma"), dump[0]
            assert len(dump) == 12 and all(
                ln.startswith(f"level {l}: ") and " op=cuda" in ln
                for l, ln in enumerate(dump[1:])), dump
            names = sorted(q.name for q in Path(tmp).iterdir())
            assert names == sorted(["XgridData.dat", "YgridData.dat",
                                    "eData.dat", "rData.dat", "uData.dat"])
            nbytes = sum((Path(tmp) / q).stat().st_size for q in names)
            errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u)
            got = [float(x) for x in Path("eData.dat").read_text().split()]
            assert got == list(errs), (got, errs)
            t0 = time.perf_counter()
            rows = {0: None, n // 2: None, n - 1: None}
            lines = 0
            with open("uData.dat", "rb") as f:
                for i, line in enumerate(f):
                    assert line.count(b"    ") == n and line.endswith(
                        b"    \n"), i
                    if i in rows:
                        rows[i] = line
                    lines += 1
            assert lines == n
            for i, line in rows.items():
                assert line == format_rows(res.u[i:i + 1].cpu().numpy()), i
            check_s = time.perf_counter() - t0
            os.chdir(cwd)  # before the directory goes
    finally:
        os.chdir(cwd)
        poisson.solve, poisson.write_artifacts = real_solve, real_write
    print(f"10 (a) CLI 8193^2/11 levels -view 1: iters {res.iters}, error "
          f"{errs[0]:.6e}; artifact files {nbytes} B written in "
          f"{seen['write_s']:.2f} s ({nbytes / seen['write_s'] / 1e6:.1f} "
          f"MB/s, {os.cpu_count()} CPU cores), uData.dat checked in "
          f"{check_s:.2f} s")


# 10 (b) / (c): label, config changes, kernels the run must launch,
# kernels it must not (K1-K4 and the fused visits: none may run on an
# RBGS or line level), error bound (None: the forced count is not held
# to a bound), forced; the (c) history floor at 1025^2.
K1_K4 = {"cg_papply_u", "cg_visit_down", "visit_down", "visit_up",
         "coarse_tree"}
FUSED_VISITS = {"smooth_sweeps", "fused_level_visit", "smooth9_sweeps",
                "fused_level_visit9"}
X_STRONG = (100.0, 0.0, 1.0, 0.0, 0.0)


def smoother_runs():
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SmootherType

    return (
        ("RBGS V-cycle", dict(cycle=CycleType.VCYCLE,
                              smoother=SmootherType.RBGS, max_iter=5),
         {"residual5"}, K1_K4 | FUSED_VISITS, 1e-2, True, 5e-3),
        ("mg-CG -coarse_smoother rbgs",
         dict(cycle=CycleType.MGCG, coarse_smoother=SmootherType.RBGS),
         K1_K4 - {"coarse_tree"}, {"coarse_tree"}, 1e-2, False, 5e-6),
        ("LINE_X mg-CG aniso (100,0,1,0,0)",
         dict(cycle=CycleType.MGCG, smoother=SmootherType.LINE_X,
              problem="aniso", aniso=X_STRONG),
         {"line_visit9", "apply_stencil9", "residual9"},
         K1_K4 | FUSED_VISITS, 5e-2, False, 2e-2),
        ("LINE_XY V-cycle aniso (100,0,1,0,0)",
         dict(cycle=CycleType.VCYCLE, smoother=SmootherType.LINE_XY,
              problem="aniso", aniso=X_STRONG, max_iter=5),
         {"line_visit9", "residual9"}, K1_K4 | FUSED_VISITS, 5e-2, True,
         2e-2),
    )


def phase_smoothers(torch, main_ref):
    """10 (b): RBGS, LINE_X and LINE_XY at 8193^2 / 11 levels, f32: their
    launches (the residual and line kernels; none of K1-K4 or the fused
    visits on their levels), the coarse-tree split of -coarse_smoother
    rbgs against phase 4's, errors and ms per iteration."""
    from multigrid_petsc_tpu_torch.solvers.krylov import build_coarse_tree
    from multigrid_petsc_tpu_torch.utils.config import SolverConfig

    base = dict(npts=8193, grids=11, levels=11, dtype="float32", rtol=1e-5,
                max_iter=100)
    counts = {}
    for label, changes, expect, forbid, err, forced, _ in smoother_runs():
        cfg = SolverConfig(**{**base, **changes})
        c, res = run_full_width(torch, f"10 (b) {label}", cfg, expect, True,
                                forced, err_max=err, forbid=forbid)
        if "coarse_smoother" in changes:
            tree = build_coarse_tree(res.ctx)
            print(f"  coarse tree: {'none' if tree is None else tree[0]} "
                  f"(JAX's rule: none while the coarsest level is RBGS; "
                  f"phase 4: from level {main_ref['tree']}), route "
                  f"{res.route}")
            assert tree is None and res.route == "mdma"
        for k, v in c.items():
            counts[k] = counts.get(k, 0) + v
        del res
        torch.cuda.empty_cache()
    return counts


def phase_parity_smoothers(torch):
    """10 (c): each solve of (b) on the card against the CPU at 1025^2 /
    8 levels, the same iterations, history to rtol 0.05 above the floor
    given per run (phase 3's 5e-6; at the f32 floor of the true residual
    the V-cycles' 5e-3; the card's Thomas line solve against the CPU's
    PCR, 2e-2, as phase 3b's y-line run)."""
    from multigrid_petsc_tpu_torch.utils.config import SmootherType

    runs = []
    for _, changes, _, _, _, _, atol in smoother_runs():
        extra = {k: v for k, v in changes.items()
                 if k not in ("cycle", "smoother", "max_iter")}
        runs.append((changes["cycle"],
                     changes.get("smoother", SmootherType.JACOBI),
                     changes.get("max_iter", 100), extra, atol))
    phase_parity(torch, runs)


def phase_profile(torch):
    """10 (d): ``solve(profile_phases=True)`` on phase 4's config: the
    level-0 building blocks' times (CUDA events, median of 5)."""
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    cfg = SolverConfig(npts=8193, grids=11, levels=11, cycle=CycleType.MGCG,
                       dtype="float32", rtol=1e-5, max_iter=100)
    res = solve(cfg, device="cuda", profile_phases=True)
    ph = res.phases
    print("10 (d) phase breakdown 8193^2 level 0 (ms): " + ", ".join(
        f"{k} {1e3 * ph[k]:.4f}" for k in ("smooth_v", "residual",
                                           "restrict", "prolong", "norm"))
          + f"; solve {ph['solve']:.6f} s")
    assert set(ph) == {"solve", "smooth_v", "residual", "restrict",
                       "prolong", "norm"}
    assert all(v > 0 for v in ph.values())


def phase_checkpoint(torch, main_ref):
    """10 (e): phase 4's mg-CG stopped after 2 iterations, checkpointed,
    loaded and resumed (``solve(u0=)``) to rtol 1e-5: it converges, with
    its error within 1.1x of phase 4's."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils import checkpoint
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    cfg = SolverConfig(npts=8193, grids=11, levels=11, cycle=CycleType.MGCG,
                       dtype="float32", rtol=1e-5, max_iter=100)
    part = solve(dataclasses.replace(cfg, max_iter=2), device="cuda")
    assert part.iters == 2 and not part.converged
    with tempfile.TemporaryDirectory() as tmp:
        path = Path(tmp) / "ck.npz"
        t0 = time.perf_counter()
        checkpoint.save(path, cfg, part.u_grids, part.rnorm, part.iters)
        save_s, size = time.perf_counter() - t0, path.stat().st_size
        t0 = time.perf_counter()
        u0, rnorm, iters = checkpoint.load(path, cfg)
        load_s = time.perf_counter() - t0
    assert iters == 2 and np.array_equal(rnorm, part.rnorm)
    res = solve(cfg, device="cuda", u0=u0)
    errs = error_norms(res.ctx.problem, MeshType.UNIFORM, res.u)
    print(f"10 (e) checkpoint after {iters} iterations: {size} B, save "
          f"{save_s:.2f} s, load {load_s:.2f} s; resumed: iters {res.iters}"
          f", converged {res.converged}, route {res.route}, error "
          f"{errs[0]:.6e} (phase 4: {main_ref['err']:.6e})")
    assert res.converged and res.path == "cuda"
    assert errs[0] <= 1.1 * main_ref["err"], errs


def run_phase10(torch, main_ref):
    """Phase 10: the CLI's outputs and the smoothers RBGS, LINE_X and
    LINE_XY."""
    torch.cuda.empty_cache()
    timed_phase(torch, "10 (a)", phase_cli)
    timed_phase(torch, "10 (b)", phase_smoothers, main_ref)
    timed_phase(torch, "10 (c)", phase_parity_smoothers)
    timed_phase(torch, "10 (d)", phase_profile)
    timed_phase(torch, "10 (e)", phase_checkpoint, main_ref)


# ---------------------------------------------------------------------------
# Phase 11: distribution, every single-grid cycle.
# ---------------------------------------------------------------------------

# (a): the rank-spanning K15 on (n, row blocks, timed): 2048-row blocks of
# the 8191^2 level (32-row segments), 256-row blocks, and blocks of 16
# and 8 rows (16- and 8-row segments).
P11_LINE_SHAPES = ((8191, 4, True), (1023, 4, False), (63, 4, False),
                   (31, 4, False), (15, 2, False))
P11_OMEGA = 0.8


def line_launch_ms(torch, lk, lf, b, u, halo, every) -> dict:
    """Device ms (``device_ms``) of one split y-line sweep of a block
    (``lf``, b, u, its halo or ring), each of its launches alone -- 1
    (``line_rows_begin``: the block's segment ends), 2 (``line_rows_carry``:
    the carry pass over every segment of the gathered ends ``every``), 3
    (``line_rows_fix``: the block's segments fixed up) -- and the whole
    sweep (both halves); the wrapper's allocations and copies count with
    their launch."""
    carries = lk.line_rows_carry(lf, every)

    def whole():
        lk.line_rows_begin(lf, b, u, halo)
        return lk.line_rows_end(lf, b, u, halo, every, P11_OMEGA)

    out = {f"launch {i}": device_ms(torch, fn) for i, fn in enumerate((
        lambda: lk.line_rows_begin(lf, b, u, halo),
        lambda: lk.line_rows_carry(lf, every),
        lambda: lk.line_rows_fix(lf, b, u, halo, carries, P11_OMEGA)), 1)}
    out["sweep"] = device_ms(torch, whole)
    out["segments"] = every.shape[0] // 2
    return out


def line_row_sweep(torch, lk, st, b, u, P):
    """One rank-spanning y-line sweep (K15) of the (ny, nx) level (b, u),
    its pad row appended, cut into P row blocks in one process as P ranks
    run it: ``line_rows_begin`` on every block, the outputs stacked as
    the all-gather's caller stacks them (``stack_lines``),
    ``line_rows_end`` on every block; the
    stitched (ny + 1, nx) result.  Returns (sweep, the blocks' RowLines,
    the blocks' (b, u, halo))."""
    from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo

    ny, nx = b.shape
    R = (ny + 1) // P
    bp = torch.cat([b, b.new_zeros((1, nx))])
    up = torch.cat([u, u.new_zeros((1, nx))])
    zero = u.new_zeros((1, nx))
    lfs = [lk.row_line(st, ny, R, p * R) for p in range(P)]
    blocks = [(bp[p * R:(p + 1) * R], up[p * R:(p + 1) * R],
               Halo(up[p * R - 1:p * R] if p else zero,
                    up[(p + 1) * R:(p + 1) * R + 1] if p < P - 1 else zero))
              for p in range(P)]

    def sweep():
        every = lk.stack_lines(lfs[0], [lk.line_rows_begin(lf, *blk)
                                         for lf, blk in zip(lfs, blocks)])
        return torch.cat([lk.line_rows_end(lf, *blk, every, P11_OMEGA)
                          for lf, blk in zip(lfs, blocks)])

    return sweep, lfs, blocks


def phase_line_rows(torch, dev, rec):
    """11 (a): K15's rank-spanning mode (a row-sharded level's y-lines,
    which cross the ranks), its blocks run in one process as the ranks run
    them, the all-gather of the segment carries a concatenation: one
    sweep of the stitched blocks against one sweep of the whole-grid plain
    version (``line_visit9_plain``: PCR over the whole columns) and of the
    one-card K15, TOL_LINE of max|plain|, on aniso (1,0,100,0,0) (the
    packed per-row table) and (1,1,1,2,0.4) (an x-varying centre: factor
    fields) in f32 and f64, on P11_LINE_SHAPES; the pad row exactly 0.
    Timed at 8191^2 in f32 on the strong-y stencil: the 4 blocks' sweep
    (both halves, the carry pass on every block as every rank runs it)
    per call and as device time against the whole-grid plain sweep, and
    block 1's launches alone (``line_launch_ms``); the bound counts a
    sweep's three arrays (b and u read, u written).  Then the carry scan
    on segment counts that do not fill its warps
    (``check_line_odd_segments``)."""
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )

    gen = torch.Generator(device=dev).manual_seed(2468)
    for dt, sfx in ((torch.float32, ""), (torch.float64, ".f64")):
        key = "line_visit9_rows" + sfx
        rec.setdefault(key, {})
        for n, P, timed in P11_LINE_SHAPES:
            for pname, prob in (("(1,0,100,0,0)", (1.0, 0.0, 100.0, 0.0,
                                                   0.0)),
                                ("(1,1,1,2,0.4)", (1.0, 1.0, 1.0, 2.0,
                                                   0.4))):
                if n > 1023 and (dt == torch.float64 or prob[1]):
                    continue  # the full-width level: f32, table mode
                line = lk.collapse_stencil(stencil9_coefficients(
                    AnisoProblem(*prob), n, n, dt, dev))
                b = torch.randn((n, n), generator=gen, device=dev).to(dt)
                u = torch.randn((n, n), generator=gen, device=dev).to(dt)
                sweep, lfs, blocks = line_row_sweep(torch, lk, line, b,
                                                    u, P)
                label = (f"K15 rank-spanning sweep aniso {pname} {n}^2, {P} "
                         f"blocks of {(n + 1) // P} rows ({lfs[0].seg}-row "
                         f"segments), {str(dt).replace('torch.', '')}")
                print(label)
                got = sweep()
                assert bool((got[-1] == 0).all()), f"{label}: pad row"
                want = lk.line_visit9_plain(line, b, u, 1, P11_OMEGA)
                compare(torch, "vs whole-grid plain (PCR)", got[:n], want,
                        rec[key], TOL_LINE)
                fac = lk.line_factor(line, n)

                def one_card():
                    return lk.line_visit9(line, b, u, 1, P11_OMEGA, fac=fac)

                compare(torch, "vs one-card K15", got[:n], one_card(), {},
                        TOL_LINE)
                if timed:
                    ms = time_ms(torch, sweep)
                    pms = time_ms(torch, lambda: lk.line_visit9_plain(
                        line, b, u, 1, P11_OMEGA))
                    oms = time_ms(torch, one_card)
                    nbytes = 3 * n * n * dt.itemsize
                    print(f"  {label}: {P} blocks {ms:.4f} ms "
                          f"({nbytes / ms / 1e6:.1f} GB/s effective), one-"
                          f"card K15 sweep {oms:.4f} ms, plain {pms:.4f} "
                          f"ms; bound {1e3 * nbytes / HBM_PEAK:.4f} ms")
                    keep_time(rec[key], ms, pms, nbytes, 20 * n * n)
                    every = lk.stack_lines(lfs[0], [
                        lk.line_rows_begin(lf, *blk)
                        for lf, blk in zip(lfs, blocks)])
                    dms = device_ms(torch, sweep)
                    split = line_launch_ms(torch, lk, lfs[1], *blocks[1],
                                           every)
                    print(f"  {label}: {P} blocks device time {dms:.4f} ms; "
                          f"block 1: {split}")
                    rec[key].update(device_ms=dms, launch_ms=split)
                    del every
                del got, want, b, u, line, sweep, lfs, blocks, fac
                torch.cuda.empty_cache()
    check_line_odd_segments(torch, dev, rec)


# Segment counts that are not a multiple of the carry launch's warps: one
# card at 1101^2 (35 segments) and 63^2 (2); the rank-spanning mode at
# 1119^2 on 4 blocks of 280 rows (8-row segments: 140) and at 63^2 on 2
# blocks of 32 (2).
P17_ODD_CARD = (1101, 63)
P17_ODD_ROWS = ((1119, 4), (63, 2))
TOL_LINE_F64 = 6e-14  # K15 in f64: Thomas and PCR in f64 agree to ~1e-14


def check_line_odd_segments(torch, dev, rec):
    """K15's blocked carry scan where the segments do not fill its warps'
    chunks (P17_ODD_CARD, P17_ODD_ROWS): one sweep's k = 3 u visit on one
    card and one rank-spanning sweep of the stitched blocks, each against
    the whole-grid plain version (PCR), on aniso (1,0,100,0,0) (the packed
    table) and (1,1,1,2,0.4) (factor fields), f32 (TOL_LINE) and f64
    (TOL_LINE_F64); the pad row exactly 0."""
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )

    gen = torch.Generator(device=dev).manual_seed(1717)
    for dt, sfx, tol in ((torch.float32, "", TOL_LINE),
                         (torch.float64, ".f64", TOL_LINE_F64)):
        tag = str(dt).replace("torch.", "")
        rec.setdefault("line_visit9" + sfx, {})
        for pname, prob in (("(1,0,100,0,0)", (1.0, 0.0, 100.0, 0.0, 0.0)),
                            ("(1,1,1,2,0.4)", (1.0, 1.0, 1.0, 2.0, 0.4))):
            def line_of(n):
                return lk.collapse_stencil(stencil9_coefficients(
                    AnisoProblem(*prob), n, n, dt, dev))

            def rnd(n):
                return torch.randn((n, n), generator=gen, device=dev).to(dt)

            for n in P17_ODD_CARD:
                line, b, u = line_of(n), rnd(n), rnd(n)
                check_kernel(
                    torch, rec, "line_visit9" + sfx,
                    f"K15 line_visit9 u k=3 aniso {pname} {tag} at {n}^2 "
                    f"({-(-n // lk.LINE_SEG)} segments)", 0, 0,
                    lambda: lk.line_visit9(line, b, u, 3, P11_OMEGA),
                    lambda: lk.line_visit9_plain(line, b, u, 3, P11_OMEGA),
                    ("u'",), tol, timed=False)
            for n, P in P17_ODD_ROWS:
                line, b, u = line_of(n), rnd(n), rnd(n)
                sweep, lfs, _ = line_row_sweep(torch, lk, line, b, u, P)
                print(f"K15 rank-spanning sweep aniso {pname} {tag} {n}^2, "
                      f"{P} blocks of {(n + 1) // P} rows ({lfs[0].seg}-row "
                      f"segments, {P * lfs[0].nseg} in all)")
                got = sweep()
                assert bool((got[-1] == 0).all()), "pad row"
                compare(torch, "vs whole-grid plain (PCR)", got[:n],
                        lk.line_visit9_plain(line, b, u, 1, P11_OMEGA),
                        rec.setdefault("line_visit9_rows" + sfx, {}), tol)
            del line, b, u, sweep, lfs, got
        torch.cuda.empty_cache()


def p11_configs(npts: int):
    """Phase 11's solves at ``npts`` (f32 levels): name -> (config, job
    extras, the one-card phase that runs the same config at 8193^2)."""
    L = npts.bit_length() - 3
    base = dict(npts=npts, grids=L, levels=L, dtype="float32", rtol=1e-5,
                max_iter=100)
    forced = dict(rtol=1e-30, divtol=1e30)
    return {
        "mixed": (dict(base, cycle=101, outer_dtype="float64", rtol=1e-8),
                  {"cert": True}, "8 (a)"),
        "bf16": (dict(base, cycle=101, precond_dtype="bfloat16"), {}, None),
        "fgmres": (dict(base, cycle=102, fgmres_restart=10, max_iter=3,
                        **forced), {}, None),
        "additive": (dict(base, cycle=9, max_iter=5, **forced), {}, None),
        "rbgs": (dict(base, cycle=0, smoother="rbgs", max_iter=5), {},
                 "10 (b)"),
        "line_y": (dict(base, cycle=101, problem="aniso",
                        aniso=[1.0, 0.0, 100.0, 0.0, 0.0],
                        smoother="line_y"), {}, "6 (b)"),
        "line_x": (dict(base, cycle=101, problem="aniso",
                        aniso=list(X_STRONG), smoother="line_x"), {},
                   "10 (b)"),
    }


def one_card_reference(torch, fields):
    """A phase-11 config solved on the card in this process: (iters,
    max error)."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve

    cfg = config_of(fields)
    res = solve(cfg, device="cuda")
    err = error_norms(res.ctx.problem, MeshType(cfg.mesh), res.u)[0]
    out = (res.iters, float(err))
    del res
    torch.cuda.empty_cache()
    return out


def phase_dist_cycles(torch):
    """11 (b): every single-grid cycle, smoother and precision outer under
    the row partition at full width: 2 ranks sharing the card over gloo
    (as phase 9 (b)), 8193^2 / 11 levels, f32, ``row_plan(min_local=32)``:
    the mixed outer to a true f64 residual of 1e-8, the bf16
    preconditioner (mg-CG to 1e-5), mg-FGMRES(10) forced 3 blocks,
    Additive forced 5, an RBGS V-cycle (10 (b)'s, 5), aniso (1,0,100,0,0)
    y-line mg-CG (6 (b)'s) and aniso (100,0,1,0,0) x-line mg-CG (10 (b)'s).
    Each: its iterations, error, launches per kernel and per K17 emit, the
    all-gathers it made (only onto replicated levels and the y-lines'
    carries, with their bytes), ms per iteration (two ranks share one
    card: not a speed figure); held to the one-card solve of the same
    config in this process where phase 6, 8 or 10 runs it (iterations
    within 1, error <= 1.1x).  (c): card against CPU at 1025^2 / 8
    levels, ``min_local=8``, the same configs and mg-CG -v 8,8 (its
    8-row blocks take K17 in pieces): equal iterations (the bf16
    preconditioner within 1, as phase 3d holds it).  Returns the
    launches the kernels' record takes: K17 bf16 (the bf16 run, rank 0)
    and the rank-spanning K15 (the y-line run, rank 0)."""
    import tempfile
    from pathlib import Path

    big = p11_configs(P9_N)
    small = p11_configs(P9_SMALL)
    Ls = P9_SMALL.bit_length() - 3
    small["v88"] = (dict(npts=P9_SMALL, grids=Ls, levels=Ls,
                         dtype="float32", rtol=1e-5, max_iter=100,
                         cycle=101, v=[8, 8]), {}, None)
    refs = {}
    for name, (f, _, phase) in big.items():
        if phase is not None:
            refs[name] = one_card_reference(torch, f)
            print(f"11 (b) one-card reference {name} (phase {phase}'s "
                  f"config): iters {refs[name][0]}, max error "
                  f"{refs[name][1]:.6e}")
    card_jobs = [dict(name=n, cfg=f, **x) for n, (f, x, _) in big.items()]
    par_jobs = [dict(name=n, cfg=f, min_local=8, **x)
                for n, (f, x, _) in small.items()]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        run_worlds([(par_jobs, "cpu", "cpu"), (card_jobs, "cuda", "card"),
                    (par_jobs, "cuda", "card1025")], out)
        got = {}
        for name, (f, x, phase) in big.items():
            res = world_results(out, name, "card")
            r0 = res[0]
            iters = r0["iters"]
            ms = 1e3 * r0["wall"] / max(iters, 1)
            print(f"11 (b) {name} {P9_N}^2/{f['levels']} levels, {P9_RANKS} "
                  f"ranks sharing one card: iters {iters}, converged "
                  f"{r0['converged']}, path {r0['path']}, max error "
                  f"{r0['errs'][0]:.6e}"
                  + (f", true f64 residual {r0['true']:.6e}"
                     if r0["true"] is not None else "")
                  + f"; {ms:.3f} ms per iteration (not a speed figure)")
            print(f"  residual history {r0['rnorm']}")
            print(f"  sharded levels {r0['dist']}")
            for r, x_ in enumerate(res):
                print(f"  rank {r}: launches {x_['counts']}; K17 per emit "
                      f"{x_['emits']}; all-gathers {x_['gathers']} "
                      f"({x_['gathered']} B sent)")
            for x_ in res:
                assert x_["path"] == "cuda"
                assert x_["iters"] == iters and x_["rnorm"] == r0["rnorm"]
                k17 = "dist_level_visit" + (".bf16" if name == "bf16"
                                            else "")
                assert x_["counts"].get("dist_level_visit", 0) > 0, name
                assert x_["counts"].get(k17, 0) > 0, f"{name}: {k17}"
                assert set(x_["gathers"]) <= {"agglomerate", "line"}, (
                    f"{name}: {x_['gathers']}")
                if name == "line_y":
                    assert x_["counts"].get("line_visit9_rows", 0) > 0
                    assert x_["gathers"].get("line", 0) > 0
            assert all(r0["dist"][:L9_SHARDED]), r0["dist"]
            assert all(map(lambda e: e == e, r0["errs"])), r0["errs"]
            if name == "mixed":
                assert r0["true"] <= 1e-8, r0["true"]
            if name in ("fgmres", "additive"):
                assert iters == f["max_iter"], iters
            elif name != "rbgs":
                assert r0["converged"], name
            if name == "bf16":
                assert r0["errs"][0] <= 1e-2, r0["errs"]
            if name in refs:
                ri, re_ = refs[name]
                assert abs(iters - ri) <= 1, (name, iters, ri)
                assert r0["errs"][0] <= 1.1 * re_, (name, r0["errs"], re_)
            got[name] = r0["counts"]
        for name, (f, x, _) in small.items():
            g = world_results(out, name, "card1025")[0]
            c = world_results(out, name, "cpu")[0]
            print(f"11 (c) {name} {P9_SMALL}^2/{Ls} levels, min_local 8, "
                  f"{P9_RANKS} ranks: iters card {g['iters']} cpu "
                  f"{c['iters']}; max error card {g['errs'][0]:.6e} cpu "
                  f"{c['errs'][0]:.6e}; sharded levels {g['dist']}; card "
                  f"launches {g['counts']}; all-gathers {g['gathers']}")
            assert g["path"] == "cuda" and c["path"] == "torch"
            assert g["dist"] == c["dist"]
            slack = 1 if name == "bf16" else 0
            assert abs(g["iters"] - c["iters"]) <= slack, name
            assert set(g["gathers"]) <= {"agglomerate", "line"}
    return {"dist_level_visit.bf16": got["bf16"]["dist_level_visit.bf16"],
            "line_visit9_rows": got["line_y"]["line_visit9_rows"]}


# The levels phase 11 (b)'s plan shards at 8193^2 (min_local 32, 2
# ranks): 8191 ... 63.
L9_SHARDED = 8


def run_phase11(torch, dev, rec):
    """Phase 11: distribution, every single-grid cycle."""
    torch.cuda.empty_cache()
    timed_phase(torch, "11 (a)", phase_line_rows, dev, rec)
    return timed_phase(torch, "11 (b), (c)", phase_dist_cycles)


# Phase 12: the merged-grid cycles under the row partition.
P12_ONE = ("ICYCLE", "ECYCLE", "D1CYCLE", "D2CYCLE", "D1PSCYCLE")
CYCLE_IDS = {"ICYCLE": 1, "ECYCLE": 2, "D1CYCLE": 3, "D2CYCLE": 4,
             "D1PSCYCLE": 7}
P12_FORCED = dict(rtol=1e-30, divtol=1e30)


def p12_configs():
    """Phase 12's solves (f32): name -> (config, job extras).  (a) the
    one-level merged cycles on 2 grids at 8193^2, forced 10 (both grids
    sharded under min_local 32: blocks of 4096 and 2048 rows); (b) a
    V-cycle (forced 5) and mg-CG (rtol 1e-5, max_iter 10) at 8193^2,
    grids 4 / levels 3 (level 2 merges 2047^2 and 1023^2, both sharded,
    solved by 64 CG iterations of a nonsymmetric operator: in f32 mg-CG
    runs its 10 iterations unconverged over the ranks and on one card
    alike, as it ran 30 to ~1e-4); (c) card against CPU at 1025^2: the
    one-level cycles with min_local 512 (the 1023^2 grid sharded, the
    511^2 grid replicated), phase 3c's V-cycle (forced 3) at grids 4 /
    levels 2 with min_local 256 (level 1 merges 511^2, sharded, 255^2 and
    127^2, replicated; CG) and mg-CG at grids 10 / levels 7
    with min_local 8 (level 6 merges 15^2, sharded, 7^2, 3^2 and 1^2;
    solved directly, its sharded grid gathered)."""
    f32 = dict(dtype="float32")
    big, small = {}, {}
    for c in P12_ONE:
        cyc = CYCLE_IDS[c]
        big[c] = (dict(f32, npts=P9_N, grids=2, levels=1, cycle=cyc,
                       max_iter=10, **P12_FORCED), {"save_u": True})
        small[c] = (dict(f32, npts=P9_SMALL, grids=2, levels=1, cycle=cyc,
                         max_iter=10, **P12_FORCED), {"min_local": 512})
    big["vcycle"] = (dict(f32, npts=P9_N, grids=4, levels=3, cycle=0,
                          max_iter=5, **P12_FORCED), {})
    big["mgcg"] = (dict(f32, npts=P9_N, grids=4, levels=3, cycle=101,
                        rtol=1e-5, max_iter=10), {})
    small["vcycle"] = (dict(f32, npts=P9_SMALL, grids=4, levels=2, cycle=0,
                            max_iter=3, **P12_FORCED), {"min_local": 256})
    small["mgcg_direct"] = (dict(f32, npts=P9_SMALL, grids=10, levels=7,
                                 cycle=101, rtol=1e-5, max_iter=30),
                            {"min_local": 8})
    return big, small


def merged_twin(torch, fields):
    """A phase-12 config on one card in this process: its iterations,
    history, solution (numpy), max error and launches."""
    import numpy as np

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import launches
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve

    cfg = config_of(fields)
    launches.clear()
    res = solve(cfg, device="cuda")
    counts = dict(launches)
    err = error_norms(res.ctx.problem, MeshType(cfg.mesh), res.u)[0]
    out = dict(iters=res.iters, rnorm=np.asarray(res.rnorm),
               u=res.u.cpu().numpy(), err=float(err), counts=counts,
               wall=res.wall_time)
    del res
    torch.cuda.empty_cache()
    return out


def phase_dist_merged(torch):
    """12: the merged-grid cycles and merged levels under the row
    partition, 2 ranks sharing the card over gloo (as phase 11 (b)),
    ``row_plan(min_local=32)`` unless a config names another
    (``p12_configs``).  (a) I, E, D1, D2, D1PS on 2 sharded grids at
    8193^2, each held to its one-card twin in this process: the
    normalized histories within 1e-5 entry by entry, u within TOL_ARRAY
    of max|u|; K17 on both ranks, no K6 or K7 on either (no grid is
    replicated; the twin launches them).  (b) the V-cycle and mg-CG over
    the sharded merged level 2 (CG-solved): iterations within 1 and error
    <= 1.1x of the one-card twin.  (c) card against CPU at 1025^2, merged
    levels with replicated grids: equal iterations, histories rtol 0.05 +
    atol 5e-6 (as phase 9 (c)).  Every run prints its launches per kernel
    and per K17 emit, its all-gathers by what they gather (inside the
    iterations only "agglomerate" onto a replicated grid and "coarsest"
    for a direct solve) and its ms per iteration, which measures the
    gloo host staging of two ranks on one card, not the card.  Returns
    rank 0's K17 launches over (a)'s five runs."""
    import tempfile
    from pathlib import Path

    import numpy as np

    big, small = p12_configs()
    twins = {}
    for name, (f, _) in big.items():
        twins[name] = merged_twin(torch, f)
        t = twins[name]
        print(f"12 one-card twin {name} {P9_N}^2 grids {f['grids']} levels "
              f"{f['levels']}: iters {t['iters']}, max error "
              f"{t['err']:.6e}, launches {t['counts']}, "
              f"{1e3 * t['wall'] / max(t['iters'], 1):.3f} ms per iteration")
    card_jobs = [dict(name=n, cfg=f, **x) for n, (f, x) in big.items()]
    par_jobs = [dict(name=n, cfg=f, **x) for n, (f, x) in small.items()]
    k17 = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        run_worlds([(par_jobs, "cpu", "cpu"), (card_jobs, "cuda", "card"),
                    (par_jobs, "cuda", "card1025")], out)
        for name, (f, x) in big.items():
            res = world_results(out, name, "card")
            r0, t = res[0], twins[name]
            iters = r0["iters"]
            print(f"12 ({'a' if name in P12_ONE else 'b'}) {name} "
                  f"{P9_N}^2 grids {f['grids']} levels {f['levels']}, "
                  f"{P9_RANKS} ranks sharing one card: iters {iters} (twin "
                  f"{t['iters']}), path {r0['path']}, max error "
                  f"{r0['errs'][0]:.6e} (twin {t['err']:.6e}); "
                  f"{1e3 * r0['wall'] / max(iters, 1):.3f} ms per "
                  f"iteration (gloo host staging, not the card)")
            print(f"  residual history {r0['rnorm']}")
            print(f"  sharded grids per level {r0['split']}")
            for r, x_ in enumerate(res):
                print(f"  rank {r}: launches {x_['counts']}; K17 per emit "
                      f"{x_['emits']}; all-gathers {x_['gathers']} "
                      f"({x_['gathered']} B sent)")
            for x_ in res:
                assert x_["path"] == "cuda"
                assert x_["iters"] == iters and x_["rnorm"] == r0["rnorm"]
                assert x_["counts"].get("dist_level_visit", 0) > 0, name
                assert (sum(x_["emits"].values())
                        == x_["counts"]["dist_level_visit"])
                # Every grid of (a) and (b)'s merged levels is sharded:
                # no K6 or K7, and nothing gathered.
                for k in ("apply_stencil5", "smooth_sweeps"):
                    assert x_["counts"].get(k, 0) == 0, f"{name}: {k}"
                assert not x_["gathers"], f"{name}: {x_['gathers']}"
            assert all(all(s) for s in r0["split"]), r0["split"]
            assert all(e == e for e in r0["errs"]), r0["errs"]
            if name in P12_ONE:
                assert t["counts"].get("apply_stencil5", 0) > 0
                if name == "ICYCLE":
                    assert t["counts"].get("smooth_sweeps", 0) > 0
                assert iters == t["iters"] == f["max_iter"]
                dh = float(np.abs(np.asarray(r0["rnorm"])
                                  - t["rnorm"]).max())
                u = np.load(out / f"{name}.npy")
                du = float(np.abs(u - t["u"]).max() / np.abs(t["u"]).max())
                print(f"  vs the twin: max|history diff| {dh:.3e}, "
                      f"max|u - u_twin| / max|u_twin| {du:.3e}")
                assert dh <= 1e-5, dh
                assert du <= TOL_ARRAY, du
                k17 += r0["counts"]["dist_level_visit"]
            else:
                assert abs(iters - t["iters"]) <= 1, (name, iters,
                                                      t["iters"])
                assert r0["errs"][0] <= 1.1 * t["err"], (name, r0["errs"])
        for name, (f, x) in small.items():
            g = world_results(out, name, "card1025")[0]
            c = world_results(out, name, "cpu")[0]
            print(f"12 (c) {name} {P9_SMALL}^2 grids {f['grids']} levels "
                  f"{f['levels']}, min_local {x.get('min_local', 32)}, "
                  f"{P9_RANKS} ranks: iters card {g['iters']} cpu "
                  f"{c['iters']}; max error card {g['errs'][0]:.6e} cpu "
                  f"{c['errs'][0]:.6e}; sharded grids {g['split']}; card "
                  f"launches {g['counts']}, K17 per emit {g['emits']}; "
                  f"all-gathers {g['gathers']}")
            assert g["path"] == "cuda" and c["path"] == "torch"
            assert g["split"] == c["split"]
            assert any(not all(s) for s in g["split"]), g["split"]
            assert g["iters"] == c["iters"], name
            np.testing.assert_allclose(g["rnorm"], c["rnorm"], rtol=0.05,
                                       atol=5e-6)
            assert g["counts"].get("dist_level_visit", 0) > 0
            assert set(g["gathers"]) <= {"agglomerate", "coarsest"}
            if name == "mgcg_direct":
                assert g["converged"] and g["gathers"].get("coarsest", 0)
            else:
                assert g["gathers"].get("agglomerate", 0) > 0
    return k17


def run_phase12(torch):
    """Phase 12: distribution, the merged-grid cycles and merged levels."""
    torch.cuda.empty_cache()
    return timed_phase(torch, "12", phase_dist_merged)


# ---------------------------------------------------------------------------
# Phase 13: the 2-D blocks layout (-map 0/1) and K17's 2-D block mode.
# ---------------------------------------------------------------------------

P13_MESHES = ((2, 2), (1, 2))  # (a): the (my, mx) cuts of the 8191^2 level
P13_RANKS = 4  # (b), (c): a 2x2 mesh of ranks sharing the one card


def k17_2d_blocks(x, my, mx, h):
    """x's (R, C) blocks on an my x mx mesh (an axis of mesh size 1 not
    split: its whole extent; a split one with its pad row or column), each
    with its depth-h ring cut from its neighbours (zeros past the edges):
    [(row0, col0, block, Halo2)] in rank order."""
    from multigrid_petsc_tpu_torch.parallel.block_ops import cut_halo

    ny, nx = x.shape
    R = (ny + 1) // my if my > 1 else ny
    C = (nx + 1) // mx if mx > 1 else nx
    return [(iy * R, ix * C, *cut_halo(x, iy * R, ix * C, R, C, h))
            for iy in range(my) for ix in range(mx)]


def stitch(torch, outs, my, mx):
    """The blocks' outputs (rank order, each a tuple) joined into whole
    arrays."""
    return tuple(torch.cat([torch.cat([outs[iy * mx + ix][i]
                                       for ix in range(mx)], 1)
                            for iy in range(my)])
                 for i in range(len(outs[0])))


def phase_k17_blocks(torch, dev, rec):
    """13 (a): K17's 2-D block mode at full width in one process.  The
    8191^2 level (with its pad row and column along a split axis) cut into
    2x2 blocks of 4096^2 and 1x2 blocks of 8191 x 4096, each block's ring
    cut from its neighbours; every emit of the 5-point visit (Jacobi k =
    3) and of the aniso (1,1,1,2,0.4) 9-point visit in f32, every emit of
    the 5-point visit in bf16 (storage), the 5-point zero-guess rc visit
    in f64.  The stitched blocks are held to the
    whole-grid kernel of the same flags (K9 / K6 / residual5 / K12 / K14)
    and to the plain block version (TOL_ARRAY of max|plain|; bf16: one
    bf16 ulp); the pad row
    and column (the coarse ones of rc) must be exactly 0.  Times (2x2,
    block 1): per call, the plain version, and as device time
    (``device_ms``: 20 launches queued behind a sleep) the 5-point "a"
    and "r" blocks (f32) beside conv2d on the block and its ring (the
    library call), and the zero-guess rc and correct + u blocks in f32
    and bf16 (each storage type's ``modes_5pt``); the
    bound counts one block's bytes: its points and ring of each input
    read once, each output written once."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.parallel.block_ops import _cut_coeffs
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
        stencil_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    n = P9_N - 2
    nxc = (n - 1) // 2
    jac = jacobi_step_coeffs(3, 0.8)
    gen = torch.Generator(device=dev).manual_seed(4321)
    modes = (  # label, guess, steps, emit, correct
        ("zero-guess rc", False, jac, "rc", False),
        ("u", True, jac, "u", False),
        ("correct + u", True, jac, "u", True),
        ("correct + ur", True, jac, "ur", True),
        ("a", True, (), "a", False),
        ("r", True, (), "r", False),
    )
    # The bf16 preconditioner's split levels run two 5-point visits, timed
    # as device time: the zero-guess rc down and correct + u up.
    pre = ("zero-guess rc", "correct + u")
    for dt, sfx in ((torch.float32, ""), (torch.float64, ".f64"),
                    (torch.bfloat16, ".bf16")):
        key = dk.BLOCKS + sfx
        rec.setdefault(key, {})
        isz = dt.itemsize
        b = torch.randn((n, n), generator=gen, device=dev).to(dt)
        u = torch.randn((n, n), generator=gen, device=dev).to(dt)
        e = torch.randn((nxc, nxc), generator=gen, device=dev).to(dt)
        stencils = [("5-point", stencil_coefficients(MeshType.UNIFORM, n, n,
                                                     dt, dev))]
        if dt == torch.float32:
            stencils.append(("9-point (1,1,1,2,0.4)", stencil9_coefficients(
                AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), n, n, dt, dev)))
        modes_rec = {}
        for sname, st in stencils:
            nine = isinstance(st, Stencil9)
            for label, guess, steps, emit, correct in modes:
                if (dt == torch.float64 and label != "zero-guess rc"
                        or nine and label == "correct + u"):
                    continue
                k = len(steps)
                h = dk.halo_rows(k, emit)
                hc = dk.coarse_halo_rows(h)

                def whole_fn():
                    if emit == "a":
                        return ((k9.apply_stencil9 if nine else
                                 sk.apply_stencil5)(st, u),)
                    if emit == "r":
                        return ((k9.residual9 if nine else sk.residual5)(
                            st, b, u),)
                    out = (k9.fused_level_visit9 if nine else
                           sk.fused_level_visit)(
                        st, b, u if guess else None, steps, emit,
                        e if correct else None)
                    return out if isinstance(out, tuple) else (out,)

                ref = whole_fn()
                for my, mx in P13_MESHES:
                    bb = k17_2d_blocks(b, my, mx, h)
                    ub = k17_2d_blocks(u, my, mx, h)
                    eb = k17_2d_blocks(e, my, mx, hc)
                    R, C = bb[0][2].shape
                    m = k + 2  # the coefficients a rank keeps, as in a solve

                    def args(p):
                        r0, c0 = bb[p][0], bb[p][1]
                        cr0, cc0 = max(0, r0 - m), max(0, c0 - m)
                        stp = (_cut_coeffs(st, cr0, min(n, r0 + R + m), cc0,
                                           min(n, c0 + C + m))
                               if nine else st)
                        return (stp, None if emit == "a" else bb[p][2],
                                ub[p][2] if guess else None, steps, emit), \
                            dict(row0=r0, col0=c0, ny=n, nx=n,
                                 b_halo=bb[p][3], u_halo=ub[p][3],
                                 e=eb[p][2] if correct else None,
                                 e_halo=eb[p][3] if correct else None,
                                 coeff_row0=cr0 if nine else 0,
                                 coeff_col0=cc0 if nine else 0)

                    calls = [args(p) for p in range(my * mx)]

                    def run(fn):
                        outs = [fn(*a, **kw) for a, kw in calls]
                        return stitch(torch, [o if isinstance(o, tuple)
                                              else (o,) for o in outs],
                                      my, mx)

                    tag = (f"K17 2-D {sname} {label}" + (f" k={k}" if k
                                                         else "")
                           + f" {dt}".replace("torch.", " "))
                    print(f"{tag}, {my}x{mx} blocks of {R} x {C} at {n}^2")
                    got = run(dk.block_visit)
                    want = run(dk.block_visit_plain)
                    names = {"rc": ("u'", "rc"), "ur": ("u'", "r")}.get(
                        emit, (emit,))
                    for nm, g, w, wh in zip(names, got, want, ref):
                        ry, rx = wh.shape
                        for x, what in ((g, "kernel"), (w, "plain")):
                            assert bool((x[ry:] == 0).all()), \
                                f"{tag}: {nm} {what} pad row"
                            assert bool((x[:, rx:] == 0).all()), \
                                f"{tag}: {nm} {what} pad column"
                        compare(torch, f"{nm} vs plain 2-D blocks", g, w,
                                rec[key])
                        compare(torch, f"{nm} vs whole-grid kernel",
                                g[:ry, :rx], wh, {})
                    del got, want
                    if (my, mx) == (2, 2):
                        a1, kw1 = calls[1]
                        ms1 = time_ms(torch, lambda: dk.block_visit(*a1,
                                                                    **kw1))
                        pms = time_ms(torch, lambda: dk.block_visit_plain(
                            *a1, **kw1))
                        # Read once: u (a, r, a guess) and b (the visits)
                        # on the block and its ring, b on its own points
                        # (r), e and its ring, the 9-point (n, n) cc on the
                        # points read; written once: the outputs.
                        ext = (R + 2 * h) * (C + 2 * h)
                        if emit in ("a", "r"):
                            ins = ext + (R * C if emit == "r" else 0)
                        else:
                            ins = ext * (1 + int(guess)) + (
                                (R // 2 + 2 * hc) * (C // 2 + 2 * hc)
                                if correct else 0)
                        outs = R * C * (2 if emit == "ur" else 1) + (
                            (R // 2) * (C // 2) if emit == "rc" else 0)
                        nbytes = isz * (ins + outs + (ext if nine else 0))
                        flops = ((23 * k + 20) if nine else
                                 (15 * k + 12)) * R * C
                        bound = 1e3 * nbytes / HBM_PEAK
                        print(f"  {tag}: kernel {ms1:.4f} ms per block "
                              f"({nbytes / ms1 / 1e6:.1f} GB/s effective), "
                              f"plain {pms:.4f} ms; bound {bound:.4f} ms "
                              f"per block")
                        keep_time(rec[key], ms1, pms, nbytes, flops)
                        if (not nine and dt != torch.float64 and (
                                label in pre or dt == torch.float32
                                and emit in ("a", "r"))):
                            dms = device_ms(torch, lambda: dk.block_visit(
                                *a1, **kw1))
                            lms = ldms = None
                            if emit in ("a", "r"):  # conv2d: block + ring
                                c = [float(x[0, 0]) for x in st]
                                w5 = torch.tensor(
                                    [[0.0, c[0], 0.0], [c[1], c[2], c[3]],
                                     [0.0, c[4], 0.0]], device=dev)
                                from multigrid_petsc_tpu_torch.parallel.\
                                    block_ops import extend
                                ue = extend(a1[2], kw1["u_halo"])
                                be = (torch.nn.functional.pad(
                                    a1[1], (h, h, h, h))
                                    if emit == "r" else None)
                                conv = conv_call(torch, w5, ue, be)
                                lms = time_ms(torch, conv)
                                ldms = library_device_ms(torch, conv, lms)
                                del ue, be, conv
                            modes_rec[label if label == "correct + u"
                                      else emit] = {
                                "ms_per_call": ms1, "device_ms": dms,
                                "bound_ms": bound, "library_ms": lms,
                                "library_device_ms": ldms}
                            if dt == torch.bfloat16 and emit == "rc":
                                rec[key]["device_ms"] = dms
                            print(f"  {tag}: device time {dms:.4f} ms per "
                                  f"block ({100 * bound / dms:.1f}% of its "
                                  f"bound {bound:.4f} ms), per call "
                                  f"{ms1:.4f} ms"
                                  + (f"; conv2d on the block and its ring "
                                     f"{lms:.4f} ms a call, device "
                                     f"{ldms:.4f} ms" if lms is not None
                                     else ""))
                    del bb, ub, eb, calls
                del ref
            del st
        del b, u, e
        torch.cuda.empty_cache()
        if modes_rec:
            rec[key]["modes_5pt"] = modes_rec


# 13 (a): K15's 2-D block mode on (n, (my, mx), storage type, timed) cuts
# of a level: the 8191^2 level in 2x2 blocks of 4096^2 (y- and x-lines
# across two ranks each), 1x2 and 2x1 (the y-, then the x-lines whole in
# each block: a group of one rank), and the 1023^2 level in f64.
P13_LINE_CASES = ((8191, (2, 2), "f32", True), (8191, (1, 2), "f32", False),
                  (8191, (2, 1), "f32", False), (1023, (2, 2), "f64", False))


def line_block_sweeps(torch, lk, st, b, u, my, mx, axis, plain, sides=None):
    """One line sweep of K15's 2-D block mode (``plain``: its plain
    version) of the (ny, nx) level (b, u) cut into my x mx blocks with
    their rings (equal ones, or ``sides``: the (rows, columns) of
    ``uneven_blocks``), run in one process as the ranks run it: y-lines
    (``axis`` 0, ``st`` the collapsed line stencil) or x-lines (1: ``st``
    the transposed level's, each block and ring transposed,
    ``line_kernel.transpose_ring``), the first half on every block, its
    outputs stacked over the ranks the lines span (the all-gather and
    ``stack_lines``; none along an axis of one rank), the second half on
    every block.  Returns
    (sweep: the stitched (ny + pad, nx + pad) result, the blocks' calls
    (line, b, u, ring, the stacked first halves) of the second half)."""
    ny, nx = b.shape
    if sides is None:
        blocks = list(zip(k17_2d_blocks(b, my, mx, 1),
                          k17_2d_blocks(u, my, mx, 1)))
        spans = (None, None)
    else:
        blocks = list(zip(uneven_blocks(b, *sides, 1),
                          uneven_blocks(u, *sides, 1)))
        spans = tuple(s if len(s) > 1 else None for s in sides)
    calls = []
    for (r0, c0, bb, _), (_, _, ub, ring) in blocks:
        R, C = bb.shape
        if axis:
            lf = lk.row_line(st, nx, C, c0, r0, min(R, ny - r0), plain=plain,
                             blocks=spans[1])
            calls.append([lf, bb.T.contiguous(), ub.T.contiguous(),
                          lk.transpose_ring(ring)])
        else:
            lf = lk.row_line(st, ny, R, r0, c0, min(C, nx - c0), plain=plain,
                             blocks=spans[0])
            calls.append([lf, bb, ub, ring])
    begin = lk.line_rows_begin_plain if plain else lk.line_rows_begin

    def end(lf, bb, ub, ring, every):
        if plain:
            return lk.line_rows_end_plain(lf, ub, every, P11_OMEGA)
        return lk.line_rows_end(lf, bb, ub, ring, every, P11_OMEGA)

    def sweep():
        mine = [begin(*c[:4]) for c in calls]
        outs = []
        for p, c in enumerate(calls):
            iy, ix = divmod(p, mx)
            group = (mine[ix::mx] if axis == 0 else
                     mine[iy * mx:(iy + 1) * mx])
            spans = my if axis == 0 else mx
            c[4:] = [lk.stack_lines(c[0], group) if spans > 1 else mine[p]]
            out = end(*c)
            outs.append((out.T if axis else out,))
        return stitch(torch, outs, my, mx)[0]

    return sweep, calls


def phase_line_blocks(torch, dev, rec):
    """13 (a): K15's 2-D block mode (the y-lines of a level of the blocks
    layout across a mesh column, the x-lines across a mesh row on the
    transposed block) on P13_LINE_CASES, its blocks run in one process as
    the ranks run them, on aniso (1,0,100,0,0) (the packed per-row table)
    and (1,1,1,2,0.4) (factor fields): one sweep of the stitched blocks
    held to the stitched plain blocks (``line_rows_*_plain``: PCR over the
    whole gathered lines) and to the whole-grid plain sweep (TOL_LINE of
    max|plain|); the pad row and column exactly 0.  Timed on the 8191^2
    level's 2x2 cut, f32, strong-y y-lines: block 1's sweep (both halves,
    launches 1-3) as device time and per call, each launch alone
    (``line_launch_ms``), the plain block's, the bound 3 arrays of the
    block (b and u read, u written)."""
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.ops.stencil import transpose_stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )

    gen = torch.Generator(device=dev).manual_seed(1357)
    dts = {"f32": (torch.float32, ""), "f64": (torch.float64, ".f64")}
    for n, (my, mx), dname, timed in P13_LINE_CASES:
        dt, sfx = dts[dname]
        key = "line_visit9_blocks" + sfx
        rec.setdefault(key, {})
        b = torch.randn((n, n), generator=gen, device=dev).to(dt)
        u = torch.randn((n, n), generator=gen, device=dev).to(dt)
        for pname, prob in (("(1,0,100,0,0)", (1.0, 0.0, 100.0, 0.0, 0.0)),
                            ("(1,1,1,2,0.4)", (1.0, 1.0, 1.0, 2.0, 0.4))):
            if prob[1] and (my, mx) != (2, 2):
                continue  # the fields on the 2x2 cuts
            st9 = stencil9_coefficients(AnisoProblem(*prob), n, n, dt, dev)
            for axis, lname in ((0, "y-lines"), (1, "x-lines")):
                st = lk.collapse_stencil(transpose_stencil9(st9) if axis
                                         else st9)
                tag = (f"K15 2-D blocks {lname} aniso {pname} {n}^2, {my}x"
                       f"{mx} blocks, {dname}")
                print(tag)
                sweep, calls = line_block_sweeps(torch, lk, st, b, u, my, mx,
                                                 axis, plain=False)
                psweep, pcalls = line_block_sweeps(torch, lk, st, b, u, my,
                                                   mx, axis, plain=True)
                got, want = sweep(), psweep()
                for x, what in ((got, "kernel"), (want, "plain")):
                    assert bool((x[n:] == 0).all()), f"{tag}: {what} pad row"
                    assert bool((x[:, n:] == 0).all()), \
                        f"{tag}: {what} pad column"
                compare(torch, "vs plain 2-D blocks", got, want, rec[key],
                        TOL_LINE)
                if axis:
                    whole = lk.line_visit9_plain(
                        st, b.T.contiguous(), u.T.contiguous(), 1,
                        P11_OMEGA).T
                else:
                    whole = lk.line_visit9_plain(st, b, u, 1, P11_OMEGA)
                compare(torch, "vs whole-grid plain (PCR)", got[:n, :n],
                        whole, {}, TOL_LINE)
                del got, want, whole
                if timed and axis == 0 and not prob[1]:
                    c1, p1 = calls[1], pcalls[1]
                    R, C = c1[1].shape

                    def kern():
                        lk.line_rows_begin(*c1[:4])
                        return lk.line_rows_end(*c1, P11_OMEGA)

                    def plain():
                        lk.line_rows_begin_plain(*p1[:4])
                        return lk.line_rows_end_plain(p1[0], p1[2], p1[4],
                                                      P11_OMEGA)

                    ms = time_ms(torch, kern)
                    dms = device_ms(torch, kern)
                    pms = time_ms(torch, plain)
                    nbytes = 3 * R * C * dt.itemsize
                    bound = 1e3 * nbytes / HBM_PEAK
                    print(f"  {tag}: block 1 ({R} x {C}) sweep device time "
                          f"{dms:.4f} ms ({100 * bound / dms:.1f}% of its "
                          f"bound {bound:.4f} ms), per call {ms:.4f} ms, "
                          f"plain {pms:.4f} ms")
                    keep_time(rec[key], ms, pms, nbytes, 20 * R * C)
                    split = line_launch_ms(torch, lk, *c1)
                    print(f"  {tag}: block 1: {split}")
                    rec[key].update(device_ms=dms, launch_ms=split)
                del sweep, psweep, calls, pcalls, st
                torch.cuda.empty_cache()
            del st9
        del b, u
        torch.cuda.empty_cache()


def p13_configs(npts: int):
    """Phase 13's solves at ``npts`` (f32): name -> (config, job extras).
    mg-CG is phase 4's config (rtol 1e-5), the V-cycle forced 5,
    mg-FGMRES(10) forced 3 blocks, the aniso (1,1,1,2,0.4) mg-CG Jacobi
    to rtol 1e-5."""
    L = npts.bit_length() - 3
    base = dict(npts=npts, grids=L, levels=L, dtype="float32", rtol=1e-5,
                max_iter=100)
    forced = dict(rtol=1e-30, divtol=1e30)
    return {
        "mgcg": (dict(base, cycle=101), {}),
        "vcycle": (dict(base, cycle=0, max_iter=5, **forced), {}),
        "fgmres": (dict(base, cycle=102, fgmres_restart=10, max_iter=3,
                        **forced), {}),
        "aniso": (dict(base, cycle=101, problem="aniso",
                       aniso=[1.0, 1.0, 1.0, 2.0, 0.4]), {}),
    }


# The one-card mg-CG route's kernels K1, K2a and K4, which no solve under
# a plan launches (a plan takes the generic route).  K2b and K3
# ("visit_down", "visit_up": the whole-grid visit's zero-guess rc and
# correcting u flag sets) run on the replicated levels only: as many a
# cycle as the replicated levels above the coarsest, where a split
# level's visits are K17's.
MGCG_KERNELS = ("cg_papply_u", "cg_visit_down", "coarse_tree")


def replicated_visits_only(x, axes):
    """A rank's launches show K2b / K3 on the replicated levels alone:
    per cycle (K17's rc emits over the split levels) one of each on every
    replicated level but the coarsest."""
    split = sum(map(any, axes))
    rep = len(axes) - split - 1
    cycles = x["emits"].get("rc.blocks", 0) / split
    for kk in ("visit_down", "visit_up"):
        assert x["counts"].get(kk, 0) in (0, cycles * rep), (kk, x["counts"])


def phase_dist_blocks(torch, main_ref):
    """13 (b): the blocks layout at full width, 4 ranks sharing the card
    over gloo (halos staged through the host), ``blocks_plan(min_local=
    32)`` on the 2x2 mesh, 8193^2 / 11 levels (8191 ... 127 split along
    both axes, 63 and below replicated): phase 4's mg-CG, a V-cycle forced
    5, mg-FGMRES(10) forced 3 blocks and the aniso (1,1,1,2,0.4) mg-CG
    Jacobi, each held to its one-card twin (phase 4's solve for mg-CG, the
    others in this process): iterations within 1, error <= 1.1x (mg-FGMRES,
    at the f32 floor: 2x), u within 1e-3 of max|u|.  Each: K17's 2-D block launches per emit on every
    rank, no K1, K2a or K4 and K2b / K3 on the replicated levels only
    (``replicated_visits_only``), its all-gathers by label (inside the
    iterations only
    "agglomerate" onto the replicated 63^2 level and "coarsest"), ms per
    iteration (gloo host staging of 4 ranks on one card, not the card).
    (b'): the 2-rank (1x2 mesh) mg-CG at 8193^2 (levels split along x
    alone).  (c): card against CPU at 1025^2 / 8 levels, 2x2, min_local
    8, mg-CG in f32 and f64: equal iterations, histories rtol 0.05 + atol
    5e-6.  Returns the launches the kernels' record takes: f32 from (b)'s
    mg-CG on rank 0, f64 from (c)'s card run."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import BLOCKS

    big = p13_configs(P9_N)
    twins = {"mgcg": dict(iters=main_ref["iters"], err=main_ref["err"],
                          u=main_ref["u"])}
    for name, (f, _) in big.items():
        if name not in twins:
            twins[name] = merged_twin(torch, f)
        t = twins[name]
        print(f"13 one-card twin {name} {P9_N}^2: iters {t['iters']}, max "
              f"error {t['err']:.6e}")
    blocks = dict(layout="blocks", save_u=True)
    card_jobs = [dict(name=n, cfg=f, **blocks, **x)
                 for n, (f, x) in big.items()]
    pair_jobs = [dict(name="pair_mgcg", cfg=big["mgcg"][0], **blocks)]
    Ls = P9_SMALL.bit_length() - 3
    small = dict(npts=P9_SMALL, grids=Ls, levels=Ls, cycle=101,
                 max_iter=100)
    parity = [dict(name="p1025", cfg=dict(small, dtype="float32",
                                          rtol=1e-5), min_local=8,
                   layout="blocks"),
              dict(name="p1025_f64", cfg=dict(small, dtype="float64"),
                   min_local=8, layout="blocks")]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        # The full-width 2x2 world alone (its ms per iteration), then the
        # others side by side.
        run_worlds([(card_jobs, "cuda", "card", P13_RANKS)], out)
        run_worlds([(pair_jobs, "cuda", "pair", 2),
                    (parity, "cuda", "card1025", P13_RANKS),
                    (parity, "cpu", "cpu", P13_RANKS)], out)
        for name, (f, _) in big.items():
            res = world_results(out, name, "card", P13_RANKS)
            r0, t = res[0], twins[name]
            iters = r0["iters"]
            u = np.load(out / f"{name}.npy")
            du = float(np.abs(u - t["u"]).max() / np.abs(t["u"]).max())
            print(f"13 (b) {name} {P9_N}^2/{f['levels']} levels, "
                  f"{P13_RANKS} ranks (2x2) sharing one card: iters {iters} "
                  f"(twin {t['iters']}), path {r0['path']}, max error "
                  f"{r0['errs'][0]:.6e} (twin {t['err']:.6e}), max|u - "
                  f"u_twin| / max|u_twin| {du:.3e}; "
                  f"{1e3 * r0['wall'] / max(iters, 1):.3f} ms per "
                  f"iteration (gloo host staging, not the card)")
            print(f"  residual history {r0['rnorm']}")
            print(f"  split axes per level {r0['axes']}")
            for r, x in enumerate(res):
                print(f"  rank {r}: launches {x['counts']}; K17 per emit "
                      f"{x['emits']}; all-gathers {x['gathers']} "
                      f"({x['gathered']} B sent)")
            for x in res:
                assert x["path"] == "cuda"
                assert x["iters"] == iters and x["rnorm"] == r0["rnorm"]
                assert x["counts"].get(BLOCKS, 0) > 0, name
                assert x["counts"].get(BLOCKS, 0) == sum(
                    v for e, v in x["emits"].items() if ".blocks" in e)
                for kk in MGCG_KERNELS:
                    assert x["counts"].get(kk, 0) == 0, f"{name}: {kk}"
                replicated_visits_only(x, r0["axes"])
                assert set(x["gathers"]) <= {"agglomerate", "coarsest"}, (
                    f"{name}: {x['gathers']}")
            assert r0["axes"][:7] == [[True, True]] * 7, r0["axes"]
            assert not any(map(any, r0["axes"][7:])), r0["axes"]
            assert abs(iters - t["iters"]) <= 1, (name, iters, t["iters"])
            # mg-FGMRES forced 3 blocks ends at the f32 floor (PERF.md
            # §2): its error there is roundoff, whose realization follows
            # the dots' summation order over the ranks (the V-cycle, which
            # takes no dot, equals its twin bit for bit); it is held to 2x
            # its twin's, the others to 1.1x.
            ratio = 2.0 if name == "fgmres" else 1.1
            assert r0["errs"][0] <= ratio * t["err"], (name, r0["errs"])
            assert du <= 1e-3, (name, du)
            if name in ("vcycle", "fgmres"):
                assert iters == f["max_iter"]
            else:
                assert r0["converged"], name
        f32_launches = world_results(out, "mgcg", "card",
                                     P13_RANKS)[0]["counts"][BLOCKS]
        res = world_results(out, "pair_mgcg", "pair", 2)
        r0, t = res[0], twins["mgcg"]
        u = np.load(out / "pair_mgcg.npy")
        du = float(np.abs(u - t["u"]).max() / np.abs(t["u"]).max())
        print(f"13 (b') mg-CG {P9_N}^2, 2 ranks (1x2) sharing one card: "
              f"iters {r0['iters']} (twin {t['iters']}), max error "
              f"{r0['errs'][0]:.6e}, max|u - u_twin| / max|u_twin| "
              f"{du:.3e}; {1e3 * r0['wall'] / max(r0['iters'], 1):.3f} ms "
              f"per iteration; split axes {r0['axes']}; rank 0 launches "
              f"{r0['counts']}, all-gathers {r0['gathers']}")
        for x in res:
            assert x["path"] == "cuda" and x["counts"].get(BLOCKS, 0) > 0
            assert x["iters"] == r0["iters"]
            assert set(x["gathers"]) <= {"agglomerate", "coarsest"}
            for kk in MGCG_KERNELS:
                assert x["counts"].get(kk, 0) == 0, f"1x2: {kk}"
            replicated_visits_only(x, r0["axes"])
        assert r0["converged"] and abs(r0["iters"] - t["iters"]) <= 1
        assert r0["errs"][0] <= 1.1 * t["err"] and du <= 1e-3
        assert r0["axes"][0] == [False, True], r0["axes"]
        f64_launches = 0
        for job in parity:
            name = job["name"]
            g = world_results(out, name, "card1025", P13_RANKS)[0]
            c = world_results(out, name, "cpu", P13_RANKS)[0]
            print(f"13 (c) {name} {P9_SMALL}^2/{Ls} levels, min_local 8, "
                  f"2x2: iters card {g['iters']} cpu {c['iters']}; rnorm "
                  f"card {g['rnorm']} cpu {c['rnorm']}; split axes "
                  f"{g['axes']}; card launches {g['counts']}; all-gathers "
                  f"{g['gathers']}")
            assert g["converged"] and c["converged"]
            assert g["path"] == "cuda" and c["path"] == "torch"
            assert g["axes"] == c["axes"]
            assert g["iters"] == c["iters"], name
            np.testing.assert_allclose(g["rnorm"], c["rnorm"], rtol=0.05,
                                       atol=5e-6)
            if name == "p1025_f64":
                f64_launches = g["counts"].get(BLOCKS + ".f64", 0)
                assert f64_launches > 0
                assert all(k.endswith(".f64") for k in g["counts"])
    return {BLOCKS: f32_launches, BLOCKS + ".f64": f64_launches}


def run_phase13(torch, dev, rec, main_ref):
    """Phase 13: the blocks layout."""
    torch.cuda.empty_cache()
    timed_phase(torch, "13 (a)", phase_k17_blocks, dev, rec)
    timed_phase(torch, "13 (a) K15", phase_line_blocks, dev, rec)
    return timed_phase(torch, "13 (b), (c)", phase_dist_blocks, main_ref)


# ---------------------------------------------------------------------------
# Phase 14: the blocks layout's precision outers, checkpoint, RBGS and line
# smoothers.
# ---------------------------------------------------------------------------


def p14_configs(npts: int):
    """Phase 14's solves at ``npts`` (f32 levels): name -> (config, job
    extras, the one-card phase that runs the same config at 8193^2):
    phase 11 (b)'s mixed outer, bf16 preconditioner, RBGS V-cycle, y- and
    x-line mg-CG, 10 (b)'s LINE_XY V-cycle (forced 5) and phase 4's mg-CG
    checkpointed after 2 iterations and resumed."""
    L = npts.bit_length() - 3
    base = dict(npts=npts, grids=L, levels=L, dtype="float32", rtol=1e-5,
                max_iter=100)
    p11 = p11_configs(npts)
    out = {k: p11[k] for k in ("mixed", "bf16", "rbgs", "line_y", "line_x")}
    out["bf16"] = (out["bf16"][0], {}, "8 (c)")
    out["line_xy"] = (dict(base, cycle=0, problem="aniso",
                           aniso=list(X_STRONG), smoother="line_xy",
                           max_iter=5), {}, "10 (b)")
    out["checkpoint"] = (dict(base, cycle=101), {"checkpoint": 2}, "4")
    return out


# The levels the blocks plan splits at 8193^2 (min_local 32, 2x2): 8191
# ... 127 along both axes, 63 and below replicated.
L13_SPLIT = 7


def phase_dist_blocks_smoothers(torch, main_ref):
    """14: the precision outers, the checkpoint, RBGS and the line
    smoothers under the blocks layout at full width: 4 ranks on the 2x2
    mesh sharing the card over gloo (halos staged through the host),
    8193^2 / 11 levels, f32, ``blocks_plan(min_local=32)``: the mixed
    outer to a true f64 residual of 1e-8, the bf16 preconditioner (mg-CG
    to 1e-5), an RBGS V-cycle (5), aniso (1,0,100,0,0) y-line mg-CG, aniso
    (100,0,1,0,0) x-line mg-CG, a LINE_XY V-cycle (forced 5), and phase
    4's mg-CG checkpointed after 2 iterations, loaded as each rank's block
    and resumed.  Each is held to its one-card twin, the same config on
    one card in this process (phase 4's solve for the checkpoint):
    error <= 1.1x, iterations within 1 and u within 1e-3 of max|u| (the
    resumed solve, as 10 (e): converged; the bf16 preconditioner, whose
    count follows its rounding, as 11 (b): converged, error <= 1e-2); on
    every rank ``path == "cuda"``, K17's 2-D
    block mode launched (``.bf16`` in the bf16 run, ``.f64`` for the
    mixed outer's operator), K15's 2-D block mode in the line runs, no
    K1, K2a or K4, and the all-gathers "agglomerate" and "line" alone
    (with their bytes).  Ms per iteration over gloo host staging is not a
    speed figure.  Card against CPU at 1025^2 / 8 levels, 2x2,
    ``min_local=8``: equal iterations (the bf16 preconditioner within
    1).  Returns the launches the kernels' record takes: K17 2-D bf16
    (the bf16 run, rank 0) and K15's 2-D mode (the y-line run, rank 0)."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import BLOCKS

    big = p14_configs(P9_N)
    small = p14_configs(P9_SMALL)
    Ls = P9_SMALL.bit_length() - 3
    twins = {}
    for name, (f, _, phase) in big.items():
        twins[name] = (dict(iters=main_ref["iters"], err=main_ref["err"],
                            u=main_ref["u"]) if name == "checkpoint"
                       else merged_twin(torch, f))
        t = twins[name]
        print(f"14 one-card twin {name} (phase {phase}'s config) {P9_N}^2: "
              f"iters {t['iters']}, max error {t['err']:.6e}")
    blocks = dict(layout="blocks")
    card_jobs = [dict(name=n, cfg=f, save_u=True, **blocks, **x)
                 for n, (f, x, _) in big.items()]
    par_jobs = [dict(name=n, cfg=f, min_local=8, **blocks, **x)
                for n, (f, x, _) in small.items()]
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        run_worlds([(card_jobs, "cuda", "card", P13_RANKS),
                    (par_jobs, "cpu", "cpu", P13_RANKS)], out)
        run_worlds([(par_jobs, "cuda", "card1025", P13_RANKS)], out)
        got = {}
        for name, (f, x, _) in big.items():
            res = world_results(out, name, "card", P13_RANKS)
            r0, t = res[0], twins[name]
            iters = r0["iters"]
            u = np.load(out / f"{name}.npy")
            du = float(np.abs(u - t["u"]).max() / np.abs(t["u"]).max())
            print(f"14 {name} {P9_N}^2/{f['levels']} levels, {P13_RANKS} "
                  f"ranks (2x2) sharing one card: iters {iters} (twin "
                  f"{t['iters']}), converged {r0['converged']}, path "
                  f"{r0['path']}, max error {r0['errs'][0]:.6e} (twin "
                  f"{t['err']:.6e}), max|u - u_twin| / max|u_twin| "
                  f"{du:.3e}"
                  + (f", true f64 residual {r0['true']:.6e}"
                     if r0["true"] is not None else "")
                  + (f", resumed from a checkpoint of {r0['checkpoint']}"
                     if r0["checkpoint"] else "")
                  + f"; {1e3 * r0['wall'] / max(iters, 1):.3f} ms per "
                  f"iteration (gloo host staging, not the card)")
            print(f"  residual history {r0['rnorm']}")
            print(f"  split axes per level {r0['axes']}")
            for r, x_ in enumerate(res):
                print(f"  rank {r}: launches {x_['counts']}; K17 per emit "
                      f"{x_['emits']}; all-gathers {x_['gathers']} "
                      f"({x_['gathered']} B sent)")
            k17 = BLOCKS + (".bf16" if name == "bf16" else "")
            lines = name.startswith("line")
            for x_ in res:
                assert x_["path"] == "cuda"
                assert x_["iters"] == iters and x_["rnorm"] == r0["rnorm"]
                assert x_["counts"].get(k17, 0) > 0, f"{name}: {k17}"
                if name == "mixed":
                    assert x_["counts"].get(BLOCKS + ".f64", 0) > 0
                for kk in MGCG_KERNELS:
                    assert x_["counts"].get(kk, 0) == 0, f"{name}: {kk}"
                assert set(x_["gathers"]) <= {"agglomerate", "line"}, (
                    f"{name}: {x_['gathers']}")
                assert (x_["counts"].get("line_visit9_blocks", 0) > 0) == \
                    lines, (name, x_["counts"])
                assert (x_["gathers"].get("line", 0) > 0) == lines, name
            assert r0["axes"][:L13_SPLIT] == [[True, True]] * L13_SPLIT, \
                r0["axes"]
            assert not any(map(any, r0["axes"][L13_SPLIT:])), r0["axes"]
            assert all(e == e for e in r0["errs"]), r0["errs"]
            assert r0["errs"][0] <= 1.1 * t["err"], (name, r0["errs"])
            if name == "checkpoint":  # as 10 (e) holds the resume
                assert r0["checkpoint"]["iters"] == 2
                assert r0["converged"]
            elif name == "bf16":
                # As 11 (b) holds it: the bf16 preconditioner's count at
                # 8193^2 follows its rounding (ROADMAP Queue 3: 48 on one
                # card, 29 over 2 row ranks), and its solution differs
                # from the twin's by the two errors, so the error is the
                # readout.
                assert r0["errs"][0] <= 1e-2, r0["errs"]
            else:
                assert abs(iters - t["iters"]) <= 1, (name, iters,
                                                      t["iters"])
                assert du <= 1e-3, (name, du)
            if name == "mixed":
                assert r0["true"] <= 1e-8, r0["true"]
            if name not in ("rbgs", "line_xy"):  # the V-cycles: 5 at most
                assert r0["converged"], name
            got[name] = r0["counts"]
        for name, (f, x, _) in small.items():
            g = world_results(out, name, "card1025", P13_RANKS)[0]
            c = world_results(out, name, "cpu", P13_RANKS)[0]
            print(f"14 (c) {name} {P9_SMALL}^2/{Ls} levels, min_local 8, "
                  f"2x2: iters card {g['iters']} cpu {c['iters']}; max "
                  f"error card {g['errs'][0]:.6e} cpu {c['errs'][0]:.6e}; "
                  f"split axes {g['axes']}; card launches {g['counts']}; "
                  f"all-gathers {g['gathers']}")
            assert g["path"] == "cuda" and c["path"] == "torch"
            assert g["axes"] == c["axes"]
            slack = 1 if name == "bf16" else 0
            assert abs(g["iters"] - c["iters"]) <= slack, name
            assert set(g["gathers"]) <= {"agglomerate", "line"}
    return {BLOCKS + ".bf16": got["bf16"][BLOCKS + ".bf16"],
            "line_visit9_blocks": got["line_y"]["line_visit9_blocks"]}


def run_phase14(torch, main_ref):
    """Phase 14: the blocks layout's precision outers, checkpoint, RBGS
    and line smoothers."""
    torch.cuda.empty_cache()
    return timed_phase(torch, "14", phase_dist_blocks_smoothers, main_ref)


# ---------------------------------------------------------------------------
# Phase 15: merged levels and the merged-grid cycles under the blocks
# layout.
# ---------------------------------------------------------------------------


def p15_configs():
    """Phase 15's solves (f32): name -> (config, job extras).  (a) I, E,
    D1, D2, D1PS on 2 grids at 8193^2 (8191^2 and 4095^2, both split along
    both axes of the 2x2 mesh), forced 10; (b) a V-cycle and mg-CG
    (forced 5 each) at 8193^2, grids 4 / levels 3 (level 2 merges 2047^2
    and 1023^2, both split, and 64 CG iterations solve it); (d) card
    against CPU at 1025^2 on 2x2: I and D1 with min_local 256 (1023^2
    split, 511^2 whole), phase 3c's V-cycle (forced 3) at grids 4 /
    levels 2 with min_local 128 (level 1 merges 511^2, split, with 255^2 and
    127^2, whole; CG), and mg-CG at grids 10 / levels 7 with min_local 4
    (level 6 merges 15^2, split, with 7^2, 3^2 and 1^2; solved directly,
    its split grid gathered).  (c), D1 on the 1x2 mesh, runs (a)'s D1."""
    f32 = dict(dtype="float32")
    big, small = {}, {}
    for c in P12_ONE:
        big[c] = (dict(f32, npts=P9_N, grids=2, levels=1, cycle=CYCLE_IDS[c],
                       max_iter=10, **P12_FORCED), {})
    big["vcycle"] = (dict(f32, npts=P9_N, grids=4, levels=3, cycle=0,
                          max_iter=5, **P12_FORCED), {})
    big["mgcg"] = (dict(f32, npts=P9_N, grids=4, levels=3, cycle=101,
                        max_iter=5, **P12_FORCED), {})
    for c in ("ICYCLE", "D1CYCLE"):
        small[c] = (dict(f32, npts=P9_SMALL, grids=2, levels=1,
                         cycle=CYCLE_IDS[c], max_iter=10, **P12_FORCED),
                    {"min_local": 256})
    small["vcycle"] = (dict(f32, npts=P9_SMALL, grids=4, levels=2, cycle=0,
                            max_iter=3, **P12_FORCED), {"min_local": 128})
    small["mgcg_direct"] = (dict(f32, npts=P9_SMALL, grids=10, levels=7,
                                 cycle=101, rtol=1e-5, max_iter=30),
                            {"min_local": 4})
    return big, small


def phase_dist_blocks_merged(torch):
    """15: merged levels and the merged-grid cycles under the blocks
    layout, every grid of a merged level on its own 2-D block: 4 ranks on
    the 2x2 mesh sharing the card over gloo (as phase 13 (b)),
    ``blocks_plan(min_local=32)`` unless a config names another
    (``p15_configs``).  (a) I, E, D1, D2, D1PS on 2 split grids at
    8193^2, each held to its one-card twin in this process (as 12 (a)):
    normalized histories within 1e-5 entry by entry, u within TOL_ARRAY
    of max|u|.  (b) the V-cycle and mg-CG over the split CG-solved merged
    level 2: errors and last residuals within 1.1x of the twin's.  (c) (a)'s
    D1 on the 1x2 mesh (every grid split along x alone), held as (a).  (d)
    card against CPU at 1025^2 with merged levels holding whole grids:
    equal iterations, histories rtol 0.05 + atol 5e-6 (as 12 (c)).  On
    every rank ``path == "cuda"`` and K17's 2-D mode launched; where
    every grid is split, no K6 or K7 and nothing gathered; else the
    gathers "agglomerate" and "coarsest" only.  Every run prints its
    launches per kernel and per K17 emit, its all-gathers with their
    bytes, and its ms per iteration, which measures the gloo host staging
    of the ranks on one card, not the card.  Returns rank 0's K17 2-D
    launches over (a)'s five runs."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import BLOCKS

    big, small = p15_configs()
    twins = {}
    for name, (f, _) in big.items():
        twins[name] = t = merged_twin(torch, f)
        print(f"15 one-card twin {name} {P9_N}^2 grids {f['grids']} levels "
              f"{f['levels']}: iters {t['iters']}, max error "
              f"{t['err']:.6e}, last residual {t['rnorm'][-1]:.6e}, "
              f"{1e3 * t['wall'] / max(t['iters'], 1):.3f} ms per "
              f"iteration")
    blocks = dict(layout="blocks", save_u=True)
    card_jobs = [dict(name=n, cfg=f, **blocks, **x)
                 for n, (f, x) in big.items()]
    pair_jobs = [dict(name="pair_d1", cfg=big["D1CYCLE"][0], **blocks)]
    par_jobs = [dict(name=n, cfg=f, layout="blocks", **x)
                for n, (f, x) in small.items()]
    k17 = 0
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        # The full-width 2x2 world alone (its ms per iteration), then the
        # others side by side.
        run_worlds([(card_jobs, "cuda", "card", P13_RANKS)], out)
        run_worlds([(pair_jobs, "cuda", "pair", 2),
                    (par_jobs, "cuda", "card1025", P13_RANKS),
                    (par_jobs, "cpu", "cpu", P13_RANKS)], out)
        runs = [(n, f, "card", P13_RANKS, n) for n, (f, _) in big.items()]
        runs.append(("pair_d1", big["D1CYCLE"][0], "pair", 2, "D1CYCLE"))
        for name, f, label, ranks, twin in runs:
            res = world_results(out, name, label, ranks)
            r0, t = res[0], twins[twin]
            iters = r0["iters"]
            u = np.load(out / f"{name}.npy")
            du = float(np.abs(u - t["u"]).max() / np.abs(t["u"]).max())
            dh = float(np.abs(np.asarray(r0["rnorm"]) - t["rnorm"]).max())
            part = ("c" if ranks == 2 else "a" if name in P12_ONE else "b")
            mesh = "1x2" if ranks == 2 else "2x2"
            print(f"15 ({part}) {name} {P9_N}^2 grids {f['grids']} levels "
                  f"{f['levels']}, {ranks} ranks ({mesh}) sharing one "
                  f"card: iters {iters} (twin {t['iters']}), path "
                  f"{r0['path']}, max error {r0['errs'][0]:.6e} (twin "
                  f"{t['err']:.6e}), last residual {r0['rnorm'][-1]:.6e} "
                  f"(twin {t['rnorm'][-1]:.6e}), max|history diff| "
                  f"{dh:.3e}, max|u - u_twin| / max|u_twin| {du:.3e}; "
                  f"{1e3 * r0['wall'] / max(iters, 1):.3f} ms per "
                  f"iteration (gloo host staging, not the card)")
            print(f"  residual history {r0['rnorm']}")
            print(f"  split axes per level and grid {r0['grid_axes']}")
            for r, x in enumerate(res):
                print(f"  rank {r}: launches {x['counts']}; K17 per emit "
                      f"{x['emits']}; all-gathers {x['gathers']} "
                      f"({x['gathered']} B sent)")
            axes = [True, True] if ranks == 4 else [False, True]
            assert all(a == axes for lv in r0["grid_axes"] for a in lv), \
                r0["grid_axes"]
            for x in res:
                assert x["path"] == "cuda"
                assert x["iters"] == iters and x["rnorm"] == r0["rnorm"]
                assert x["counts"].get(BLOCKS, 0) > 0, name
                assert x["counts"][BLOCKS] == sum(
                    v for e, v in x["emits"].items() if ".blocks" in e)
                # Every grid is split: no K6 or K7, nothing gathered.
                for kk in ("apply_stencil5", "smooth_sweeps", *MGCG_KERNELS):
                    assert x["counts"].get(kk, 0) == 0, f"{name}: {kk}"
                assert not x["gathers"], f"{name}: {x['gathers']}"
            assert all(e == e for e in r0["errs"]), r0["errs"]
            assert iters == t["iters"] == f["max_iter"], (name, iters)
            if part == "b":
                assert r0["errs"][0] <= 1.1 * t["err"], (name, r0["errs"])
                assert r0["rnorm"][-1] <= 1.1 * t["rnorm"][-1], name
            else:
                assert dh <= 1e-5, dh
                assert du <= TOL_ARRAY, du
            if part == "a":
                k17 += r0["counts"][BLOCKS]
        for name, (f, x) in small.items():
            g = world_results(out, name, "card1025", P13_RANKS)[0]
            c = world_results(out, name, "cpu", P13_RANKS)[0]
            print(f"15 (d) {name} {P9_SMALL}^2 grids {f['grids']} levels "
                  f"{f['levels']}, min_local {x['min_local']}, 2x2: iters "
                  f"card {g['iters']} cpu {c['iters']}; max error card "
                  f"{g['errs'][0]:.6e} cpu {c['errs'][0]:.6e}; split axes "
                  f"{g['grid_axes']}; card launches {g['counts']}, K17 per "
                  f"emit {g['emits']}; all-gathers {g['gathers']} "
                  f"({g['gathered']} B sent); "
                  f"{1e3 * g['wall'] / max(g['iters'], 1):.3f} ms per "
                  f"iteration")
            assert g["path"] == "cuda" and c["path"] == "torch"
            assert g["grid_axes"] == c["grid_axes"]
            assert any(a == [False, False] for lv in g["grid_axes"]
                       for a in lv), g["grid_axes"]
            assert g["iters"] == c["iters"], name
            np.testing.assert_allclose(g["rnorm"], c["rnorm"], rtol=0.05,
                                       atol=5e-6)
            assert g["counts"].get(BLOCKS, 0) > 0, name
            assert set(g["gathers"]) <= {"agglomerate", "coarsest"}
            if name == "mgcg_direct":
                assert g["converged"] and g["gathers"].get("coarsest", 0)
            else:  # a split grid restricted onto a whole one
                assert g["gathers"].get("agglomerate", 0) > 0
                assert g["counts"].get("apply_stencil5", 0) > 0, name
    return k17


def run_phase15(torch):
    """Phase 15: merged levels and the merged-grid cycles under the blocks
    layout."""
    torch.cuda.empty_cache()
    return timed_phase(torch, "15", phase_dist_blocks_merged)


# ---------------------------------------------------------------------------
# Phase 16: the blocks layout on any rank count (uneven blocks).
# ---------------------------------------------------------------------------

# (a): the (my, mx) meshes the 8191^2 level and a ragged 1119^2 one are
# cut on, as a solve's plan cuts them (min_local 32: nested even blocks,
# 8191 + 1 over 3 ranks 2816 + 2688 + 2688, 1119 + 1 384 + 368 + 368).
P16_MESHES = ((1, 3), (2, 3), (3, 2))
P16_SIZES = (8191, 1119)
P16_MIN_LOCAL = 32


def p16_sides(n: int, m: int) -> tuple:
    """The extents of an n-point axis over m ranks under the blocks plan
    (``device_mesh.block_sides``; one whole block on an axis not split)."""
    from multigrid_petsc_tpu_torch.parallel.device_mesh import block_sides

    if m > 1 and n // m >= P16_MIN_LOCAL:
        return block_sides(n, m, P16_MIN_LOCAL)
    return (n,)


def uneven_blocks(x, ys, xs, h):
    """x's blocks of ``ys`` rows (by mesh row) and ``xs`` columns (by mesh
    column), each with its depth-h ring cut from its neighbours (zeros
    past the edges): [(row0, col0, block, Halo2)] in rank order."""
    from multigrid_petsc_tpu_torch.parallel.block_ops import cut_halo

    out, r0 = [], 0
    for R in ys:
        c0 = 0
        for C in xs:
            out.append((r0, c0, *cut_halo(x, r0, c0, R, C, h)))
            c0 += C
        r0 += R
    return out


def phase_k17_uneven(torch, dev, rec):
    """16 (a): K17's 2-D block mode on uneven blocks in one process: the
    8191^2 level and a ragged 1119^2 one cut as the blocks plan cuts them
    on 1x3, 2x3 and 3x2 meshes (``p16_sides``), each block's ring cut from
    its neighbours; the 5-point and the aniso (1,1,1,2,0.4) 9-point visit,
    zero-guess rc, u, correct + ur (Jacobi k = 3), a and r, in f32, f64
    and bf16.  The stitched blocks are held to the whole-grid kernel of
    the same flags and to the plain block version (TOL_ARRAY of
    max|plain|; bf16 one bf16 ulp); the pad row and column must be
    exactly 0.  Device time (``device_ms``) of the largest block (block 0
    of the 1x3 cut of 8191^2, 8191 x 2816) for the f32 5-point a, r and
    zero-guess rc, beside the same on 13 (a)'s even 4096^2 block (block 1
    of the 2x2 cut), per call and per million points."""
    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel as dk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.parallel.block_ops import _cut_coeffs
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
        stencil_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    jac = jacobi_step_coeffs(3, 0.8)
    gen = torch.Generator(device=dev).manual_seed(1616)
    modes = (  # label, guess, steps, emit, correct
        ("zero-guess rc", False, jac, "rc", False),
        ("u", True, jac, "u", False),
        ("correct + ur", True, jac, "ur", True),
        ("a", True, (), "a", False),
        ("r", True, (), "r", False),
    )
    timed = {}
    for dt, sfx in ((torch.float32, ""), (torch.float64, ".f64"),
                    (torch.bfloat16, ".bf16")):
        key = dk.BLOCKS + sfx
        rec.setdefault(key, {})
        for n in P16_SIZES:
            nxc = (n - 1) // 2
            b = torch.randn((n, n), generator=gen, device=dev).to(dt)
            u = torch.randn((n, n), generator=gen, device=dev).to(dt)
            e = torch.randn((nxc, nxc), generator=gen, device=dev).to(dt)
            for sname, st in (
                    ("5-point", stencil_coefficients(MeshType.UNIFORM, n, n,
                                                     dt, dev)),
                    ("9-point", stencil9_coefficients(
                        AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), n, n, dt,
                        dev))):
                nine = isinstance(st, Stencil9)
                for label, guess, steps, emit, correct in modes:
                    k = len(steps)
                    h = dk.halo_rows(k, emit)
                    hc = dk.coarse_halo_rows(h)
                    if emit == "a":
                        ref = ((k9.apply_stencil9 if nine else
                                sk.apply_stencil5)(st, u),)
                    elif emit == "r":
                        ref = ((k9.residual9 if nine else sk.residual5)(
                            st, b, u),)
                    else:
                        ref = (k9.fused_level_visit9 if nine else
                               sk.fused_level_visit)(
                            st, b, u if guess else None, steps, emit,
                            e if correct else None)
                        ref = ref if isinstance(ref, tuple) else (ref,)
                    for my, mx in P16_MESHES:
                        ys, xs = p16_sides(n, my), p16_sides(n, mx)
                        bb = uneven_blocks(b, ys, xs, h)
                        ub = uneven_blocks(u, ys, xs, h)
                        eb = uneven_blocks(e, [r // 2 for r in ys],
                                           [c // 2 for c in xs], hc)
                        m = k + 2  # the coefficients a rank keeps

                        def args(p):
                            r0, c0, blk = bb[p][:3]
                            R, C = blk.shape
                            cr0, cc0 = max(0, r0 - m), max(0, c0 - m)
                            stp = (_cut_coeffs(st, cr0, min(n, r0 + R + m),
                                               cc0, min(n, c0 + C + m))
                                   if nine else st)
                            return (stp, None if emit == "a" else blk,
                                    ub[p][2] if guess else None, steps,
                                    emit), \
                                dict(row0=r0, col0=c0, ny=n, nx=n,
                                     b_halo=bb[p][3], u_halo=ub[p][3],
                                     e=eb[p][2] if correct else None,
                                     e_halo=eb[p][3] if correct else None,
                                     coeff_row0=cr0 if nine else 0,
                                     coeff_col0=cc0 if nine else 0)

                        calls = [args(p) for p in range(my * mx)]

                        def run(fn):
                            outs = [fn(*a, **kw) for a, kw in calls]
                            return stitch(torch, [o if isinstance(o, tuple)
                                                  else (o,) for o in outs],
                                          my, mx)

                        tag = (f"16 (a) K17 2-D {sname} {label} {dt} "
                               f"{n}^2 {my}x{mx} blocks {ys} x {xs}"
                               ).replace("torch.", "")
                        got, want = run(dk.block_visit), run(
                            dk.block_visit_plain)
                        for g, w, wh in zip(got, want, ref):
                            ry, rx = wh.shape
                            for x, what in ((g, "kernel"), (w, "plain")):
                                assert bool((x[ry:] == 0).all()), \
                                    f"{tag}: {what} pad row"
                                assert bool((x[:, rx:] == 0).all()), \
                                    f"{tag}: {what} pad column"
                            compare(torch, f"{tag} vs plain", g, w,
                                    rec[key])
                            compare(torch, f"{tag} vs whole-grid kernel",
                                    g[:ry, :rx], wh, {})
                        if (n == 8191 and dt == torch.float32 and not nine
                                and (my, mx) == (1, 3)
                                and label in ("zero-guess rc", "a", "r")):
                            a0, kw0 = calls[0]
                            dms = device_ms(torch, lambda: dk.block_visit(
                                *a0, **kw0))
                            R, C = bb[0][2].shape
                            timed[label] = dict(
                                block=[R, C], device_ms=dms,
                                ms_per_mpoint=1e6 * dms / (R * C))
                        del got, want, bb, ub, eb, calls
                    del ref
                del st
            del b, u, e
            torch.cuda.empty_cache()
    # 13 (a)'s even block beside the largest uneven one, in this process.
    n = 8191
    b = torch.randn((n, n), generator=gen, device=dev)
    u = torch.randn((n, n), generator=gen, device=dev)
    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, dev)
    for label, guess, steps, emit, _ in modes:
        if label not in timed:
            continue
        h = dk.halo_rows(len(steps), emit)
        r0, c0, bb, bh = k17_2d_blocks(b, 2, 2, h)[1]
        ubk, uh = k17_2d_blocks(u, 2, 2, h)[1][2:]
        R, C = bb.shape
        dms = device_ms(torch, lambda: dk.block_visit(
            st, None if emit == "a" else bb, ubk if guess else None, steps,
            emit, row0=r0, col0=c0, ny=n, nx=n, b_halo=bh, u_halo=uh))
        timed[label].update(even_block=[R, C], even_device_ms=dms,
                            even_ms_per_mpoint=1e6 * dms / (R * C))
        t = timed[label]
        print(f"16 (a) K17 2-D 5-point {label} f32, device time: largest "
              f"uneven block {t['block']} {t['device_ms']:.4f} ms "
              f"({t['ms_per_mpoint']:.5f} ms per Mpoint); 13 (a)'s even "
              f"block {t['even_block']} {dms:.4f} ms "
              f"({t['even_ms_per_mpoint']:.5f} ms per Mpoint)")
    rec[dk.BLOCKS]["uneven"] = timed
    del b, u, st
    torch.cuda.empty_cache()


def phase_line_uneven(torch, dev, rec):
    """16 (a): K15's 2-D block mode on uneven blocks: the 8191^2 level and
    the ragged 1119^2 one cut on 1x3, 2x3 and 3x2 meshes as the blocks
    plan cuts them, y- and x-lines (``line_block_sweeps``) on aniso
    (1,0,100,0,0) / (100,0,1,0,0) (the packed per-row table; the strong
    direction along the lines) in f32, and (1,1,1,2,0.4) (factor fields)
    on the 1x3 cut: one sweep of the stitched blocks held to the stitched
    plain blocks, the whole-grid plain sweep and the whole-grid kernel
    (TOL_LINE of max|plain|), the pads exactly 0.  Block 0's launches
    alone as device time (``line_launch_ms``), over unequal segment
    counts (the x-lines of the 1x3 cut of 8191^2: 88, 84 and 84 segments)
    and over equal ones (the y-lines of the 2x3 cut: 128 and 128), and
    the stacking of the gathered ends as one piece (``stack_lines``),
    which the gather's own copy does."""
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.ops.stencil import transpose_stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )

    key = "line_visit9_blocks"
    rec.setdefault(key, {})
    gen = torch.Generator(device=dev).manual_seed(1717)
    for n in P16_SIZES:
        b = torch.randn((n, n), generator=gen, device=dev)
        u = torch.randn((n, n), generator=gen, device=dev)
        for pname, prob, meshes in (
                ("strong", None, P16_MESHES),
                ("(1,1,1,2,0.4)", (1.0, 1.0, 1.0, 2.0, 0.4), ((1, 3),))):
            for axis, lname in ((0, "y-lines"), (1, "x-lines")):
                p = prob or ((1.0, 0.0, 100.0, 0.0, 0.0) if axis == 0
                             else X_STRONG)
                st9 = stencil9_coefficients(AnisoProblem(*p), n, n,
                                            torch.float32, dev)
                st = lk.collapse_stencil(transpose_stencil9(st9) if axis
                                         else st9)
                bt, ut = ((b.T.contiguous(), u.T.contiguous()) if axis
                          else (b, u))
                whole = lk.line_visit9_plain(st, bt, ut, 1, P11_OMEGA)
                whole_k = lk.line_visit9(st, bt, ut, 1, P11_OMEGA)
                if axis:
                    whole, whole_k = whole.T, whole_k.T
                del bt, ut
                for my, mx in meshes:
                    sides = (p16_sides(n, my), p16_sides(n, mx))
                    tag = (f"16 (a) K15 2-D {lname} aniso {pname} {n}^2, "
                           f"{my}x{mx} blocks {sides[0]} x {sides[1]}, f32")
                    sweep, calls = line_block_sweeps(
                        torch, lk, st, b, u, my, mx, axis, False, sides)
                    psweep, _ = line_block_sweeps(
                        torch, lk, st, b, u, my, mx, axis, True, sides)
                    got, want = sweep(), psweep()
                    for x, what in ((got, "kernel"), (want, "plain")):
                        assert bool((x[n:] == 0).all()), f"{tag}: {what}"
                        assert bool((x[:, n:] == 0).all()), f"{tag}: {what}"
                    compare(torch, f"{tag} vs plain", got, want, rec[key],
                            TOL_LINE)
                    compare(torch, f"{tag} vs whole-grid plain (PCR)",
                            got[:n, :n], whole, {}, TOL_LINE)
                    compare(torch, f"{tag} vs whole-grid kernel",
                            got[:n, :n], whole_k, {}, TOL_LINE)
                    timed = {((1, 3), 1): "uneven", ((2, 3), 0): "even"}.get(
                        ((my, mx), axis))
                    if n == 8191 and prob is None and timed:
                        lf = calls[0][0]
                        group = [lk.line_rows_begin(*c[:4]) for c in (
                            calls[::mx] if axis == 0 else calls[:mx])]
                        t_stack = device_ms(
                            torch, lambda: lk.stack_lines(lf, group))
                        split = line_launch_ms(torch, lk, *calls[0])
                        rec[key].setdefault("uneven", {})[timed] = dict(
                            block=list(calls[0][1].shape),
                            segments=list(lf.counts), stack_ms=t_stack,
                            launch_ms=split)
                        print(f"  {tag}: block 0 {list(calls[0][1].shape)} "
                              + ("(transposed), " if axis else "")
                              + f"segments {list(lf.counts)}: device time "
                              f"of the launches {split}; stacking the "
                              f"gathered ends {t_stack:.4f} ms")
                    del sweep, psweep, calls, got, want
                    torch.cuda.empty_cache()
                del whole, whole_k, st, st9
        del b, u
        torch.cuda.empty_cache()


def p16_configs():
    """Phase 16 (b)'s solves at 8193^2 (f32): name -> (config, the (my,
    mx) mesh).  mg-CG is phase 4's config on 2x3 and on 1x3, a V-cycle
    forced 5 on 2x3, aniso (1,0,100,0,0) y-line mg-CG forced 3 on 3x2
    (the y-lines across three unequal blocks), aniso (100,0,1,0,0) x-line
    mg-CG forced 3 on 2x3 (the x-lines across three), D1 on 2 grids forced
    10 on 1x3 (both grids split into unequal blocks)."""
    L = P9_N.bit_length() - 3
    base = dict(npts=P9_N, grids=L, levels=L, dtype="float32", rtol=1e-5,
                max_iter=100)
    forced = dict(rtol=1e-30, divtol=1e30)
    lines = dict(base, cycle=101, problem="aniso", max_iter=3, **forced)
    return {
        "mgcg6": (dict(base, cycle=101), (2, 3)),
        "vcycle6": (dict(base, cycle=0, max_iter=5, **forced), (2, 3)),
        "yline6": (dict(lines, aniso=[1.0, 0.0, 100.0, 0.0, 0.0],
                        smoother="line_y"), (3, 2)),
        "xline6": (dict(lines, aniso=list(X_STRONG), smoother="line_x"),
                   (2, 3)),
        "mgcg3": (dict(base, cycle=101), (1, 3)),
        "d1_3": (dict(npts=P9_N, grids=2, levels=1, dtype="float32",
                      cycle=CYCLE_IDS["D1CYCLE"], max_iter=10,
                      **P12_FORCED), (1, 3)),
    }


def phase_dist_uneven(torch, main_ref):
    """16 (b), (c): the blocks layout on 3 and 6 ranks sharing the card
    over gloo (halos and gathers staged through the host, as phases 13-15),
    ``blocks_plan(min_local=32)``, 8193^2: ``p16_configs``, each held to
    its one-card twin (phase 4's solve for mg-CG, the others in this
    process) with phases 13-15's bounds: iterations within 1 (forced
    counts equal), error <= 1.1x the twin's, D1's history within 1e-5
    and u within TOL_ARRAY of max|u|.  On every rank ``path == "cuda"``,
    K17's 2-D mode launched, K15's 2-D mode in the line runs, no K1, K2a
    or K4, and the all-gathers "agglomerate", "coarsest", "line" and
    "solution" only; the split axes per level and the blocks of level 0
    printed.  (c): 1025^2 mg-CG on 3 ranks (1x3, min_local 32: 1023^2 and
    511^2 split along x, 340 + 342 + 342 columns ... ), card against CPU:
    equal iterations, histories rtol 0.05 + atol 5e-6.  Ms per iteration
    here measure gloo's host staging of ranks that share one card, not
    the card."""
    import tempfile
    from pathlib import Path

    import numpy as np

    from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import BLOCKS

    big = p16_configs()
    twins = {}
    for name, (f, _) in big.items():
        if name.startswith("mgcg"):
            twins[name] = dict(iters=main_ref["iters"], err=main_ref["err"],
                               u=main_ref["u"])
        else:
            twins[name] = merged_twin(torch, f)
        t = twins[name]
        print(f"16 one-card twin {name} {P9_N}^2: iters {t['iters']}, max "
              f"error {t['err']:.6e}")
    jobs = {6: [], 3: []}
    for name, (f, mesh) in big.items():
        jobs[mesh[0] * mesh[1]].append(dict(
            name=name, cfg=f, layout="blocks", mesh=list(mesh),
            save_u=True))
    Ls = P9_SMALL.bit_length() - 3
    parity = [dict(name="p1025", cfg=dict(npts=P9_SMALL, grids=Ls,
                                          levels=Ls, cycle=101,
                                          dtype="float32", rtol=1e-5,
                                          max_iter=100),
                   layout="blocks", mesh=[1, 3])]
    allowed = {"agglomerate", "coarsest", "line", "solution"}
    with tempfile.TemporaryDirectory() as tmp:
        out = Path(tmp)
        run_worlds([(jobs[6], "cuda", "card6", 6)], out)
        run_worlds([(jobs[3], "cuda", "card3", 3),
                    (parity, "cuda", "card1025", 3),
                    (parity, "cpu", "cpu", 3)], out)
        for name, (f, mesh) in big.items():
            ranks = mesh[0] * mesh[1]
            res = world_results(out, name, f"card{ranks}", ranks)
            r0, t = res[0], twins[name]
            iters = r0["iters"]
            u = np.load(out / f"{name}.npy")
            du = float(np.abs(u - t["u"]).max() / np.abs(t["u"]).max())
            print(f"16 (b) {name} {P9_N}^2 grids {f['grids']} levels "
                  f"{f['levels']}, {ranks} ranks ({mesh[0]}x{mesh[1]}) "
                  f"sharing one card: iters {iters} (twin {t['iters']}), "
                  f"path {r0['path']}, max error {r0['errs'][0]:.6e} (twin "
                  f"{t['err']:.6e}), max|u - u_twin| / max|u_twin| "
                  f"{du:.3e}; {1e3 * r0['wall'] / max(iters, 1):.3f} ms "
                  f"per iteration (gloo host staging of {ranks} ranks on "
                  f"one card, not the card)")
            print(f"  residual history {r0['rnorm']}")
            print(f"  split axes per level {r0['grid_axes']}; blocks of "
                  f"level 0 {r0['blocks0']}")
            for r, x in enumerate(res):
                print(f"  rank {r}: launches {x['counts']}; K17 per emit "
                      f"{x['emits']}; all-gathers {x['gathers']} "
                      f"({x['gathered']} B sent); peak "
                      f"{x['peak_gib']:.2f} GiB")
            lines = "line" in name
            for x in res:
                assert x["path"] == "cuda", name
                assert x["iters"] == iters and x["rnorm"] == r0["rnorm"]
                assert x["counts"].get(BLOCKS, 0) > 0, name
                for kk in MGCG_KERNELS:
                    assert x["counts"].get(kk, 0) == 0, f"{name}: {kk}"
                assert set(x["gathers"]) <= allowed, (name, x["gathers"])
                assert (x["counts"].get("line_visit9_blocks", 0) > 0) == \
                    lines, (name, x["counts"])
            assert any(map(any, r0["axes"])), r0["axes"]
            assert r0["axes"][0] == [mesh[0] > 1, True], r0["axes"]
            assert all(e == e for e in r0["errs"]), r0["errs"]
            assert r0["errs"][0] <= 1.1 * t["err"], (name, r0["errs"])
            assert abs(iters - t["iters"]) <= 1, (name, iters, t["iters"])
            if f.get("rtol", 1.0) > 1e-20:
                assert r0["converged"], name
            else:
                assert iters == f["max_iter"], (name, iters)
            if name == "d1_3":
                dh = float(np.abs(np.asarray(r0["rnorm"])
                                  - t["rnorm"]).max())
                print(f"  max|history diff| {dh:.3e}")
                assert dh <= 1e-5, dh
                assert du <= TOL_ARRAY, du
            else:
                assert du <= 1e-3, (name, du)
        g = world_results(out, "p1025", "card1025", 3)[0]
        c = world_results(out, "p1025", "cpu", 3)[0]
        print(f"16 (c) mg-CG {P9_SMALL}^2/{Ls} levels, 3 ranks (1x3): iters "
              f"card {g['iters']} cpu {c['iters']}; rnorm card {g['rnorm']} "
              f"cpu {c['rnorm']}; split axes {g['axes']}; blocks of level 0 "
              f"{g['blocks0']}; card launches {g['counts']}; all-gathers "
              f"{g['gathers']}")
        assert g["converged"] and c["converged"]
        assert g["path"] == "cuda" and c["path"] == "torch"
        assert g["axes"] == c["axes"] and any(map(any, g["axes"]))
        assert g["iters"] == c["iters"]
        np.testing.assert_allclose(g["rnorm"], c["rnorm"], rtol=0.05,
                                   atol=5e-6)


def run_phase16(torch, dev, rec, main_ref):
    """Phase 16: the blocks layout on any rank count."""
    torch.cuda.empty_cache()
    timed_phase(torch, "16 (a) K17", phase_k17_uneven, dev, rec)
    timed_phase(torch, "16 (a) K15", phase_line_uneven, dev, rec)
    timed_phase(torch, "16 (b), (c)", phase_dist_uneven, main_ref)


def partial_run(torch, dev, parts) -> int:
    """``chip_smoke.py --only 9a,10``: the build, then only the phases
    named (k18: phase 1's K18a; 9a: K17's blocks and their split visits;
    9b: the distributed runs; 10: phase 10;
    11a: K17 in bf16 (phase 2d's check) and 11 (a); k15: K15's one-card
    checks at 8191^2 (phase 2's), 11 (a) and 13 (a)'s K15; 11: phase 11; 12:
    phase 12; 13a: K17's 2-D block mode and K15's; 13: phase 13; 14:
    phase 14; 15: phase 15; 16a: phase 16 (a); 16: phase 16), with phase
    4 first where they read it; no result line, so a partial run never
    passes for a whole one."""
    main_ref = None
    if {"9b", "10", "13", "14", "16"} & set(parts):
        _, u_ref, main_ref = phase_main(torch)
        main_ref["u"] = u_ref.cpu().numpy()
        del u_ref
    if "k18" in parts or "1b" in parts:
        rec = {}
        stream = timed_phase(torch, "1 (K18a)", phase_stream, dev, rec)
        if "1b" in parts:
            timed_phase(torch, "1b (K18b)", phase_probes, dev, rec, stream)
        print(json.dumps(rec))
    if "9a" in parts:
        rec = {}
        timed_phase(torch, "9 (a)", phase_k17, dev, rec)
        print(json.dumps(rec["dist_level_visit"]))
    if "9b" in parts:
        timed_phase(torch, "9 (b), (c)", phase_dist, main_ref)
    if "10" in parts:
        run_phase10(torch, main_ref)
    if "11a" in parts:
        rec = {}
        timed_phase(torch, "2d K17 bf16", phase_k17, dev, rec, ("bf16",))
        timed_phase(torch, "11 (a)", phase_line_rows, dev, rec)
        print(json.dumps(rec))
    if "11" in parts:
        rec = {}
        print(run_phase11(torch, dev, rec))
        print(json.dumps(rec))
    if "12" in parts:
        print(f"12 (a) rank 0 K17 launches: {run_phase12(torch)}")
    if "k15" in parts:
        rec = {}
        timed_phase(torch, "2 K15", phase_line_card, dev, rec)
        timed_phase(torch, "11 (a)", phase_line_rows, dev, rec)
        timed_phase(torch, "13 (a) K15", phase_line_blocks, dev, rec)
        print(json.dumps(rec))
    if "13a" in parts:
        rec = {}
        timed_phase(torch, "13 (a)", phase_k17_blocks, dev, rec)
        timed_phase(torch, "13 (a) K15", phase_line_blocks, dev, rec)
        print(json.dumps(rec))
    if "13" in parts:
        rec = {}
        print(run_phase13(torch, dev, rec, main_ref))
        print(json.dumps(rec))
    if "14" in parts:
        print(run_phase14(torch, main_ref))
    if "15" in parts:
        print(f"15 (a) rank 0 K17 2-D launches: {run_phase15(torch)}")
    if "16a" in parts:
        rec = {}
        timed_phase(torch, "16 (a) K17", phase_k17_uneven, dev, rec)
        timed_phase(torch, "16 (a) K15", phase_line_uneven, dev, rec)
        print(json.dumps(rec))
    if "16" in parts:
        rec = {}
        run_phase16(torch, dev, rec, main_ref)
        print(json.dumps(rec))
    print(f"partial run {parts}: no result line")
    return 0


def timed_phase(torch, name, fn, *args):
    """Run one phase; print its seconds (set-up included) and the peak
    device memory it reached."""
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = fn(torch, *args)
    torch.cuda.synchronize()
    print(f"phase {name}: {time.perf_counter() - t0:.2f} s, peak device "
          f"memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    return out


def main() -> int:
    if sys.argv[1:2] == ["--rank"]:  # one rank of phase 9's worlds
        return rank_worker(sys.argv[2:])
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    from multigrid_petsc_tpu_torch.ops.cuda._build import BUILD_DIR, load_library
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SmootherType

    t0 = time.perf_counter()
    load_library()
    print(f"build + load of the CUDA kernels: {time.perf_counter() - t0:.2f} s")
    log = BUILD_DIR / "build.log"
    if log.exists():
        text = log.read_text()
        for line in ptxas_summary(text):
            print("  ptxas: " + line)
        print("  " + "; ".join(ln for ln in text.splitlines()
                               if ln.startswith("nvcc ")))
    dev = torch.device("cuda")
    # The library yardstick (conv2d) in full f32, as the kernels compute.
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print(f"device: {torch.cuda.get_device_name(0)}")
    print(f"nvidia-smi: {smi}")
    rate = copy_rate(torch)
    print(f"copy rate {rate / 1e9:.1f} GB/s on {smi}")
    if sys.argv[1:2] == ["--only"]:
        return partial_run(torch, dev, sys.argv[2].split(","))

    rec = {}
    stream = timed_phase(torch, "1 (K18a)", phase_stream, dev, rec)
    timed_phase(torch, "1b (K18b)", phase_probes, dev, rec, stream)
    rec.update(timed_phase(torch, "2", phase_kernels, dev, rate))
    timed_phase(torch, "2 (V-cycle family)", phase_kernels_vcycle, dev, rec)
    timed_phase(torch, "2b", phase_kernels_9pt, dev, rec)
    torch.cuda.empty_cache()
    timed_phase(torch, "2c", phase_kernels_sparse, dev, rec)
    timed_phase(torch, "2d", phase_kernels_precision, dev, rec)
    torch.cuda.empty_cache()
    jac, cheb = SmootherType.JACOBI, SmootherType.CHEBYSHEV
    timed_phase(torch, "3", phase_parity, (  # cycle, smoother, max_iter,
        # extra, atol
        (CycleType.MGCG, jac, 100, {}, 5e-6),
        (CycleType.MGCG, cheb, 100, {}, 5e-6),
        (CycleType.VCYCLE, jac, 6, {}, 5e-6),
        (CycleType.VCYCLE, cheb, 6, {}, 5e-6),
        (CycleType.VCYCLE, jac, 4, {"v": (8, 8)}, 5e-6),
        (CycleType.PCMG, jac, 6, {}, 5e-6),
        (CycleType.FMG, jac, 4, {}, 5e-6),
        (CycleType.ADDITIVE, jac, 6, {}, 5e-6),
    ))
    mixed = {"aniso": (1.0, 1.0, 1.0, 2.0, 0.4)}
    # The 9-point runs' absolute floors, from their measured f32 noise
    # (an H100 against the CPU): BASELINE config 4 solves its lines by
    # Thomas's recurrence on the card and by f32 PCR on the CPU, and on
    # its nearly singular line systems PCG's f32 recursive residual
    # carries that difference (after one iteration: CPU f32 PCR 0.0215,
    # card 0.0128, the f64 solve 0.0087), so 2e-2; mg-FGMRES
    # and the V-cycle test the true residual, whose f32 floor the card's
    # FMA rounding moves (mg-FGMRES 0.0129 vs 0.0120 just above its floor
    # of 0.0087; the V-cycle's floor 0.0058 vs 0.0082), so 2e-3 and 5e-3.
    # The counts and the solutions are held as everywhere.
    timed_phase(torch, "3b", phase_parity, (
        (CycleType.MGCG, jac, 100, mixed, 5e-6),
        (CycleType.MGCG, SmootherType.LINE_Y, 100,
         {"aniso": (1.0, 0.0, 100.0, 0.0, 0.0)}, 2e-2),
        (CycleType.MGFGMRES, jac, 4, {"aniso": (1.0, 0.0, 1.0, 0.0, 0.4)},
         2e-3),
        (CycleType.VCYCLE, jac, 6, mixed, 5e-3),
    ), {"problem": "aniso"})
    timed_phase(torch, "3c", phase_parity_zoo)
    p3d_counts = timed_phase(torch, "3d", phase_parity_precision)
    counts, u_ref, main_ref = timed_phase(torch, "4", phase_main)
    vcounts = timed_phase(torch, "5", phase_vcycle, u_ref)
    main_ref["u"] = u_ref.cpu().numpy()  # phase 9 (b)'s reference
    del u_ref
    acounts = timed_phase(torch, "6", phase_aniso)
    k8_counts, k16_counts = timed_phase(torch, "7", phase_zoo)
    p8_counts = timed_phase(torch, "8", phase_precision)
    torch.cuda.empty_cache()
    timed_phase(torch, "9 (a)", phase_k17, dev, rec)
    counts.update(timed_phase(torch, "9 (b), (c)", phase_dist, main_ref))
    run_phase10(torch, main_ref)
    counts.update(run_phase11(torch, dev, rec))
    merged_k17 = run_phase12(torch)
    counts.update(run_phase13(torch, dev, rec, main_ref))
    counts.update(run_phase14(torch, main_ref))
    merged_blocks_k17 = run_phase15(torch)
    run_phase16(torch, dev, rec, main_ref)
    for k in ("apply_stencil5", "smooth_sweeps", "fused_level_visit",
              "residual5"):
        counts[k] = vcounts[k]
    for k in ("apply_stencil9", "residual9", "smooth9_sweeps",
              "fused_level_visit9", "line_visit9"):
        counts[k] = acounts[k]
    for k in ("apply_stencil5_field", "residual5_field"):
        counts[k] = k8_counts[k]
    counts["dia_spmv"] = k16_counts["dia_spmv"]

    src = "multigrid_petsc_tpu_torch/csrc/"
    tpu = "multigrid_petsc_tpu/ops/pallas/"
    meta = {  # launches: phase 4 for K1-K4, 5 for K6-K9, 6 for K12-K15,
        # 7 (a) for K8, 7 (c)'s D1 run for K16
        "cg_papply_u": ("visit.cu", "mdma_kernel.py:973"),
        "cg_visit_down": ("visit.cu", "mdma_kernel.py:471"),
        "visit_down": ("visit.cu", "mdma_kernel.py:628"),
        "visit_up": ("visit.cu", "mdma_kernel.py:796"),
        "coarse_tree": ("coarse_tree.cu", "coarse_tree_kernel.py:92"),
        "apply_stencil5": ("visit.cu", "stencil_kernel.py:141"),
        "smooth_sweeps": ("visit.cu", "stencil_kernel.py:286"),
        "fused_level_visit": ("visit.cu", "stencil_kernel.py:687"),
        "residual5": ("visit.cu", "stencil_kernel.py:846"),
        "apply_stencil9": ("visit.cu", "stencil9_kernel.py:178"),
        "residual9": ("visit.cu", "stencil9_kernel.py:211"),
        "smooth9_sweeps": ("visit.cu", "stencil9_kernel.py:266"),
        "fused_level_visit9": ("visit.cu", "stencil9_kernel.py:429"),
        "line_visit9": ("line.cu", "line_kernel.py:208"),
        "apply_stencil5_field": ("visit.cu", "stencil_kernel.py:427"),
        "residual5_field": ("visit.cu", "stencil_kernel.py:427"),
        "dia_spmv": ("spmv_dia.cu", "spmv_dia.py:99"),
        # The precision slice; launches from phase 8, else (the 9-point
        # f64 instantiations) from phase 3d's card runs.
        "cg_papply": ("visit.cu", "stencil_kernel.py:1055"),
        "fused_cg_visit_down": ("visit.cu", "stencil_kernel.py:921"),
        "apply_stencil5.f64": ("visit_f64.cu", "stencil_kernel.py:141"),
        "residual5.f64": ("visit_f64.cu", "stencil_kernel.py:846"),
        "smooth_sweeps.f64": ("visit_f64.cu", "stencil_kernel.py:286"),
        "visit_down.f64": ("visit_f64.cu", "mdma_kernel.py:628"),
        "visit_up.f64": ("visit_f64.cu", "mdma_kernel.py:796"),
        "fused_level_visit.f64": ("visit_f64.cu", "stencil_kernel.py:687"),
        "apply_stencil9.f64": ("visit_f64.cu", "stencil9_kernel.py:178"),
        "residual9.f64": ("visit_f64.cu", "stencil9_kernel.py:211"),
        "fused_level_visit9.f64": ("visit_f64.cu", "stencil9_kernel.py:429"),
        "line_visit9.f64": ("line_f64.cu", "line_kernel.py:208"),
        "visit_down.bf16": ("visit_bf16.cu", "mdma_kernel.py:628"),
        "visit_up.bf16": ("visit_bf16.cu", "mdma_kernel.py:796"),
        # The distribution slice; launches from phase 9 (b)'s Poisson run
        # (rank 0) and, for f64, 9 (c)'s card run.
        "dist_level_visit": ("visit_rows.cu", "dist_kernel.py:399"),
        "dist_level_visit.f64": ("visit_rows_f64.cu", "dist_kernel.py:399"),
        # Phase 11's: K17 in bf16 (11 (b)'s bf16 preconditioner run),
        # K15's rank-spanning mode (11 (b)'s y-line run).
        "dist_level_visit.bf16": ("visit_rows_bf16.cu",
                                  "dist_kernel.py:399"),
        "line_visit9_rows": ("line.cu", "line_kernel.py:208"),
        # Phase 13's: K17's 2-D block mode (13 (b)'s mg-CG on rank 0; f64:
        # 13 (c)'s card run).  JAX runs its blocks levels as XLA ops; the
        # mode is K17's, whose TPU kernel it names.
        "dist_level_visit.blocks": ("visit_rows.cu", "dist_kernel.py:399"),
        "dist_level_visit.blocks.f64": ("visit_rows_f64.cu",
                                        "dist_kernel.py:399"),
        # Phase 14's: K17's 2-D block mode in bf16 (the bf16
        # preconditioner run, rank 0) and K15's 2-D block mode (the y-line
        # run, rank 0); device times from 13 (a).
        "dist_level_visit.blocks.bf16": ("visit_rows_bf16.cu",
                                         "dist_kernel.py:399"),
        "line_visit9_blocks": ("line.cu", "line_kernel.py:208"),
        # Phase 1's: K18a, the stream-rate probe's blocked copy (launches
        # from its rate's run).
        "scale_copy": ("stream.cu", "benchmarks/baseline_configs.py:148"),
        # Phase 1b's: K18b part 1, the attribution probes' kernels
        # (launches from the probes' path run there).  The base mode is
        # K2b's kernel, launched for the probe.
        "visit_ablate.base": ("visit.cu", "benchmarks/probe_visit_vpu.py:182"),
        "visit_ablate.norm": ("probe_visit.cu",
                              "benchmarks/probe_visit_vpu.py:182"),
        "visit_ablate.nomask": ("probe_visit.cu",
                                "benchmarks/probe_visit_vpu.py:182"),
        "visit_ablate.norestrict": ("probe_visit.cu",
                                    "benchmarks/probe_mdma_vpu.py:207"),
        "visit_ablate.nosweep": ("probe_visit.cu",
                                 "benchmarks/probe_mdma_vpu.py:207"),
        "visit_ablate.loadstore": ("probe_visit.cu",
                                   "benchmarks/probe_mdma_vpu.py:207"),
        "scale_copy_": ("stream.cu", "benchmarks/probe_dma.py:78"),
        "staged_copy": ("pipeline.cu", "benchmarks/probe_dma.py:132"),
        "staged_visit_pipeline": ("pipeline.cu",
                                  "benchmarks/probe_dma_parts.py:157"),
        # K18b part 2 (1b too): the halo windows and the x-transfer passes;
        # xfer_restrict's times are its full mode's (the production
        # x-restriction), every mode's device time under "modes".
        "halo_windows": ("probe_xfer.cu",
                         "benchmarks/probe_windows_ab.py:72"),
        "xfer_restrict": ("probe_xfer.cu",
                          "benchmarks/probe_transpose.py:109"),
        "xfer_prolong": ("probe_xfer.cu",
                         "benchmarks/probe_transpose.py:139"),
    }
    for k in meta:  # K18a's from phase 1's rate run, 1b's probes' path
        if "launches" in rec.get(k, {}):
            counts[k] = rec[k]["launches"]
    for k in meta:
        if k not in counts:
            counts[k] = p8_counts.get(k) or p3d_counts.get(k, 0)
            assert counts[k] > 0, f"kernel {k} never launched on its path"
    kernels = []
    for k, (s, r) in meta.items():
        byte_ms = 1e3 * rec[k]["bytes"] / HBM_PEAK
        op_ms = 1e3 * rec[k]["flops"] / (F64_PEAK if k.endswith(".f64")
                                          else F32_PEAK)
        # K18b-R / K18b-P: instructions at 128 a clock an SM, or the slab's
        # bytes once a pass from shared memory (``xfer_bound``).
        bound_ms, bound_by = rec[k].get("bound_ms"), rec[k].get("bound_by")
        if bound_ms is None:
            bound_ms = max(byte_ms, op_ms)
            bound_by = "bytes" if byte_ms >= op_ms else "operations"
        kernels.append({
            "name": k, "route": "cuda", "source": src + s,
            "replaces": r if r.startswith("benchmarks/") else tpu + r,
            "launches": counts[k],
            "max_abs_err": rec[k]["max_abs_err"], "ms": rec[k]["ms"],
            "plain_ms": rec[k]["plain_ms"], "bound_ms": bound_ms,
            "bound_by": bound_by,
            "library_ms": rec[k]["library_ms"],
            "library_device_ms": rec[k].get("library_device_ms"),
            "bound_at_copy_rate_ms": 1e3 * rec[k]["bytes"] / rate,
            **({"launches_merged": merged_k17}
               if k == "dist_level_visit" else {}),
            **({"launches_merged": merged_blocks_k17}
               if k == "dist_level_visit.blocks" else {}),
            **({"ms_nine_scalars": rec[k]["scalars_ms"],
                "bound_ms_nine_scalars": rec[k]["scalars_bound_ms"]}
               if "scalars_ms" in rec[k] else {}),
            **{x: rec[k][x] for x in ("device_ms", "launch_ms",
                                      "grid_syncs", "grid_sync_us",
                                      "latency_floor_ms", "modes_5pt",
                                      "uneven", "modes")
               if x in rec[k]}})
    print(f"copy rate {rate / 1e9:.1f} GB/s (phase 1); K18a's stream rate "
          f"{stream['bytes_per_s'] / 1e9:.1f} GB/s")
    print(f"chip_smoke.py: {time.perf_counter() - T_START:.1f} s since the "
          f"process started (the build included; the limit is 1200 s)")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
