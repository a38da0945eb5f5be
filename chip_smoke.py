#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (multigrid_petsc_tpu_torch)
on one NVIDIA GPU.

    python3 chip_smoke.py

Phases (each raises on failure; nothing is caught, so any failure exits
non-zero):
  1. build the CUDA kernels from the package's csrc/, name the card, and
     measure its device-to-device copy rate (a 1 GiB copy);
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
     (b) the distributed main path, 2 ranks (this script re-run with
     --rank, one process each) sharing the card over gloo with halos
     staged through the host: Poisson mg-CG at 8193^2 / 11 levels against
     phase 4 (its iterations, solution and error; K17's launches per
     emit), then the aniso (1,1,1,2,0.4) mg-CG; (c) the 2-rank mg-CG at
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
     iterations of phase 4's solve, loaded and resumed to convergence.
Every path run starts with the launch counters at 0 and reads them right
after (a rank's counters in its own process).  ``--only 9a,9b,10`` runs
the build and just those phases (phase 4 first where they read it), and
prints no result line.  The line before the last two is the kernels' JSON record (times,
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
    fam = re.compile(r"(visit5|visit9|apply9|stencil|cg_papply|line_fix|"
                     r"line_carry|line_segment|line_residual|coarse_tree|"
                     r"dia_spmv)_kernel(I(f|d|13__nv_bfloat16))?")
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


def keep_time(record, ms, pms, nbytes, flops, library_ms=None):
    """The first timing of each kernel is the one its record keeps."""
    if "ms" not in record:
        record.update(ms=ms, plain_ms=pms, bytes=nbytes, flops=flops,
                      library_ms=library_ms)


def device_ms(torch, fn, n: int = 20) -> float:
    """Device ms per call of ``fn``: ``n`` calls queued behind a sleeping
    kernel, so that the events bracket the kernels' back-to-back run and
    none of the wrappers' host work.  The sleep is sized from the host
    time of ``n`` calls (and checked to have covered it)."""
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
    for _ in range(3):
        torch.cuda._sleep(int(cycles_per_ms * (2 * host_ms + 1.0)))
        t0 = time.perf_counter()
        start.record()
        for _ in range(n):
            fn()
        end.record()
        queued_ms = 1e3 * (time.perf_counter() - t0)
        end.synchronize()
        assert queued_ms < 2 * host_ms + 1.0, "the sleep did not cover"
        times.append(start.elapsed_time(end) / n)
    return statistics.median(times)


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
    lms = None
    if library is not None:
        lms = time_ms(torch, library)
        lerr = float((library() - want[0]).abs().max() / want[0].abs().max())
        print(f"  {library_name}: {lms:.4f} ms (rel. diff. from plain "
              f"{lerr:.2e})")
    print(f"  {label}: kernel {ms:.4f} ms ({nbytes / ms / 1e6:.1f} GB/s "
          f"effective), plain {pms:.4f} ms")
    keep_time(rec[key], ms, pms, nbytes, flops, lms)


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
    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
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
    del allk

    # K15: BASELINE config 4's line stencil ((ny, 1) line coefficients),
    # then the mixed one, whose cc varies with x ((ny, nx) factors).
    line = lk.collapse_stencil(aniso(1.0, 0.0, 100.0, 0.0, 0.0))
    xvar = lk.collapse_stencil(mixed)
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
    del b, u, e, line, xvar, mixed, const
    torch.cuda.empty_cache()
    check_ragged_9pt(torch, dev, rec, torch.float32)


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
    cfg = SolverConfig(**base, grids=11, levels=11, cycle=CycleType.VCYCLE,
                       max_iter=5)
    run("(b) sparse V-cycle", cfg, k8, True, True, forbid=MATRIX_FREE)
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


def phase_k17(torch, dev, rec):
    """9 (a): K17 at full width in one process.  The 8191^2 level, padded
    to 8192 rows, cut into 4 row blocks of 2048 rows on the card, each
    block's halo rows cut from its neighbours; every emit of the 5-point
    visit (Jacobi k = 3) and of the aniso (1,1,1,2,0.4) 9-point visit in
    f32, the zero-guess rc visit in f64.  The stitched blocks are held to
    the whole-grid kernel of the same flags (K9 / K12 / K14) and to the
    plain row-block version (TOL_ARRAY of max|plain|); the pad row and the
    coarse pad row must be exactly 0.  Times: one block (block 1), all 4
    blocks, the whole-grid kernel; the bound counts one block's bytes:
    its rows and halo rows of each input read once, each output once.  The
    per-call time brackets the wrapper's host work too, so the 5-point
    "a", "r" and zero-guess "rc" blocks are also timed as device time
    (``device_ms``: 20 launches queued behind a sleep), "a" and "r" beside
    conv2d on the block and its halo rows (the library call)."""
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
        ("correct + ur", True, jac, "ur", True),
        ("a", True, (), "a", False),
        ("r", True, (), "r", False),
    )
    summary = []
    modes_rec = {}
    for dt, sfx in ((torch.float32, ""), (torch.float64, ".f64")):
        key = "dist_level_visit" + sfx
        rec.setdefault(key, {})
        isz = 8 if dt == torch.float64 else 4
        b = torch.randn((n, n), generator=gen, device=dev).to(dt)
        u = torch.randn((n, n), generator=gen, device=dev).to(dt)
        e = torch.randn((nxc, nxc), generator=gen, device=dev).to(dt)
        stencils = [("5-point", stencil_coefficients(MeshType.UNIFORM, n, n,
                                                     dt, dev))]
        if dt == torch.float32:
            stencils.append(("9-point (1,1,1,2,0.4)", stencil9_coefficients(
                AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), n, n, dt, dev)))
        for sname, st in stencils:
            nine = isinstance(st, Stencil9)
            whole = k9 if nine else sk
            for label, guess, steps, emit, correct in modes:
                if dt == torch.float64 and label != "zero-guess rc":
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
                del got, want, ref
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
                if not nine and dt == torch.float32 and emit in ("a", "r",
                                                                 "rc"):
                    dms = device_ms(torch, lambda: dk.row_visit(*a1, **kw1))
                    lms = None
                    if emit != "rc":  # conv2d over the block + its halo
                        c = [float(x[0, 0]) for x in st]
                        w5 = torch.tensor([[0.0, c[0], 0.0],
                                           [c[1], c[2], c[3]],
                                           [0.0, c[4], 0.0]], device=dev)
                        hal = kw1["u_halo"]
                        ue = torch.cat([hal.top, a1[2], hal.bot])
                        be = (torch.cat([torch.zeros_like(hal.top), a1[1],
                                         torch.zeros_like(hal.bot)])
                              if emit == "r" else None)
                        lms = time_ms(torch, conv_call(torch, w5, ue, be))
                        del ue, be
                    bound = 1e3 * nbytes / HBM_PEAK
                    modes_rec[emit] = {"ms_per_call": ms1, "device_ms": dms,
                                       "bound_ms": bound, "library_ms": lms}
                    print(f"  {tag}: device time {dms:.4f} ms per block "
                          f"({100 * bound / dms:.1f}% of its bound "
                          f"{bound:.4f} ms), per call {ms1:.4f} ms"
                          + (f"; conv2d on the block and its halo rows "
                             f"{lms:.4f} ms" if lms is not None else ""))
                del bb, ub, eb, calls
            del st
        del b, u, e
        torch.cuda.empty_cache()
    rec["dist_level_visit"]["modes_5pt"] = modes_rec
    return summary


def rank_worker(argv) -> int:
    """One rank of phase 9's worlds (``chip_smoke.py --rank RANK WORLD
    PORT DEVICE LABEL OUTDIR JOBS``): joins the gloo group, solves each
    job under ``row_plan(min_local=32)`` on DEVICE and writes its results
    to OUTDIR/<job>.<LABEL>.<RANK>.json (rank 0 also the gathered solution
    of a job with "save_u")."""
    import dataclasses as dc
    from datetime import timedelta
    from pathlib import Path

    import numpy as np
    import torch
    import torch.distributed as dist

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda import dist_kernel, launches
    from multigrid_petsc_tpu_torch.parallel import row_plan
    from multigrid_petsc_tpu_torch.postprocess import error_norms
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import (
        CycleType,
        SmootherType,
        SolverConfig,
    )

    rank, world, port = (int(a) for a in argv[:3])
    device, label, out = argv[3], argv[4], Path(argv[5])
    jobs = json.loads(argv[6])
    torch.set_num_threads(2)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=P9_TIMEOUT))
    try:
        plan = row_plan(min_local=32, device=device)
        cuda = plan.device.type == "cuda"
        for job in jobs:
            f = dict(job["cfg"], cycle=CycleType(job["cfg"]["cycle"]))
            if "smoother" in f:
                f["smoother"] = SmootherType(f["smoother"])
            if "aniso" in f:
                f["aniso"] = tuple(f["aniso"])
            cfg = SolverConfig(**f)
            if cuda:
                torch.cuda.empty_cache()
                torch.cuda.reset_peak_memory_stats()
            launches.clear()
            dist_kernel.emits.clear()
            res = solve(cfg, plan=plan)
            counts = dict(launches)
            emits = dict(dist_kernel.emits)
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
                       emits=emits,
                       dist=[lv.dist is not None for lv in res.ctx.levels],
                       errs=list(errs), wall=res.wall_time, ms=ms,
                       transport=plan.transport,
                       peak_gib=(torch.cuda.max_memory_allocated() / 2**30
                                 if cuda else None))
            (out / f"{job['name']}.{label}.{rank}.json").write_text(
                json.dumps(rep))
            if rank == 0 and job.get("save_u"):
                np.save(out / f"{job['name']}.npy", u)
            print(f"[rank {rank} {label}] {job['name']}: iters "
                  f"{res.iters}, converged {res.converged}", flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def start_world(jobs, device, label, out):
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    return [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(P9_RANKS),
         str(port), device, label, str(out), json.dumps(jobs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(P9_RANKS)]


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
        cpu = start_world(parity, "cpu", "cpu", out)
        card = start_world(card_jobs, "cuda", "card", out)
        try:
            finish_world(card, "card world")
            finish_world(cpu, "cpu world")
        finally:  # a failed world leaves no rank of either running
            for p in card + cpu:
                if p.poll() is None:
                    p.kill()
                    p.wait()

        def ranks(name, label):
            return [json.loads((out / f"{name}.{label}.{r}.json")
                               .read_text()) for r in range(P9_RANKS)]

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


def partial_run(torch, dev, parts) -> int:
    """``chip_smoke.py --only 9a,10``: the build, then only the phases
    named (9a: K17's blocks; 9b: the distributed runs; 10: phase 10),
    with phase 4 first where they read it; no result line, so a partial
    run never passes for a whole one."""
    main_ref = None
    if {"9b", "10"} & set(parts):
        _, u_ref, main_ref = phase_main(torch)
        main_ref["u"] = u_ref.cpu().numpy()
        del u_ref
    if "9a" in parts:
        rec = {}
        timed_phase(torch, "9 (a)", phase_k17, dev, rec)
        print(json.dumps(rec["dist_level_visit"]))
    if "9b" in parts:
        timed_phase(torch, "9 (b), (c)", phase_dist, main_ref)
    if "10" in parts:
        run_phase10(torch, main_ref)
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
        for line in ptxas_summary(log.read_text()):
            print("  ptxas: " + line)
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

    rec = phase_kernels(torch, dev, rate)
    phase_kernels_vcycle(torch, dev, rec)
    phase_kernels_9pt(torch, dev, rec)
    torch.cuda.empty_cache()
    timed_phase(torch, "2c", phase_kernels_sparse, dev, rec)
    timed_phase(torch, "2d", phase_kernels_precision, dev, rec)
    torch.cuda.empty_cache()
    jac, cheb = SmootherType.JACOBI, SmootherType.CHEBYSHEV
    phase_parity(torch, (  # cycle, smoother, max_iter, extra, atol
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
    phase_parity(torch, (
        (CycleType.MGCG, jac, 100, mixed, 5e-6),
        (CycleType.MGCG, SmootherType.LINE_Y, 100,
         {"aniso": (1.0, 0.0, 100.0, 0.0, 0.0)}, 2e-2),
        (CycleType.MGFGMRES, jac, 4, {"aniso": (1.0, 0.0, 1.0, 0.0, 0.4)},
         2e-3),
        (CycleType.VCYCLE, jac, 6, mixed, 5e-3),
    ), base={"problem": "aniso"})
    timed_phase(torch, "3c", phase_parity_zoo)
    p3d_counts = timed_phase(torch, "3d", phase_parity_precision)
    counts, u_ref, main_ref = phase_main(torch)
    vcounts = phase_vcycle(torch, u_ref)
    main_ref["u"] = u_ref.cpu().numpy()  # phase 9 (b)'s reference
    del u_ref
    acounts = phase_aniso(torch)
    k8_counts, k16_counts = timed_phase(torch, "7", phase_zoo)
    p8_counts = timed_phase(torch, "8", phase_precision)
    torch.cuda.empty_cache()
    timed_phase(torch, "9 (a)", phase_k17, dev, rec)
    counts.update(timed_phase(torch, "9 (b), (c)", phase_dist, main_ref))
    run_phase10(torch, main_ref)
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
        "line_visit9.f64": ("line.cu", "line_kernel.py:208"),
        "visit_down.bf16": ("visit_bf16.cu", "mdma_kernel.py:628"),
        "visit_up.bf16": ("visit_bf16.cu", "mdma_kernel.py:796"),
        # The distribution slice; launches from phase 9 (b)'s Poisson run
        # (rank 0) and, for f64, 9 (c)'s card run.
        "dist_level_visit": ("visit.cu", "dist_kernel.py:399"),
        "dist_level_visit.f64": ("visit_f64.cu", "dist_kernel.py:399"),
    }
    for k in meta:
        if k not in counts:
            counts[k] = p8_counts.get(k) or p3d_counts.get(k, 0)
            assert counts[k] > 0, f"kernel {k} never launched on its path"
    kernels = []
    for k, (s, r) in meta.items():
        byte_ms = 1e3 * rec[k]["bytes"] / HBM_PEAK
        op_ms = 1e3 * rec[k]["flops"] / (F64_PEAK if k.endswith(".f64")
                                          else F32_PEAK)
        kernels.append({
            "name": k, "route": "cuda", "source": src + s,
            "replaces": tpu + r, "launches": counts[k],
            "max_abs_err": rec[k]["max_abs_err"], "ms": rec[k]["ms"],
            "plain_ms": rec[k]["plain_ms"], "bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations",
            "library_ms": rec[k]["library_ms"],
            "bound_at_copy_rate_ms": 1e3 * rec[k]["bytes"] / rate,
            **({"ms_nine_scalars": rec[k]["scalars_ms"],
                "bound_ms_nine_scalars": rec[k]["scalars_bound_ms"]}
               if "scalars_ms" in rec[k] else {}),
            **{x: rec[k][x] for x in ("device_ms", "grid_syncs",
                                      "grid_sync_us", "latency_floor_ms",
                                      "modes_5pt")
               if x in rec[k]}})
    print(f"copy rate {rate / 1e9:.1f} GB/s (phase 1)")
    print(json.dumps({"kernels": kernels}))
    print(f"nvidia-smi: {nvidia_smi_line()}")
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
