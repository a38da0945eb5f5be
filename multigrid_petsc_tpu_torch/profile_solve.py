"""Where a solve's device time goes: ``torch.profiler`` over one solve on
the card.

    python -m multigrid_petsc_tpu_torch.profile_solve [-key value ...]
        [-precond_dtype bfloat16]

Takes the CLI's ``-key value`` options (``poisson.py``; ``-outer_dtype
float64`` runs the mixed outer) and ``-precond_dtype`` (the Krylov
outers' preconditioner type), builds the context on the card, runs one
warm-up solve and then profiles a second solve of the same configuration
(set ``-iter`` to force its length: the stop test is ``rtol``).  Prints the wall time, the device time summed
over kernels and the device's busy share of the wall time, peak device
memory, and the kernels by device time: launches, ms per launch and
share.  Needs a CUDA device; it does not fall back to the CPU.
"""

from __future__ import annotations

import sys
import time

import torch

from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.utils.config import SolverConfig, parse_options


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    if not torch.cuda.is_available():
        raise RuntimeError("profile_solve needs a CUDA device")
    precond_dtype = None
    if "-precond_dtype" in argv:
        i = argv.index("-precond_dtype")
        precond_dtype = argv[i + 1]
        del argv[i : i + 2]
    cfg = parse_options(
        [f"{argv[j]} {argv[j + 1]}" for j in range(0, len(argv) - 1, 2)],
        SolverConfig(precond_dtype=precond_dtype))
    ctx = build_context(cfg, device="cuda")

    def drive():
        return solve(cfg, ctx=ctx, device="cuda")

    drive()  # warm-up: kernel build and first launches
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = drive()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    rows = [e for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in rows) / 1e3  # ms
    print(f"{cfg.cycle.name} npts={cfg.npts} grids={cfg.grids} "
          f"levels={cfg.levels} problem={cfg.problem} "
          f"smoother={cfg.smoother.value} backend={cfg.backend} "
          f"dtype={cfg.dtype} outer_dtype={cfg.outer_dtype} "
          f"precond_dtype={cfg.precond_dtype} route={res.route}: "
          f"{res.iters} iterations")
    print(f"wall {1e3 * wall:.3f} ms, device kernels {busy:.3f} ms, busy "
          f"{100 * busy / (1e3 * wall):.1f}%, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    print("kernel | launches | ms / launch | total ms | share")
    for e in sorted(rows, key=lambda e: -e.self_device_time_total):
        tot = e.self_device_time_total / 1e3
        if tot <= 0:
            continue
        print(f"{e.key[:90]} | {e.count} | {tot / e.count:.4f} | "
              f"{tot:.3f} | {100 * tot / busy:.1f}%")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
