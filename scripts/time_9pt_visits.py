"""Time the 9-point visits K14 (fused_level_visit9) and K15 (line_visit9)
on one card, each held to its plain version first.

    PYTHONPATH=<checkout> python scripts/time_9pt_visits.py [--n 8191]

The package is imported from PYTHONPATH, so one call can time two
checkouts side by side (run them in the order A, B, B, A and compare
within the call).  Cases, at n^2 in f32:

  K15 u k=3 on BASELINE config 4's line stencil ((ny, 1) line factors) and
      on the (1,1,1,2,0.4) stencil ((ny, nx) factors: cc varies with x);
  K14 zero-guess rc on the (1,1,1,2,0.4) stencil for k = 1, 2, 3, 5, 8
      Jacobi steps, and k = 3 on a stencil with every coefficient kind.

The K14 series separates what a block pays once (staging the region and
the coefficients, the residual and the restriction) from what it pays
per step: the region is fixed, so the output tile and the block count
follow the halo H = k + 2; ms per block = once + k * per step, fitted by
least squares.  Prints one JSON line (card name and power limit
included); exits non-zero if a kernel disagrees with its plain version.
"""

from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

import numpy as np
import torch

TOL_ARRAY = 1e-5  # K14: max|kernel - plain| <= TOL_ARRAY * max|plain|
TOL_LINE = 1e-4   # K15: Thomas segments vs PCR, solve rounding
REPS = 20
K14_STEPS = (1, 2, 3, 5, 8)
V9_REGION = 64  # csrc/visit.cuh V9_SH = V9_SW: the 9-point visit's region


def time_ms(fn) -> float:
    for _ in range(3):
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


def max_rel_err(got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((g.double() - w.double()).abs().max())
               / max(float(w.double().abs().max()), 1e-300)
               for g, w in zip(got, want))


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8191)
    ap.add_argument("--label", default="")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1

    from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

    dev = torch.device("cuda", 0)
    n, f32 = args.n, torch.float32
    gen = torch.Generator(device=dev).manual_seed(999)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev, dtype=f32)

    def aniso(*p):
        return stencil9_coefficients(AnisoProblem(*p), n, n, f32, dev)

    mixed = aniso(1.0, 1.0, 1.0, 2.0, 0.4)
    h2 = float(n + 1) ** 2
    allk = Stencil9(h2 * rnd(1, 1), h2 * rnd(n, 1), h2 * rnd(1, n),
                    h2 * rnd(n, n), -h2 * (12 + 4 * rnd(n, n).abs()),
                    h2 * rnd(1, n), h2 * rnd(n, 1), h2 * rnd(1, 1),
                    h2 * rnd(n, n))
    b, u = rnd(n, n), rnd(n, n)
    out = {"label": args.label, "n": n, "card": card(), "k15": {},
           "k14": {}}
    ok = True

    line = lk.collapse_stencil(aniso(1.0, 0.0, 100.0, 0.0, 0.0))
    for name, st in (("columns", line),
                     ("x-varying", lk.collapse_stencil(mixed))):
        fac = lk.line_factor(st, n)
        err = max_rel_err(lk.line_visit9(st, b, u, 3, 0.8, fac=fac),
                          lk.line_visit9_plain(st, b, u, 3, 0.8))
        ok &= err <= TOL_LINE
        out["k15"][name] = {
            "ms": time_ms(lambda: lk.line_visit9(st, b, u, 3, 0.8, fac=fac)),
            "err": err}

    series = []
    for name, st, ks in (("aniso", mixed, K14_STEPS), ("all kinds", allk,
                                                        (3,))):
        for k in ks:
            steps = jacobi_step_coeffs(k, 0.8)
            err = max_rel_err(
                k9.fused_level_visit9(st, b, None, steps, "rc"),
                k9.fused_level_visit9_plain(st, b, None, steps, "rc"))
            ok &= err <= TOL_ARRAY
            ms = time_ms(
                lambda: k9.fused_level_visit9(st, b, None, steps, "rc"))
            tile = V9_REGION - 2 * (k + 2)
            blocks = (-(-n // tile)) ** 2
            out["k14"][f"{name} k={k}"] = {"ms": ms, "err": err,
                                           "blocks": blocks}
            if name == "aniso":
                series.append((k, 1e3 * ms / blocks))
    ks, us = np.array([s[0] for s in series]), np.array([s[1] for s in series])
    per_step, once = np.polyfit(ks, us, 1)
    out["k14_fit_us_per_block"] = {"once": float(once),
                                   "per_step": float(per_step)}
    out["ok"] = bool(ok)
    print(json.dumps(out))
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
