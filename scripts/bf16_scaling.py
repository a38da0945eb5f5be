#!/usr/bin/env python3
"""How the bf16 working dtype's accuracy scales with the grid.

    PYTHONPATH=<checkout> python scripts/bf16_scaling.py [--sizes 1025,2049]
        [--cpu-max 2049] [--iters 10]

For each size n (npts; levels = log2(n - 1), the deepest hierarchy) runs,
10 forced iterations each (rtol 0): the bf16 V-cycle, bf16 mg-CG (the
mdma route), and the f32 V-cycle with its iterate rounded to bf16 after
every cycle (everything else f32: what the rounding of u alone costs),
on the card (when there is one) and, up to ``--cpu-max``, on the CPU
(the plain versions).  Prints one line per run and a JSON record of
max|u - u_exact| / max|u_exact| and the residual histories, beside the
card's nvidia-smi line.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import time

import torch

from multigrid_petsc_tpu_torch.mesh import MeshType
from multigrid_petsc_tpu_torch.postprocess import error_norms
from multigrid_petsc_tpu_torch.problems import exact_grid, poisson_sin_problem
from multigrid_petsc_tpu_torch.solvers.context import build_context
from multigrid_petsc_tpu_torch.solvers.solve import solve
from multigrid_petsc_tpu_torch.solvers.vcycle import v_cycle
from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "no card"


def run(n: int, label: str, device: str, iters: int) -> dict:
    levels = (n - 1).bit_length() - 1
    base = dict(npts=n, grids=levels, levels=levels, rtol=0.0,
                max_iter=iters)
    t0 = time.perf_counter()
    if label == "f32 V-cycle, u rounded to bf16":
        cfg = SolverConfig(cycle=CycleType.VCYCLE, dtype="float32", **base)
        ctx = build_context(cfg, device=device)
        u = torch.zeros_like(ctx.b0)
        for _ in range(iters):
            u = v_cycle(ctx, ctx.b0, u, *cfg.v).bfloat16().float()
        hist = None
    else:
        cycle = CycleType.VCYCLE if "V-cycle" in label else CycleType.MGCG
        res = solve(SolverConfig(cycle=cycle, dtype="bfloat16", **base),
                    device=device)
        ctx, u, hist = res.ctx, res.u, res.rnorm.tolist()
    umax = float(exact_grid(poisson_sin_problem(), MeshType.UNIFORM, n - 2,
                            n - 2, torch.float64, "cpu").abs().max())
    err = error_norms(ctx.problem, MeshType.UNIFORM, u)[0] / umax
    out = {"n": n, "run": label, "device": device, "err": err,
           "history": hist, "seconds": time.perf_counter() - t0}
    print(f"{n}^2 {label} on {device}: max error / max|u_exact| {err:.4e} "
          f"({out['seconds']:.1f} s)", flush=True)
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--sizes", default="1025,2049,4097,8193")
    ap.add_argument("--cpu-max", type=int, default=4097)
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    labels = ("bf16 V-cycle", "bf16 mg-CG", "f32 V-cycle, u rounded to bf16")
    devices = ["cuda"] if torch.cuda.is_available() else []
    rows = []
    for n in map(int, args.sizes.split(",")):
        for dev in devices + (["cpu"] if n <= args.cpu_max else []):
            for label in labels:
                rows.append(run(n, label, dev, args.iters))
    print(json.dumps({"card": card(), "runs": rows}))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
