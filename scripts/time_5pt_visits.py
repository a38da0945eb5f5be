"""Time the 5-point strip visit and K12's strip kernel on one card, each
held to its plain version first; with --ab, A/B the visit's region rule
in one call.

    python scripts/time_5pt_visits.py [--n 8191] [--label L]
    python scripts/time_5pt_visits.py --ab [--n 8191]

Cases, at n^2 in f32 (the main path's storage type): K7 (u k = 3 from a
guess, Jacobi), K9 nonzero-guess rc k = 3, K3 (correct + u + <b, u>),
K2a (the CG flag set), the zero-guess rc visit (K2b's flag set) for
k = 1, 2, 3, 5, 6, 7 and 8 Jacobi steps (6 and 7: halos 8 and 9, on
either side of the region rule V5_SHORT_MAX_H), and K12 (apply) on a
stencil of nine scalars and on the anisotropic (1,1,1,2,0.4) stencil.
The zero-guess series on the short region (k = 1, 2, 3, 5, 6) is fitted
by least squares as us of device time per tile = once + k * per step
(the tiles follow the halo H = k + 2), which separates what a block pays
once (staging, loads, residual, restriction, stores) from its steps.

--ab builds a variant tree of this checkout's package under _archive/ab5/
(listed in .gitignore) with one constant of csrc/visit.cuh changed:
  tall      V5_SHORT_MAX_H = 0: every f32 visit on the 128 x 128 region
and times it against the tree as it is in the order A B B A (one process
per run), then prints one JSON line with every run (card name and power
limit included).  Exits non-zero if a kernel disagrees with its plain
version.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
TOL_ARRAY = 1e-5  # max|kernel - plain| <= TOL_ARRAY * max|plain|
REPS = 20
FIT_STEPS = (1, 2, 3, 5, 6)  # halos 3..8: the short region
EDGE_STEPS = (7, 8)
VARIANTS = {  # name: (constant, value)
    "tall": ("V5_SHORT_MAX_H", "0"),
}


def card() -> str:
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return "not read"


def run_cases(n: int) -> dict:
    import numpy as np
    import torch

    from multigrid_petsc_tpu_torch.mesh import MeshType
    from multigrid_petsc_tpu_torch.ops.cuda._build import load_library
    from multigrid_petsc_tpu_torch.ops.cuda import mdma_kernel as mdma
    from multigrid_petsc_tpu_torch.ops.cuda import stencil9_kernel as k9
    from multigrid_petsc_tpu_torch.ops.cuda import stencil_kernel as sk
    from multigrid_petsc_tpu_torch.ops.stencil import Stencil9
    from multigrid_petsc_tpu_torch.problems import (
        AnisoProblem,
        stencil9_coefficients,
        stencil_coefficients,
    )
    from multigrid_petsc_tpu_torch.solvers.smoothers import jacobi_step_coeffs

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

    def rel_err(got, want) -> float:
        got = got if isinstance(got, tuple) else (got,)
        want = want if isinstance(want, tuple) else (want,)
        return max(float((g.double() - w.double()).abs().max())
                   / max(float(w.double().abs().max()), 1e-300)
                   for g, w in zip(got, want))

    lib = load_library()
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(777)

    def rnd(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    st = stencil_coefficients(MeshType.UNIFORM, n, n, torch.float32, dev)
    b, u, ap = rnd(n, n), rnd(n, n), rnd(n, n)
    e = rnd((n - 1) // 2, (n - 1) // 2)
    alpha = torch.tensor(0.37, device=dev)
    jac3 = jacobi_step_coeffs(3, 0.8)
    out, ok = {}, True

    def case(name, kern, plain, blocks=None):
        nonlocal ok
        err = rel_err(kern(), plain())
        ok &= err <= TOL_ARRAY
        out[name] = {"ms": time_ms(kern), "err": err}
        if blocks is not None:
            out[name]["blocks"] = blocks

    case("K7 u k=3", lambda: sk.smooth_sweeps(st, b, u, jac3),
         lambda: sk.smooth_sweeps_plain(st, b, u, jac3))
    case("K9 rc k=3", lambda: sk.fused_level_visit(st, b, u, jac3, "rc"),
         lambda: sk.fused_level_visit_plain(st, b, u, jac3, "rc"))
    case("K3 correct + u + dot k=3",
         lambda: mdma.visit_up(st, b, u, e, jac3),
         lambda: mdma.visit_up_plain(st, b, u, e, jac3))
    case("K2a CG rc k=3",
         lambda: mdma.cg_visit_down(st, b, ap, alpha, jac3),
         lambda: mdma.cg_visit_down_plain(st, b, ap, alpha, jac3))
    series = []
    for k in FIT_STEPS + EDGE_STEPS:
        steps = jacobi_step_coeffs(k, 0.8)
        tiles = lib.mg_visit5_blocks(n, n, k + 2, 4)
        case(f"zero-guess rc k={k}",
             lambda: sk.fused_level_visit(st, b, None, steps, "rc"),
             lambda: sk.fused_level_visit_plain(st, b, None, steps, "rc"),
             tiles)
        if k in FIT_STEPS:
            series.append((k, 1e3 * out[f"zero-guess rc k={k}"]["ms"]
                           / tiles))
    ks = np.array([s[0] for s in series])
    us = np.array([s[1] for s in series])
    per_step, once = np.polyfit(ks, us, 1)
    out["fit_us_per_block"] = {"once": float(once),
                               "per_step": float(per_step)}
    del ap, e
    mixed = stencil9_coefficients(AnisoProblem(1.0, 1.0, 1.0, 2.0, 0.4), n,
                                  n, torch.float32, dev)
    scal = Stencil9(*(x.reshape(-1)[:1].reshape(1, 1) for x in
                      stencil9_coefficients(
                          AnisoProblem(1.0, 0.0, 100.0, 0.0, 0.3), n, n,
                          torch.float32, dev)))
    for name, s9 in (("scalars", scal), ("aniso", mixed)):
        case(f"K12 apply ({name})", lambda: k9.apply_stencil9(s9, u),
             lambda: k9.apply_stencil9_plain(s9, u))
    out["ok"] = bool(ok)
    return out


def make_variant(name: str) -> Path:
    """A copy of the package with one constant of csrc/visit.cuh set."""
    const, value = VARIANTS[name]
    root = REPO / "_archive" / "ab5" / name
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(REPO / "multigrid_petsc_tpu_torch",
                    root / "multigrid_petsc_tpu_torch",
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    src = root / "multigrid_petsc_tpu_torch" / "csrc" / "visit.cuh"
    text, count = re.subn(rf"(constexpr \w+ {const} = )[^;]+;",
                          rf"\g<1>{value};", src.read_text())
    if count != 1:
        raise RuntimeError(f"{const} not found once in {src}")
    src.write_text(text)
    return root


def ab(n: int) -> int:
    trees = {"base": REPO, **{v: make_variant(v) for v in VARIANTS}}
    build = {name: subprocess.Popen(
        [sys.executable, "-c", "from multigrid_petsc_tpu_torch.ops.cuda."
         "_build import load_library; load_library()"],
        env=dict(os.environ, PYTHONPATH=str(t)), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for name, t in trees.items()}
    failed = [name for name, p in build.items()
              if p.communicate()[0] is not None and p.returncode != 0]
    for name in failed:
        print(f"{name}: build failed", file=sys.stderr)
    if "base" in failed:
        return 1
    runs, ok = [], True
    for v in VARIANTS:
        if v in failed:
            continue
        for name in ("base", v, v, "base"):
            res = subprocess.run(
                [sys.executable, __file__, "--n", str(n), "--label", name],
                env=dict(os.environ, PYTHONPATH=str(trees[name])),
                capture_output=True, text=True)
            if res.returncode not in (0, 1) or not res.stdout.strip():
                print(res.stdout, res.stderr, file=sys.stderr)
                return 1
            line = json.loads(res.stdout.strip().splitlines()[-1])
            ok &= line["ok"]
            runs.append({"pair": v, **line})
    print(json.dumps({"n": n, "card": card(), "runs": runs, "ok": ok}))
    return 0 if ok else 1


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, default=8191)
    ap.add_argument("--label", default="")
    ap.add_argument("--ab", action="store_true")
    args = ap.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 1
    if args.ab:
        return ab(args.n)
    out = {"label": args.label, "n": args.n, "card": card(),
           **run_cases(args.n)}
    print(json.dumps(out))
    return 0 if out["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
