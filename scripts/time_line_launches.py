"""Time K15's sweep launches alone, as device time, for this checkout's
``csrc/line.cuh`` and for variants of it made by text substitutions, each
build of ``line.cu`` alone (one nvcc a build, all started together), run
in turns (A B B A) in one process on one card.

    PYTHONPATH=<checkout> python scripts/time_line_launches.py \\
        [--variant NAME ...] [--rounds 2]

A variant (``VARIANTS``: its substitutions, each ``old`` of which must
occur in ``line.cuh``) is built from a copy of ``csrc/``; a variant may
compute something else (a probe of where the time goes): its
disagreement with the plain version is printed, and only this checkout's
own build must agree.  Cases, f32, BASELINE config 4's line stencil (the
packed per-row table), random b, u:

  card    8191^2: ``line_visit9`` u k = 1 (``mg_line_sweep``'s three
          launches), and the split entries on the whole level;
  rows    block 1 of 4 row blocks of 8191^2 (2048 rows; 256 segments),
          and block 3 (2047 rows and the pad row: its last segment cut);
  blocks  block 1 of the 2x2 cut of 8191^2 (4096^2), y-lines across its
          mesh column (256 segments).

``--shapes`` adds split cases that differ in the block's shape, row
stride or layout (``shape_cases``).  For each split case: launches 1
(segment ends), 2 (carry scan) and 3 (fix-up) alone and the whole sweep,
``chip_smoke.device_ms`` each (``chip_smoke.line_launch_ms``).  Every
build's sweeps are held to the plain version (TOL_LINE of max|plain|)
before they are timed.  Prints one JSON line, the card's name and power
limit included.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke as cs  # noqa: E402
from multigrid_petsc_tpu_torch.ops.cuda import _build  # noqa: E402
from multigrid_petsc_tpu_torch.ops.cuda import line_kernel as lk  # noqa: E402
from multigrid_petsc_tpu_torch.ops.cuda.dist_kernel import Halo  # noqa: E402
from multigrid_petsc_tpu_torch.problems import (  # noqa: E402
    AnisoProblem,
    stencil9_coefficients,
)

N = 8191
# Probes of where a sweep's time goes (csrc/line.cuh), by name.
VARIANTS = {
    # Every row of a segment tested against the level's edges (none read
    # as IN).
    "edges": [("iterate_row<GUESS, CORRECT, ROWS, SIDES, FULL>(",
               "iterate_row<GUESS, CORRECT, ROWS, SIDES, false>("),
              ("if (GUESS && FULL && i + 1 < SEG)",
               "if (GUESS && false)")],
    # The 2-D block mode's rows in the level without the ring's side
    # columns (wrong at the block's side edges): what reading them costs.
    "nosides": [("return v + (side != nullptr ? side[y] : T(0));",
                 "return v;")],
    # Launches 1 and 3 running the segments in order (the first design),
    # the last one (cut by the edge) in the last wave.
    "inorder": [("return gridDim.y - 1 - blockIdx.y;", "return blockIdx.y;")],
    # Every block of threads of the 2-D block mode compiled to read the
    # ring's side columns (SIDE_EDGE), as the first design.
    "alledge": [("if (blockIdx.x == 0 || (int)(blockIdx.x + 1) * ST >= nx)",
                 "if (true)")],
}


def build(variants) -> dict:
    """Each variant's ``line.cu``, from a copy of csrc/ with its
    substitutions applied, built alone (one nvcc a variant, all started
    together) into _build/line_variants/<name>/ and loaded with the line
    entries' argument types: {name: library}."""
    procs = {}
    for name, subs in variants:
        out = _build.BUILD_DIR / "line_variants" / name
        if out.exists():
            shutil.rmtree(out)
        shutil.copytree(_build.CSRC_DIR, out / "csrc")
        head = out / "csrc" / "line.cuh"
        text = head.read_text()
        for old, new in subs:
            if old not in text:
                raise SystemExit(f"variant {name}: {old!r} not in line.cuh")
            text = text.replace(old, new)
        head.write_text(text)
        procs[name] = (out / "libline.so", subprocess.Popen(
            [_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
             str(out / "libline.so"), str(out / "csrc" / "line.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (lib, proc) in procs.items():
        log = proc.communicate()[0]
        if proc.returncode:
            raise SystemExit(f"variant {name}: nvcc failed\n{log}")
        print(f"{name}: " + "; ".join(cs.ptxas_summary(log)))
        fn = None
        for line in log.splitlines():  # the spilling instantiations
            if "Compiling entry function" in line:
                fn = line.split("'")[1]
            elif (fn and "spill stores" in line
                  and " 0 bytes spill" not in line):
                print(f"  {fn}: {line.strip()}")
        cdll = ctypes.CDLL(str(lib))
        for fn, argtypes in _build._SIGNATURES.items():
            if fn.startswith("mg_line") and not fn.endswith("_f64"):
                getattr(cdll, fn).argtypes = argtypes
                getattr(cdll, fn).restype = ctypes.c_int
        libs[name] = cdll
    return libs


def cases():
    """The one-card level (stencil, b, u, factor), the split cases (name,
    RowLine, b, u, halo or ring, the gathered ends) and the stitched
    sweeps each build is held to the plain sweep by."""
    gen = torch.Generator(device="cuda").manual_seed(17)
    st = lk.collapse_stencil(stencil9_coefficients(
        AnisoProblem(1.0, 0.0, 100.0, 0.0, 0.0), N, N, torch.float32,
        "cuda"))
    b, u = (torch.randn((N, N), generator=gen, device="cuda")
            for _ in range(2))
    whole = lk.row_line(st, N, N, 0, plain=False)
    zero = u.new_zeros((1, N))
    halo = Halo(zero, zero)
    rsweep, lfs, blocks = cs.line_row_sweep(torch, lk, st, b, u, 4)
    bsweep, calls = cs.line_block_sweeps(torch, lk, st, b, u, 2, 2, 0,
                                         plain=False)

    def card_sweep():
        every = lk.line_rows_begin(whole, b, u, halo)
        return lk.line_rows_end(whole, b, u, halo, every, cs.P11_OMEGA)

    def rows_every():
        return torch.cat([lk.line_rows_begin(lf, *blk)
                          for lf, blk in zip(lfs, blocks)])

    def blocks_every():  # block 1's mesh column: blocks 1 and 3
        return torch.cat([lk.line_rows_begin(*calls[p][:4]) for p in (1, 3)])

    split = [("card", (whole, b, u, halo),
              lambda: lk.line_rows_begin(whole, b, u, halo)),
             ("rows", (lfs[1], *blocks[1]), rows_every),
             ("rows last", (lfs[3], *blocks[3]), rows_every),
             ("blocks", tuple(calls[1][:4]), blocks_every)]
    checks = [("card", card_sweep), ("rows", lambda: rsweep()[:N]),
              ("blocks", lambda: bsweep()[:N, :N])]
    return (st, b, u, lk.line_factor(st, N)), split, checks


def shape_cases():
    """Split cases that differ from ``cases``' in the block's shape or the
    layout (timed, not checked): block 1 of 4 row blocks of an 8191 x
    8192 level (a row stride of 8192), block 1 of 2 row blocks of 8191^2
    (4096 x 8191), block 1 of 2 row blocks of an 8191 x 4096 level (4096^2
    in the rows mode), block 1 of the 2x2 cut of an 8191 x 8193 level (a
    stride of 4097), and block 1 of the 1x2 cut of 8191^2 (8191 x 4096,
    the lines whole in the 2-D block mode)."""
    gen = torch.Generator(device="cuda").manual_seed(18)
    out = []
    for name, nx, mesh in (("rows8192", 8192, 4), ("rows2", N, 2),
                           ("rows4096sq", 4096, 2),
                           ("blocks4097", 8193, (2, 2)),
                           ("blocks1x2", N, (1, 2))):
        st = lk.collapse_stencil(stencil9_coefficients(
            AnisoProblem(1.0, 0.0, 100.0, 0.0, 0.0), N, nx, torch.float32,
            "cuda"))
        b, u = (torch.randn((N, nx), generator=gen, device="cuda")
                for _ in range(2))
        if isinstance(mesh, int):
            _, lfs, blocks = cs.line_row_sweep(torch, lk, st, b, u, mesh)
            every = torch.cat([lk.line_rows_begin(lf, *blk)
                               for lf, blk in zip(lfs, blocks)])
            out.append((name, (lfs[1], *blocks[1]), lambda e=every: e))
        else:
            my, mx = mesh
            _, calls = cs.line_block_sweeps(torch, lk, st, b, u, my, mx, 0,
                                            plain=False)
            every = torch.cat([lk.line_rows_begin(*calls[q][:4])
                               for q in range(1, my * mx, mx)])
            out.append((name, tuple(calls[1][:4]), lambda e=every: e))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--variant", action="append", default=[],
                    choices=sorted(VARIANTS))
    ap.add_argument("--rounds", type=int, default=2)
    ap.add_argument("--shapes", action="store_true",
                    help="also time shape_cases()")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("time_line_launches: no CUDA device", file=sys.stderr)
        return 1
    variants = [("tree", []), *((v, VARIANTS[v]) for v in args.variant)]
    libs = build(variants)
    (st, b, u, fac), split, checks = cases()
    if args.shapes:
        split += shape_cases()
    want = lk.line_visit9_plain(st, b, u, 1, cs.P11_OMEGA)
    results: dict = {name: [] for name in libs}
    order = list(libs) + list(reversed(list(libs)))
    for r in range(args.rounds):
        for i, name in enumerate(order):
            lk.load_library = lambda lib=libs[name]: lib
            if r == 0 and i < len(libs):
                for cname, sweep in checks:
                    try:
                        cs.compare(torch, f"{name} {cname} vs plain",
                                   sweep(), want, {}, cs.TOL_LINE)
                    except AssertionError as err:
                        if name == "tree":
                            raise
                        print(f"  (a probe) {err}")
            row = {"card k=1": cs.device_ms(torch, lambda: lk.line_visit9(
                st, b, u, 1, cs.P11_OMEGA, fac=fac))}
            for cname, call, every in split:
                row[cname] = cs.line_launch_ms(torch, lk, *call, every())
            print(name, json.dumps(row))
            results[name].append(row)
    print(json.dumps({"device": torch.cuda.get_device_name(0),
                      "nvidia_smi": cs.nvidia_smi_line(),
                      "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
