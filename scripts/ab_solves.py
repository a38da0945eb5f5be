#!/usr/bin/env python3
"""Parent against change on the card: ms per iteration of the main path's
solves (8193^2 / 11 levels, f32: mg-CG to rtol 1e-5, the Jacobi V-cycle
forced), each tree in its own process, in the order A B B A repeated.

    python scripts/ab_solves.py OTHER_TREE [--rounds 5] [--ranks 2]

With ``--ranks P`` each measurement is instead a world of P rank
processes sharing the card over gloo (``row_plan(min_local=32)``, halos
staged through the host, as ``chip_smoke.py`` phase 9 (b) runs it, but
with no other world beside it): mg-CG's ms per iteration on rank 0,
differenced 3 vs 13 iterations, median of 3 pairs, and its residual
history.

OTHER_TREE is another checkout of the repo (``git archive`` it into
``_archive/``, which git ignores).  The kernels are built once, in this
checkout, and the build is copied into the other tree when their sources
are the same (the library's name carries their hash); otherwise the other
tree builds its own, before the first measurement.  Each process prints one JSON line: the tree, mg-CG's
and the V-cycle's ms per iteration (differenced forced-length runs, 3 vs
33 iterations, median of 3 pairs) and the iterations.  The last line
gives each tree's medians and the card's name and power limit.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
BUILD = Path("multigrid_petsc_tpu_torch") / "_build"


def measure() -> dict:
    import dataclasses

    import torch

    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    out = {}
    for name, cyc, it in (("mgcg", CycleType.MGCG, 100),
                          ("vcycle", CycleType.VCYCLE, 10)):
        cfg = SolverConfig(npts=8193, grids=11, levels=11, cycle=cyc,
                           dtype="float32", rtol=1e-5, max_iter=it)
        res = solve(cfg, device="cuda")
        forced = dataclasses.replace(cfg, rtol=1e-30, divtol=1e30)
        pairs = []
        for _ in range(3):
            t = [solve(forced, ctx=dataclasses.replace(
                res.ctx, config=dataclasses.replace(forced, max_iter=k)),
                device="cuda", timed=True).wall_time for k in (3, 33)]
            pairs.append(1e3 * (t[1] - t[0]) / 30)
        out[name] = statistics.median(pairs)
        out[name + "_iters"] = res.iters
        del res
        torch.cuda.empty_cache()
    return out


def measure_rank(rank: int, world: int, port: int) -> dict:
    """One rank of a ``--ranks`` world: mg-CG under the row plan, then the
    forced pairs."""
    import dataclasses
    from datetime import timedelta

    import torch.distributed as dist

    from multigrid_petsc_tpu_torch.parallel import row_plan
    from multigrid_petsc_tpu_torch.solvers.solve import solve
    from multigrid_petsc_tpu_torch.utils.config import CycleType, SolverConfig

    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=timedelta(seconds=600))
    try:
        plan = row_plan(min_local=32, device="cuda")
        cfg = SolverConfig(npts=8193, grids=11, levels=11,
                           cycle=CycleType.MGCG, dtype="float32", rtol=1e-5,
                           max_iter=100)
        res = solve(cfg, plan=plan)
        forced = dataclasses.replace(cfg, rtol=1e-30, divtol=1e30)
        pairs = []
        for _ in range(3):
            t = [solve(forced, ctx=dataclasses.replace(
                res.ctx, config=dataclasses.replace(forced, max_iter=k)),
                timed=True).wall_time for k in (3, 13)]
            pairs.append(1e3 * (t[1] - t[0]) / 10)
        return {"mgcg_ranks": statistics.median(pairs),
                "mgcg_ranks_pairs": pairs, "mgcg_ranks_iters": res.iters,
                "mgcg_ranks_rnorm": [float(x) for x in res.rnorm],
                "transport": plan.transport}
    finally:
        dist.destroy_process_group()


def measure_world(world: int) -> dict:
    """Start ``world`` rank processes of this script on this tree; rank
    0's record."""
    import socket

    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    procs = [subprocess.Popen(
        [sys.executable, __file__, "--rank", str(r), str(world), str(port)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(world)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for r, (p, o) in enumerate(zip(procs, outs)):
        if p.returncode != 0:
            raise RuntimeError(f"rank {r} exited {p.returncode}:\n{o}")
    return json.loads(outs[0].strip().splitlines()[-1])


def run(tree: Path, ranks: int = 0) -> dict:
    proc = subprocess.run(
        [sys.executable, __file__, "--measure"]
        + (["--ranks", str(ranks)] if ranks else []), cwd=tree,
        env=dict(os.environ, PYTHONPATH=str(tree)),
        capture_output=True, text=True, timeout=900, check=True)
    rec = json.loads(proc.stdout.strip().splitlines()[-1])
    rec["tree"] = str(tree)
    print(json.dumps(rec), flush=True)
    return rec


def main() -> int:
    ranks = int(sys.argv[sys.argv.index("--ranks") + 1]) \
        if "--ranks" in sys.argv else 0
    if sys.argv[1:2] == ["--rank"]:
        rec = measure_rank(*map(int, sys.argv[2:5]))
        print(json.dumps(rec))
        return 0
    if sys.argv[1:2] == ["--measure"]:
        print(json.dumps(measure_world(ranks) if ranks else measure()))
        return 0
    other = Path(sys.argv[1]).resolve()
    rounds = int(sys.argv[sys.argv.index("--rounds") + 1]) \
        if "--rounds" in sys.argv else 5
    subprocess.run([sys.executable, "-c", "from multigrid_petsc_tpu_torch."
                    "ops.cuda._build import load_library; load_library()"],
                   cwd=REPO, check=True, timeout=900,
                   env=dict(os.environ, PYTHONPATH=str(REPO)))
    dst = other / BUILD
    dst.mkdir(parents=True, exist_ok=True)
    for f in (REPO / BUILD).iterdir():
        if f.is_file():
            shutil.copy2(f, dst / f.name)
    # The other tree's own build where its sources differ (a rank world's
    # processes would otherwise each build it).
    subprocess.run([sys.executable, "-c", "from multigrid_petsc_tpu_torch."
                    "ops.cuda._build import load_library; load_library()"],
                   cwd=other, check=True, timeout=900,
                   env=dict(os.environ, PYTHONPATH=str(other)))
    recs = []
    for _ in range(rounds):
        for tree in (REPO, other, other, REPO):
            recs.append(run(tree, ranks))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    summary = {"card": smi}
    for tree, label in ((REPO, "this"), (other, "other")):
        mine = [r for r in recs if r["tree"] == str(tree)]
        for k in ("mgcg_ranks",) if ranks else ("mgcg", "vcycle"):
            summary[f"{label}_{k}_median"] = statistics.median(
                r[k] for r in mine)
            summary[f"{label}_{k}"] = [r[k] for r in mine]
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
